"""IPA polynomial commitment scheme (Halo-style, transparent setup).

Port of halo2_tpu/poly/commitment.py (halo2_proofs/src/poly/
commitment.rs + msm.rs, prover.rs, verifier.rs). The SRS bases live on
the device as [48, n] projective batches with Z = mont 1 (identity
(0 : R : 0)), so rows 0-31 are the coded-affine batch the mixed-add
bucket kernel takes. On CUDA every commitment runs the device Pippenger
(ops/msm_pippenger.py); there is no host-MSM threshold.

The IPA open runs the reference's hybrid schedule: rounds with
half > `native_ipa_threshold` (NATIVE_IPA_THRESHOLD = 8192, the
reference's accelerator default) run on the device (ops/ipa_device.py),
then the folded state is handed once to the native host library
(curves/native.py), which runs the small rounds. At the default, k <= 14
opens are all native; 0 runs every round on the device.

Setup: g comes from the native library's hash-to-curve (Python where the
library is absent), as in the reference. On CUDA g_lagrange is a device
group iNTT (ops/ntt.py::group_ntt, then the 1/n scale, both on the
scalar-multiplication ladder; the reference's Params._build_lagrange); on
the CPU it is the native library's group iNTT, else a host one.
`Params.new` shares the reference's `.srs_cache`. The verifier's final
MSM runs on the host (the native library) unless that library is absent
and the MSM is large; `Guard.compute_g` is a device MSM through
ops/msm.py, as the reference's.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..fields.host import FieldSpec, batch_invert
from ..fields.device import (DeviceField, NLIMBS, digits_to_ints, from_mont,
                             ints_to_digits)
from ..curves.host import CurveSpec, Point
from ..curves.sswu import hash_to_curve
from ..curves import native
from ..curves.device import batch_scalar_mul, normalize
from ..ops.field_kernels import fmul, fadd, fsub
from ..ops.point_kernels import pack_affine, points_to_proj
from ..ops import msm_pippenger as mp
from ..ops.msm import msm
from ..ops.ntt import group_ntt, make_plan
from ..ops.ipa_device import ipa_device_lr, ipa_device_fold_lr
from ..parallel import context
from ..parallel.context import WHOLE
from ..parallel.mesh import sharded_msm_mont
from .utils import eval_poly, powers

# Memory ceiling of one batched commit: the Pippenger gathers a sorted
# point copy per (column, window) row -- 192 B x G x n in the segmented
# scan -- so columns are chunked to keep G*n (G = columns x windows)
# under 2^26, about 13 GB of that gather on an 80 GB card.
COMMIT_GN_BUDGET = 1 << 26

# IPA rounds with half > this run on the device, the rest in the native
# host library (halo2_tpu/poly/commitment.py:654-656, accelerator default)
NATIVE_IPA_THRESHOLD = 8192

# without the native library, MSMAccumulator.eval runs an MSM of more
# terms than this on the device (halo2_tpu/poly/commitment.py:581)
DEVICE_EVAL_THRESHOLD = 4096

# the reference's SRS cache, shared with it (same file format)
_SRS_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", ".srs_cache")


def _host_group_intt(curve: CurveSpec, g: list, omega_inv: int,
                     minv: int) -> list:
    """g_lagrange without the native library: an iterative radix-2 group
    iNTT on host points, scaled by 1/n (the reference's
    Params._host_group_intt)."""
    from ..ops.ntt import bit_reverse_perm
    q = curve.scalar.modulus
    n = len(g)
    x = [g[int(i)] for i in bit_reverse_perm(n)]
    m = 2
    while m <= n:
        w_m = pow(omega_inv, n // m, q)
        half = m // 2
        for start in range(0, n, m):
            w = 1
            for j in range(half):
                lo = x[start + j]
                hi = curve.mul(x[start + j + half], w)
                x[start + j] = curve.add(lo, hi)
                x[start + j + half] = curve.add(lo, curve.neg(hi))
                w = w * w_m % q
        m *= 2
    return [curve.mul(pt, minv) for pt in x]


def _device_group_intt(curve: CurveSpec, g_dev: torch.Tensor, omega_inv: int,
                       minv: int) -> tuple:
    """g_lagrange on the device of g_dev, the [48, n] batch of g (the
    reference's Params._build_lagrange, halo2_tpu/poly/commitment.py:
    115-122): the group NTT of g under omega_inv, each lane scaled by
    minv = 1/n on the scalar ladder, then one batch normalize. Returns
    (the affine host points, the [48, n] batch with Z = mont 1, identity
    (0, mont 1, 0)) -- the batch equals points_to_proj of the host points
    bit for bit."""
    base_df = DeviceField(curve.base)
    device = g_dev.device
    plan = make_plan(DeviceField(curve.scalar), g_dev.shape[1], omega_inv)
    pts = group_ntt(base_df, g_dev, plan)
    scale = tracing.upload("srs_scale", torch.from_numpy(
        ints_to_digits([minv])), device)
    x, y, inf = normalize(base_df, batch_scalar_mul(base_df, pts, scale,
                                                    nbits=255))
    z = torch.where(inf[:, None], torch.zeros_like(x),
                    base_df.scalar(1, device))
    dev = torch.cat([x.T, y.T, z.T], dim=0).contiguous()
    canon = from_mont(base_df, torch.stack([x, y])).cpu().numpy()
    xs, ys = digits_to_ints(canon[0]), digits_to_ints(canon[1])
    flags = inf.cpu().tolist()
    host = [None if f else (xi, yi) for xi, yi, f in zip(xs, ys, flags)]
    return host, dev


class Params:
    """Transparent SRS for one curve and size 2^k, with its device copy."""

    def __init__(self, curve: CurveSpec, k: int, g: list[Point],
                 g_lagrange: list[Point], w: Point, u: Point, device=None,
                 g_dev=None, g_lagrange_dev=None):
        assert k < 32
        self.device = resolve_device(device)
        self.curve = curve
        self.k = k
        self.n = 1 << k
        self.g = g
        self.g_lagrange = g_lagrange
        self.w = w
        self.u = u
        self.scalar_df = DeviceField(curve.scalar)
        self.base_df = DeviceField(curve.base)
        # g_dev, g_lagrange_dev: points_to_proj of g and g_lagrange, where
        # the caller already has them on the device
        self.g_dev = (points_to_proj(self.base_df, g, self.device)
                      if g_dev is None else g_dev)
        self.g_lagrange_dev = (
            points_to_proj(self.base_df, g_lagrange, self.device)
            if g_lagrange_dev is None else g_lagrange_dev)
        self._packed = {}
        self._mesh_cache = {}

    # ----------------- construction -----------------
    @classmethod
    def new(cls, curve: CurveSpec, k: int, device=None,
            use_cache: bool = True) -> "Params":
        """SRS via hash_to_curve("Halo2-Parameters") with messages
        [0, i_le4] / [1] / [2] (commitment.rs:38-114): g in the native
        library, in Python (curves/sswu.py) where it is absent; g_lagrange
        on CUDA by the device group iNTT (_device_group_intt; a failed
        build or launch raises), on the CPU in the native library, else a
        host group iNTT. With use_cache, read from and written to
        .srs_cache/{curve}_{k}.params at the repository root, the
        reference's cache (halo2_tpu/poly/commitment.py:62-88). Leaves
        tracing.LAST_PARAMS: the span "params.new" and the counters
        "srs_cache.hit" and "srs_cache.miss" (use_cache only)."""
        with tracing.record("params"), tracing.span("params.new"):
            return cls._new(curve, k, resolve_device(device), use_cache)

    @classmethod
    def _new(cls, curve: CurveSpec, k: int, device, use_cache: bool
             ) -> "Params":
        cache = os.path.join(_SRS_CACHE, f"{curve.name}_{k}.params")
        if use_cache and os.path.exists(cache):
            with open(cache, "rb") as fh:
                data = fh.read()
            try:
                params = cls.read(curve, data, device)
                tracing.count("srs_cache.hit")
                return params
            except ValueError:
                pass    # a file another process is still writing: rebuild
        if use_cache:
            tracing.count("srs_cache.miss")
        n = 1 << k
        g = native.native_srs_g(curve, "Halo2-Parameters", n)
        if g is False:
            g = [hash_to_curve(curve, "Halo2-Parameters",
                               b"\x00" + i.to_bytes(4, "little"))
                 for i in range(n)]
        w = hash_to_curve(curve, "Halo2-Parameters", b"\x01")
        u = hash_to_curve(curve, "Halo2-Parameters", b"\x02")
        fs = curve.scalar
        omega = pow(fs.root_of_unity, 1 << (fs.s - k), fs.modulus)
        omega_inv = pow(omega, fs.modulus - 2, fs.modulus)
        minv = pow(n, fs.modulus - 2, fs.modulus)
        g_dev = g_lagrange_dev = None
        if device.type == "cuda":
            g_dev = points_to_proj(DeviceField(curve.base), g, device)
            g_lagrange, g_lagrange_dev = _device_group_intt(
                curve, g_dev, omega_inv, minv)
        else:
            g_lagrange = native.native_group_ntt(curve, g, omega_inv, minv)
            if g_lagrange is False:
                g_lagrange = _host_group_intt(curve, g, omega_inv, minv)
        params = cls(curve, k, g, g_lagrange, w, u, device, g_dev,
                     g_lagrange_dev)
        if use_cache:
            # a file of its own renamed into place: a reader in another
            # process or thread never sees half a file
            os.makedirs(_SRS_CACHE, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=_SRS_CACHE,
                                       prefix=os.path.basename(cache) + ".",
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(params.write())
                os.replace(tmp, cache)
            except BaseException:
                os.unlink(tmp)
                raise
        return params

    # ----------------- serialization (commitment.rs:169-205) ------------
    def write(self) -> bytes:
        out = bytearray()
        out += int(self.k).to_bytes(4, "little")
        for pt in self.g:
            out += self.curve.to_bytes(pt)
        for pt in self.g_lagrange:
            out += self.curve.to_bytes(pt)
        out += self.curve.to_bytes(self.w)
        out += self.curve.to_bytes(self.u)
        return bytes(out)

    @classmethod
    def read(cls, curve: CurveSpec, data: bytes, device=None) -> "Params":
        k = int.from_bytes(data[:4], "little")
        if k >= 32:
            raise ValueError(f"SRS k={k} out of range (k < 32)")
        n = 1 << k
        if len(data) < 4 + 32 * (2 * n + 2):
            raise ValueError(f"truncated SRS buffer for k={k}")
        body = data[4:4 + 32 * (2 * n + 2)]
        pts = native.native_decompress_many(curve, body)
        if pts is False:
            # no native library: decompress in Python, as the reference
            pts = [curve.from_bytes(body[i:i + 32])
                   for i in range(0, len(body), 32)]
            if any(pt is False for pt in pts):
                raise ValueError("SRS buffer holds an invalid point")
        return cls(curve, k, pts[:n], pts[n:2 * n], pts[2 * n],
                   pts[2 * n + 1], device)

    # ----------------- commitments -----------------
    def packed_bases(self, lagrange: bool) -> torch.Tensor:
        """g_lagrange_dev or g_dev as the bucket-run kernel reads them
        (pack_affine: [n, 16] words, 64 B a point), made once."""
        ent = self._packed.get(lagrange)
        if ent is None:
            bases = self.g_lagrange_dev if lagrange else self.g_dev
            ent = self._packed[lagrange] = pack_affine(bases[:2 * NLIMBS])
        return ent

    def commit(self, coeffs_mont: torch.Tensor, blind: int) -> Point:
        assert coeffs_mont.shape[0] == self.n
        return self.commit_many([coeffs_mont], [blind], lagrange=False)[0]

    def commit_lagrange(self, values_mont: torch.Tensor, blind: int) -> Point:
        assert values_mont.shape[0] == self.n
        return self.commit_many([values_mont], [blind], lagrange=True)[0]

    def _mesh_ctx(self):
        """The active ProverMesh when n shards evenly (D | n), else None."""
        ctx = context.active()
        if ctx is not None and self.n % ctx.ndev == 0:
            return ctx
        return None

    def _mesh_bases(self, ctx, lagrange: bool) -> tuple:
        """This rank's rows of g_lagrange_dev or g_dev and their packed
        copy (the reference's _mesh_bases), in storage of their own, made
        once per basis and mesh."""
        key = (lagrange, ctx.ndev, ctx.rank)
        ent = self._mesh_cache.get(key)
        if ent is None:
            bases = self.g_lagrange_dev if lagrange else self.g_dev
            local = ctx.local_rows(bases, dim=1)
            ent = self._mesh_cache[key] = (
                local, pack_affine(local[:2 * NLIMBS]))
        return ent

    def commit_many(self, polys_mont: list, blinds: list[int],
                    lagrange: bool, rows=WHOLE) -> list[Point]:
        """m same-basis commitments in one batched device Pippenger: the
        m scalar vectors share the bases, so they only widen the lanes of
        every round. Under a ProverMesh (D | n) each rank runs it on its
        n/D rows and the ranks sum their window sums
        (parallel/mesh.py::sharded_msm_mont): rows of whole vectors, or
        the vectors themselves where `rows` is the ProverMesh whose rank's
        rows they are. [blind]w is added on the host."""
        m = len(polys_mont)
        if m == 0:
            return []
        ctx = rows if rows.local else self._mesh_ctx()
        nrows = self.n if ctx is None else self.n // ctx.ndev
        c = mp.pick_c(nrows)
        w_cnt = -(-256 // c)
        m_chunk = max(1, (COMMIT_GN_BUDGET // nrows) // w_cnt)
        bases = self.g_lagrange_dev if lagrange else self.g_dev
        fs = self.curve.scalar
        out = []
        for i in range(0, m, m_chunk):
            vals = torch.stack(polys_mont[i:i + m_chunk], dim=0)
            if ctx is not None:
                local, packed = self._mesh_bases(ctx, lagrange)
                pts = sharded_msm_mont(
                    self.curve, ctx.mesh,
                    vals if rows.local else ctx.shard_rows(vals, dim=1),
                    local, packed)
            else:
                digits = from_mont(self.scalar_df, vals)
                pts = mp.msm_many(self.curve, self.base_df, digits, bases,
                                  c=c, packed=self.packed_bases(lagrange))
            for pt, b in zip(pts, blinds[i:i + m_chunk]):
                b %= fs.modulus
                if b:
                    pt = self.curve.add(pt, self.curve.mul(self.w, b))
                out.append(pt)
        return out

    def empty_msm(self) -> "MSMAccumulator":
        return MSMAccumulator(self)


DEFAULT_BLIND = 1  # Blind::default() == ONE (commitment.rs:209-216)


class MSMAccumulator:
    """Deferred linear combination of commitments -- the verifier's whole
    state (poly/commitment/msm.rs:10-170): host-side symbolic algebra with
    sign-aware merging keyed on x; `eval()` runs one host MSM."""

    def __init__(self, params: Params):
        self.params = params
        self.fs = params.curve.scalar
        self.g_scalars: list[int] | None = None
        self.w_scalar: int | None = None
        self.u_scalar: int | None = None
        self.other: dict[int, tuple[int, int]] = {}  # x -> (scalar, y)

    def clone(self) -> "MSMAccumulator":
        c = MSMAccumulator(self.params)
        c.g_scalars = None if self.g_scalars is None else list(self.g_scalars)
        c.w_scalar = self.w_scalar
        c.u_scalar = self.u_scalar
        c.other = dict(self.other)
        return c

    def append_term(self, scalar: int, point: Point) -> None:
        if point is None:
            return
        x, y = point
        q = self.fs.modulus
        if x in self.other:
            s, oy = self.other[x]
            if oy == y:
                self.other[x] = ((s + scalar) % q, oy)
            else:
                assert oy == self.params.curve.base.neg(y)
                self.other[x] = ((s - scalar) % q, oy)
        else:
            self.other[x] = (scalar % q, y)

    def add_msm(self, other: "MSMAccumulator") -> None:
        for x, (s, y) in other.other.items():
            self.append_term(s, (x, y))
        if other.g_scalars is not None:
            self.add_to_g_scalars(other.g_scalars)
        if other.w_scalar is not None:
            self.add_to_w_scalar(other.w_scalar)
        if other.u_scalar is not None:
            self.add_to_u_scalar(other.u_scalar)

    def add_constant_term(self, constant: int) -> None:
        if self.g_scalars is None:
            self.g_scalars = [0] * self.params.n
        self.g_scalars[0] = (self.g_scalars[0] + constant) % self.fs.modulus

    def add_to_g_scalars(self, scalars: list[int]) -> None:
        assert len(scalars) == self.params.n
        q = self.fs.modulus
        if self.g_scalars is None:
            self.g_scalars = [s % q for s in scalars]
        else:
            self.g_scalars = [(a + b) % q
                              for a, b in zip(self.g_scalars, scalars)]

    def add_to_w_scalar(self, scalar: int) -> None:
        self.w_scalar = ((self.w_scalar or 0) + scalar) % self.fs.modulus

    def add_to_u_scalar(self, scalar: int) -> None:
        self.u_scalar = ((self.u_scalar or 0) + scalar) % self.fs.modulus

    def scale(self, factor: int) -> None:
        q = self.fs.modulus
        if self.g_scalars is not None:
            self.g_scalars = [s * factor % q for s in self.g_scalars]
        self.other = {x: (s * factor % q, y)
                      for x, (s, y) in self.other.items()}
        if self.w_scalar is not None:
            self.w_scalar = self.w_scalar * factor % q
        if self.u_scalar is not None:
            self.u_scalar = self.u_scalar * factor % q

    def eval(self) -> bool:
        """One MSM over the flattened terms; True iff it is the identity.
        The host MSM (the native library), or, where that library is
        absent and there are more than DEVICE_EVAL_THRESHOLD terms, one
        device MSM (halo2_tpu/poly/commitment.py:577-584)."""
        scalars: list[int] = []
        bases: list[Point] = []
        for x in sorted(self.other):   # BTreeMap iteration order
            s, y = self.other[x]
            scalars.append(s)
            bases.append((x, y))
        if self.w_scalar is not None:
            scalars.append(self.w_scalar)
            bases.append(self.params.w)
        if self.u_scalar is not None:
            scalars.append(self.u_scalar)
            bases.append(self.params.u)
        if self.g_scalars is not None:
            scalars.extend(self.g_scalars)
            bases.extend(self.params.g)
        if not scalars:
            return True
        if (native._load() is None
                and len(scalars) > DEVICE_EVAL_THRESHOLD):
            params = self.params
            digits = torch.from_numpy(ints_to_digits(
                [v % self.fs.modulus for v in scalars])).to(params.device)
            pts = points_to_proj(params.base_df, bases, params.device)
            return msm(params.curve, digits, pts,
                       packed=pack_affine(pts[:2 * NLIMBS])) is None
        return self.params.curve.msm(scalars, bases) is None


# ---------------------------------------------------------------------------
# IPA open (commitment/prover.rs:27-152)
# ---------------------------------------------------------------------------

def ipa_create_proof(params: Params, rng, transcript,
                     p_poly_mont: torch.Tensor, p_blind: int, x3: int,
                     native_ipa_threshold: int = NATIVE_IPA_THRESHOLD
                     ) -> None:
    """Open `p_poly` (coeff basis) at x3; the transcript already holds P,
    v, x3. The S commitment and P' run on the device; L/R rounds with
    half > native_ipa_threshold run on the device too, each fold fused
    with the next round's L/R, and the rest in one native session that
    takes over the folded state (the reference's hybrid loop,
    halo2_tpu/poly/commitment.py:657-739). Spans: "ipa.s_poly" (S drawn,
    its value at x3, its upload and commit), "ipa.p_prime", "ipa.b_powers",
    "ipa.device" (the device rounds), "ipa.native" (the session's start,
    every round and fold, final_c) and "ipa.blind" (L and R blinded and
    written, each round's challenge)."""
    df = params.scalar_df
    fs = params.curve.scalar
    n, k = params.n, params.k
    q = fs.modulus
    dev = p_poly_mont.device
    assert p_poly_mont.shape[0] == n

    # random poly S with a root at x3 (prover.rs:45-58)
    with tracing.span("ipa.s_poly"):
        s_vals = [fs.rand(rng) for _ in range(n)]
        s_at_x3 = 0
        for v in reversed(s_vals):
            s_at_x3 = (s_at_x3 * x3 + v) % q
        s_vals[0] = (s_vals[0] - s_at_x3) % q
        s_poly = df.upload_values(s_vals, dev, site="ipa_s_poly")
        s_blind = fs.rand(rng)
        transcript.write_point(params.commit(s_poly, s_blind))

    xi = transcript.squeeze_challenge()
    z = transcript.squeeze_challenge()

    # P' = xi S + P, minus v = P'(x3) in the constant term (prover.rs:69-78)
    with tracing.span("ipa.p_prime"):
        p_prime = fadd(df, fmul(df, s_poly, df.scalar(xi, dev)),
                       p_poly_mont)
        v = eval_poly(df, p_prime, x3)
        p_prime = torch.cat([fsub(df, p_prime[0:1], df.scalar(v, dev)),
                             p_prime[1:]], dim=0)
    f = (s_blind * xi + p_blind) % q
    with tracing.span("ipa.b_powers"):
        b = powers(df, x3, n, dev)

    sess = None     # the native session, once the rounds are handed over
    g_prime = None  # [48, 2 half] device G' while rounds run on the card
    dev_lr = None   # this round's L/R, computed by the previous device fold
    cur = params.curve
    for j in range(k):
        half = 1 << (k - j - 1)
        if sess is None and half <= native_ipa_threshold:
            with tracing.span("ipa.native"):
                sess = _start_native_ipa(params, p_prime, b, g_prime)
        if sess is not None:
            with tracing.span("ipa.native"):
                l_pt, r_pt, value_l, value_r = sess.round()
        elif j == 0:
            g_prime = params.g_dev
            with tracing.span("ipa.device"):
                l_pt, r_pt, value_l, value_r = ipa_device_lr(
                    params, p_prime, b, g_prime)
        else:
            l_pt, r_pt, value_l, value_r = dev_lr
        with tracing.span("ipa.blind"):
            l_rand = fs.rand(rng)
            r_rand = fs.rand(rng)
            # L_j += [v_l z] U + [l_rand] W
            l_pt = cur.add(l_pt, cur.add(
                cur.mul(params.u, value_l * z % q),
                cur.mul(params.w, l_rand)))
            r_pt = cur.add(r_pt, cur.add(
                cur.mul(params.u, value_r * z % q),
                cur.mul(params.w, r_rand)))
            transcript.write_point(l_pt)
            transcript.write_point(r_pt)
            u_j = transcript.squeeze_challenge()
            u_j_inv = fs.inv(u_j)
        if sess is not None:
            with tracing.span("ipa.native"):
                sess.fold(u_j, u_j_inv)
        else:
            # no fused next-round L/R when that round runs natively
            next_native = half // 2 <= native_ipa_threshold
            with tracing.span("ipa.device"):
                p_prime, b, g_prime, *dev_lr = ipa_device_fold_lr(
                    params, p_prime, b, g_prime, half, u_j, u_j_inv,
                    with_lr=not next_native)
        f = (f + l_rand * u_j_inv + r_rand * u_j) % q

    if sess is not None:
        with tracing.span("ipa.native"):
            c = sess.final_c()
    else:
        c = int(df.from_mont_np(p_prime[0]))
    transcript.write_scalar(c)
    transcript.write_scalar(f)


def _start_native_ipa(params: Params, p_prime: torch.Tensor,
                      b: torch.Tensor, g_prime: torch.Tensor | None):
    """Hand p', b and G' to the native session, in Montgomery form (the
    device's R = 2^256 matches the library's). G' is the SRS g when the
    session starts at round 0 (g_prime None; its arrays are cached on
    Params), else the device rounds' projective G', batch-normalized."""
    if native._load() is None:
        raise RuntimeError("the native pasta library (g++) is required for "
                           "the IPA rounds")
    if g_prime is None:
        cached = getattr(params, "_g_native", None)
        if cached is None:
            g = params.g_dev.cpu().numpy()
            g_inf = np.array([pt is None for pt in params.g], np.uint8)
            cached = params._g_native = (
                np.ascontiguousarray(g[:NLIMBS].T),
                np.ascontiguousarray(g[NLIMBS:2 * NLIMBS].T), g_inf)
        gx, gy, g_inf = cached
    else:
        x, y, inf = normalize(params.base_df, g_prime)
        gx, gy = x.cpu().numpy(), y.cpu().numpy()
        g_inf = inf.cpu().numpy().astype(np.uint8)
    pb = torch.stack([p_prime, b]).cpu().numpy()
    return native.NativeIpaSession(params.curve, pb[0], pb[1], gx, gy, g_inf)


# ---------------------------------------------------------------------------
# IPA verify (commitment/verifier.rs:66-171)
# ---------------------------------------------------------------------------

@dataclass
class Accumulator:
    g: Point
    u_packed: list[int]


class Guard:
    """Deferred final check with two exits (commitment/verifier.rs:13-60)."""

    def __init__(self, msm_acc: MSMAccumulator, neg_c: int, u: list[int]):
        self.msm = msm_acc
        self.neg_c = neg_c
        self.u = u

    def use_challenges(self) -> MSMAccumulator:
        s = compute_s(self.msm.fs, self.u, self.neg_c)
        self.msm.add_to_g_scalars(s)
        return self.msm

    def use_g(self, g: Point) -> tuple[MSMAccumulator, Accumulator]:
        self.msm.append_term(self.neg_c, g)
        return self.msm, Accumulator(g=g, u_packed=list(self.u))

    def compute_g(self) -> Point:
        """G = <s, params.g> through the MSM dispatch (ops/msm.py): a
        device MSM above its host threshold, as the reference's
        (halo2_tpu/poly/commitment.py:806-814)."""
        params = self.msm.params
        s = compute_s(self.msm.fs, self.u, 1)
        digits = torch.from_numpy(ints_to_digits(s)).to(params.device)
        return msm(params.curve, digits, params.g_dev,
                   packed=params.packed_bases(False))


class OpeningError(Exception):
    pass


def ipa_verify_proof(params: Params, msm_acc: MSMAccumulator, transcript,
                     x: int, v: int) -> Guard:
    fs = params.curve.scalar
    k = params.k
    msm_acc.add_constant_term((-v) % fs.modulus)
    s_commitment = transcript.read_point()
    xi = transcript.squeeze_challenge()
    msm_acc.append_term(xi, s_commitment)
    z = transcript.squeeze_challenge()

    rounds = []
    for _ in range(k):
        l = transcript.read_point()
        r = transcript.read_point()
        u_j = transcript.squeeze_challenge()
        rounds.append((l, r, u_j))
    u_invs = batch_invert(fs, [u_j for (_, _, u_j) in rounds])

    u = []
    for (l, r, u_j), u_j_inv in zip(rounds, u_invs):
        msm_acc.append_term(u_j_inv, l)
        msm_acc.append_term(u_j, r)
        u.append(u_j)

    c = transcript.read_scalar()
    neg_c = (-c) % fs.modulus
    f = transcript.read_scalar()
    b = compute_b(fs, x, u)

    msm_acc.add_to_u_scalar(neg_c * b % fs.modulus * z % fs.modulus)
    msm_acc.add_to_w_scalar((-f) % fs.modulus)
    return Guard(msm_acc, neg_c, u)


def compute_b(fs: FieldSpec, x: int, u: list[int]) -> int:
    """prod (1 + u_{k-1-i} x^{2^i}) (commitment/verifier.rs:145-153)."""
    q = fs.modulus
    tmp, cur = 1, x
    for u_j in reversed(u):
        tmp = tmp * (1 + u_j * cur) % q
        cur = cur * cur % q
    return tmp


def compute_s(fs: FieldSpec, u: list[int], init: int) -> list[int]:
    """Coefficients of g(X) = prod (1 + u_{k-1-i} X^{2^i}), scaled by init
    (commitment/verifier.rs:156-171)."""
    q = fs.modulus
    v = [0] * (1 << len(u))
    v[0] = init % q
    length = 1
    for u_j in reversed(u):
        for i in range(length):
            v[length + i] = v[i] * u_j % q
        length *= 2
    return v
