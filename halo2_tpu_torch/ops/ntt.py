"""Radix-2 NTT over field tensors: kernel B7 and its plain version.

Port of halo2_tpu/ops/ntt.py (`make_plan`, `ntt`, `ntt_many`, `intt`) and
of the TPU routine halo2_tpu/ops/pallas_field.py::ntt_pallas. On CUDA
`ntt_many` launches kernel B7 (csrc/ntt_kernels.cu) once per pass of
`ntt_passes`: two launches for 2^10 < n <= 2^20 (one up to 2^10), the
first with the bit-reversal gather fused into its load, each running up
to PASS_LOG stages in shared memory. On the CPU it runs `ntt_many_plain`,
log2(n) vectorized butterfly stages after one gather, with the plain field
ops. `LAUNCHES` counts B7's kernel launches, nowhere else
(tracing.launch, with a pass's work: its columns read and written, 128
bytes an element, its stages' packed twiddles read once, 32 bytes each,
and n/2 products a stage a column).

`group_ntt` (halo2_tpu/ops/ntt.py:179) runs the same stages over a [48, n]
point batch, whose twiddle products are per-lane scalar multiplications:
one launch a stage of the scalar-multiplication ladder with its fused
butterfly (ops/point_kernels.py). It builds the SRS's g_lagrange.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tracing
from ..fields.device import DeviceField, NLIMBS, from_mont, int_to_limbs
from .field_kernels import (MONT_MULADDS, fmul, fmul_plain, fadd_plain,
                            fsub_plain, _dispatch)
from .point_kernels import scalar_mul_ladder_flat

LAUNCHES = tracing.launch_counters("ntt")
# stages a pass runs in shared memory at most: a 2^10-element tile of 8 x
# 32-bit limbs is 33 KB with its padding, so several blocks share an SM
PASS_LOG = 10
# a later pass takes enough residues that its tile holds 2^8 elements
MIN_TILE_LOG = 8


def ntt_passes(log_n: int) -> tuple:
    """The launch plan of a 2^log_n transform: (a, cnt, r_log) per pass,
    running stages a+1 .. a+cnt on tiles of 2^r_log consecutive residues
    mod 2^a times 2^cnt elements. ceil(log_n / PASS_LOG) passes of near
    equal stage counts (8 + 8 at 2^16, so each pass has 2^8 tiles a
    column); the first pass (a = 0) gathers through the bit reversal."""
    if log_n <= 0:
        return ()
    npass = -(-log_n // PASS_LOG)
    size, extra = divmod(log_n, npass)
    passes, a = [], 0
    for p in range(npass):
        cnt = size + (p < extra)
        passes.append((a, cnt, min(a, max(0, MIN_TILE_LOG - cnt))))
        a += cnt
    return tuple(passes)


def bit_reverse_perm(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


@dataclass(eq=False)
class NttPlan:
    """Tables for a size-n NTT with root `omega` (host ints) over the
    field `df`: `twiddles[s]` holds the 2^s twiddles of stage s+1 as
    Montgomery digits, `perm` the bit-reversal gather. The device copy is
    made once per device: the stage tables concatenated into one
    [n - 1, 16] tensor (stage s at rows 2^(s-1) - 1 .. 2^s - 2), which the
    kernel indexes, and views of it per stage. `exponents` gives the group
    NTT the same twiddles as canonical digits (the reference's
    twiddle_exps)."""
    n: int
    omega: int
    perm: np.ndarray
    twiddles: tuple
    df: DeviceField
    _dev: dict = field(default_factory=dict, repr=False)
    _exps: dict = field(default_factory=dict, repr=False)

    def exponents(self, device) -> tuple:
        """Per stage, its twiddles as int32 [2^s, 16] canonical 16-bit
        digits on `device`, the scalars of the group NTT's ladders: the
        device table taken out of Montgomery form (one B1 launch on CUDA),
        once per device."""
        device = torch.device(device)
        ent = self._exps.get(device)
        if ent is None:
            table = from_mont(self.df, self.on(device)[1])
            ent = self._exps[device] = tuple(
                table[(1 << s) - 1:(1 << (s + 1)) - 1]
                for s in range(len(self.twiddles)))
        return ent

    def on(self, device) -> tuple:
        """(perm, the concatenated twiddle table, the per-stage views, the
        table as packed 32-bit limbs [n - 1, 8]) on `device`."""
        device = torch.device(device)
        ent = self._dev.get(device)
        if ent is None:
            digits = np.concatenate(
                self.twiddles or (np.zeros((0, NLIMBS), np.int32),))
            table = tracing.upload("ntt_plan", torch.from_numpy(digits),
                                   device)
            stages = tuple(table[(1 << s) - 1:(1 << (s + 1)) - 1]
                           for s in range(len(self.twiddles)))
            words = (digits[:, 0::2].astype(np.uint32)
                     | (digits[:, 1::2].astype(np.uint32) << 16))
            packed = tracing.upload("ntt_plan", torch.from_numpy(
                np.ascontiguousarray(words.view(np.int32))), device)
            ent = self._dev[device] = (
                tracing.upload("ntt_plan", torch.as_tensor(self.perm),
                               device), table, stages, packed)
        return ent


def make_plan(df: DeviceField, n: int, omega: int) -> NttPlan:
    p = df.spec.modulus
    assert n & (n - 1) == 0
    k = n.bit_length() - 1
    assert pow(omega, n, p) == 1
    twiddles = []
    for s in range(1, k + 1):
        half = 1 << (s - 1)
        w_m = pow(omega, n >> s, p)
        ws, w = [], 1
        for _ in range(half):
            ws.append(w)
            w = w * w_m % p
        twiddles.append(df.to_mont_np(ws).reshape(half, NLIMBS))
    return NttPlan(n=n, omega=omega, perm=bit_reverse_perm(n),
                   twiddles=tuple(twiddles), df=df)


def ntt_many_plain(df: DeviceField, x: torch.Tensor, plan: NttPlan
                   ) -> torch.Tensor:
    """Forward NTT of [m, n, 16] along axis 1 in plain PyTorch: one
    bit-reversal gather, then per stage the twiddle products and the
    butterfly sums over all m columns (the twiddle row broadcasts over
    the butterfly groups)."""
    m, n = x.shape[0], x.shape[1]
    perm, _, tws, _ = plan.on(x.device)
    x = x.index_select(1, perm)
    for s, tw in enumerate(tws, start=1):
        mm = 1 << s
        half = mm // 2
        xr = x.view(m, n // mm, mm, NLIMBS)
        lo, hi = xr[:, :, :half], xr[:, :, half:]
        t = fmul_plain(df, hi, tw)
        x = torch.cat([fadd_plain(df, lo, t), fsub_plain(df, lo, t)],
                      dim=2).view(m, n, NLIMBS)
    return x


def ntt_many(df: DeviceField, x: torch.Tensor, plan: NttPlan
             ) -> torch.Tensor:
    """Forward NTT of [m, n, 16] int32 Montgomery digits along axis 1 (m
    independent transforms share every launch): kernel B7 on CUDA, one
    launch per pass of ntt_passes, the plain version on the CPU."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] != NLIMBS:
        raise TypeError(f"ntt_many takes int32 [m, n, 16], got {x.dtype} "
                        f"{tuple(x.shape)}")
    m, n = x.shape[0], x.shape[1]
    if n != plan.n:
        raise ValueError(f"plan of size {plan.n} for columns of {n}")
    if not _dispatch(x):
        return ntt_many_plain(df, x, plan)
    if n == 1 or m == 0:
        return x.clone()
    if m * n >= 1 << 31:
        raise ValueError(f"{m} columns of {n} exceed the kernel's 2^31 "
                         f"elements")
    from . import cuda_build
    x = x.contiguous()
    packed = plan.on(x.device)[3]
    out = torch.empty_like(x)
    log_n = n.bit_length() - 1
    lib = cuda_build.library("ntt_kernels")
    stream = cuda_build.stream_ptr(x.device)
    src = x
    for a, cnt, r_log in ntt_passes(log_n):
        rc = lib.h2t_ntt_pass(df.field_id, out.data_ptr(), src.data_ptr(),
                              packed.data_ptr(), m, log_n, a, cnt, r_log,
                              int(a == 0), stream)
        cuda_build.check(rc, "h2t_ntt_pass")
        tracing.launch("ntt", m * n,
                       m * n * 2 * NLIMBS * 4 + (((1 << cnt) - 1) << a) * 32,
                       m * (n // 2) * cnt * MONT_MULADDS)
        src = out
    return out


def ntt(df: DeviceField, a: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT: [n, 16] Montgomery coefficients -> evaluations at
    {omega^i} in natural order."""
    return ntt_many(df, a.unsqueeze(0), plan)[0]


def make_inv_plan(df: DeviceField, plan: NttPlan):
    """Inverse plan + n^{-1} as a host Montgomery digit array."""
    p = df.spec.modulus
    omega_inv = pow(plan.omega, p - 2, p)
    n_inv = pow(plan.n, p - 2, p)
    return (make_plan(df, plan.n, omega_inv),
            int_to_limbs(n_inv * (1 << 256) % p))


def intt(df: DeviceField, a: torch.Tensor, inv_plan: NttPlan,
         n_inv_mont) -> torch.Tensor:
    x = ntt(df, a, inv_plan)
    return fmul(df, x, tracing.upload("intt", torch.as_tensor(n_inv_mont),
                                      x.device))


def group_ntt(df: DeviceField, pts: torch.Tensor, plan: NttPlan
              ) -> torch.Tensor:
    """NTT over a [48, n] point batch (df: the points' base field; plan:
    over the scalar field): the butterflies of `ntt_many_plain` with
    point adds, whose twiddle products are per-lane scalar
    multiplications, 255 bits since every twiddle is below q < 2^255 (the
    reference's group_ntt, halo2_tpu/ops/ntt.py:179). Each stage is one
    launch of the scalar-multiplication ladder on the hi half, lane j of
    each group of `half` reading twiddle j % half, with the butterfly
    lo + t, lo - t fused."""
    n = plan.n
    if pts.dim() != 2 or pts.shape != (3 * NLIMBS, n):
        raise TypeError(f"group_ntt takes a [48, {n}] batch, got "
                        f"{tuple(pts.shape)}")
    rows = 3 * NLIMBS
    x = pts.index_select(1, plan.on(pts.device)[0])
    for s, tw in enumerate(plan.exponents(pts.device), start=1):
        half = 1 << (s - 1)
        xr = x.view(rows, n >> s, 2 * half)
        lo = xr[:, :, :half].reshape(rows, -1)
        hi = xr[:, :, half:].reshape(rows, -1)
        top, bot = scalar_mul_ladder_flat(df, hi, tw, 255, lo=lo)
        x = torch.cat([top.view(rows, -1, half), bot.view(rows, -1, half)],
                      dim=2).view(rows, n)
    return x
