"""The cooperative schedule of csrc/point_kernels.cu (coop_add, coop_double,
and B4 and the scalar-multiplication ladder built on them), emulated on
the CPU: a group of four ranks serves one lane, each rank's registers are
row r of a [4, L, 16] tensor, a shuffle reads the row its map names, a
select picks by rank, and every product and sum is the plain version's
(fmul_plain, fadd_plain, fsub_plain). The maps are read from the .cu, and
the emulation follows its statements one by one. It must equal
rcb_add_plain and rcb_double_plain (and so the one-thread kernels and the
reference) bit for bit on random projective points, identity lanes and
a == b lanes, and the ladder must equal scalar_mul_ladder_plain, in both
fields. Inputs are numpy-seeded."""
import os
import re

import numpy as np
import pytest
import torch

from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.curves.native import native_srs_g
from halo2_tpu_torch.fields.device import DeviceField, ints_to_digits
from halo2_tpu_torch.ops import cuda_build
from halo2_tpu_torch.ops import point_kernels as pk
from halo2_tpu_torch.ops.field_kernels import (NLIMBS, fadd_plain, fmul_plain,
                                               fsub_plain)

L = 40
CURVES = {"pallas": PALLAS, "vesta": VESTA}
RANKS = torch.arange(4)


def _constants() -> dict:
    src = open(os.path.join(cuda_build.CSRC, "point_kernels.cu")).read()
    found = dict(re.findall(
        r"static constexpr (?:int|uint32_t) (k\w+) = (0x[0-9A-Fa-f]+|\d+);",
        src))
    return {k: int(v, 0) for k, v in found.items()}


C = _constants()


def _src(name):
    """The rank each rank reads in a shuffle by map `name` (nibble r)."""
    return torch.tensor([(C[name] >> (4 * r)) & 15 for r in range(4)])


def _shfl(v, src):
    return v[src if isinstance(src, torch.Tensor) else torch.full((4,), src)]


def _sel(cond, a, b):
    return torch.where(cond[:, None, None], a, b)


def _sel3(q, v0, v1, v2):
    return _sel(q == 0, v0, _sel(q == 1, v1, v2))


def _mul15(df, a):
    x = fadd_plain(df, a, a)
    x = fadd_plain(df, x, x)
    x = fadd_plain(df, x, x)
    x = fadd_plain(df, x, x)
    return fsub_plain(df, x, a)


def coop_add(df, a0, a1, b0, b1):
    """coop_add, statement by statement; rows r = ranks."""
    r = RANKS
    q = torch.where(r == 3, 0, r)
    nxt = _src("kNext")
    t = fmul_plain(df, a0, b0)
    u = fadd_plain(df, a0, a1)
    v = fadd_plain(df, b0, b1)
    m = fmul_plain(df, u, v)
    tn = _shfl(t, nxt)
    d = fsub_plain(df, m, t)
    d = fsub_plain(df, d, tn)
    u = _sel(q == 0, t, tn)
    g3 = fadd_plain(df, u, u)
    g3 = fadd_plain(df, g3, u)
    u = _sel(q == 2, d, tn)
    f = _mul15(df, u)
    z = fadd_plain(df, t, f)
    s = fsub_plain(df, t, f)
    u = _shfl(_sel(q == 2, f, d), _src("kAddOpA1"))
    v = _shfl(_sel3(q, g3, z, f), _src("kAddOpB1"))
    m = fmul_plain(df, u, v)
    u = _shfl(_sel(q == 1, s, d), _src("kAddOpA2"))
    v = _sel3(q, d, z, g3)
    t = fmul_plain(df, u, v)
    u = fsub_plain(df, t, m)
    v = fadd_plain(df, m, t)
    return _sel(q == 0, u, v)


def coop_double(df, c):
    """coop_double, statement by statement."""
    r = RANKS
    a = _shfl(c, _src("kDblOpA"))
    b = _shfl(c, _src("kDblOpB"))
    p = fmul_plain(df, a, b)
    e = fadd_plain(df, p, p)
    e = fadd_plain(df, e, e)
    e = fadd_plain(df, e, e)
    f = fadd_plain(df, e, e)
    f = fsub_plain(df, f, p)
    t0 = _shfl(p, 0)
    z3 = _shfl(e, 0)
    t2 = _shfl(f, 2)
    f = fadd_plain(df, t0, t2)
    e = fadd_plain(df, t2, t2)
    e = fadd_plain(df, e, t2)
    t0 = fsub_plain(df, t0, e)
    a = _sel(r == 2, t2, t0)
    a = _sel(r == 1, p, a)
    b = _sel(r == 0, f, z3)
    b = _sel(r == 3, p, b)
    e = fmul_plain(df, a, b)
    f = _shfl(e, 2)
    f = _sel(r == 0, f, e)
    f = fadd_plain(df, e, f)
    f = _sel(r == 1, e, f)
    return _shfl(f, _src("kDblOut"))


def _spread(batch):
    """[48, L] -> [4, L, 16]: rank r's coordinate c(r) = {X, Y, Z, X}[r]
    (load_rows at row 16 c(r))."""
    X, Y, Z = pk._split2d(batch)
    return torch.stack([X, Y, Z, X])


def _gather(regs):
    """Ranks 0-2's coordinates as a [48, L] batch (store_rows)."""
    return pk._join2d(regs[0], regs[1], regs[2])


def b4(df, a, b):
    """padd_kernel: each rank loads c(r) of a and b, shuffles for the next
    coordinate, runs coop_add; ranks 0-2 store."""
    a0, b0 = _spread(a), _spread(b)
    nxt = _src("kNext")
    out = coop_add(df, a0, _shfl(a0, nxt), b0, _shfl(b0, nxt))
    assert torch.equal(out[3], out[0])       # rank 3 holds X
    return _gather(out)


def ladder(df, pts, digits, nbits, lo=None):
    """scalar_mul_ladder_kernel: P staged (ranks read coordinates c(r) and
    c(r) + 1 of it), acc = O spread over the ranks, a coop_double a step
    and a coop_add where the lane's bit is set (a branch of the group, so
    lanes without the bit keep the doubled acc), then the store or the
    fused butterfly with -acc's Y (rank 1) negated."""
    nxt = _src("kNext")
    P = _spread(pts)
    Pn = _shfl(P, nxt)
    n = pts.shape[1]
    acc = _spread(pk.ident_col(df, "cpu")[:, None].expand(3 * NLIMBS, n))
    bits = pk.scalar_bits(digits[torch.arange(n) % digits.shape[0]], nbits)
    for bit in bits:
        acc = coop_double(df, acc)
        added = coop_add(df, acc, _shfl(acc, nxt), P, Pn)
        acc = torch.where(bit[None, :, None], added, acc)
    if lo is None:
        return _gather(acc)
    lo0 = _spread(lo)
    lo1 = _shfl(lo0, nxt)
    out = _gather(coop_add(df, lo0, lo1, acc, _shfl(acc, nxt)))
    neg = fsub_plain(df, torch.zeros_like(acc), acc)
    acc = _sel(RANKS == 1, neg, acc)
    out2 = _gather(coop_add(df, lo0, lo1, acc, _shfl(acc, nxt)))
    return out, out2


def _points(curve, seed):
    """[48, L] batches A, B with Z != 1 (sums of two SRS points); identity
    lanes in both and in one operand only; lanes with A == B."""
    df = DeviceField(curve.base)
    pts = native_srs_g(curve, f"coop-point-{seed}", 4 * L)
    proj = pk.points_to_proj(df, pts, "cpu")
    A = pk.padd_plain(df, proj[:, :L], proj[:, L:2 * L])
    B = pk.padd_plain(df, proj[:, 2 * L:3 * L], proj[:, 3 * L:])
    ident = pk.ident_col(df, "cpu")[:, None]
    A[:, 0:3] = ident
    B[:, 2:5] = ident
    B[:, 9:12] = A[:, 9:12]
    perm = np.random.default_rng(seed).permutation(L)
    return df, A[:, perm].contiguous(), B[:, perm].contiguous()


def test_constants():
    """One group of four ranks a lane; kNext names the rank of the next
    coordinate c(r) + 1 (mod 3) with rank 3 holding X."""
    assert C["kGroup"] == 4
    coord = [0, 1, 2, 0]
    assert _src("kNext").tolist() == [(c + 1) % 3 for c in coord]
    for name in ("kAddOpA1", "kAddOpB1", "kAddOpA2", "kDblOpA", "kDblOpB",
                 "kDblOut"):
        assert all(0 <= s < 4 for s in _src(name).tolist()), name


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_coop_add_equals_rcb_add(curve):
    df, A, B = _points(curve, 1)
    assert torch.equal(b4(df, A, B), pk.padd_plain(df, A, B))
    assert torch.equal(b4(df, B, A), pk.padd_plain(df, A, B))
    assert torch.equal(b4(df, A, A), pk.pdouble_plain(df, A))


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_coop_double_equals_rcb_double(curve):
    df, A, B = _points(curve, 2)
    for x in (A, B):
        got = coop_double(df, _spread(x))
        assert torch.equal(got[3], got[0])   # rank 3 holds X
        assert torch.equal(_gather(got), pk.pdouble_plain(df, x))


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_coop_ladder_equals_plain(curve):
    """16 bits of scalars 0, 1, q - 1, 2^256 - 1 and random ones, one a
    lane and from an 8-row table with the fused butterfly."""
    df, A, B = _points(curve, 3)
    other = VESTA if curve is PALLAS else PALLAS
    q = other.base.modulus
    rng = np.random.default_rng(4)
    vals = [0, 1, q - 1, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(L - 4)]
    digits = torch.from_numpy(ints_to_digits(vals))
    nbits = 16
    assert torch.equal(ladder(df, A, digits, nbits),
                       pk.scalar_mul_ladder_plain(df, A, digits, nbits))
    got = ladder(df, A, digits[:8], nbits, lo=B)
    want = pk.scalar_mul_ladder_plain(df, A, digits[:8], nbits, lo=B)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
