"""The cooperative schedule of csrc/point_kernels.cu (coop_add, coop_double,
and B4, B5, B6 and the scalar-multiplication ladder built on them),
emulated on the CPU: a group of four ranks serves one lane, each rank's
registers are row r of a [4, L, 16] tensor, a shuffle reads the row its
map names, a select picks by rank, and every product and sum is the plain
version's (fmul_plain, fadd_plain, fsub_plain). The maps are read from the
.cu, and the emulation follows its statements one by one. It must equal
rcb_add_plain and rcb_double_plain (and so the one-thread kernels and the
reference) bit for bit on random projective points, identity lanes and
a == b lanes, the masked group form of B6 pdouble_masked_plain, the
ladder scalar_mul_ladder_plain, the GLV ladder's group form (its table
read per rank from the staged shared-memory layout) glv_ladder_plain,
the bucket-run kernel's group form (its four-word base load and the
shuffles) pmixed_bucket_runs_plain and B2's group form
pmixed_masked_plain, in both fields. The same holds for the
schedule of two threads a lane that redesign_variants.py builds and times
beside the kernels (pair_double, its maps read from that script). Inputs
are numpy-seeded."""
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


CU = os.path.join(cuda_build.CSRC, "point_kernels.cu")
# the pair form's source, a variant of redesign_variants.py at the root
VARIANTS = os.path.join(os.path.dirname(os.path.dirname(cuda_build.CSRC)),
                        "redesign_variants.py")


def _constants(path: str = CU) -> dict:
    src = open(path).read()
    found = dict(re.findall(
        r"static constexpr (?:int|uint32_t) (k\w+) = (0x[0-9A-Fa-f]+|\d+);",
        src))
    return {k: int(v, 0) for k, v in found.items()}


C = _constants()
P = _constants(VARIANTS)


def _src(name, consts=C, ranks=4):
    """The rank each rank reads in a shuffle by map `name` (nibble r)."""
    return torch.tensor([(consts[name] >> (4 * r)) & 15
                         for r in range(ranks)])


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


def pair_double(df, c0, c1):
    """pair_double (redesign_variants.PAIR_FORM), statement by statement;
    rows r = the pair's two ranks, c0 and c1 their coordinates r and r + 1."""
    r = torch.arange(P["kPair"])
    other = _src("kPairOther", P, P["kPair"])
    p0 = fmul_plain(df, c0, c1)
    p1 = fmul_plain(df, c1, c1)
    q = _shfl(p1, other)
    ysq = _sel(r == 0, p1, q)
    u = _sel(r == 0, q, p1)
    z3 = fadd_plain(df, ysq, ysq)
    z3 = fadd_plain(df, z3, z3)
    z3 = fadd_plain(df, z3, z3)
    t2 = _mul15(df, u)
    y3 = fadd_plain(df, ysq, t2)
    u = fadd_plain(df, t2, t2)
    u = fadd_plain(df, u, t2)
    t0 = fsub_plain(df, ysq, u)
    e1 = fmul_plain(df, _sel(r == 0, t0, p0), _sel(r == 0, p0, z3))
    e2 = fmul_plain(df, _sel(r == 0, t0, t2), _sel(r == 0, y3, z3))
    q = _shfl(e2, other)
    u = fadd_plain(df, e2, q)
    a = fadd_plain(df, e1, e1)
    return _sel(r == 0, a, u), _sel(r == 0, u, e1)


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


def b6_group(df, a, mask):
    """pdouble_group_kernel<F, true>: each rank loads c(r), runs
    coop_double and keeps the loaded coordinate where the lane's mask word
    is 0; ranks 0-2 store."""
    c = _spread(a)
    d = coop_double(df, c)
    return _gather(torch.where((mask != 0)[None, :, None], d, c))


def pdouble_pair(df, a, mask=None):
    """pdouble_pair_kernel (redesign_variants.PAIR_FORM): rank r loads
    coordinates r and r + 1, runs pair_double and, with a mask, keeps its
    loads where the lane's mask word is 0; rank r stores coordinate r and
    rank 1 coordinate 2 too."""
    X, Y, Z = pk._split2d(a)
    c0, c1 = torch.stack([X, Y]), torch.stack([Y, Z])
    o0, o1 = pair_double(df, c0, c1)
    assert torch.equal(o1[0], o0[1])          # both ranks hold Y3
    if mask is not None:
        live = (mask != 0)[None, :, None]
        o0, o1 = torch.where(live, o0, c0), torch.where(live, o1, c1)
    return pk._join2d(o0[0], o0[1], o1[1])


def glv_group(df, t1, t2, t12, bits1, bits2):
    """glv_ladder_group_kernel: ranks 0-2 stage coordinate c(r) of t1, t2
    and t12 at words 24 k + 8 r of the group's kGlvTabStride words (here
    slot (24 k + 8 r) / 8 of a list of coordinates); acc = O on the ranks;
    a coop_double a step and, where sel = b1 + 2 b2 (the same on every
    lane) is not 0, a coop_add with b0 and b1 read at words
    24 (sel - 1) + 8 c(r) and 24 (sel - 1) + 8 c(r + 1)."""
    coord = [0, 1, 2, 0]
    nxt = _src("kNext")
    tab = [None] * (C["kGlvTabStride"] // 8)
    for k, t in enumerate((t1, t2, t12)):
        regs = _spread(t)
        for r in range(3):
            tab[(24 * k + 8 * r) // 8] = regs[r]
    n = t1.shape[1]
    acc = _spread(pk.ident_col(df, "cpu")[:, None].expand(3 * NLIMBS, n))
    for b1, b2 in zip(bits1, bits2):
        acc = coop_double(df, acc)
        sel = int(b1) + 2 * int(b2)
        if sel == 0:
            continue
        e = 24 * (sel - 1)
        b0 = torch.stack([tab[(e + 8 * coord[r]) // 8] for r in range(4)])
        bn = torch.stack([tab[(e + 8 * coord[int(nxt[r])]) // 8]
                          for r in range(4)])
        acc = coop_add(df, acc, _shfl(acc, nxt), b0, bn)
    assert torch.equal(acc[3], acc[0])       # rank 3 holds X
    return _gather(acc)


def _words_digits(w):
    """[..., 8] 32-bit limbs (int32 bits) -> [..., 16] 16-bit digits."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).flatten(-2).to(
        torch.int32)


def bucket_group(df, bases, members, starts, counts, BL, lanes):
    """pmixed_bucket_runs_group_kernel: group i serves lane lanes[i]; per
    member of the lane's run, rank r loads 16-byte word r (limbs 4r..4r+3)
    of the packed base, the group takes x from ranks 0 and 1 and y from
    ranks 2 and 3 by shuffles, skips an identity-coded base, negates y
    where bit 31 of the member is set, and runs coop_add with
    b0 = {x, y, 1}[c(r)] and b1 = {y, 1, x}[c(r)] (Z2 = mont 1). Groups
    past their run keep acc (the group's loop has ended); ranks 0-2 store
    column lanes[i]."""
    coord = torch.tensor([0, 1, 2, 0])
    nxt = _src("kNext")
    n = bases.shape[0]
    L = starts.shape[0]
    one = pk.mont_one(df, "cpu")
    acc = _spread(pk.ident_col(df, "cpu")[:, None].expand(3 * NLIMBS, L))
    flat = members.reshape(-1).to(torch.int64)
    lanes = lanes.to(torch.int64)
    row = lanes // BL * n
    starts, counts = starts.to(torch.int64)[lanes], counts.to(
        torch.int64)[lanes]
    for k in range(int(counts.max())):
        live = k < counts
        m = flat[row + torch.where(live, starts + k, 0)]
        words = bases[m & 0x7FFFFFFF].view(L, 4, 4).permute(1, 0, 2)
        x2 = _words_digits(torch.cat([words[0], words[1]], dim=-1))
        y2 = _words_digits(torch.cat([words[2], words[3]], dim=-1))
        ident = (x2 == 0).all(-1) & (y2 == one).all(-1)
        # p - y as in the kernel (y is never 0 on a curve point)
        y2 = torch.where((m < 0)[:, None],
                         fsub_plain(df, torch.zeros_like(y2), y2), y2)
        ones = one.expand(L, NLIMBS)
        cands0, cands1 = (x2, y2, ones), (y2, ones, x2)
        b0 = torch.stack([cands0[int(c)] for c in coord])
        b1 = torch.stack([cands1[int(c)] for c in coord])
        added = coop_add(df, acc, _shfl(acc, nxt), b0, b1)
        acc = torch.where((live & ~ident)[None, :, None], added, acc)
    assert torch.equal(acc[3], acc[0])       # rank 3 holds X
    out = torch.empty(3 * NLIMBS, L, dtype=torch.int32)
    out[:, lanes] = _gather(acc)
    return out


def b2_group(df, a, b_aff, mask, signs):
    """pmixed_masked_group_kernel: every rank reads the lane's mask word
    and, where it is set, the whole base; a lane whose mask is 0 or whose
    base is identity-coded (0, mont 1) copies A, a branch of the whole
    group. On the other lanes y is negated where the sign is set (p - y,
    as the kernel's sub_raw: y is never 0 on a curve point), select3
    spreads b0 = {x, y, 1}[c(r)] and b1 = {y, 1, x}[c(r)] (Z2 = mont 1),
    rank r loads coordinate c(r) of A and takes the next from its
    neighbour, and coop_add runs; ranks 0-2 store."""
    coord = [0, 1, 2, 0]
    nxt = _src("kNext")
    one = pk.mont_one(df, "cpu")
    x2, y2 = b_aff[:NLIMBS].T, b_aff[NLIMBS:].T
    live = (mask != 0) & ~((x2 == 0).all(-1) & (y2 == one).all(-1))
    y2 = torch.where((signs != 0)[:, None],
                     fsub_plain(df, torch.zeros_like(y2), y2), y2)
    ones = one.expand(x2.shape)
    cands0, cands1 = (x2, y2, ones), (y2, ones, x2)
    b0 = torch.stack([cands0[c] for c in coord])
    b1 = torch.stack([cands1[c] for c in coord])
    a0 = _spread(a)
    added = coop_add(df, a0, _shfl(a0, nxt), b0, b1)
    assert torch.equal(added[3], added[0])   # rank 3 holds X
    return _gather(torch.where(live[None, :, None], added, a0))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(seed):
    """Masks of all ones, all zeros and a random half of the lanes."""
    half = np.random.default_rng(seed).random(L) < 0.5
    return [torch.ones(L, dtype=torch.int32),
            torch.zeros(L, dtype=torch.int32),
            torch.from_numpy(half.astype(np.int32))]


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


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_masked_group_double_equals_plain(curve):
    """B6 one lane a group of four: masks of all ones, all zeros and a
    random half, on points with identity lanes."""
    df, A, B = _points(curve, 5)
    for x in (A, B):
        for mask in _masks(6):
            assert torch.equal(b6_group(df, x, mask),
                               pk.pdouble_masked_plain(df, x, mask))


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_pair_double_equals_plain(curve):
    """The two-thread schedule (not a form of the kernels: measured beside
    them) equals rcb_double_plain, and its masked form
    pdouble_masked_plain."""
    assert P["kPair"] == 2
    assert _src("kPairOther", P, 2).tolist() == [1, 0]
    df, A, B = _points(curve, 7)
    for x in (A, B):
        assert torch.equal(pdouble_pair(df, x), pk.pdouble_plain(df, x))
        for mask in _masks(8):
            assert torch.equal(pdouble_pair(df, x, mask),
                               pk.pdouble_masked_plain(df, x, mask))


def test_pdouble_form_thresholds():
    """B5's and B6's lane counts from which one thread serves a lane are
    positive and at most kMaxGroupLanes, the most lanes the group form
    takes."""
    src = open(CU).read()
    max_threads = int(re.search(r"static const int kMaxThreads = (\d+);",
                                src).group(1))
    m = re.search(r"static const long long kMaxGroupLanes = "
                  r"\(1LL << 32\) / (\d+) - kMaxThreads;", src)
    assert int(m.group(1)) == C["kGroup"]
    max_group_lanes = (1 << 32) // C["kGroup"] - max_threads
    names = [k for k in C if k.startswith("kPdouble")]
    assert sorted(names) == ["kPdoubleLaneFrom", "kPdoubleMaskedLaneFrom"]
    for name in names:
        assert 0 < C[name] <= max_group_lanes, name


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_glv_group_ladder_equals_plain(curve, one_thread):
    """The GLV ladder's group form, with its table read per rank from the
    staged layout, equals glv_ladder_plain on 9 bit pairs that take sel =
    0, 1, 2 and 3 (twice 3 and 0 in a row), on tables with identity lanes
    (t1, t2 or both)."""
    df, A, B = _points(curve, 9)
    t12 = pk.padd_plain(df, A, B)
    bits1 = [1, 0, 1, 1, 0, 0, 1, 0, 1]
    bits2 = [0, 1, 1, 1, 0, 0, 0, 1, 1]
    assert {b1 + 2 * b2 for b1, b2 in zip(bits1, bits2)} == {0, 1, 2, 3}
    assert torch.equal(glv_group(df, A, B, t12, bits1, bits2),
                       pk.glv_ladder_plain(df, A, B, t12, bits1, bits2))


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_b2_group_equals_plain(curve, one_thread):
    """B2's group form equals pmixed_masked_plain (and so the one-thread
    kernel and the reference's) on accumulators with Z != 1 and identity
    lanes, affine bases with identity-coded ones, masks of all ones, all
    zeros and a random half, signs all unset, all set and a random half;
    at L = 40 lanes and 37 (neither a multiple of a block's 8, 16 or 32
    groups)."""
    df, A, _ = _points(curve, 11)
    pts = native_srs_g(curve, "coop-b2", L)
    pts[5] = pts[17] = pts[30] = None
    aff = pk.points_to_proj(df, pts, "cpu")[:32]
    half = torch.from_numpy(
        (np.random.default_rng(12).random(L) < 0.5).astype(np.int32))
    for n in (L, 37):
        for mask in _masks(13):
            for signs in (torch.zeros(L, dtype=torch.int32),
                          torch.ones(L, dtype=torch.int32), half):
                args = (A[:, :n], aff[:, :n], mask[:n], signs[:n])
                assert torch.equal(b2_group(df, *args),
                                   pk.pmixed_masked_plain(df, *args))


def _bucket_case(curve, seed):
    """Two window rows of 16 packed bases (two identity-coded) with runs of
    0, 1 and several members, a third of them negated: (df, bases,
    members, starts, counts, BL)."""
    df = DeviceField(curve.base)
    n, BL = 16, 5
    pts = native_srs_g(curve, f"coop-bucket-{seed}", n)
    pts[3] = pts[11] = None
    bases = pk.pack_affine(pk.points_to_proj(df, pts, "cpu")[:32])
    rng = np.random.default_rng(seed)
    order = torch.from_numpy(np.stack([rng.permutation(n)
                                       for _ in range(2)]))
    signs = torch.from_numpy((rng.random((2, n)) < 0.33).astype(np.int64))
    members = pk.bucket_members(order, signs)
    counts = torch.tensor([0, 1, 3, 5, 7, 4, 0, 2, 1, 9], dtype=torch.int32)
    starts = torch.cat([torch.cumsum(c, 0) - c
                        for c in counts.view(2, BL)]).to(torch.int32)
    return df, bases, members, starts, counts, BL


@pytest.mark.parametrize("curve", CURVES.values(), ids=CURVES.keys())
def test_bucket_group_runs_equal_plain(curve, one_thread):
    """The bucket-run kernel's group form, with its four-word base load
    and shuffles, equals pmixed_bucket_runs_plain (the B2 round loop) on
    runs of 0, 1 and up to 9 members with identity-coded bases and negated
    members, its groups serving the lanes in order and longest run first
    (the map the wrapper sorts on the card)."""
    df, bases, members, starts, counts, BL = _bucket_case(curve, 10)
    assert (members < 0).any()
    want = pk.pmixed_bucket_runs_plain(df, bases, members, starts, counts,
                                       BL)
    for lanes in (torch.arange(counts.shape[0]),
                  torch.argsort(counts, descending=True)):
        assert torch.equal(bucket_group(df, bases, members, starts, counts,
                                        BL, lanes), want)


def test_group_form_thresholds_and_table_banks():
    """The GLV ladder's, the bucket-run kernel's and B2's lane counts from
    which one thread serves a lane are positive and at most
    kMaxGroupLanes; the
    group ladder's table fits its stride, and one coordinate read by the
    ranks of a warp's eight groups falls in 24 distinct banks."""
    src = open(CU).read()
    max_threads = int(re.search(r"static const int kMaxThreads = (\d+);",
                                src).group(1))
    max_group_lanes = (1 << 32) // C["kGroup"] - max_threads
    for name in ("kGlvLaneFrom", "kBucketLaneFrom", "kPmixedLaneFrom"):
        assert 0 < C[name] <= max_group_lanes, name
    S = C["kGlvTabStride"]
    assert S >= 3 * 24
    for sel in (1, 2, 3):
        for i in range(8):
            banks = {(g * S + 24 * (sel - 1) + 8 * c + i) % 32
                     for g in range(32 // C["kGroup"]) for c in range(3)}
            assert len(banks) == 24, (sel, i)
