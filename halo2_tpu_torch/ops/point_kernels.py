"""Kernels B2-B6 on Pasta point batches -- the masked mixed add (B2), the
masked and unmasked complete adds (B3, B4), the doubling and the masked
doubling (B5, B6) -- the bucket-run kernel that runs B2's whole round loop
of an affine-base commit in one launch, the GLV ladder of the IPA fold
(B5 and B3 fused over 130 steps) and the per-lane scalar-multiplication
ladder of the SRS's group NTT, with their plain PyTorch versions.

Replaces halo2_tpu/ops/pallas_point.py, the ladder's fori_loop in
halo2_tpu/ops/ipa_device.py and the one of batch_scalar_mul in
halo2_tpu/curves/device.py. A point batch is one int32
[48, L] tensor, lanes last: rows 0-15 X, 16-31 Y, 32-47 Z (16-bit
Montgomery digits), homogeneous projective (x = X/Z, y = Y/Z), identity
(0 : R : 0). An affine batch is [32, L] with the identity coded as
(0, mont 1), which is not on either curve. The group law is RCB15's
complete formulas for a = 0, b3 = 15 (eprint 2015/1060, Alg 7, 8 and 9).

Each wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches csrc/point_kernels.cu or raises. `LAUNCHES` counts
kernel launches (tracing.launch, which also records each launch's
lanes, bytes and multiply-adds: each input read once and each output
written once, a point 192 bytes, an affine base 128 (64 packed), a flag
4; the formula's Montgomery products times MONT_MULADDS, 12 a complete
add (RCB Alg 7), 11 a mixed add (Alg 8), 8 a doubling (Alg 9). Where a
step depends on data on the card (a mask, a scalar's bits, a bucket's
run) every lane and step counts as taken: reading the data would sync,
and B2's and B3's bytes bound them all the same). B4 and the scalar
ladder run one lane on a group of four threads; B2, B5, B6, the GLV
ladder and the bucket-run kernel too below lane counts set in the .cu.
Their results are the same as one thread's, bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import tracing
from .field_kernels import (MONT_MULADDS, NLIMBS, fmul_plain, fadd_plain,
                            fsub, fsub_plain, _dispatch)

LAUNCHES = tracing.launch_counters(
    "padd_masked", "pmixed_masked", "pmixed_bucket_runs", "padd", "pdouble",
    "pdouble_masked", "glv_ladder", "scalar_mul_ladder")
# bytes of a projective point, an affine base and a lane's flag
_PT, _AFF, _FLAG = 3 * NLIMBS * 4, 2 * NLIMBS * 4, 4

# where B3 reads its second operand (SrcMode in csrc/point_kernels.cu)
_SRC_LANE, _SRC_ROLL, _SRC_INDEX = 0, 1, 2


# ---------------------------------------------------------------------------
# plain versions (the reference's jnp fallback, pallas_point.py:355-422)
# ---------------------------------------------------------------------------

def _split2d(a: torch.Tensor):
    """[48, L] -> three [L, 16] field tensors."""
    return (a[:NLIMBS].T, a[NLIMBS:2 * NLIMBS].T, a[2 * NLIMBS:].T)


def _join2d(X, Y, Z) -> torch.Tensor:
    return torch.cat([X.T, Y.T, Z.T], dim=0)


def _mul15_plain(df, a):
    x = fadd_plain(df, a, a)
    x = fadd_plain(df, x, x)
    x = fadd_plain(df, x, x)
    x = fadd_plain(df, x, x)
    return fsub_plain(df, x, a)


def _each(op, df, *pairs):
    """op over independent operand pairs in one plain call: the pairs
    are stacked on a new leading axis (a plain call costs about the same
    at 1 or 12 rows of a small batch, so a formula's independent products
    and sums share one)."""
    a = torch.stack(torch.broadcast_tensors(*(x for x, _ in pairs)))
    b = torch.stack(torch.broadcast_tensors(*(y for _, y in pairs)))
    return op(df, *torch.broadcast_tensors(a, b)).unbind(0)


def rcb_add_plain(df, A, B):
    """RCB Alg 7 on ([L, 16],) * 3 coordinate triples."""
    X1, Y1, Z1 = A
    X2, Y2, Z2 = B
    s1, s2, s3, s4, s5, s6 = _each(fadd_plain, df, (X1, Y1), (X2, Y2),
                                   (Y1, Z1), (Y2, Z2), (X1, Z1), (X2, Z2))
    t0, t1, t2, m3, m4, m5 = _each(fmul_plain, df, (X1, X2), (Y1, Y2),
                                   (Z1, Z2), (s1, s2), (s3, s4), (s5, s6))
    a01, a12, a02, s0 = _each(fadd_plain, df, (t0, t1), (t1, t2), (t0, t2),
                              (t0, t0))
    t3, t4, xz = _each(fsub_plain, df, (m3, a01), (m4, a12), (m5, a02))
    s0 = fadd_plain(df, s0, t0)
    b3z, y3 = _mul15_plain(df, torch.stack([t2, xz])).unbind(0)
    z3 = fadd_plain(df, t1, b3z)
    s1 = fsub_plain(df, t1, b3z)
    u1, v1, u2, v2, u3, v3 = _each(fmul_plain, df, (t3, s1), (t4, y3),
                                   (y3, s0), (s1, z3), (z3, t4), (s0, t3))
    X3 = fsub_plain(df, u1, v1)
    Y3, Z3 = _each(fadd_plain, df, (u2, v2), (u3, v3))
    return X3, Y3, Z3


def rcb_double_plain(df, A):
    """RCB Alg 9 on a ([L, 16],) * 3 coordinate triple (the reference's
    _rcb_double_arrays, pallas_point.py:400)."""
    X, Y, Z = A
    t0, t1, zz, xy = _each(fmul_plain, df, (Y, Y), (Y, Z), (Z, Z), (X, Y))
    z3 = fadd_plain(df, t0, t0)
    z3 = fadd_plain(df, z3, z3)
    z3 = fadd_plain(df, z3, z3)                  # 8 Y^2
    t2 = _mul15_plain(df, zz)                    # b3 Z^2
    X3, Z3 = _each(fmul_plain, df, (t2, z3), (t1, z3))
    Y3 = fadd_plain(df, t0, t2)
    t1 = fadd_plain(df, t2, t2)
    t0 = fsub_plain(df, t0, fadd_plain(df, t1, t2))
    u, v = _each(fmul_plain, df, (t0, Y3), (t0, xy))
    Y3, X3 = _each(fadd_plain, df, (u, X3), (v, v))
    return X3, Y3, Z3


def padd_plain(df, a, b):
    return _join2d(*rcb_add_plain(df, _split2d(a), _split2d(b)))


def gather_operand(df, b, idx=None, sign=None, width=None, shift=0):
    """B3's second operand as a [48, L] batch: b itself; with `width`,
    every row of `width` lanes of b rolled by `shift` (torch.roll); with
    `idx` [L], the lanes b[:, idx], their Y negated where sign is set."""
    if width is not None:
        rows = b.view(b.shape[0], -1, width)
        return torch.roll(rows, shift, dims=2).reshape(b.shape)
    if idx is None:
        return b
    g = b.index_select(1, idx.long())
    if sign is None:
        return g
    Y = g[NLIMBS:2 * NLIMBS].T
    negY = fsub_plain(df, torch.zeros_like(Y), Y)
    Y = torch.where(sign.bool()[:, None], negY, Y)
    return torch.cat([g[:NLIMBS], Y.T, g[2 * NLIMBS:]], dim=0)


def padd_masked_plain(df, a, b, mask, idx=None, sign=None, width=None,
                      shift=0):
    b = gather_operand(df, b, idx, sign, width, shift)
    return torch.where(mask.bool()[None, :], padd_plain(df, a, b), a)


def pdouble_plain(df, a):
    return _join2d(*rcb_double_plain(df, _split2d(a)))


def pdouble_masked_plain(df, a, mask):
    return torch.where(mask.bool()[None, :], pdouble_plain(df, a), a)


def glv_ladder_plain(df, t1, t2, t12, bits1, bits2):
    """The ladder step by step: acc = O, then per bit pair (MSB first)
    acc = 2 acc and, where sel = b1 + 2 b2 != 0, acc = acc + table[sel]."""
    L = t1.shape[1]
    acc = ident_col(df, t1.device)[:, None].expand(3 * NLIMBS, L).clone()
    table = (None, t1, t2, t12)
    on = torch.ones(L, dtype=torch.int32, device=t1.device)
    for b1, b2 in zip(bits1, bits2):
        sel = int(b1) + 2 * int(b2)
        acc = pdouble_plain(df, acc)
        if sel:
            acc = padd_masked_plain(df, acc, table[sel], on)
    return acc


def scalar_bits(digits: torch.Tensor, nbits: int) -> torch.Tensor:
    """[T, 16] canonical 16-bit digits -> [nbits, T] bool, bit nbits - 1
    first."""
    i = torch.arange(nbits - 1, -1, -1, device=digits.device)
    d = digits.to(torch.int64)[:, i // 16]
    return ((d >> (i % 16)) & 1).bool().T


def scalar_mul_ladder_plain(df, pts, digits, nbits=256, lo=None):
    """The ladder step by step (the reference's batch_scalar_mul): acc = O,
    then per bit, most significant first, acc = 2 acc (RCB Alg 9) and,
    where lane l's bit (of digits row l % T) is set, acc = acc + P (RCB
    Alg 7). With lo: (lo + acc, lo - acc), the negation by pneg_flat (the
    add/subtract kernel for a CUDA tensor)."""
    L = pts.shape[1]
    rows = torch.arange(L, device=pts.device) % digits.shape[0]
    bits = scalar_bits(digits[rows], nbits)
    P = _split2d(pts)
    acc = _split2d(ident_col(df, pts.device)[:, None].expand(3 * NLIMBS, L))
    for bit in bits:
        acc = rcb_double_plain(df, acc)
        if bool(bit.any()):
            added = rcb_add_plain(df, acc, P)
            acc = tuple(torch.where(bit[:, None], x, y)
                        for x, y in zip(added, acc))
    t = _join2d(*acc)
    if lo is None:
        return t
    return padd_plain(df, lo, t), padd_plain(df, lo, pneg_flat(df, t))


def pmixed_masked_plain(df, a, b_aff, mask, signs):
    """The full complete add at Z2 = mont(1) computes the identical
    values the mixed formulas do; identity-coded bases get Z2 = 0 and are
    masked off."""
    r1 = mont_one(df, a.device)
    X2 = b_aff[:NLIMBS].T
    Y2 = b_aff[NLIMBS:].T
    ident_b = (X2 == 0).all(dim=-1) & (Y2 == r1[None, :]).all(dim=-1)
    negY = fsub_plain(df, torch.zeros_like(Y2), Y2)
    Y2 = torch.where(signs.bool()[:, None], negY, Y2)
    Z2 = torch.where(ident_b[:, None], torch.zeros_like(X2),
                     r1[None, :].expand(X2.shape))
    added = _join2d(*rcb_add_plain(df, _split2d(a), (X2, Y2, Z2)))
    m = mask.bool() & ~ident_b
    return torch.where(m[None, :], added, a)


def pack_affine(aff: torch.Tensor) -> torch.Tensor:
    """[32, n] affine batch (16-bit digit rows, lanes last) -> [n, 16]
    point-major words: x's 32-bit limbs 0-7, then y's, as int32 bits (64 B
    a point, what the bucket-run kernel reads)."""
    d = aff.reshape(2, NLIMBS // 2, 2, -1).to(torch.int64)
    w = d[:, :, 0] | (d[:, :, 1] << 16)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.reshape(NLIMBS, -1).T.to(torch.int32).contiguous()


def unpack_affine(packed: torch.Tensor) -> torch.Tensor:
    """pack_affine's inverse: [n, 16] words -> [32, n] digit rows."""
    w = packed.T.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape(
        2 * NLIMBS, -1).to(torch.int32)


def bucket_members(order: torch.Tensor, signs=None) -> torch.Tensor:
    """[G, n] sorted base indices -> int32 [G, n] members of the bucket
    runs: the index, with bit 31 set where the base is negated (`signs`
    [G, n] per base index, 0/1)."""
    mem = order.to(torch.int32)
    if signs is None:
        return mem.contiguous()
    neg = torch.gather(signs, 1, order).bool()
    return torch.where(neg, mem | -(1 << 31), mem).contiguous()


def pmixed_bucket_runs_plain(df, bases, members, starts, counts, BL):
    """The bucket runs as the B2 round loop: round r adds the r-th member
    of every lane's run with pmixed_masked_plain, lanes past their run
    masked off."""
    aff = unpack_affine(bases)
    n = members.shape[1]
    L = starts.shape[0]
    acc = ident_col(df, bases.device)[:, None].expand(3 * NLIMBS, L).clone()
    if L == 0:
        return acc
    row_off = torch.arange(L, device=bases.device) // BL * n
    flat = members.reshape(-1).to(torch.int64)
    starts, counts = starts.to(torch.int64), counts.to(torch.int64)
    for r in range(int(counts.max())):
        valid = r < counts
        m = flat[row_off + torch.where(valid, starts + r, 0)]
        acc = pmixed_masked_plain(df, acc, aff[:, m & 0x7FFFFFFF],
                                  valid.to(torch.int32),
                                  (m < 0).to(torch.int32))
    return acc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_batch(x: torch.Tensor, rows: int, L: int, what: str):
    if x.dtype != torch.int32 or tuple(x.shape) != (rows, L):
        raise TypeError(f"{what}: expected int32 [{rows}, {L}], got "
                        f"{x.dtype} {tuple(x.shape)}")


def _flags(x: torch.Tensor, L: int, what: str) -> torch.Tensor:
    if tuple(x.shape) != (L,):
        raise TypeError(f"{what}: expected [{L}], got {tuple(x.shape)}")
    return x.to(torch.int32).contiguous()


def _arg(x):
    return x.data_ptr() if isinstance(x, torch.Tensor) else x


def _launch(name: str, df, a: torch.Tensor, *operands, lane_bytes: int,
            lane_products: int, live: int | None = None,
            dead_bytes: int = 0) -> torch.Tensor:
    """Launch the point kernel h2t_<name> over the L lanes of the [48, L]
    batch `a` into a fresh [48, L] output (never aliasing an input);
    operands are contiguous tensors on a's device, None (a null pointer)
    or plain C arguments. The launch is recorded with lane_bytes and
    lane_products Montgomery products for each of its `live` lanes (None:
    all L) and dead_bytes for each other lane."""
    from . import cuda_build
    out = torch.empty_like(a)
    L = a.shape[1]
    if L == 0:
        return out
    lib = cuda_build.library("point_kernels")
    rc = getattr(lib, "h2t_" + name)(
        df.field_id, out.data_ptr(), a.data_ptr(),
        *(_arg(x) for x in operands), L, cuda_build.stream_ptr(a.device))
    cuda_build.check(rc, name)
    live = L if live is None else live
    tracing.launch(name, L, live * lane_bytes + (L - live) * dead_bytes,
                   live * lane_products * MONT_MULADDS)
    return out


def padd_masked_flat(df, a: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor, idx=None, sign=None, width=None,
                     shift: int = 0, live: int | None = None
                     ) -> torch.Tensor:
    """out[l] = mask[l] ? a[l] + b[j(l)] : a[l] on [48, L] batches (kernel
    B3 on CUDA, which reads b[j(l)] itself), where b[j(l)] is:
      - b[l] by default (b is [48, L]);
      - with `width` (dividing L): lane l of b rolled by `shift` within its
        row of `width` lanes, as torch.roll of b.view(48, -1, width) along
        the last axis (b is [48, L]);
      - with `idx` [L] (values in [0, Lb)): lane idx[l] of b [48, Lb], its
        Y negated where `sign` [L] is set.
    Work a live lane (its mask set): a, b[j(l)] and out (192 bytes each)
    and the mask (4), 580 bytes, with idx and sign 8 more; 12 products. A
    masked-off lane reads its mask and a and writes out: 388 bytes, no
    product. `live` is the number of set mask lanes, given by a caller that
    knows it without reading the mask back from the card; None counts
    every lane live."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    if idx is None:
        _check_batch(b, 3 * NLIMBS, L, "b")
        if sign is not None:
            raise TypeError("sign needs idx")
    else:
        _check_batch(b, 3 * NLIMBS, b.shape[1], "b")
        if width is not None:
            raise TypeError("give width or idx, not both")
        idx = _flags(idx, L, "idx")
        if sign is not None:
            sign = _flags(sign, L, "sign")
    if width is not None and (width <= 0 or L % width):
        raise TypeError(f"width {width} does not divide {L} lanes")
    if live is not None and not 0 <= live <= L:
        raise TypeError(f"live {live} is not within 0..{L} lanes")
    if not _dispatch(a):
        return padd_masked_plain(df, a, b, mask, idx, sign, width, shift)
    mode = (_SRC_ROLL if width is not None
            else _SRC_INDEX if idx is not None else _SRC_LANE)
    return _launch("padd_masked", df, a.contiguous(), b.contiguous(),
                   _flags(mask, L, "mask"), idx, sign, mode, width or 0,
                   shift % width if width else 0, b.shape[1],
                   lane_bytes=3 * _PT + _FLAG
                   + (0 if idx is None else _FLAG)
                   + (0 if sign is None else _FLAG),
                   lane_products=12, live=live, dead_bytes=2 * _PT + _FLAG)


def _pack_bits(bits):
    """0/1 steps, most significant first -> the kernel's 5 words (bit i
    at bit i % 32 of word i // 32)."""
    words = [0] * 5
    for i, bit in enumerate(bits):
        words[i >> 5] |= (int(bit) & 1) << (i & 31)
    return (ctypes.c_uint32 * 5)(*words)


def _check_glv(t1, t2, t12, bits1, bits2) -> None:
    L = t1.shape[1]
    for x, what in ((t1, "t1"), (t2, "t2"), (t12, "t12")):
        _check_batch(x, 3 * NLIMBS, L, what)
    if len(bits1) != len(bits2) or len(bits1) > 160:
        raise TypeError(f"bits: {len(bits1)} and {len(bits2)} steps; "
                        f"want equal counts of at most 160")


def glv_ladder_flat(df, t1: torch.Tensor, t2: torch.Tensor, t12: torch.Tensor,
                    bits1, bits2) -> torch.Tensor:
    """The GLV double-and-add ladder on [48, L] tables (one launch of the
    fused kernel on CUDA, in the form that csrc/point_kernels.cu picks by
    lane count): acc = O, then for each bit pair, most significant first,
    acc = 2 acc (RCB Alg 9) and, where sel = b1 + 2 b2 != 0,
    acc = acc + {t1, t2, t12}[sel] (RCB Alg 7). bits1, bits2: equal-length
    sequences of 0/1, at most 160. Work a lane: the three tables and out,
    768 bytes; 8 products a step and 12 more a step with sel != 0."""
    _check_glv(t1, t2, t12, bits1, bits2)
    if not _dispatch(t1):
        return glv_ladder_plain(df, t1, t2, t12, bits1, bits2)
    adds = sum(1 for b1, b2 in zip(bits1, bits2) if b1 or b2)
    return _launch("glv_ladder", df, t1.contiguous(), t2.contiguous(),
                   t12.contiguous(), _pack_bits(bits1), _pack_bits(bits2),
                   len(bits1), lane_bytes=4 * _PT,
                   lane_products=8 * len(bits1) + 12 * adds)


def scalar_mul_ladder_flat(df, pts: torch.Tensor, digits: torch.Tensor,
                           nbits: int = 256, lo=None):
    """[s_l] pts[l] on a [48, L] batch (one launch of the scalar ladder on
    CUDA), where s_l is row l % T of `digits`, int32 [T, 16] canonical
    16-bit digits, and only its low nbits (1-256) bits count: acc = O, then
    per bit, most significant first, acc = 2 acc (RCB Alg 9) and, where the
    bit is set, acc = acc + pts[l] (RCB Alg 7). With lo [48, L], returns
    the butterfly (lo + acc, lo - acc) from the same launch.
    Work: a lane's point and result (with lo, lo read and a second result
    written), 384 or 768 bytes, and the digits once (64 bytes a row); a
    lane 8 products a bit and 12 an add, every bit counted as set (the
    digits are on the card), and 24 for the butterfly."""
    L = pts.shape[1]
    _check_batch(pts, 3 * NLIMBS, L, "pts")
    if digits.dtype != torch.int32 or digits.dim() != 2 or \
            digits.shape[1] != NLIMBS or digits.shape[0] == 0:
        raise TypeError(f"digits: expected int32 [T, {NLIMBS}] with T >= 1, "
                        f"got {digits.dtype} {tuple(digits.shape)}")
    if not 1 <= nbits <= 256:
        raise ValueError(f"nbits {nbits} is not in 1..256")
    if lo is not None:
        _check_batch(lo, 3 * NLIMBS, L, "lo")
    if not _dispatch(pts):
        return scalar_mul_ladder_plain(df, pts, digits, nbits, lo)
    from . import cuda_build
    pts, digits = pts.contiguous(), digits.contiguous()
    lo = None if lo is None else lo.contiguous()
    out = torch.empty_like(pts)
    out2 = None if lo is None else torch.empty_like(pts)
    if L:
        rc = cuda_build.library("point_kernels").h2t_scalar_mul_ladder(
            df.field_id, out.data_ptr(), _arg(out2), pts.data_ptr(),
            digits.data_ptr(), _arg(lo), digits.shape[0], nbits, L,
            cuda_build.stream_ptr(pts.device))
        cuda_build.check(rc, "scalar_mul_ladder")
        tracing.launch(
            "scalar_mul_ladder", L,
            L * (2 if lo is None else 4) * _PT + digits.shape[0] * 64,
            L * (20 * nbits + (0 if lo is None else 24)) * MONT_MULADDS)
    return out if lo is None else (out, out2)


def scalar_mul_ladder_loop(df, pts: torch.Tensor, digits: torch.Tensor,
                           nbits: int, ident=None) -> torch.Tensor:
    """The loop the scalar ladder replaces, the reference's fori_loop step
    by step: B5, B4, then a select on each lane's bit (digits [L, 16], one
    row a lane), from `ident`, the identity batch on pts's lanes (made
    here if None; a caller that captures the loop in a CUDA graph makes
    it first, since the capture takes no host-to-device copy). On no
    path: it holds the fused kernel to the kernels it fuses."""
    acc = ident
    if acc is None:
        acc = ident_col(df, pts.device)[:, None].expand(
            3 * NLIMBS, pts.shape[1]).contiguous()
    for bit in scalar_bits(digits, nbits):
        acc = pdouble_flat(df, acc)
        acc = torch.where(bit[None, :], padd_flat(df, acc, pts), acc)
    return acc


def pneg_flat(df, a: torch.Tensor) -> torch.Tensor:
    """-a on a [48, L] batch: Y negated as 0 - Y (0 stays 0), through the
    add/subtract kernel for a CUDA tensor."""
    Y = a[NLIMBS:2 * NLIMBS].T
    negY = fsub(df, torch.zeros_like(Y), Y)
    return torch.cat([a[:NLIMBS], negY.T, a[2 * NLIMBS:]], dim=0)


def pmixed_masked_flat(df, a: torch.Tensor, b_aff: torch.Tensor,
                       mask: torch.Tensor, signs=None) -> torch.Tensor:
    """out = mask ? a +/- b_aff : a with a [48, L] projective and b_aff
    [32, L] affine (kernel B2 on CUDA, in the form that
    csrc/point_kernels.cu picks by lane count). Identity-coded (0, mont 1)
    bases pass the accumulator through; signs [L] selects the negated
    base. Work a lane: a and out (192 bytes each), the base (128), mask
    and sign (4 each), 520 bytes; 11 products."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    _check_batch(b_aff, 2 * NLIMBS, L, "b_aff")
    if signs is None:
        signs = torch.zeros((L,), dtype=torch.int32, device=a.device)
    if not _dispatch(a):
        return pmixed_masked_plain(df, a, b_aff, mask, signs)
    return _launch("pmixed_masked", df, a.contiguous(), b_aff.contiguous(),
                   _flags(mask, L, "mask"), _flags(signs, L, "signs"),
                   lane_bytes=2 * _PT + _AFF + 2 * _FLAG, lane_products=11)


def _check_bucket_runs(bases, members, starts, BL) -> None:
    n = bases.shape[0]
    L = starts.shape[0]
    _check_batch(bases, n, NLIMBS, "bases")
    if members.dtype != torch.int32 or members.dim() != 2 or \
            members.shape[1] != n or members.shape[0] * BL != L:
        raise TypeError(f"members: expected int32 [{L // max(BL, 1)}, {n}],"
                        f" got {members.dtype} {tuple(members.shape)}")


def _launch_bucket_runs(df, bases, members, starts, counts, BL,
                        threads=None) -> torch.Tensor:
    """One launch of the bucket-run kernel: in the form that
    csrc/point_kernels.cu picks by lane count (threads None) or in that of
    `threads` threads a lane. The kernel serves the lanes longest run
    first (a map sorted on the card), so that a warp's runs are alike;
    each lane's sum is the same whichever thread makes it."""
    from . import cuda_build
    n = bases.shape[0]
    L = starts.shape[0]
    out = torch.empty((3 * NLIMBS, L), dtype=torch.int32,
                      device=bases.device)
    if L == 0:
        return out
    # every operand held in a name until the launch: a temporary freed
    # earlier could hand its memory to the next conversion
    bases, members = bases.contiguous(), members.contiguous()
    starts, counts = _flags(starts, L, "starts"), _flags(counts, L, "counts")
    lanes = torch.argsort(counts, descending=True).to(torch.int32)
    lib = cuda_build.library("point_kernels")
    args = (df.field_id, out.data_ptr(), bases.data_ptr(), members.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), lanes.data_ptr(), BL, n, L,
            cuda_build.stream_ptr(bases.device))
    if threads is None:
        rc = lib.h2t_pmixed_bucket_runs(*args)
    else:
        rc = lib.h2t_pmixed_bucket_runs_form(threads, *args)
    cuda_build.check(rc, "pmixed_bucket_runs")
    return out


def pmixed_bucket_runs(df, bases: torch.Tensor, members: torch.Tensor,
                       starts: torch.Tensor, counts: torch.Tensor, BL: int
                       ) -> torch.Tensor:
    """[48, L] bucket sums of an affine-base commit (one launch of the
    bucket-run kernel on CUDA, in the form that csrc/point_kernels.cu picks
    by lane count): lane l, bucket l % BL of window row l // BL, adds
    +/- bases[m & 0x7fffffff] for the members m of its run
    members[l // BL, starts[l]:starts[l] + counts[l]], negated where bit
    31 of m is set, from the identity and in order, with RCB Alg 8;
    identity-coded bases are skipped. bases: [n, 16] from pack_affine;
    members: int32 [G, n] from bucket_members; starts, counts: [G * BL].
    Work: every member (G n) as a packed base read (64 bytes), its entry
    (4) and a mixed add (11 products); a lane its start and count (8) and
    its sum (192)."""
    _check_bucket_runs(bases, members, starts, BL)
    if not _dispatch(bases):
        return pmixed_bucket_runs_plain(df, bases, members, starts, counts,
                                        BL)
    out = _launch_bucket_runs(df, bases, members, starts, counts, BL)
    L = out.shape[1]
    if L:
        m = members.numel()
        tracing.launch("pmixed_bucket_runs", L,
                       m * (64 + 4) + L * (8 + _PT),
                       m * 11 * MONT_MULADDS)
    return out


def padd_flat(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete add a + b on [48, L] batches (kernel B4 on CUDA, one lane
    a group of four threads). Work a lane: a, b and out, 576 bytes; 12
    products."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    _check_batch(b, 3 * NLIMBS, L, "b")
    if not _dispatch(a):
        return padd_plain(df, a, b)
    return _launch("padd", df, a.contiguous(), b.contiguous(),
                   lane_bytes=3 * _PT, lane_products=12)


def pdouble_flat(df, a: torch.Tensor) -> torch.Tensor:
    """2a on a [48, L] batch, RCB Alg 9 (kernel B5 on CUDA, in the form
    that csrc/point_kernels.cu picks by lane count). Work a lane: a and
    out, 384 bytes; 8 products."""
    _check_batch(a, 3 * NLIMBS, a.shape[1], "a")
    if not _dispatch(a):
        return pdouble_plain(df, a)
    return _launch("pdouble", df, a.contiguous(), lane_bytes=2 * _PT,
                   lane_products=8)


def pdouble_masked_flat(df, a: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """out = mask ? 2a : a on a [48, L] batch (kernel B6 on CUDA, in the
    form that csrc/point_kernels.cu picks by lane count). Work a lane: a,
    out and the mask, 388 bytes; 8 products."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    if not _dispatch(a):
        return pdouble_masked_plain(df, a, mask)
    return _launch("pdouble_masked", df, a.contiguous(),
                   _flags(mask, L, "mask"), lane_bytes=2 * _PT + _FLAG,
                   lane_products=8)


# the forms of B2, B5, B6, the GLV ladder and the bucket-run kernel by
# threads a lane (h2t_*_form)
FORMS = {"lane": 1, "group": 4}


def _on_card(what: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; its operand is on "
                         f"{x.device}")


def pdouble_form(df, a: torch.Tensor, threads: int, mask=None
                 ) -> torch.Tensor:
    """B5 (B6 given a mask) on a [48, L] batch on the card in the form of
    `threads` threads a lane (a value of FORMS), where pdouble_flat and
    pdouble_masked_flat take the form by lane count. On no path and
    counted nowhere: it holds each form to the plain versions at any
    width."""
    from . import cuda_build
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    mask = None if mask is None else _flags(mask, L, "mask")
    _on_card("pdouble_form", a)
    a = a.contiguous()
    out = torch.empty_like(a)
    if L:
        rc = cuda_build.library("point_kernels").h2t_pdouble_form(
            threads, df.field_id, out.data_ptr(), a.data_ptr(),
            _arg(mask), L, cuda_build.stream_ptr(a.device))
        cuda_build.check(rc, f"pdouble_form({threads})")
    return out


def pmixed_masked_form(df, a: torch.Tensor, b_aff: torch.Tensor,
                       mask: torch.Tensor, signs: torch.Tensor, threads: int
                       ) -> torch.Tensor:
    """B2 on the card in the form of `threads` threads a lane (a value of
    FORMS), where pmixed_masked_flat takes the form by lane count. On no
    path and counted nowhere: it holds each form to the plain version at
    any width."""
    from . import cuda_build
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    _check_batch(b_aff, 2 * NLIMBS, L, "b_aff")
    mask, signs = _flags(mask, L, "mask"), _flags(signs, L, "signs")
    _on_card("pmixed_masked_form", a)
    a, b_aff = a.contiguous(), b_aff.contiguous()
    out = torch.empty_like(a)
    if L:
        rc = cuda_build.library("point_kernels").h2t_pmixed_masked_form(
            threads, df.field_id, out.data_ptr(), a.data_ptr(),
            b_aff.data_ptr(), mask.data_ptr(), signs.data_ptr(), L,
            cuda_build.stream_ptr(a.device))
        cuda_build.check(rc, f"pmixed_masked_form({threads})")
    return out


def glv_ladder_form(df, t1: torch.Tensor, t2: torch.Tensor,
                    t12: torch.Tensor, bits1, bits2, threads: int
                    ) -> torch.Tensor:
    """glv_ladder_flat on the card in the form of `threads` threads a lane
    (a value of FORMS), where glv_ladder_flat takes the form by lane count.
    On no path and counted nowhere: it holds each form to the plain
    version at any width."""
    from . import cuda_build
    _check_glv(t1, t2, t12, bits1, bits2)
    _on_card("glv_ladder_form", t1)
    t1, t2, t12 = t1.contiguous(), t2.contiguous(), t12.contiguous()
    out = torch.empty_like(t1)
    if t1.shape[1]:
        rc = cuda_build.library("point_kernels").h2t_glv_ladder_form(
            threads, df.field_id, out.data_ptr(), t1.data_ptr(),
            t2.data_ptr(), t12.data_ptr(), _pack_bits(bits1),
            _pack_bits(bits2), len(bits1), t1.shape[1],
            cuda_build.stream_ptr(t1.device))
        cuda_build.check(rc, f"glv_ladder_form({threads})")
    return out


def pmixed_bucket_runs_form(df, bases: torch.Tensor, members: torch.Tensor,
                            starts: torch.Tensor, counts: torch.Tensor,
                            BL: int, threads: int) -> torch.Tensor:
    """pmixed_bucket_runs on the card in the form of `threads` threads a
    lane (a value of FORMS), where pmixed_bucket_runs takes the form by
    lane count. On no path and counted nowhere: it holds each form to the
    plain version at any width."""
    _check_bucket_runs(bases, members, starts, BL)
    _on_card("pmixed_bucket_runs_form", bases)
    return _launch_bucket_runs(df, bases, members, starts, counts, BL,
                               threads)


# ---------------------------------------------------------------------------
# identity coding and host <-> device conversion
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ident_col_np(modulus: int) -> np.ndarray:
    """[48] column for the identity (0 : R : 0)."""
    col = np.zeros(3 * NLIMBS, dtype=np.int32)
    r = (1 << 256) % modulus
    col[NLIMBS:2 * NLIMBS] = [(r >> (16 * i)) & 0xFFFF for i in range(16)]
    return col


def ident_col(df, device) -> torch.Tensor:
    return tracing.upload("ident", torch.from_numpy(
        _ident_col_np(df.spec.modulus)), device)


def mont_one(df, device) -> torch.Tensor:
    return ident_col(df, device)[NLIMBS:2 * NLIMBS]


def points_to_proj(df, pts, device) -> torch.Tensor:
    """List of affine host points (None = identity) -> [48, n] with
    Z = mont 1 for finite points, so rows 0-31 are the coded-affine
    batch."""
    p = df.spec.modulus
    R = 1 << 256
    one = R % p
    xs, ys, zs = [], [], []
    for pt in pts:
        if pt is None:
            xs.append(0), ys.append(one), zs.append(0)
        else:
            xs.append(pt[0] * R % p), ys.append(pt[1] * R % p)
            zs.append(one)
    from ..fields.device import ints_to_digits
    cols = [ints_to_digits(v).T for v in (xs, ys, zs)]
    return tracing.upload("points", torch.from_numpy(np.ascontiguousarray(
        np.concatenate(cols, axis=0))), device)


def points_from_proj(df, arr) -> list:
    """[48, n] projective batch (tensor or array) -> affine host points."""
    from ..fields.device import digits_to_ints
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else arr
    p = df.spec.modulus
    rinv = pow(1 << 256, -1, p)
    X = digits_to_ints(a[:NLIMBS].T)
    Y = digits_to_ints(a[NLIMBS:2 * NLIMBS].T)
    Z = digits_to_ints(a[2 * NLIMBS:].T)
    out = []
    for x, y, z in zip(X, Y, Z):
        z = z * rinv % p
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p) * rinv % p
            out.append((x * zi % p, y * zi % p))
    return out
