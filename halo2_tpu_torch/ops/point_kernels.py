"""Kernels B2-B6 on Pasta point batches -- the masked mixed add (B2), the
masked and unmasked complete adds (B3, B4), the doubling and the masked
doubling (B5, B6) -- with their plain PyTorch versions.

Replaces halo2_tpu/ops/pallas_point.py. A point batch is one int32
[48, L] tensor, lanes last: rows 0-15 X, 16-31 Y, 32-47 Z (16-bit
Montgomery digits), homogeneous projective (x = X/Z, y = Y/Z), identity
(0 : R : 0). An affine batch is [32, L] with the identity coded as
(0, mont 1), which is not on either curve. The group law is RCB15's
complete formulas for a = 0, b3 = 15 (eprint 2015/1060, Alg 7, 8 and 9).

Each wrapper takes the plain version only for CPU tensors; for a CUDA
tensor it launches csrc/point_kernels.cu or raises. `LAUNCHES` counts
kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .field_kernels import (NLIMBS, fmul_plain, fadd_plain, fsub_plain,
                            _dispatch)

LAUNCHES = {"padd_masked": 0, "pmixed_masked": 0, "padd": 0, "pdouble": 0,
            "pdouble_masked": 0}


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


def rcb_add_plain(df, A, B):
    """RCB Alg 7 on ([L, 16],) * 3 coordinate triples."""
    X1, Y1, Z1 = A
    X2, Y2, Z2 = B
    mul = lambda a, b: fmul_plain(df, a, b)
    add = lambda a, b: fadd_plain(df, a, b)
    sub = lambda a, b: fsub_plain(df, a, b)
    t0 = mul(X1, X2)
    t1 = mul(Y1, Y2)
    t2 = mul(Z1, Z2)
    t3 = sub(mul(add(X1, Y1), add(X2, Y2)), add(t0, t1))
    t4 = sub(mul(add(Y1, Z1), add(Y2, Z2)), add(t1, t2))
    xz = sub(mul(add(X1, Z1), add(X2, Z2)), add(t0, t2))
    s0 = add(add(t0, t0), t0)
    b3z = _mul15_plain(df, t2)
    z3 = add(t1, b3z)
    s1 = sub(t1, b3z)
    y3 = _mul15_plain(df, xz)
    X3 = sub(mul(t3, s1), mul(t4, y3))
    Y3 = add(mul(y3, s0), mul(s1, z3))
    Z3 = add(mul(z3, t4), mul(s0, t3))
    return X3, Y3, Z3


def rcb_double_plain(df, A):
    """RCB Alg 9 on a ([L, 16],) * 3 coordinate triple (the reference's
    _rcb_double_arrays, pallas_point.py:400)."""
    X, Y, Z = A
    mul = lambda a, b: fmul_plain(df, a, b)
    add = lambda a, b: fadd_plain(df, a, b)
    sub = lambda a, b: fsub_plain(df, a, b)
    t0 = mul(Y, Y)
    z3 = add(t0, t0)
    z3 = add(z3, z3)
    z3 = add(z3, z3)
    t1 = mul(Y, Z)
    t2 = _mul15_plain(df, mul(Z, Z))
    X3 = mul(t2, z3)
    Y3 = add(t0, t2)
    Z3 = mul(t1, z3)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    t0 = sub(t0, t2)
    Y3 = add(mul(t0, Y3), X3)
    t1 = mul(X, Y)
    X3 = mul(t0, t1)
    X3 = add(X3, X3)
    return X3, Y3, Z3


def padd_plain(df, a, b):
    return _join2d(*rcb_add_plain(df, _split2d(a), _split2d(b)))


def padd_masked_plain(df, a, b, mask):
    return torch.where(mask.bool()[None, :], padd_plain(df, a, b), a)


def pdouble_plain(df, a):
    return _join2d(*rcb_double_plain(df, _split2d(a)))


def pdouble_masked_plain(df, a, mask):
    return torch.where(mask.bool()[None, :], pdouble_plain(df, a), a)


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


def _launch(name: str, df, a: torch.Tensor, *operands) -> torch.Tensor:
    """Launch the point kernel h2t_<name> over the L lanes of the [48, L]
    batch `a`; operands are contiguous tensors on a's device."""
    from . import cuda_build
    out = torch.empty_like(a)
    L = a.shape[1]
    if L == 0:
        return out
    lib = cuda_build.library("point_kernels")
    rc = getattr(lib, "h2t_" + name)(
        df.field_id, out.data_ptr(), a.data_ptr(),
        *(x.data_ptr() for x in operands), L,
        cuda_build.stream_ptr(a.device))
    cuda_build.check(rc, name)
    LAUNCHES[name] += 1
    return out


def padd_masked_flat(df, a: torch.Tensor, b: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """out = mask ? a + b : a on [48, L] batches (kernel B3 on CUDA)."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    _check_batch(b, 3 * NLIMBS, L, "b")
    if not _dispatch(a):
        return padd_masked_plain(df, a, b, mask)
    return _launch("padd_masked", df, a.contiguous(), b.contiguous(),
                   _flags(mask, L, "mask"))


def pmixed_masked_flat(df, a: torch.Tensor, b_aff: torch.Tensor,
                       mask: torch.Tensor, signs=None) -> torch.Tensor:
    """out = mask ? a +/- b_aff : a with a [48, L] projective and b_aff
    [32, L] affine (kernel B2 on CUDA). Identity-coded (0, mont 1) bases
    pass the accumulator through; signs [L] selects the negated base."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    _check_batch(b_aff, 2 * NLIMBS, L, "b_aff")
    if signs is None:
        signs = torch.zeros((L,), dtype=torch.int32, device=a.device)
    if not _dispatch(a):
        return pmixed_masked_plain(df, a, b_aff, mask, signs)
    return _launch("pmixed_masked", df, a.contiguous(), b_aff.contiguous(),
                   _flags(mask, L, "mask"), _flags(signs, L, "signs"))


def padd_flat(df, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete add a + b on [48, L] batches (kernel B4 on CUDA)."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    _check_batch(b, 3 * NLIMBS, L, "b")
    if not _dispatch(a):
        return padd_plain(df, a, b)
    return _launch("padd", df, a.contiguous(), b.contiguous())


def pdouble_flat(df, a: torch.Tensor) -> torch.Tensor:
    """2a on a [48, L] batch, RCB Alg 9 (kernel B5 on CUDA)."""
    _check_batch(a, 3 * NLIMBS, a.shape[1], "a")
    if not _dispatch(a):
        return pdouble_plain(df, a)
    return _launch("pdouble", df, a.contiguous())


def pdouble_masked_flat(df, a: torch.Tensor, mask: torch.Tensor
                        ) -> torch.Tensor:
    """out = mask ? 2a : a on a [48, L] batch (kernel B6 on CUDA)."""
    L = a.shape[1]
    _check_batch(a, 3 * NLIMBS, L, "a")
    if not _dispatch(a):
        return pdouble_masked_plain(df, a, mask)
    return _launch("pdouble_masked", df, a.contiguous(),
                   _flags(mask, L, "mask"))


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
    return torch.from_numpy(_ident_col_np(df.spec.modulus)).to(device)


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
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate(cols, axis=0))).to(device)


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
