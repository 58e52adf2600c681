"""Device Pasta point batches: the point-batch API.

Port of halo2_tpu/curves/device.py (`pdouble`, `padd`, `pneg`, `pselect`,
`batch_scalar_mul`, `normalize`, `tree_sum`, `DeviceCurve.identity`). The
port keeps points as [48, L] homogeneous projective batches
(ops/point_kernels.py: rows 0-15 X, 16-31 Y, 32-47 Z, lanes last;
x = X/Z, y = Y/Z, identity Z = 0) instead of the reference's Jacobian
`JPoint` (x = X/Z^2, y = Y/Z^3), and RCB15's complete formulas instead of
its where-selected Jacobian cases. The group law is exact, so every
function gives the reference's affine points after `normalize`; the raw
coordinates differ. Each function takes the base field's DeviceField and
runs on the device of its tensors: on CUDA through the kernels (B4, B5,
the add/subtract kernel, the scalar-multiplication ladder), on the CPU
through their plain versions.
"""
from __future__ import annotations

import torch

from ..fields.device import DeviceField, NLIMBS, batch_inv, is_zero
from ..ops.field_kernels import fmul
from ..ops.point_kernels import (ident_col, padd_flat, pdouble_flat,
                                 pneg_flat, scalar_mul_ladder_flat)


def identity(df: DeviceField, L: int, device) -> torch.Tensor:
    """[48, L] batch of the identity (0 : mont 1 : 0)."""
    return ident_col(df, torch.device(device))[:, None].expand(
        3 * NLIMBS, L).contiguous()


def pdouble(df: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """2a, RCB Alg 9 (kernel B5)."""
    return pdouble_flat(df, a)


def padd(df: DeviceField, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, complete (RCB Alg 7, kernel B4): identity lanes, a == b and
    a == -b need no special case."""
    return padd_flat(df, a, b)


def pneg(df: DeviceField, a: torch.Tensor) -> torch.Tensor:
    """-a: the Y rows negated as 0 - Y (the add/subtract kernel)."""
    return pneg_flat(df, a)


def pselect(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """cond: bool [L]; lane l of a where cond[l], else of b."""
    return torch.where(cond[None, :], a, b)


def batch_scalar_mul(df: DeviceField, pts: torch.Tensor,
                     scalar_digits: torch.Tensor, nbits: int = 256
                     ) -> torch.Tensor:
    """Per-lane variable-base scalar mul: pts [48, L], scalar_digits int32
    [L, 16] canonical (not Montgomery) 16-bit digits, or [T, 16] read by
    lane % T; MSB-first double-and-add over the low nbits bits (one launch
    of the scalar-multiplication ladder)."""
    return scalar_mul_ladder_flat(df, pts, scalar_digits.to(torch.int32),
                                  nbits)


def normalize(df: DeviceField, pts: torch.Tensor):
    """[48, L] projective batch -> (x [L, 16], y [L, 16], inf [L] bool):
    affine Montgomery coordinates from one batch inversion of Z. Identity
    lanes (Z = 0) are flagged, not inverted, and come out as (0, mont 1)."""
    X, Y, Z = (pts[i * NLIMBS:(i + 1) * NLIMBS].T for i in range(3))
    inf = is_zero(df, Z)
    zinv = batch_inv(df, Z.contiguous())   # zeros stay zero
    x = fmul(df, X, zinv)
    y = torch.where(inf[:, None], df.scalar(1, pts.device),
                    fmul(df, Y, zinv))
    return x, y, inf


def tree_sum(df: DeviceField, pts: torch.Tensor, axis=None
             ) -> torch.Tensor:
    """Sum of the L lanes of a [48, L] batch as a [48, 1] batch; with
    axis=1, of a [48, D, L] batch over its D axis as a [48, L] batch (the
    mesh's sum over ranks): log-depth halvings with B4, an odd count
    padded with one identity (the reference's tree_sum,
    halo2_tpu/curves/device.py:191)."""
    if axis not in (None, 1):
        raise ValueError(f"tree_sum sums lanes or axis 1, not {axis}")
    cur = pts.unsqueeze(2) if axis is None else pts
    rows, L = cur.shape[0], cur.shape[2]
    if cur.shape[1] == 0:
        return identity(df, L, pts.device)
    while cur.shape[1] > 1:
        if cur.shape[1] % 2:
            cur = torch.cat([cur, identity(df, L, cur.device)[:, None]],
                            dim=1)
        half = cur.shape[1] // 2
        cur = padd(df, cur[:, :half].reshape(rows, -1),
                   cur[:, half:].reshape(rows, -1)).view(rows, half, L)
    return cur.reshape(rows, L)
