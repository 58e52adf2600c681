"""Device Pasta point batches: the batch normalize.

Port of the part of halo2_tpu/curves/device.py that the IPA's hand-off
to the native session needs (`normalize`, :172). The port keeps points
as [48, L] homogeneous projective batches (ops/point_kernels.py: x = X/Z,
y = Y/Z, identity Z = 0) instead of the reference's Jacobian `JPoint`;
the affine values are the same. `JPoint`, `batch_scalar_mul` and
`tree_sum` come with a later slice.
"""
from __future__ import annotations

import torch

from ..fields.device import DeviceField, NLIMBS, batch_inv, is_zero
from ..ops.field_kernels import fmul


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
