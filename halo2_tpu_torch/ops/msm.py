"""The MSM dispatch: host MSM or device Pippenger; and the per-lane
ladder MSM.

Port of halo2_tpu/ops/msm.py (`msm`, `msm_mont`, `msm_small`,
`scalars_to_digits`, `_pad_pow2`). The port never traces, so every call
is concrete and the dispatch is by size alone, with the reference's
schedule as a module constant: up to HOST_MSM_THRESHOLD scalars, the host
MSM (`CurveSpec.msm`, the native library where it is loaded); above it,
the device Pippenger (ops/msm_pippenger.py). The reference's third
branch, `msm_small` between its two thresholds, is empty at their
defaults (both 512), so `msm` has none; `msm_small` (the
scalar-multiplication ladder and a tree sum) is called directly. Points
are [48, n] projective batches of the curve's base field; `msm` returns
an affine host point (None for the identity).
"""
from __future__ import annotations

import torch

from ..curves.device import batch_scalar_mul, identity, tree_sum
from ..fields.device import DeviceField, NLIMBS, from_mont
from .msm_pippenger import msm_many
from .point_kernels import points_from_proj

# the reference's schedule (halo2_tpu/ops/msm.py:146 and :296: its host
# and Pallas thresholds, both 512 by default; the port reads no
# environment)
HOST_MSM_THRESHOLD = 512


def scalars_to_digits(df: DeviceField, scalars_mont: torch.Tensor
                      ) -> torch.Tensor:
    """Montgomery-form field tensor [n, 16] -> canonical digits [n, 16]."""
    return from_mont(df, scalars_mont)


def _pad_pow2(df: DeviceField, digits: torch.Tensor, pts: torch.Tensor,
              min_n: int = 8):
    """Pad to the next power of two (at least min_n) with zero scalars and
    identity points (df: the points' base field)."""
    n = digits.shape[0]
    target = max(min_n, 1 << max(n - 1, 0).bit_length())
    if target == n:
        return digits, pts
    pad = target - n
    digits = torch.cat([digits, digits.new_zeros((pad, NLIMBS))], dim=0)
    pts = torch.cat([pts, identity(df, pad, pts.device)], dim=1)
    return digits, pts


def msm_small(df: DeviceField, scalar_digits: torch.Tensor,
              pts: torch.Tensor) -> torch.Tensor:
    """[s_i] P_i per lane (the scalar-multiplication ladder, 256 bits),
    then a log-depth tree sum: a [48, 1] batch."""
    return tree_sum(df, batch_scalar_mul(df, pts, scalar_digits, nbits=256))


def msm(curve, scalar_digits: torch.Tensor, pts: torch.Tensor,
        packed=None):
    """sum_i s_i P_i: scalar_digits int32 [n, 16] canonical 16-bit
    digits, pts [48, n] on the curve's base field. `packed`
    (pack_affine(pts[:32])) says that the bases are affine in projective
    coding (Z in {0, mont 1}, as the SRS's) and hands the Pippenger their
    packed copy; without it the bases may be any projective points."""
    df = DeviceField(curve.base)
    n = scalar_digits.shape[0]
    if n <= HOST_MSM_THRESHOLD:
        scalars = [int.from_bytes(row.astype("<u2").tobytes(), "little")
                   for row in scalar_digits.cpu().numpy()]
        return curve.msm(scalars, points_from_proj(df, pts))
    if packed is None:
        digits, pts = _pad_pow2(df, scalar_digits, pts)
    else:
        digits = scalar_digits
    return msm_many(curve, df, digits[None], pts, affine=packed is not None,
                    packed=packed)[0]


def msm_mont(curve, scalars_mont: torch.Tensor, pts: torch.Tensor,
             packed=None):
    """msm taking the scalars in Montgomery form (as polynomial
    coefficients live on the device)."""
    return msm(curve, scalars_to_digits(DeviceField(curve.scalar),
                                        scalars_mont), pts, packed)
