"""Device IPA rounds: the GLV-ladder fold of G' and the L/R MSMs.

Port of halo2_tpu/ops/ipa_device.py (halo2_proofs/src/poly/commitment/
prover.rs:100-166). Per round: two cross-term MSMs (L_j, R_j) and two
inner products, then the collapse p' = p'_lo + u_j^-1 p'_hi,
b = b_lo + u_j b_hi and G' = G'_lo + [u_j] G'_hi. The scalar u_j is
split as u_j = +-s1 +- s2 lambda with s1, s2 < 2^130 (GLV), where
[lambda](x, y) = (zeta_p x, y) is the curve endomorphism, so [u_j] G'_hi
is a 130-step double-and-add ladder over the table {t1, t2, t1 + t2}
(B4) of (X, +-Y, Z) and (zeta_p X, +-Y, Z), run as one launch of the
fused ladder kernel (the reference's fori_loop of B5 and a masked B3);
then G'_lo is added (B4). p' and b live in the scalar field, G' in the base
field. The L/R window sums are Horner-combined on the host.

The state is folded at its exact width: a round that starts from
2 * half lanes ends with half lanes. The reference keeps the state
zero/identity-padded to the full width n and compiles one program per
power-of-4 bucket width (its `bucket_widths`, HALO2_TPU_IPA_TAIL_WF) to
bound the number of TPU executables; eager PyTorch has no compile step,
and every lane's arithmetic is the same, so the values are the same.
The next round's L and R run as one MSM call with two scalar sets over
the folded G' (L: p'_hi on the G'_lo lanes, R: p'_lo on the G'_hi lanes,
zeros elsewhere), which gives the reference's points.

Group math is exact: results are bit-identical to the reference and the
native host path.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..curves.host import PALLAS, VESTA
from ..fields.device import NLIMBS, fneg, from_mont
from ..poly.utils import inner_product
from . import msm_pippenger as mp
from .field_kernels import fadd, fmul
from .point_kernels import glv_ladder_flat, padd_flat

GLV_BITS = 130  # ceil(|q|/2) + slack for the decomposition bound


@functools.lru_cache(maxsize=None)
def _find_lambda(curve_name: str, q: int, zeta_q: int) -> int:
    """The scalar lambda with [lambda](x, y) = (zeta_p x, y): zeta_q or
    zeta_q^2 depending on orientation, resolved on the generator once."""
    spec = PALLAS if curve_name == PALLAS.name else VESTA
    gx, gy = spec.generator
    zp = spec.base.zeta
    phi = (zp * gx % spec.base.modulus, gy)
    for lam in (zeta_q, zeta_q * zeta_q % q):
        if spec.mul(spec.generator, lam) == phi:
            return lam
    raise AssertionError("no cube root matches the endomorphism")


@functools.lru_cache(maxsize=None)
def _glv_basis(q: int, lam: int):
    """Two short lattice vectors (a, b) with a + b lambda = 0 (mod q), via
    the extended-Euclid half-GCD (GLV01, Alg. 3.74)."""
    r0, r1 = q, lam
    t0, t1 = 0, 1
    lim = math.isqrt(q)
    rows = [(r0, t0), (r1, t1)]
    while r1 >= lim:
        qt = r0 // r1
        r0, r1 = r1, r0 - qt * r1
        t0, t1 = t1, t0 - qt * t1
        rows.append((r1, t1))
    # rows[-1] is the first remainder < sqrt(q); candidates around it
    (rl, tl), (rm, tm) = rows[-1], rows[-2]
    v1 = (rl, -tl)
    # second vector: the shorter of rows[-2] and one more EEA step
    qt = rm // rl
    r2, t2 = rm - qt * rl, tm - qt * tl
    v2 = ((rm, -tm) if rm * rm + tm * tm <= r2 * r2 + t2 * t2
          else (r2, -t2))
    return v1, v2


def glv_split(spec_scalar, curve_name: str, u: int):
    """u -> (s1, neg1, s2, neg2) with u = +-s1 +- s2 lambda (mod q) and
    s1, s2 < 2^GLV_BITS."""
    q = spec_scalar.modulus
    lam = _find_lambda(curve_name, q, spec_scalar.zeta)
    (a1, b1), (a2, b2) = _glv_basis(q, lam)
    det = a1 * b2 - a2 * b1

    def rnd(num, den):
        # round(num / den), exact rational rounding
        if den < 0:
            num, den = -num, -den
        return (2 * num + den) // (2 * den)

    c1 = rnd(u * b2, det)
    c2 = rnd(-u * b1, det)
    u1 = u - c1 * a1 - c2 * a2
    u2 = -c1 * b1 - c2 * b2
    assert (u1 + u2 * lam - u) % q == 0
    s1, neg1 = (u1, 0) if u1 >= 0 else (-u1, 1)
    s2, neg2 = (u2, 0) if u2 >= 0 else (-u2, 1)
    assert s1 < (1 << GLV_BITS) and s2 < (1 << GLV_BITS), (s1, s2)
    return s1, neg1, s2, neg2


def _bits_msb(s: int, nb: int) -> np.ndarray:
    return np.array([(s >> (nb - 1 - i)) & 1 for i in range(nb)], np.uint32)


def glv_table(dfb, g_hi: torch.Tensor, neg1: int, neg2: int):
    """The ladder's addends for sel = 1, 2, 3 on a [48, h] batch:
    t1 = (X, +-Y, Z), t2 = (zeta_p X, +-Y, Z) = +-[lambda] and t1 + t2
    (ipa_device.py:201-216)."""
    dev = g_hi.device
    X, Y, Z = (g_hi[i * NLIMBS:(i + 1) * NLIMBS] for i in range(3))
    negY = fneg(dfb, Y.T).T
    zX = fmul(dfb, X.T, dfb.scalar(dfb.spec.zeta, dev)).T
    t1 = torch.cat([X, negY if neg1 else Y, Z])
    t2 = torch.cat([zX, negY if neg2 else Y, Z])
    return t1, t2, padd_flat(dfb, t1, t2)


def _glv_mul_add(params, g_lo: torch.Tensor, g_hi: torch.Tensor, u: int
                 ) -> torch.Tensor:
    """g_lo + [u] g_hi on [48, h] batches (ipa_device.py:201-233)."""
    dfb = params.base_df
    s1, neg1, s2, neg2 = glv_split(params.curve.scalar, params.curve.name, u)
    acc = glv_ladder_flat(dfb, *glv_table(dfb, g_hi, neg1, neg2),
                          _bits_msb(s1, GLV_BITS), _bits_msb(s2, GLV_BITS))
    return padd_flat(dfb, g_lo, acc)


def ipa_device_lr(params, p: torch.Tensor, b: torch.Tensor,
                  g: torch.Tensor):
    """One round's L/R over a width-2h state: L = <p'_hi, G'_lo> with
    value <p'_hi, b_lo>, R = <p'_lo, G'_hi> with value <p'_lo, b_hi>
    (ipa_device.py:243-259): the reference's ipa_device_first_lr on the
    unfolded state, and the L/R half of its fold on a folded one. Returns
    (l_pt, r_pt, value_l, value_r) on the host."""
    df = params.scalar_df
    h = p.shape[0] // 2
    d = from_mont(df, p)
    zero = torch.zeros_like(d[:h])
    digits = torch.stack([torch.cat([d[h:], zero]),
                          torch.cat([zero, d[:h]])])
    # msm_many's host Horner combine is the reference's _lr_to_host
    l_pt, r_pt = mp.msm_many(params.curve, params.base_df, digits, g,
                             affine=False)
    return (l_pt, r_pt, inner_product(df, p[h:], b[:h]),
            inner_product(df, p[:h], b[h:]))


def ipa_device_fold_lr(params, p_prime: torch.Tensor, b: torch.Tensor,
                       g: torch.Tensor, half: int, u_j: int, u_j_inv: int,
                       with_lr: bool = True):
    """Fold a width-2*half state to width half, then the next round's L/R
    unless with_lr is False or no round is left (half == 1). Returns
    (p', b', g', l_pt, r_pt, value_l, value_r); the L/R slots are None
    where they were not computed."""
    df = params.scalar_df
    dev = p_prime.device
    assert p_prime.shape[0] == 2 * half and g.shape[1] == 2 * half
    p_f = fadd(df, p_prime[:half],
               fmul(df, p_prime[half:], df.scalar(u_j_inv, dev)))
    b_f = fadd(df, b[:half], fmul(df, b[half:], df.scalar(u_j, dev)))
    g_f = _glv_mul_add(params, g[:, :half], g[:, half:], u_j)
    if not with_lr or half == 1:
        return p_f, b_f, g_f, None, None, None, None
    return (p_f, b_f, g_f) + ipa_device_lr(params, p_f, b_f, g_f)
