"""Radix-2 NTT over field tensors.

Port of halo2_tpu/ops/ntt.py (`make_plan`, `ntt`, `ntt_many`, `intt`):
log2(n) vectorized butterfly stages over a [..., n, 16] tensor after one
bit-reversal gather. The twiddle products launch kernel B1 (the twiddle
row is indexed modulo its length, never materialised per butterfly) and
the butterfly sums the field add/subtract kernel. The reference's group
NTT serves SRS setup, which the port leaves to the native host library.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields.device import DeviceField, NLIMBS, int_to_limbs
from .field_kernels import fmul, fadd, fsub


def bit_reverse_perm(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


@dataclass(eq=False)
class NttPlan:
    """Tables for a size-n NTT with root `omega` (host ints): `twiddles[s]`
    holds the 2^s twiddles of stage s+1 as Montgomery digits, `perm` the
    bit-reversal gather. Device copies are made once per device."""
    n: int
    omega: int
    perm: np.ndarray
    twiddles: tuple
    _dev: dict = field(default_factory=dict, repr=False)

    def on(self, device) -> tuple:
        device = torch.device(device)
        ent = self._dev.get(device)
        if ent is None:
            ent = self._dev[device] = (
                torch.as_tensor(self.perm, device=device),
                tuple(torch.from_numpy(t).to(device) for t in self.twiddles))
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
                   twiddles=tuple(twiddles))


def ntt_many(df: DeviceField, x: torch.Tensor, plan: NttPlan
             ) -> torch.Tensor:
    """Forward NTT of [m, n, 16] along axis 1 (m independent transforms
    share every stage's launches)."""
    m, n = x.shape[0], x.shape[1]
    assert n == plan.n
    perm, tws = plan.on(x.device)
    x = x.index_select(1, perm)
    for s, tw in enumerate(tws, start=1):
        mm = 1 << s
        half = mm // 2
        xr = x.view(m, n // mm, mm, NLIMBS)
        lo, hi = xr[:, :, :half], xr[:, :, half:]
        t = fmul(df, hi, tw)
        x = torch.cat([fadd(df, lo, t), fsub(df, lo, t)],
                      dim=2).view(m, n, NLIMBS)
    return x


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
    return fmul(df, x, torch.as_tensor(n_inv_mont, device=x.device))
