"""Polynomial utilities over field tensors: powers, evaluation, inner
products, Kate division, Horner folds.

Port of halo2_tpu/poly/utils.py. Evaluations are one Montgomery multiply
against a powers table and a digit-column sum: summing the 16-bit digits
of n Montgomery values in int64 is exact (each column < n * 2^16), and the
host reduces the one 16-column result mod p. This replaces the
reference's log-depth tree of modular adds with a single reduction.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.device import (DeviceField, NLIMBS, R, running_sum,
                             digits_to_ints, ints_to_digits)
from ..ops.field_kernels import fmul, fadd

_POWERS_CACHE: dict = {}  # (modulus, x, n, device) -> tensor


def powers(df: DeviceField, x: int, n: int, device, start: int = 1
           ) -> torch.Tensor:
    """[start, start*x, ..., start*x^{n-1}] as [n, 16] Montgomery digits,
    by a host bigint recurrence (the domain's omega/zeta tables recur in
    keygen and every proof, so they are cached)."""
    p = df.spec.modulus
    device = torch.device(device)
    key = (p, x % p, n, start % p, device)
    hit = _POWERS_CACHE.get(key)
    if hit is not None:
        return hit
    acc = start % p * R % p
    vals = []
    for _ in range(n):
        vals.append(acc)
        acc = acc * x % p
    out = torch.from_numpy(ints_to_digits(vals)).to(device)
    if len(_POWERS_CACHE) >= 16:
        _POWERS_CACHE.pop(next(iter(_POWERS_CACHE)))
    _POWERS_CACHE[key] = out
    return out


def digit_sums_to_ints(df: DeviceField, sums: torch.Tensor) -> list[int]:
    """[..., 16] int64 digit-column sums of Montgomery values -> the
    canonical ints of the field sums (one readback)."""
    p = df.spec.modulus
    rinv = pow(R, -1, p)
    cols = sums.reshape(-1, NLIMBS).cpu().tolist()
    return [sum(int(c) << (16 * j) for j, c in enumerate(row)) % p * rinv % p
            for row in cols]


def eval_poly(df: DeviceField, coeffs: torch.Tensor, x: int) -> int:
    """p(x) = sum coeffs[i] x^i as a canonical host int."""
    pw = powers(df, x, coeffs.shape[0], coeffs.device)
    prod = fmul(df, coeffs, pw)
    return digit_sums_to_ints(df, prod.to(torch.int64).sum(dim=0))[0]


def inner_product(df: DeviceField, a: torch.Tensor, b: torch.Tensor) -> int:
    """sum a_i b_i (arithmetic.rs:308-318) as a canonical host int."""
    return digit_sums_to_ints(
        df, fmul(df, a, b).to(torch.int64).sum(dim=0))[0]


def batch_eval_polys(df: DeviceField, pairs) -> list[int]:
    """Evaluate many (poly [n_i, 16], point) pairs with one multiply, one
    column sum and one readback."""
    if not pairs:
        return []
    n = max(p.shape[0] for p, _ in pairs)
    device = pairs[0][0].device
    polys = torch.stack([
        p if p.shape[0] == n else torch.cat(
            [p, torch.zeros((n - p.shape[0], NLIMBS), dtype=p.dtype,
                            device=device)])
        for p, _ in pairs])
    uniq = list(dict.fromkeys(pt for _, pt in pairs))
    pw_stack = torch.stack([powers(df, pt, n, device) for pt in uniq])
    lookup = {pt: i for i, pt in enumerate(uniq)}
    gidx = torch.as_tensor([lookup[pt] for _, pt in pairs], device=device)
    prod = fmul(df, polys, pw_stack.index_select(0, gidx))
    return digit_sums_to_ints(df, prod.to(torch.int64).sum(dim=1))


class MemoEval:
    """Memoized evaluations backed by one batch_eval_polys pass: collect
    every (poly, point) pair up front, compute once, then serve
    `ev(poly, point)` during the transcript-write phase."""

    def __init__(self, df):
        self.df = df
        self._pairs = []
        self._keys = {}
        self._vals = None

    def collect(self, poly, point: int) -> None:
        key = (id(poly), point)
        if key not in self._keys:
            self._keys[key] = len(self._pairs)
            self._pairs.append((poly, point))

    def compute(self) -> None:
        self._vals = batch_eval_polys(self.df, self._pairs)

    def ev(self, poly, point: int) -> int:
        key = (id(poly), point)
        if self._vals is None or key not in self._keys:
            return eval_poly(self.df, poly, point)
        return self._vals[self._keys[key]]


def kate_division(df: DeviceField, coeffs: torch.Tensor, b: int
                  ) -> torch.Tensor:
    """q(X) = (p(X) - p(b)) / (X - b) with the remainder dropped:
    q_i = sum_{j>i} a_j b^{j-i-1}, as powers, a suffix-sum scan and an
    inverse-powers rescale (b != 0). Keeps length n (q[n-1] = 0)."""
    n = coeffs.shape[0]
    p = df.spec.modulus
    u = fmul(df, coeffs, powers(df, b, n, coeffs.device))       # a_j b^j
    suf = running_sum(df, u, axis=0, reverse=True)
    t = torch.cat([suf[1:], torch.zeros((1, NLIMBS), dtype=suf.dtype,
                                        device=suf.device)], dim=0)
    binv = pow(b, p - 2, p)
    return fmul(df, t, powers(df, binv, n, coeffs.device, start=binv))


def distribute_powers(df: DeviceField, arrays, base: int):
    """Horner fold acc = acc * base + term, i.e. sum base^{m-1-i} arrays[i]
    (Ast::DistributePowers, poly/evaluator.rs:186-196)."""
    base_m = df.scalar(base, arrays[0].device)
    acc = arrays[0]
    for arr in arrays[1:]:
        acc = fadd(df, fmul(df, acc, base_m), arr)
    return acc
