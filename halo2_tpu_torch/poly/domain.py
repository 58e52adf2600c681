"""EvaluationDomain: 2^k base domain + zeta-coset extended domain.

Port of halo2_tpu/poly/domain.py (the math of halo2_proofs/src/poly/
domain.rs:19-498) with device-resident tables. Every transform runs on
the domain's device through ops/ntt.py: there is no native-NTT
crossover and no mesh branch in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from ..fields.device import DeviceField, NLIMBS, int_to_limbs
from ..ops.field_kernels import fmul
from ..ops.ntt import make_plan, ntt_many

# Columns per batched transform: the m-column pipeline holds a few
# [m, extended_n, 16] int32 intermediates (64 B per element each); 2^24
# elements per chunk keeps it near 4 GiB on an 80 GB card.
NTT_BATCH_ELEMS = 1 << 24


class EvaluationDomain:
    def __init__(self, df: DeviceField, j: int, k: int, device):
        """j = circuit degree (quotient_poly_degree + 1), k = log2(rows)."""
        spec = df.spec
        p = spec.modulus
        self.df = df
        self.device = torch.device(device)
        self.k = k
        self.n = 1 << k
        self.quotient_poly_degree = j - 1
        extended_k = k
        while (1 << extended_k) < self.n * self.quotient_poly_degree:
            extended_k += 1
        assert extended_k <= spec.s
        self.extended_k = extended_k
        self.extended_n = 1 << extended_k

        self.extended_omega = pow(spec.root_of_unity,
                                  1 << (spec.s - extended_k), p)
        self.omega = pow(self.extended_omega, 1 << (extended_k - k), p)
        self.omega_inv = pow(self.omega, p - 2, p)
        self.extended_omega_inv = pow(self.extended_omega, p - 2, p)
        self.g_coset = spec.zeta
        self.g_coset_inv = spec.zeta * spec.zeta % p
        self.barycentric_weight = pow(self.n, p - 2, p)

        # t(X) = X^n - 1 on the coset takes 2^(extended_k - k) distinct
        # values (domain.rs:88-111); the kernel indexes the table modulo
        # its length
        orig = pow(spec.zeta, self.n, p)
        step = pow(self.extended_omega, self.n, p)
        t_evals = []
        cur = orig
        while True:
            t_evals.append((cur - 1) % p)
            cur = cur * step % p
            if cur == orig:
                break
        assert len(t_evals) == 1 << (extended_k - k)
        t_inv = [pow(t, p - 2, p) for t in t_evals]
        self._t_inv = self._upload_mont(df.to_mont_np(t_inv))

        # zeta-power coset patterns (domain.rs:357-373): index i gets
        # [1, z, z^2][i % 3] into the coset, [1, z^2, z][i % 3] out of it
        def pattern(c0, c1, length):
            return self._upload_mont(df.to_mont_np(
                [[1, c0, c1][i % 3] for i in range(length)]))
        self._coset_in = pattern(self.g_coset, self.g_coset_inv, self.n)
        self._coset_out_ext = pattern(self.g_coset_inv, self.g_coset,
                                      self.extended_n)

        self.plan = make_plan(df, self.n, self.omega)
        self.plan_inv = make_plan(df, self.n, self.omega_inv)
        self.plan_ext = make_plan(df, self.extended_n, self.extended_omega)
        self.plan_ext_inv = make_plan(df, self.extended_n,
                                      self.extended_omega_inv)
        self._ifft_divisor = self._upload_mont(
            int_to_limbs(pow(self.n, p - 2, p) * (1 << 256) % p))
        self._ext_ifft_divisor = self._upload_mont(
            int_to_limbs(pow(self.extended_n, p - 2, p) * (1 << 256) % p))

    def _upload_mont(self, digits: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(digits)).to(self.device)

    # ---------------- transforms ----------------
    def lagrange_to_coeff_extended_many(self, values_list: list):
        """m Lagrange vectors -> (m coeff polys, m extended-coset vectors):
        iNTT, 1/n scale, coset zeta powers, zero pad, extended NTT, all m
        columns per launch (in chunks of NTT_BATCH_ELEMS)."""
        m = len(values_list)
        if m == 0:
            return [], []
        m_chunk = max(1, NTT_BATCH_ELEMS // self.extended_n)
        polys, cosets = [], []
        for i in range(0, m, m_chunk):
            vals = torch.stack(values_list[i:i + m_chunk], dim=0)
            x = ntt_many(self.df, vals, self.plan_inv)
            pc = fmul(self.df, x, self._ifft_divisor)
            a = fmul(self.df, pc, self._coset_in)
            pad = torch.zeros((a.shape[0], self.extended_n - self.n, NLIMBS),
                              dtype=a.dtype, device=a.device)
            ext = ntt_many(self.df, torch.cat([a, pad], dim=1),
                           self.plan_ext)
            polys.extend(pc.unbind(0))
            cosets.extend(ext.unbind(0))
        return polys, cosets

    def lagrange_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        assert values.shape[0] == self.n
        x = ntt_many(self.df, values.unsqueeze(0), self.plan_inv)[0]
        return fmul(self.df, x, self._ifft_divisor)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        return ntt_many(self.df, coeffs.unsqueeze(0), self.plan)[0]

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        assert coeffs.shape[0] == self.n
        a = fmul(self.df, coeffs, self._coset_in)
        pad = torch.zeros((self.extended_n - self.n, NLIMBS), dtype=a.dtype,
                          device=a.device)
        return ntt_many(self.df, torch.cat([a, pad], dim=0).unsqueeze(0),
                        self.plan_ext)[0]

    def extended_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        """iNTT + un-coset; returns all extended_n coefficients (caller
        truncates to n * quotient_poly_degree, domain.rs:303-325)."""
        assert values.shape[0] == self.extended_n
        x = ntt_many(self.df, values.unsqueeze(0), self.plan_ext_inv)[0]
        x = fmul(self.df, x, self._ext_ifft_divisor)
        return fmul(self.df, x, self._coset_out_ext)

    def divide_by_vanishing_poly(self, values: torch.Tensor) -> torch.Tensor:
        reps = self.extended_n // self._t_inv.shape[0]
        v = values.reshape(reps, self._t_inv.shape[0], NLIMBS)
        return fmul(self.df, v, self._t_inv).reshape(values.shape)

    def rotate_extended(self, values: torch.Tensor, rotation: int
                        ) -> torch.Tensor:
        shift = (1 << (self.extended_k - self.k)) * rotation
        return torch.roll(values, -shift, dims=0)

    # ---------------- host scalar helpers ----------------
    def rotate_omega(self, value: int, rotation: int) -> int:
        p = self.df.spec.modulus
        if rotation >= 0:
            return value * pow(self.omega, rotation, p) % p
        return value * pow(self.omega_inv, -rotation, p) % p

    def l_i_range(self, x: int, xn: int, rotations) -> list[int]:
        """Barycentric evaluations of the Lagrange basis polys l_i(x) for i
        over `rotations` (domain.rs:447-472)."""
        p = self.df.spec.modulus
        results = [(x - self.rotate_omega(1, rot)) % p for rot in rotations]
        results = [pow(r, p - 2, p) for r in results]
        common = (xn - 1) * self.barycentric_weight % p
        return [self.rotate_omega(r * common % p, rot)
                for rot, r in zip(rotations, results)]

    def pinned(self) -> dict:
        """Minimal parameters determining the domain
        (PinnedEvaluationDomain, domain.rs:482-498)."""
        return {"k": self.k, "extended_k": self.extended_k,
                "omega": self.omega}
