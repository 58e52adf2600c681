"""EvaluationDomain: 2^k base domain + zeta-coset extended domain.

Port of halo2_tpu/poly/domain.py (the math of halo2_proofs/src/poly/
domain.rs:19-498) with device-resident tables. Every transform runs on
the domain's device: there is no native-NTT crossover. On the card a
transform of n >= MXU_NTT_MIN runs through the four-step NTT on the
tensor cores (ops/mxu_field.py, kernel K1), a smaller one through B7
(ops/ntt.py), as the reference routes them on an accelerator
(halo2_tpu/poly/domain.py:52-74); on the CPU every transform takes B7's
plain version. Under a ProverMesh whose D^2 divides both domain sizes, the
transforms run as four-step NTTs over the mesh
(parallel/mesh.py::sharded_ntt) on the rank's rows, as the reference
routes them. Given whole tensors, they return whole tensors; given a
rank's rows (`rows` a ProverMesh, the prover's sharded state), they
return its rows and gather nothing:

  - values to coefficients: the sharded inverse NTT leaves each rank its
    block of coefficients;
  - coefficients to the extended coset: with R = ext_n / n and
    k = j + R k', ext[k] = NTT_n(c_i zeta_i w_E^(i j))[k'], so R n-point
    sharded NTTs of the rank's coefficients, each scaled by its rows of
    the twiddles w_E^(i j), give the rank's ext_n/D rows interleaved;
  - the extended coset to the quotient's n-row pieces (h): the inverse
    of that, R n-point inverse NTTs of the rank's rows taken every R-th,
    twiddles w_E^(-i j) and an R-point DFT across them, leave each rank
    its rows i of every piece q (coefficient i + q n), where
    vanishing_construct commits them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..fields.device import DeviceField, NLIMBS, int_to_limbs
from ..ops.field_kernels import fmul
from ..ops.mxu_field import ntt_mxu_b
from ..ops.ntt import make_plan, ntt_many
from ..parallel import context
from ..parallel.context import WHOLE
from ..parallel.mesh import ShardedNttPlan, sharded_ntt
from .utils import powers

# Columns per batched transform: the m-column pipeline holds a few
# [m, extended_n, 16] int32 intermediates (64 B per element each); 2^24
# elements per chunk keeps it near 4 GiB on an 80 GB card.
NTT_BATCH_ELEMS = 1 << 24

# At or above this size, on the card, a transform runs through the
# four-step NTT with its twiddle products on the tensor cores (the
# reference's MXU threshold, halo2_tpu/poly/domain.py:63)
MXU_NTT_MIN = 1 << 16


def _use_mxu(n: int, device) -> bool:
    """The four-step route: on CUDA from MXU_NTT_MIN, never on the CPU
    (the reference: on accelerator backends only)."""
    return torch.device(device).type == "cuda" and n >= MXU_NTT_MIN


def _ntt_dispatch(df: DeviceField, x: torch.Tensor, plan) -> torch.Tensor:
    """[m, n, 16] through the four-step NTT (K1) or B7, by size and
    device."""
    if _use_mxu(plan.n, x.device):
        return ntt_mxu_b(df, x, plan)
    return ntt_many(df, x, plan)


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
        self._mesh_plan_cache: dict = {}

    def _upload_mont(self, digits: np.ndarray) -> torch.Tensor:
        return tracing.upload("domain", torch.from_numpy(
            np.ascontiguousarray(digits)), self.device)

    # ---------------- mesh-sharded transforms ----------------
    def _mesh_ctx(self):
        """The active ProverMesh when D^2 divides both domain sizes (the
        four-step NTT's condition), else None."""
        ctx = context.active()
        if (ctx is not None and ctx.divides(self.n)
                and ctx.divides(self.extended_n)):
            return ctx
        return None

    def _mesh_plans(self, ctx) -> dict:
        plans = self._mesh_plan_cache.get(ctx.ndev)
        if plans is None:
            df, D = self.df, ctx.ndev
            plans = self._mesh_plan_cache[D] = {
                "fwd": ShardedNttPlan(df, self.n, self.omega, D),
                "inv": ShardedNttPlan(df, self.n, self.omega_inv, D),
                "ext": ShardedNttPlan(df, self.extended_n,
                                      self.extended_omega, D),
                "ext_inv": ShardedNttPlan(df, self.extended_n,
                                          self.extended_omega_inv, D)}
        return plans

    def _local_tables(self, ctx) -> dict:
        """The rank's twiddle tables of the local extension and its
        inverse: "ext" [R, C, 16] = zeta_i w_E^(i j) for the rank's rows
        i and j < R; "inv" [R, C, 16] = w_E^(-i j); "out" [R, C, 16] =
        the 1/ext_n scale times the un-coset pattern at row i + q n;
        "dft" the R-point inverse DFT's plan (root w_E^(-n))."""
        key = ("local", ctx.ndev, ctx.rank)
        tabs = self._mesh_plan_cache.get(key)
        if tabs is None:
            df, dev, p = self.df, self.device, self.df.spec.modulus
            R = self.extended_n // self.n
            start, C = ctx.row_span(self.n)
            w, wi = self.extended_omega, self.extended_omega_inv
            coset_in = ctx.local_rows(self._coset_in)
            ext = torch.stack([fmul(df, coset_in, powers(
                df, pow(w, j, p), C, dev, start=pow(w, start * j, p)))
                for j in range(R)])
            inv = torch.stack([powers(df, pow(wi, j, p), C, dev,
                                      start=pow(wi, start * j, p))
                               for j in range(R)])
            out = torch.stack([fmul(df, self._coset_out_ext[
                q * self.n + start:q * self.n + start + C],
                self._ext_ifft_divisor) for q in range(R)])
            tabs = self._mesh_plan_cache[key] = {
                "ext": ext, "inv": inv, "out": out,
                "dft": make_plan(df, R, pow(wi, self.n, p))}
        return tabs

    def _local_extend(self, ctx, coeffs: torch.Tensor) -> torch.Tensor:
        """The rank's ext_n/D rows of the extended coset from its n/D
        coefficient rows of m columns [m, C, 16]: R sharded n-point NTTs
        of the scaled rows, interleaved (the module note)."""
        m, C = coeffs.shape[0], coeffs.shape[1]
        R = self.extended_n // self.n
        x = fmul(self.df, coeffs[:, None], self._local_tables(ctx)["ext"])
        y = sharded_ntt(self.df, ctx.mesh, self._mesh_plans(ctx)["fwd"],
                        x.reshape(m * R, C, NLIMBS))
        return y.view(m, R, C, NLIMBS).transpose(1, 2).reshape(
            m, C * R, NLIMBS)

    def extended_to_coeff_pieces(self, values: torch.Tensor, rows
                                 ) -> torch.Tensor:
        """The quotient's coefficients from the rank's ext_n/D rows of the
        extended coset: [R, n/D, 16], row c of piece q the coefficient
        start + c + q n (R n-point sharded inverse NTTs, twiddles and an
        R-point DFT: the module note). On WHOLE, extended_to_coeff's
        coefficients cut into R pieces of n."""
        R = self.extended_n // self.n
        if not rows.local:
            return self.extended_to_coeff(values).view(R, self.n, NLIMBS)
        tabs = self._local_tables(rows)
        C = values.shape[0] // R
        v = values.view(C, R, NLIMBS).transpose(0, 1).contiguous()
        z = sharded_ntt(self.df, rows.mesh, self._mesh_plans(rows)["inv"],
                        v)                                  # [R(j), C, 16]
        u = fmul(self.df, z, tabs["inv"])
        d = ntt_many(self.df, u.transpose(0, 1).contiguous(), tabs["dft"])
        return fmul(self.df, d.transpose(0, 1), tabs["out"])

    def _mesh_ntt(self, ctx, kind: str, x: torch.Tensor, *scales
                  ) -> torch.Tensor:
        """Columns x [m, N, 16] through the four-step NTT `kind` on this
        rank's rows, each product with `scales` (whole-column tables are
        sliced to the rank's rows) on them too; whole columns back."""
        local = sharded_ntt(self.df, ctx.mesh, self._mesh_plans(ctx)[kind],
                            ctx.shard_rows(x, dim=1))
        for s in scales:
            local = fmul(self.df, local,
                         ctx.shard_rows(s) if s.dim() == 2 else s)
        return ctx.gather_rows(local, dim=1)

    def _mesh_l2c(self, ctx, values: torch.Tensor) -> torch.Tensor:
        return self._mesh_ntt(ctx, "inv", values, self._ifft_divisor)

    def _mesh_c2e(self, ctx, coeffs: torch.Tensor) -> torch.Tensor:
        return self._mesh_ntt(ctx, "ext", self._pad_coset(coeffs))

    def _mesh_e2c(self, ctx, values: torch.Tensor) -> torch.Tensor:
        return self._mesh_ntt(ctx, "ext_inv", values, self._ext_ifft_divisor,
                              self._coset_out_ext)

    # ---------------- transforms ----------------
    def _pad_coset(self, coeffs: torch.Tensor) -> torch.Tensor:
        """[m, n, 16] coefficients times the coset's zeta powers, padded
        with zeros to [m, extended_n, 16]."""
        a = fmul(self.df, coeffs, self._coset_in)
        pad = torch.zeros((a.shape[0], self.extended_n - self.n, NLIMBS),
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, pad], dim=1)

    def lagrange_to_coeff_extended_many(self, values_list: list,
                                        rows=WHOLE):
        """m Lagrange vectors -> (m coeff polys, m extended-coset vectors):
        iNTT, 1/n scale, coset zeta powers, zero pad, extended NTT, all m
        columns per launch (in chunks of NTT_BATCH_ELEMS), each transform
        routed by its size (_ntt_dispatch); on a mesh, the two sharded
        four-step NTTs. With `rows` a ProverMesh the vectors are the
        rank's rows, and so are the results (the module note)."""
        m = len(values_list)
        if m == 0:
            return [], []
        m_chunk = max(1, NTT_BATCH_ELEMS // self.extended_n)
        polys, cosets = [], []
        if rows.local:
            for i in range(0, m, m_chunk):
                vals = torch.stack(values_list[i:i + m_chunk], dim=0)
                pc = fmul(self.df, sharded_ntt(
                    self.df, rows.mesh, self._mesh_plans(rows)["inv"], vals),
                    self._ifft_divisor)
                polys.extend(pc.unbind(0))
                cosets.extend(self._local_extend(rows, pc).unbind(0))
            return polys, cosets
        ctx = self._mesh_ctx()
        for i in range(0, m, m_chunk):
            vals = torch.stack(values_list[i:i + m_chunk], dim=0)
            if ctx is not None:
                pc = self._mesh_l2c(ctx, vals)
                ext = self._mesh_c2e(ctx, pc)
            else:
                x = _ntt_dispatch(self.df, vals, self.plan_inv)
                pc = fmul(self.df, x, self._ifft_divisor)
                ext = _ntt_dispatch(self.df, self._pad_coset(pc),
                                    self.plan_ext)
            polys.extend(pc.unbind(0))
            cosets.extend(ext.unbind(0))
        return polys, cosets

    def lagrange_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        assert values.shape[0] == self.n
        ctx = self._mesh_ctx()
        if ctx is not None:
            return self._mesh_l2c(ctx, values.unsqueeze(0))[0]
        x = _ntt_dispatch(self.df, values.unsqueeze(0), self.plan_inv)[0]
        return fmul(self.df, x, self._ifft_divisor)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        ctx = self._mesh_ctx()
        if ctx is not None:
            return self._mesh_ntt(ctx, "fwd", coeffs.unsqueeze(0))[0]
        return _ntt_dispatch(self.df, coeffs.unsqueeze(0), self.plan)[0]

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        assert coeffs.shape[0] == self.n
        ctx = self._mesh_ctx()
        if ctx is not None:
            return self._mesh_c2e(ctx, coeffs.unsqueeze(0))[0]
        return _ntt_dispatch(self.df, self._pad_coset(coeffs.unsqueeze(0)),
                             self.plan_ext)[0]

    def extended_to_coeff(self, values: torch.Tensor) -> torch.Tensor:
        """iNTT + un-coset; returns all extended_n coefficients (caller
        truncates to n * quotient_poly_degree, domain.rs:303-325)."""
        assert values.shape[0] == self.extended_n
        ctx = self._mesh_ctx()
        if ctx is not None:
            return self._mesh_e2c(ctx, values.unsqueeze(0))[0]
        x = _ntt_dispatch(self.df, values.unsqueeze(0),
                          self.plan_ext_inv)[0]
        x = fmul(self.df, x, self._ext_ifft_divisor)
        return fmul(self.df, x, self._coset_out_ext)

    def divide_by_vanishing_poly(self, values: torch.Tensor) -> torch.Tensor:
        """values / t on the extended coset, whole or a rank's rows (a
        block starts at a multiple of the table's 2^(ek - k) rows)."""
        reps = values.shape[0] // self._t_inv.shape[0]
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
