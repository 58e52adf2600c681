"""Permutation argument: global copy constraints via chunked grand products.

Port of halo2_tpu/plonk/permutation.py (halo2_proofs/src/plonk/permutation/
keygen.rs:16-211, prover.rs:47-312, verifier.rs:33-241), without the mesh
branches. The sigma tables are a device outer product (delta powers x
omega powers) gathered through the host-built cycle mapping; each chunk's
z is one batched inversion, elementwise products and an inclusive product
scan scaled by the chained last_z.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields.device import (DeviceField, NLIMBS, batch_inv,
                             running_product)
from ..ops.field_kernels import fadd, fsub, fmul
from ..poly.utils import powers, eval_poly
from ..poly.domain import EvaluationDomain
from .circuit import (ConstraintSystem, Column, PermutationArgument,
                      ADVICE, FIXED, INSTANCE)


class PermutationAssembly:
    """Cycle-tracking assignment sink (keygen.rs:16-100)."""

    def __init__(self, n: int, argument: PermutationArgument):
        m = len(argument.columns)
        self.n = n
        self.columns = list(argument.columns)
        self.col_index = {c: i for i, c in enumerate(self.columns)}
        # mapping/aux as int32 [m, n] pairs
        idx = np.tile(np.arange(n, dtype=np.int64)[None, :], (m, 1))
        cols = np.tile(np.arange(m, dtype=np.int64)[:, None], (1, n))
        self.map_col = cols.copy()
        self.map_row = idx.copy()
        self.aux_col = cols.copy()
        self.aux_row = idx.copy()
        self.sizes = np.ones((m, n), dtype=np.int64)

    def copy(self, left_column: Column, left_row: int,
             right_column: Column, right_row: int) -> None:
        if left_column not in self.col_index:
            raise ValueError(f"column {left_column} not in permutation")
        if right_column not in self.col_index:
            raise ValueError(f"column {right_column} not in permutation")
        lc = self.col_index[left_column]
        rc = self.col_index[right_column]
        if left_row >= self.n or right_row >= self.n:
            raise IndexError("copy row out of bounds")

        left_cycle = (self.aux_col[lc, left_row], self.aux_row[lc, left_row])
        right_cycle = (self.aux_col[rc, right_row],
                       self.aux_row[rc, right_row])
        if left_cycle == right_cycle:
            return
        if (self.sizes[left_cycle] < self.sizes[right_cycle]):
            left_cycle, right_cycle = right_cycle, left_cycle
        self.sizes[left_cycle] += self.sizes[right_cycle]
        i = right_cycle
        while True:
            self.aux_col[i], self.aux_row[i] = left_cycle
            i = (self.map_col[i], self.map_row[i])
            if i == right_cycle:
                break
        lpos = (lc, left_row)
        rpos = (rc, right_row)
        tmp = (self.map_col[lpos], self.map_row[lpos])
        self.map_col[lpos], self.map_row[lpos] = (self.map_col[rpos],
                                                  self.map_row[rpos])
        self.map_col[rpos], self.map_row[rpos] = tmp

    # ---- sigma polynomial construction (keygen.rs:102-211) ----
    def sigma_lagrange(self, df: DeviceField, domain: EvaluationDomain
                       ) -> list:
        """One [n, 16] sigma tensor per permutation column: the
        delta^i * omega^j table gathered through the cycle mapping."""
        m, n = len(self.columns), self.n
        dev = domain.device
        omega_pow = powers(df, domain.omega, n, dev)              # [n, 16]
        delta_pow = powers(df, df.spec.delta, m, dev)             # [m, 16]
        flat = fmul(df, delta_pow[:, None, :],
                    omega_pow[None, :, :]).reshape(-1, NLIMBS)
        return [flat.index_select(0, torch.as_tensor(
                    self.map_col[i] * n + self.map_row[i], device=dev))
                for i in range(m)]


def build_vk(params, domain: EvaluationDomain, assembly: PermutationAssembly):
    """Commit to the sigma columns unblinded (keygen.rs:102-153)."""
    from ..poly.commitment import DEFAULT_BLIND
    if not assembly.columns:
        return []
    sigmas = assembly.sigma_lagrange(params.scalar_df, domain)
    return params.commit_many(sigmas, [DEFAULT_BLIND] * len(sigmas),
                              lagrange=True)


@dataclass
class PermutationProvingKey:
    permutations: list   # sigma in Lagrange basis
    polys: list          # sigma in coeff basis
    cosets: list         # sigma in extended-coset basis


def build_pk(params, domain: EvaluationDomain,
             assembly: PermutationAssembly) -> PermutationProvingKey:
    sigmas = assembly.sigma_lagrange(params.scalar_df, domain)
    polys, cosets = domain.lagrange_to_coeff_extended_many(sigmas)
    return PermutationProvingKey(permutations=sigmas, polys=polys,
                                 cosets=cosets)


@dataclass
class CommittedSet:
    z_lagrange: torch.Tensor
    z_poly: torch.Tensor      # coeff basis
    z_coset: torch.Tensor     # extended basis
    blind: int


def _values_for(column: Column, advice, fixed, instance):
    return {ADVICE: advice, FIXED: fixed, INSTANCE: instance}[
        column.column_type][column.index]


def _z_chunk(df: DeviceField, vals, sigs, beta_m, gamma_m, lastz_m,
             deltas_m, omega_pow) -> torch.Tensor:
    """One chunk's z: the denominator fractions' batched inversion, the
    numerator products, and the inclusive running product scaled by the
    chained last_z. vals/sigs [cl, n, 16]; deltas_m [cl, 16] =
    beta * delta^{global column} in Montgomery form."""
    cl = vals.shape[0]
    den = fadd(df, vals, fadd(df, fmul(df, sigs, beta_m), gamma_m))
    num = fadd(df, vals, fadd(df, fmul(df, omega_pow[None],
                                       deltas_m[:, None, :]), gamma_m))
    modified = den[0]
    for j in range(1, cl):
        modified = fmul(df, modified, den[j])
    modified = batch_inv(df, modified, axis=0)
    for j in range(cl):
        modified = fmul(df, modified, num[j])
    incl = running_product(df, modified, axis=0)
    return torch.cat([lastz_m[None], fmul(df, incl[:-1], lastz_m)], dim=0)


def permutation_commit(cs: ConstraintSystem, params, domain,
                       pkey: PermutationProvingKey,
                       advice, fixed, instance,
                       beta: int, gamma: int, rng, transcript
                       ) -> list[CommittedSet]:
    """prover.rs:47-194. advice/fixed/instance: lists of [n, 16] Lagrange
    tensors. One z per chunk (serial through last_z); the commitments and
    transforms of all chunks are then batched, and the points written in
    order."""
    df = params.scalar_df
    fs = params.curve.scalar
    n = params.n
    dev = params.device
    p = df.spec.modulus
    assert cs.degree() >= 3
    chunk_len = cs.degree() - 2
    blinding_factors = cs.blinding_factors()
    columns = cs.permutation.columns

    beta_m = df.scalar(beta, dev)
    gamma_m = df.scalar(gamma, dev)
    omega_pow = powers(df, domain.omega, n, dev)

    global_col = 0          # delta exponent carried across chunks
    last_z = 1
    z_arrays: list = []
    blinds_out: list[int] = []
    for chunk_start in range(0, len(columns), chunk_len):
        chunk = columns[chunk_start:chunk_start + chunk_len]
        perms = pkey.permutations[chunk_start:chunk_start + chunk_len]
        cl = len(chunk)
        vals = torch.stack([_values_for(c, advice, fixed, instance)
                            for c in chunk], dim=0)
        sigs = torch.stack(perms, dim=0)
        deltas = [beta * pow(df.spec.delta, global_col + j, p) % p
                  for j in range(cl)]
        global_col += cl
        deltas_m = torch.from_numpy(df.to_mont_np(deltas)).to(dev)
        z = _z_chunk(df, vals, sigs, beta_m, gamma_m,
                     df.scalar(last_z, dev), deltas_m, omega_pow)
        # blinding rows
        blinds = [fs.rand(rng) for _ in range(blinding_factors)]
        z = torch.cat([z[:n - blinding_factors],
                       torch.from_numpy(df.to_mont_np(blinds)).to(dev)],
                      dim=0)
        last_z = int(df.from_mont_np(z[n - (blinding_factors + 1)]))
        z_arrays.append(z)
        blinds_out.append(fs.rand(rng))

    commitments = params.commit_many(z_arrays, blinds_out, lagrange=True)
    z_polys, z_cosets = domain.lagrange_to_coeff_extended_many(z_arrays)
    sets: list[CommittedSet] = []
    for z, zp, zc, blind, commitment in zip(z_arrays, z_polys, z_cosets,
                                            blinds_out, commitments):
        transcript.write_point(commitment)
        sets.append(CommittedSet(z_lagrange=z, z_poly=zp, z_coset=zc,
                                 blind=blind))
    return sets


def permutation_h_terms(cs: ConstraintSystem, domain, pkey,
                        sets: list[CommittedSet],
                        advice_cosets, fixed_cosets, instance_cosets,
                        l0, l_blind, l_last, coset_pts,
                        beta: int, gamma: int) -> list:
    """The 4 constraint families (prover.rs:199-312) as extended tensors."""
    df = domain.df
    dev = domain.device
    p = df.spec.modulus
    rot_scale = 1 << (domain.extended_k - domain.k)
    chunk_len = cs.degree() - 2
    last_rot = -(cs.blinding_factors() + 1)
    columns = cs.permutation.columns
    one = df.scalar(1, dev)
    beta_m = df.scalar(beta, dev)
    gamma_m = df.scalar(gamma, dev)

    out = []
    if sets:
        # l_0(X) * (1 - z_0(X))
        out.append(fmul(df, fsub(df, one, sets[0].z_coset), l0))
        # l_last(X) * (z_l(X)^2 - z_l(X))
        zl = sets[-1].z_coset
        out.append(fmul(df, fsub(df, fmul(df, zl, zl), zl), l_last))
        # l_0(X) * (z_i(X) - z_{i-1}(omega^last X))
        for prev, cur in zip(sets, sets[1:]):
            rolled = torch.roll(prev.z_coset, -last_rot * rot_scale, dims=0)
            out.append(fmul(df, fsub(df, cur.z_coset, rolled), l0))
        # product rule per chunk
        active = fsub(df, one, fadd(df, l_last, l_blind))
        for chunk_index, chunk_start in enumerate(
                range(0, len(columns), chunk_len)):
            chunk = columns[chunk_start:chunk_start + chunk_len]
            cosets = pkey.cosets[chunk_start:chunk_start + chunk_len]
            s = sets[chunk_index]
            left = torch.roll(s.z_coset, -rot_scale, dims=0)
            for column, sigma_coset in zip(chunk, cosets):
                values = _values_for(column, advice_cosets, fixed_cosets,
                                     instance_cosets)
                left = fmul(df, left, fadd(df, values, fadd(
                    df, fmul(df, sigma_coset, beta_m), gamma_m)))
            right = s.z_coset
            cur_delta = beta * pow(df.spec.delta, chunk_index * chunk_len,
                                   p) % p
            for column in chunk:
                values = _values_for(column, advice_cosets, fixed_cosets,
                                     instance_cosets)
                lin = fmul(df, coset_pts, df.scalar(cur_delta, dev))
                right = fmul(df, right, fadd(df, values,
                                             fadd(df, lin, gamma_m)))
                cur_delta = cur_delta * df.spec.delta % p
            out.append(fmul(df, fsub(df, left, right), active))
    return out


def permutation_evaluate(sets: list[CommittedSet], domain, cs, x: int,
                         df, transcript, eval_fn=None) -> None:
    """prover.rs:341-384 eval order: per set (x, omega x[, omega^last x])."""
    blinding_factors = cs.blinding_factors()
    x_next = domain.rotate_omega(x, 1)
    x_last = domain.rotate_omega(x, -(blinding_factors + 1))
    eval_fn = eval_fn or (lambda poly, pt: eval_poly(df, poly, pt))
    for i, s in enumerate(sets):
        transcript.write_scalar(eval_fn(s.z_poly, x))
        transcript.write_scalar(eval_fn(s.z_poly, x_next))
        if i < len(sets) - 1:
            transcript.write_scalar(eval_fn(s.z_poly, x_last))


def permutation_pk_evaluate(pkey: PermutationProvingKey, df, x: int,
                            transcript, eval_fn=None) -> None:
    """sigma-poly evals at x (prover.rs:315-339)."""
    eval_fn = eval_fn or (lambda poly, pt: eval_poly(df, poly, pt))
    for poly in pkey.polys:
        transcript.write_scalar(eval_fn(poly, x))


def permutation_verifier_expressions(
        cs: ConstraintSystem, fs, sets_evals, common_evals,
        advice_evals, fixed_evals, instance_evals,
        l0: int, l_last: int, l_blind: int,
        beta: int, gamma: int, x: int) -> list[int]:
    """verifier.rs:103-191 on host scalars. `sets_evals` is a list of dicts
    with keys eval/next_eval/last_eval."""
    p = fs.modulus
    chunk_len = cs.degree() - 2
    columns = cs.permutation.columns
    out = []
    if sets_evals:
        out.append(l0 * (1 - sets_evals[0]["eval"]) % p)
        zl = sets_evals[-1]["eval"]
        out.append((zl * zl - zl) * l_last % p)
        for prev, cur in zip(sets_evals, sets_evals[1:]):
            out.append((cur["eval"] - prev["last_eval"]) * l0 % p)
        for chunk_index, chunk_start in enumerate(
                range(0, len(columns), chunk_len)):
            chunk = columns[chunk_start:chunk_start + chunk_len]
            perm_evals = common_evals[chunk_start:chunk_start + chunk_len]
            s = sets_evals[chunk_index]
            left = s["next_eval"]
            for column, perm_eval in zip(chunk, perm_evals):
                idx = cs.get_any_query_index(column)
                ev = {ADVICE: advice_evals, FIXED: fixed_evals,
                      INSTANCE: instance_evals}[column.column_type][idx]
                left = left * ((ev + beta * perm_eval + gamma) % p) % p
            right = s["eval"]
            cur_delta = (beta * x % p) * pow(fs.delta,
                                             chunk_index * chunk_len, p) % p
            for column in chunk:
                idx = cs.get_any_query_index(column)
                ev = {ADVICE: advice_evals, FIXED: fixed_evals,
                      INSTANCE: instance_evals}[column.column_type][idx]
                right = right * ((ev + cur_delta + gamma) % p) % p
                cur_delta = cur_delta * fs.delta % p
            out.append((left - right) * (1 - (l_last + l_blind)) % p)
    return out
