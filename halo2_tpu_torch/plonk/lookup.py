"""Lookup argument (halo2's permuted-pair Plookup variant).

Port of halo2_tpu/plonk/lookup.py (halo2_proofs/src/plonk/lookup/
prover.rs:76-552, verifier.rs:34-208):
  commit_permuted: theta-compress the input and table expressions,
    permute the pair, commit A' and S';
  commit_product: the fraction batch and the running product Z (under
    a ProverMesh whose D^2 divides n, on the rank's rows through
    parallel/mesh.py's sharded inversion and scan);
  h terms: the 5 constraint families on the extended domain;
  evaluate: the 5 evaluations, in the reference's order.

The permuted pair replaces 255-bit comparisons with dense ranks: the
canonical values of the input and table rows, packed MSB-first into six
48-bit words, go through one `torch.unique(dim=0)` (PyTorch's sort, as
the reference leaves its `lax.sort` to XLA), and the first-occurrence and
leftover fill run as static-shape tensor ops on the column's device.
Only the containment flag is read back. `permute_pair_oracle` is the
reference's numpy formulation, kept as the check.

In the prover's sharded state (`rows` a ProverMesh) every column here is
the rank's rows. The compressed input and table are gathered whole for
the permute, a sort of whole columns, and each rank keeps its rows of the
permuted pair; Z's shift by a row and the h terms' rolls take a
neighbour's edge rows (ProverMesh.roll_rows). Given whole columns under a
mesh, the product narrows the rank's rows out and Z is gathered whole.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..fields.device import (DeviceField, NLIMBS, LIMB_BITS, batch_inv,
                             running_product, from_mont, to_mont,
                             digits_to_ints, ints_to_digits)
from ..ops.field_kernels import fadd, fsub, fmul
from ..parallel.context import WHOLE, work_rows
from .circuit import LookupArgument, ConstraintSystem
from .evaluation import evaluate_expression, evaluate_expression_host

NOT_CONTAINED = ("lookup input not contained in table "
                 "(ConstraintSystemFailure)")


@dataclass
class Permuted:
    compressed_input: torch.Tensor     # Lagrange values
    compressed_table: torch.Tensor
    input_expressions: list            # expressions for the coset values
    table_expressions: list
    permuted_input: torch.Tensor       # Lagrange
    permuted_table: torch.Tensor
    permuted_input_poly: torch.Tensor  # coeff
    permuted_table_poly: torch.Tensor
    permuted_input_coset: torch.Tensor
    permuted_table_coset: torch.Tensor
    permuted_input_blind: int
    permuted_table_blind: int


@dataclass
class CommittedLookup:
    permuted: Permuted
    product_poly: torch.Tensor
    product_coset: torch.Tensor
    product_blind: int


def _compress(df, theta_m, arrays):
    """Horner over the expression list: acc = acc * theta + value."""
    acc = None
    for arr in arrays:
        acc = arr if acc is None else fadd(df, fmul(df, acc, theta_m), arr)
    return acc


def lookup_commit_permuted(argument: LookupArgument, cs: ConstraintSystem,
                           params, domain, theta: int, advice, fixed,
                           instance, rng, transcript,
                           sanity: bool = False, rows=WHOLE) -> Permuted:
    """prover.rs:76-243. advice/fixed/instance: lists of [n, 16] Lagrange
    tensors (the rank's rows with `rows` a ProverMesh, as are the
    results). `sanity`: check the permuted pair
    (permute_expression_pair)."""
    df = params.scalar_df
    fs = params.curve.scalar
    n = params.n
    theta_m = df.scalar(theta, params.device)
    count = rows.row_span(n)[1]

    def compressed(exprs):
        acc = _compress(df, theta_m, [
            evaluate_expression(df, e, advice=advice, fixed=fixed,
                                instance=instance, rot_scale=1, rows=rows)
            for e in exprs])
        return acc.expand(count, NLIMBS)   # a constant expression broadcasts

    compressed_input = compressed(argument.input_expressions)
    compressed_table = compressed(argument.table_expressions)
    permuted_input, permuted_table = permute_expression_pair(
        cs, params, rng, rows.gather_rows(compressed_input),
        rows.gather_rows(compressed_table), sanity=sanity)
    permuted_input = rows.local_rows(permuted_input)
    permuted_table = rows.local_rows(permuted_table)

    pi_blind = fs.rand(rng)
    pt_blind = fs.rand(rng)
    pi_comm, pt_comm = params.commit_many(
        [permuted_input, permuted_table], [pi_blind, pt_blind],
        lagrange=True, rows=rows)
    (pi_poly, pt_poly), (pi_coset, pt_coset) = (
        domain.lagrange_to_coeff_extended_many(
            [permuted_input, permuted_table], rows))
    transcript.write_point(pi_comm)
    transcript.write_point(pt_comm)
    return Permuted(
        compressed_input=compressed_input,
        compressed_table=compressed_table,
        input_expressions=argument.input_expressions,
        table_expressions=argument.table_expressions,
        permuted_input=permuted_input, permuted_table=permuted_table,
        permuted_input_poly=pi_poly, permuted_table_poly=pt_poly,
        permuted_input_coset=pi_coset, permuted_table_coset=pt_coset,
        permuted_input_blind=pi_blind, permuted_table_blind=pt_blind)


def _rank_words(canon: torch.Tensor) -> torch.Tensor:
    """Canonical [r, 16] digits -> [r, 6] int64 words of at most 48 bits,
    most significant first, so row order is numeric order."""
    d = canon.to(torch.int64)
    words = [d[:, i] | (d[:, i + 1] << LIMB_BITS) | (d[:, i + 2] << 32)
             for i in range(0, 15, 3)] + [d[:, 15]]
    return torch.stack(words[::-1], dim=1)


def permute_pair_ranks(df: DeviceField, input_mont: torch.Tensor,
                       table_mont: torch.Tensor):
    """The permuted pair of `usable` input and table rows (Montgomery
    [u, 16]) on their device (the reference's _permute_pair_device_fn,
    lookup.py:127-190): (permuted input, permuted table, containment flag
    as a 0-dim bool tensor).

    The input sorted ascending; the first occurrence of each value is
    mirrored in the table column; the repeated rows, taken in ascending
    order, get the leftover table values in descending order (the
    reference's BTreeMap iteration with Vec::pop, lookup.py:273-280)."""
    u = input_mont.shape[0]
    dev = input_mont.device
    union = from_mont(df, torch.cat([input_mont, table_mont], dim=0))
    rep, ranks = torch.unique(_rank_words(union), dim=0, return_inverse=True)
    rep_digits = torch.empty((rep.shape[0], NLIMBS), dtype=union.dtype,
                             device=dev)
    rep_digits[ranks] = union              # every row of a rank is equal
    sent = tracing.upload("lookup", torch.tensor(2 * u, dtype=torch.int64),
                          dev)

    in_ranks = torch.sort(ranks[:u]).values            # sorted input
    tab_ranks = torch.sort(ranks[u:]).values
    first = torch.ones(u, dtype=torch.bool, device=dev)
    first[1:] = in_ranks[1:] != in_ranks[:-1]
    uniq_q = torch.where(first, in_ranks, sent)
    lo = torch.searchsorted(tab_ranks, uniq_q, right=False)
    hi = torch.searchsorted(tab_ranks, uniq_q, right=True)
    ok = (~first | (hi > lo)).all()        # every unique input in the table
    # drop ONE table occurrence per unique input (the positions differ)
    removed = torch.zeros(u + 1, dtype=torch.bool, device=dev)
    removed[torch.where(first, lo, torch.full_like(lo, u))] = True
    leftover = torch.sort(torch.where(removed[:u], sent, tab_ranks)).values
    r_count = u - first.sum()
    j = torch.cumsum((~first).to(torch.int64), dim=0) - 1
    lidx = torch.clamp(r_count - 1 - j, 0, u - 1)
    perm_tab_ranks = torch.where(first, in_ranks, leftover[lidx])
    return (to_mont(df, rep_digits[in_ranks]),
            to_mont(df, rep_digits[perm_tab_ranks]), ok)


def permute_pair_oracle(df: DeviceField, input_mont, table_mont):
    """The reference's numpy formulation (lookup.py:246-297): the
    permuted pair of `usable` rows as Montgomery int32 [u, 16] numpy
    arrays; raises ValueError when an input is not in the table."""
    p = df.spec.modulus
    r = 1 << (NLIMBS * LIMB_BITS)
    rinv = pow(r, -1, p)
    in_vals = [v * rinv % p for v in digits_to_ints(np.asarray(input_mont))]
    tab_vals = [v * rinv % p for v in digits_to_ints(np.asarray(table_mont))]
    usable = len(in_vals)
    allv = np.array([[(v >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
                     for v in in_vals + tab_vals], dtype=np.uint64)
    order = np.lexsort((allv[:, 0], allv[:, 1], allv[:, 2], allv[:, 3]))
    svals = allv[order]
    new_grp = np.ones(len(svals), dtype=bool)
    new_grp[1:] = (svals[1:] != svals[:-1]).any(axis=1)
    ranks = np.empty(len(allv), dtype=np.int64)
    ranks[order] = np.cumsum(new_grp) - 1
    ndistinct = int(ranks.max()) + 1
    rep = [0] * ndistinct
    for rk, v in zip(ranks, in_vals + tab_vals):
        rep[rk] = v

    in_ranks = np.sort(ranks[:usable])
    tab_counts = np.bincount(ranks[usable:], minlength=ndistinct)
    first = np.ones(usable, dtype=bool)
    first[1:] = in_ranks[1:] != in_ranks[:-1]
    uniq = in_ranks[first]
    if (tab_counts[uniq] < 1).any():
        raise ValueError(NOT_CONTAINED)
    leftover = tab_counts.copy()
    leftover[uniq] -= 1
    leftover_ranks = np.repeat(np.arange(ndistinct), leftover)
    repeated = np.nonzero(~first)[0]
    perm_tab_ranks = in_ranks.copy()
    perm_tab_ranks[repeated] = leftover_ranks[::-1]
    return tuple(ints_to_digits([rep[rk] * r % p for rk in rks])
                 for rks in (in_ranks, perm_tab_ranks))


def check_permuted_pair(pi_body: torch.Tensor, pt_body: torch.Tensor
                        ) -> None:
    """The debug check of a permuted pair (lookup/prover.rs:628-641, the
    reference's HALO2_TPU_SANITY check, halo2_tpu/plonk/lookup.py:282-289):
    every usable row has A'[i] == S'[i] or A'[i] == A'[i-1]. Montgomery
    digits are canonical, so equal digits are equal values; one bool is
    read back."""
    eq_ts = (pi_body == pt_body).all(dim=-1)
    eq_prev = torch.zeros_like(eq_ts)
    eq_prev[1:] = (pi_body[1:] == pi_body[:-1]).all(dim=-1)
    if not bool((eq_ts | eq_prev).all()):
        raise AssertionError("permuted pair violates A'==S' or A'==A'_prev")


def check_lookup_product(df, z: torch.Tensor, usable: int, rows=WHOLE
                         ) -> None:
    """The debug check of a lookup product (lookup/prover.rs:339-376, the
    reference's halo2_tpu/plonk/lookup.py:372-380): Z starts at 1 and
    closes to 1 at the last usable row boundary. Two rows are read
    back."""
    ends = df.from_mont_np(torch.stack([rows.fetch_row(z, 0),
                                        rows.fetch_row(z, usable)]))
    if int(ends[0]) != 1:
        raise AssertionError("lookup z[0] != 1")
    if int(ends[1]) != 1:
        raise AssertionError(
            "lookup grand product does not telescope (z[u] != 1)")


def permute_expression_pair(cs: ConstraintSystem, params, rng,
                            input_values: torch.Tensor,
                            table_values: torch.Tensor,
                            sanity: bool = False):
    """prover.rs:563-647: the permuted pair of the usable rows, then the
    blinding rows -- `blinding_factors + 1` input blinds, then as many
    table blinds, each through fs.rand (the reference's draw order).
    `sanity`: check_permuted_pair on the usable rows."""
    df = params.scalar_df
    fs = params.curve.scalar
    n = params.n
    blinding_factors = cs.blinding_factors()
    usable = n - (blinding_factors + 1)
    pi_body, pt_body, ok = permute_pair_ranks(
        df, input_values[:usable], table_values[:usable])
    if not bool(ok):
        raise ValueError(NOT_CONTAINED)
    if sanity:
        check_permuted_pair(pi_body, pt_body)
    dev = input_values.device
    pi_blinds = [fs.rand(rng) for _ in range(blinding_factors + 1)]
    pt_blinds = [fs.rand(rng) for _ in range(blinding_factors + 1)]
    blinds = [df.upload_values(b, dev, site="lookup_blinds")
              for b in (pi_blinds, pt_blinds)]
    return (torch.cat([pi_body, blinds[0]], dim=0),
            torch.cat([pt_body, blinds[1]], dim=0))


def lookup_commit_product(permuted: Permuted, cs: ConstraintSystem, params,
                          domain, beta: int, gamma: int, rng, transcript,
                          sanity: bool = False, rows=WHOLE
                          ) -> CommittedLookup:
    """prover.rs:253-392: Z = the exclusive running product of
    (A_c + beta)(S_c + gamma) / ((A' + beta)(S' + gamma)), then
    `blinding_factors` blinds and the product blind. `sanity`:
    check_lookup_product. The columns are the rank's rows with `rows` a
    ProverMesh, as are the results."""
    df = params.scalar_df
    fs = params.curve.scalar
    n = params.n
    dev = params.device
    blinding_factors = cs.blinding_factors()
    beta_m = df.scalar(beta, dev)
    gamma_m = df.scalar(gamma, dev)
    work, narrow = work_rows(rows, n)
    take = work.shard_rows if narrow else (lambda t: t)
    denom = fmul(df, fadd(df, take(permuted.permuted_input), beta_m),
                 fadd(df, take(permuted.permuted_table), gamma_m))
    frac = fmul(df, fadd(df, take(permuted.compressed_input), beta_m),
                fadd(df, take(permuted.compressed_table), gamma_m))
    if work.local:
        incl = work.inclusive_product(
            df, fmul(df, work.batch_inv(df, denom), frac))
    else:
        incl = running_product(
            df, fmul(df, batch_inv(df, denom, axis=0), frac), axis=0)
    # Z: 1, then the products of rows 0..u-1 (u usable rows), then blinds
    blinds = [fs.rand(rng) for _ in range(blinding_factors)]
    z = work.put_rows(work.roll_rows(incl, 1), 0, df.scalar(1, dev)[None])
    z = work.put_rows(z, n - blinding_factors,
                      df.upload_values(blinds, dev, site="lookup_blinds"))
    if sanity:
        check_lookup_product(df, z, n - (blinding_factors + 1), work)
    if narrow:
        z = work.gather_rows(z)
    product_blind = fs.rand(rng)
    (commitment,) = params.commit_many([z], [product_blind], lagrange=True,
                                       rows=rows)
    (z_poly,), (z_coset,) = domain.lagrange_to_coeff_extended_many([z],
                                                                  rows)
    transcript.write_point(commitment)
    return CommittedLookup(permuted=permuted, product_poly=z_poly,
                           product_coset=z_coset, product_blind=product_blind)


def lookup_h_terms(committed: CommittedLookup, domain, theta: int,
                   beta: int, gamma: int, advice_cosets, fixed_cosets,
                   instance_cosets, l0, l_blind, l_last, rows=WHOLE
                   ) -> list:
    """prover.rs:401-477: the 5 constraint families on the extended
    domain (the rank's rows with `rows` a ProverMesh)."""
    df = domain.df
    dev = domain.device
    rot_scale = 1 << (domain.extended_k - domain.k)
    ext_n = rows.row_span(domain.extended_n)[1]
    one = df.scalar(1, dev)
    perm = committed.permuted
    theta_m = df.scalar(theta, dev)
    beta_m = df.scalar(beta, dev)
    gamma_m = df.scalar(gamma, dev)

    def coset_of(exprs):
        acc = _compress(df, theta_m, [
            evaluate_expression(df, e, advice=advice_cosets,
                                fixed=fixed_cosets, instance=instance_cosets,
                                rot_scale=rot_scale, rows=rows)
            for e in exprs])
        return acc.expand(ext_n, NLIMBS)

    compressed_input_coset = coset_of(perm.input_expressions)
    compressed_table_coset = coset_of(perm.table_expressions)

    active = fsub(df, one, fadd(df, l_last, l_blind))
    z = committed.product_coset
    z_next = rows.roll_rows(z, -rot_scale)
    a_prime = perm.permuted_input_coset
    s_prime = perm.permuted_table_coset
    a_prev = rows.roll_rows(a_prime, rot_scale)
    a_minus_s = fsub(df, a_prime, s_prime)

    # l_0(X) (1 - z(X))
    out = [fmul(df, fsub(df, one, z), l0)]
    # l_last(X) (z(X)^2 - z(X))
    out.append(fmul(df, fsub(df, fmul(df, z, z), z), l_last))
    # active (z(wX)(a' + beta)(s' + gamma) - z(X)(A_c + beta)(S_c + gamma))
    left = fmul(df, z_next, fmul(df, fadd(df, a_prime, beta_m),
                                 fadd(df, s_prime, gamma_m)))
    right = fmul(df, z, fmul(df, fadd(df, compressed_input_coset, beta_m),
                             fadd(df, compressed_table_coset, gamma_m)))
    out.append(fmul(df, fsub(df, left, right), active))
    # l_0(X) (a'(X) - s'(X))
    out.append(fmul(df, a_minus_s, l0))
    # active (a'(X) - s'(X)) (a'(X) - a'(w^-1 X))
    out.append(fmul(df, fmul(df, a_minus_s, fsub(df, a_prime, a_prev)),
                    active))
    return out


def lookup_evaluate(committed: CommittedLookup, domain, x: int, transcript,
                    eval_fn) -> None:
    """prover.rs:481-510: the 5 evaluations in transcript order."""
    x_inv = domain.rotate_omega(x, -1)
    x_next = domain.rotate_omega(x, 1)
    perm = committed.permuted
    for poly, point in ((committed.product_poly, x),
                        (committed.product_poly, x_next),
                        (perm.permuted_input_poly, x),
                        (perm.permuted_input_poly, x_inv),
                        (perm.permuted_table_poly, x)):
        transcript.write_scalar(eval_fn(poly, point))


def lookup_verifier_expressions(argument: LookupArgument, fs, evals: dict,
                                advice_evals, fixed_evals, instance_evals,
                                l0: int, l_last: int, l_blind: int,
                                theta: int, beta: int, gamma: int
                                ) -> list[int]:
    """verifier.rs:94-167 on host scalars."""
    p = fs.modulus
    active = (1 - (l_last + l_blind)) % p

    def compress(exprs):
        acc = 0
        for e in exprs:
            v = evaluate_expression_host(
                fs, e, advice_evals=advice_evals, fixed_evals=fixed_evals,
                instance_evals=instance_evals)
            acc = (acc * theta + v) % p
        return acc

    z = evals["product_eval"]
    z_next = evals["product_next_eval"]
    a_prime = evals["permuted_input_eval"]
    a_prev = evals["permuted_input_inv_eval"]
    s_prime = evals["permuted_table_eval"]
    left = z_next * ((a_prime + beta) % p) % p * ((s_prime + gamma) % p) % p
    right = z * ((compress(argument.input_expressions) + beta) % p) % p \
        * ((compress(argument.table_expressions) + gamma) % p) % p
    return [l0 * (1 - z) % p,
            l_last * (z * z - z) % p,
            (left - right) * active % p,
            l0 * (a_prime - s_prime) % p,
            (a_prime - s_prime) * (a_prime - a_prev) % p * active % p]
