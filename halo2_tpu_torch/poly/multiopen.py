"""Multipoint opening argument: batch many (poly, point, eval) claims into
one IPA opening.

Reference: halo2_proofs/src/poly/multiopen.rs (+ prover.rs, verifier.rs).
The combinatorial core `construct_intermediate_sets` (multiopen.rs:152-276)
is reproduced exactly: commitments keyed by identity in insertion order
(IndexMap), points ordered by field-integer value (BTreeMap), point-sets
de-duplicated with set indices in first-appearance order. Challenge
schedule: x1 (collapse same-point-set polys), x2 (independent q' terms),
x3 (opening point), x4 (final fold) — multiopen.rs:20-39.

Port of halo2_tpu/poly/multiopen.py: the q-poly accumulation, chained
Kate divisions and evaluations run on the device; the set bookkeeping is
host-side O(#queries).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from ..fields.host import FieldSpec
from ..fields.device import NLIMBS
from ..ops.field_kernels import fadd, fmul
from .commitment import (Params, MSMAccumulator, NATIVE_IPA_THRESHOLD,
                         ipa_create_proof, ipa_verify_proof, Guard)
from .utils import kate_division, batch_eval_polys


@dataclass
class ProverQuery:
    point: int                # host scalar
    poly: Any                 # [n, 16] mont coeff tensor (identity-keyed)
    blind: int


@dataclass
class VerifierQuery:
    point: int
    commitment: Any           # Point tuple or MSMAccumulator (identity-keyed)
    eval: int

    def key(self):
        # identity (pointer) keying, like the reference's
        # CommitmentReference PartialEq (multiopen.rs:96-116): the same
        # commitment OBJECT queried at several points groups together;
        # equal-valued but distinct commitments do not merge.
        return id(self.commitment)


@dataclass
class CommitmentData:
    commitment: Any
    set_index: int = 0
    point_indices: list = field(default_factory=list)
    evals: list = field(default_factory=list)


def construct_intermediate_sets(queries, get_point, get_eval, get_key,
                                track_evals: bool = True):
    """Exact port of multiopen.rs:152-276. Returns (commitment_data list in
    first-appearance order, point_sets list of point lists) or None on
    conflicting evaluations."""
    commitment_map: dict = {}       # key -> CommitmentData (insertion order)
    point_index_map: dict = {}      # point -> index (ordering on points)

    for q in queries:
        pt = get_point(q)
        if pt not in point_index_map:
            point_index_map[pt] = len(point_index_map)
        key = get_key(q)
        if key not in commitment_map:
            commitment_map[key] = CommitmentData(commitment=q)
        commitment_map[key].point_indices.append(point_index_map[pt])

    inverse_point_index_map = {v: k for k, v in point_index_map.items()}

    point_idx_sets: dict = {}       # frozen sorted tuple -> set_idx
    commitment_set_map: dict = {}   # key -> sorted tuple of point indices
    for key, cdata in commitment_map.items():
        pis = tuple(sorted(set(cdata.point_indices)))
        commitment_set_map[key] = pis
        if pis not in point_idx_sets:
            point_idx_sets[pis] = len(point_idx_sets)
        cdata.evals = [None] * len(pis)

    for q in queries:
        key = get_key(q)
        cdata = commitment_map[key]
        point_index = point_index_map[get_point(q)]
        pis = commitment_set_map[key]
        cdata.set_index = point_idx_sets[pis]
        pos = pis.index(point_index)
        if not track_evals:
            continue
        if cdata.evals[pos] is None:
            cdata.evals[pos] = get_eval(q)
        elif cdata.evals[pos] != get_eval(q):
            return None
    if track_evals:
        for cdata in commitment_map.values():
            if any(e is None for e in cdata.evals):
                return None

    point_sets = [None] * len(point_idx_sets)
    for pis, set_idx in point_idx_sets.items():
        point_sets[set_idx] = [inverse_point_index_map[i] for i in pis]

    return list(commitment_map.values()), point_sets


def lagrange_interpolate(fs: FieldSpec, points: list[int],
                         evals: list[int]) -> list[int]:
    """O(n^2) interpolation (arithmetic.rs:379-432); host-side — point sets
    are tiny (<= number of distinct rotations)."""
    p = fs.modulus
    assert len(points) == len(evals)
    if len(points) == 1:
        return [evals[0] % p]
    denoms = []
    for j, xj in enumerate(points):
        d = 1
        for k, xk in enumerate(points):
            if k != j:
                d = d * ((xj - xk) % p) % p
        denoms.append(pow(d, p - 2, p))
    final = [0] * len(points)
    for j, (xj, ev) in enumerate(zip(points, evals)):
        # numerator poly prod_{k != j} (X - x_k)
        num = [1]
        for k, xk in enumerate(points):
            if k != j:
                new = [0] * (len(num) + 1)
                for i, c in enumerate(num):
                    new[i + 1] = (new[i + 1] + c) % p
                    new[i] = (new[i] - c * xk) % p
                num = new
        coef = ev * denoms[j] % p
        for i, c in enumerate(num):
            final[i] = (final[i] + c * coef) % p
    return final


def multiopen_create_proof(params: Params, rng, transcript,
                           queries: list[ProverQuery],
                           native_ipa_threshold: int = NATIVE_IPA_THRESHOLD
                           ) -> None:
    """multiopen/prover.rs:21-122; native_ipa_threshold as
    ipa_create_proof's."""
    df = params.scalar_df
    fs = params.curve.scalar
    n = params.n

    x1 = transcript.squeeze_challenge()
    x2 = transcript.squeeze_challenge()

    result = construct_intermediate_sets(
        queries, get_point=lambda q: q.point,
        get_eval=lambda q: None, get_key=lambda q: id(q.poly),
        track_evals=False)
    assert result is not None
    poly_map, point_sets = result

    dev = queries[0].poly.device
    x1_m = df.scalar(x1, dev)
    q_polys: list = [None] * len(point_sets)
    q_blinds = [0] * len(point_sets)
    for cdata in poly_map:
        q: ProverQuery = cdata.commitment
        si = cdata.set_index
        if q_polys[si] is None:
            q_polys[si] = q.poly
        else:
            q_polys[si] = fadd(df, fmul(df, q_polys[si], x1_m), q.poly)
        q_blinds[si] = (q_blinds[si] * x1 + q.blind) % fs.modulus

    # q'(X): chained Kate divisions per point set, folded with x2
    x2_m = df.scalar(x2, dev)
    q_prime = None
    for points, qp in zip(point_sets, q_polys):
        poly = qp
        for point in points:
            poly = kate_division(df, poly, point)
        pad = torch.zeros((n - poly.shape[0], NLIMBS), dtype=poly.dtype,
                          device=dev)
        poly = torch.cat([poly, pad], dim=0)
        if q_prime is None:
            q_prime = poly
        else:
            q_prime = fadd(df, fmul(df, q_prime, x2_m), poly)

    q_prime_blind = fs.rand(rng)
    transcript.write_point(params.commit(q_prime, q_prime_blind))

    x3 = transcript.squeeze_challenge()
    for ev in batch_eval_polys(df, [(qp, x3) for qp in q_polys]):
        transcript.write_scalar(ev)

    x4 = transcript.squeeze_challenge()
    x4_m = df.scalar(x4, dev)
    p_poly = q_prime
    p_blind = q_prime_blind
    for qp, blind in zip(q_polys, q_blinds):
        p_poly = fadd(df, fmul(df, p_poly, x4_m), qp)
        p_blind = (p_blind * x4 + blind) % fs.modulus

    ipa_create_proof(params, rng, transcript, p_poly, p_blind, x3,
                     native_ipa_threshold)


def multiopen_verify_proof(params: Params, transcript,
                           queries: list[VerifierQuery],
                           msm: MSMAccumulator) -> Guard:
    """multiopen/verifier.rs:15-134."""
    fs = params.curve.scalar
    q = fs.modulus

    x1 = transcript.squeeze_challenge()
    x2 = transcript.squeeze_challenge()

    result = construct_intermediate_sets(
        queries, get_point=lambda vq: vq.point,
        get_eval=lambda vq: vq.eval, get_key=lambda vq: vq.key())
    assert result is not None
    commitment_map, point_sets = result

    q_commitments = [params.empty_msm() for _ in point_sets]
    x1_powers = [1] * len(point_sets)
    q_eval_sets = [[0] * len(ps) for ps in point_sets]

    # run in order of increasing x1 powers (verifier iterates .rev())
    for cdata in reversed(commitment_map):
        vq: VerifierQuery = cdata.commitment
        si = cdata.set_index
        power = x1_powers[si]
        if isinstance(vq.commitment, MSMAccumulator):
            scaled = vq.commitment.clone()
            scaled.scale(power)
            q_commitments[si].add_msm(scaled)
        else:
            q_commitments[si].append_term(power, vq.commitment)
        for i, ev in enumerate(cdata.evals):
            q_eval_sets[si][i] = (q_eval_sets[si][i] + ev * power) % q
        x1_powers[si] = power * x1 % q

    q_prime_commitment = transcript.read_point()
    x3 = transcript.squeeze_challenge()
    u = [transcript.read_scalar() for _ in range(len(q_eval_sets))]

    msm_eval = 0
    for points, evals, proof_eval in zip(point_sets, q_eval_sets, u):
        r_poly = lagrange_interpolate(fs, points, evals)
        r_eval = 0
        for c in reversed(r_poly):
            r_eval = (r_eval * x3 + c) % q
        ev = (proof_eval - r_eval) % q
        for point in points:
            ev = ev * pow((x3 - point) % q, q - 2, q) % q
        msm_eval = (msm_eval * x2 + ev) % q

    x4 = transcript.squeeze_challenge()
    msm.append_term(1, q_prime_commitment)
    v = msm_eval
    for q_commitment, q_eval in zip(q_commitments, u):
        msm.scale(x4)
        msm.add_msm(q_commitment)
        v = (v * x4 + q_eval) % q

    return ipa_verify_proof(params, msm, transcript, x3, v)
