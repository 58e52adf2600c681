"""The PLONK verifier + verification strategies.

Port of halo2_tpu/plonk/verifier.py (halo2_proofs/src/plonk/verifier.rs:
22-347 with vanishing/, permutation/ and lookup/verifier.rs). The verifier
commits the instance columns on the Params device, replays the
transcript, evaluates every constraint on host scalars, reconstructs the
expected h(x) = (y-fold of expressions)/(x^n - 1), and defers everything
into one MSM. Strategies: SingleVerifier, AccumulatorStrategy and
BatchVerifier (halo2_tpu/plonk/verifier.py:230-301)."""
from __future__ import annotations

import random

from ..poly.commitment import Params, MSMAccumulator, DEFAULT_BLIND
from ..poly.multiopen import VerifierQuery, multiopen_verify_proof
from ..transcript import TranscriptError, TranscriptRead
from .error import Error
from .keys import VerifyingKey
from .evaluation import evaluate_expression_host
from .permutation import permutation_verifier_expressions
from .lookup import lookup_verifier_expressions


class VerificationError(Exception):
    pass


def verify_proof(params: Params, vk: VerifyingKey, strategy,
                 instances: list[list[list[int]]], transcript):
    """plonk/verifier.rs:67-347. `strategy` is a SingleVerifier, an
    AccumulatorStrategy or any object whose process(f) takes the function
    from an empty MSMAccumulator to the opening's Guard."""
    cs = vk.cs
    fs = params.curve.scalar
    df = params.scalar_df
    p = fs.modulus
    domain = vk.domain
    n = params.n

    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise VerificationError("invalid instances")
    # instance commitments (common)
    instance_commitments = []
    for inst in instances:
        lags = []
        for values in inst:
            if len(values) > n - (cs.blinding_factors() + 1):
                raise VerificationError("InstanceTooLarge")
            padded = list(values) + [0] * (n - len(values))
            lags.append(df.upload_values(padded, params.device))
        instance_commitments.append(params.commit_many(
            lags, [DEFAULT_BLIND] * len(lags), lagrange=True))
    num_proofs = len(instances)

    vk.hash_into(transcript)
    for comms in instance_commitments:
        for c in comms:
            transcript.common_point(c)

    advice_commitments = [transcript.read_n_points(cs.num_advice_columns)
                          for _ in range(num_proofs)]
    theta = transcript.squeeze_challenge()
    lookups_permuted = [
        [(transcript.read_point(), transcript.read_point())
         for _ in cs.lookups]
        for _ in range(num_proofs)]

    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # permutation z commitments: chunked count
    chunk_len = cs.degree() - 2
    num_perm_sets = ((len(cs.permutation.columns) + chunk_len - 1)
                     // chunk_len)
    permutations_committed = [transcript.read_n_points(num_perm_sets)
                              for _ in range(num_proofs)]
    lookups_committed = [
        [(pi, pt, transcript.read_point()) for pi, pt in per_proof]
        for per_proof in lookups_permuted]

    random_poly_commitment = transcript.read_point()
    y = transcript.squeeze_challenge()
    h_commitments = transcript.read_n_points(domain.quotient_poly_degree)
    x = transcript.squeeze_challenge()

    instance_evals = [transcript.read_n_scalars(len(cs.instance_queries))
                      for _ in range(num_proofs)]
    advice_evals = [transcript.read_n_scalars(len(cs.advice_queries))
                    for _ in range(num_proofs)]
    fixed_evals = transcript.read_n_scalars(len(cs.fixed_queries))
    random_eval = transcript.read_scalar()
    permutations_common = transcript.read_n_scalars(
        len(cs.permutation.columns))

    permutations_evaluated = []
    for _ in range(num_proofs):
        sets = []
        for i in range(num_perm_sets):
            ev = transcript.read_scalar()
            ev_next = transcript.read_scalar()
            ev_last = (transcript.read_scalar()
                       if i < num_perm_sets - 1 else None)
            sets.append({"eval": ev, "next_eval": ev_next,
                         "last_eval": ev_last})
        permutations_evaluated.append(sets)
    lookup_keys = ("product_eval", "product_next_eval", "permuted_input_eval",
                   "permuted_input_inv_eval", "permuted_table_eval")
    lookups_evaluated = [
        [{key: transcript.read_scalar() for key in lookup_keys}
         for _ in per_proof]
        for per_proof in lookups_committed]

    # ---- expected h(x) ----
    xn = pow(x, n, p)
    blinding_factors = cs.blinding_factors()
    l_evals = domain.l_i_range(x, xn,
                               range(-(blinding_factors + 1), 1))
    assert len(l_evals) == 2 + blinding_factors
    l_last = l_evals[0]
    l_blind = sum(l_evals[1:1 + blinding_factors]) % p
    l_0 = l_evals[1 + blinding_factors]

    expressions: list[int] = []
    for pf in range(num_proofs):
        for gate in cs.gates:
            for poly in gate.polys:
                expressions.append(evaluate_expression_host(
                    fs, poly, advice_evals=advice_evals[pf],
                    fixed_evals=fixed_evals,
                    instance_evals=instance_evals[pf]))
        expressions.extend(permutation_verifier_expressions(
            cs, fs, permutations_evaluated[pf], permutations_common,
            advice_evals[pf], fixed_evals, instance_evals[pf],
            l_0, l_last, l_blind, beta, gamma, x))
        for lk_evals, argument in zip(lookups_evaluated[pf], cs.lookups):
            expressions.extend(lookup_verifier_expressions(
                argument, fs, lk_evals, advice_evals[pf], fixed_evals,
                instance_evals[pf], l_0, l_last, l_blind,
                theta, beta, gamma))

    expected_h_eval = 0
    for v in expressions:
        expected_h_eval = (expected_h_eval * y + v) % p
    expected_h_eval = expected_h_eval * pow((xn - 1) % p, p - 2, p) % p

    # h commitment as deferred MSM (vanishing/verifier.rs:100-110)
    h_msm = params.empty_msm()
    for commitment in reversed(h_commitments):
        h_msm.scale(xn)
        h_msm.append_term(1, commitment)

    # ---- multiopen queries ----
    queries: list[VerifierQuery] = []
    x_next = domain.rotate_omega(x, 1)
    x_inv = domain.rotate_omega(x, -1)
    x_last = domain.rotate_omega(x, -(blinding_factors + 1))

    for pf in range(num_proofs):
        for qi, (column, at) in enumerate(cs.instance_queries):
            queries.append(VerifierQuery(
                point=domain.rotate_omega(x, at.value),
                commitment=instance_commitments[pf][column.index],
                eval=instance_evals[pf][qi]))
        for qi, (column, at) in enumerate(cs.advice_queries):
            queries.append(VerifierQuery(
                point=domain.rotate_omega(x, at.value),
                commitment=advice_commitments[pf][column.index],
                eval=advice_evals[pf][qi]))
        # permutation queries (permutation/verifier.rs:199-226)
        sets = permutations_evaluated[pf]
        comms = permutations_committed[pf]
        for comm, s in zip(comms, sets):
            queries.append(VerifierQuery(point=x, commitment=comm,
                                         eval=s["eval"]))
            queries.append(VerifierQuery(point=x_next, commitment=comm,
                                         eval=s["next_eval"]))
        for comm, s in list(zip(comms, sets))[::-1][1:]:
            queries.append(VerifierQuery(point=x_last, commitment=comm,
                                         eval=s["last_eval"]))
        # lookup queries (lookup/verifier.rs:170-208)
        for (pi_comm, pt_comm, prod_comm), evs in zip(
                lookups_committed[pf], lookups_evaluated[pf]):
            for point, comm, key in (
                    (x, prod_comm, "product_eval"),
                    (x, pi_comm, "permuted_input_eval"),
                    (x, pt_comm, "permuted_table_eval"),
                    (x_inv, pi_comm, "permuted_input_inv_eval"),
                    (x_next, prod_comm, "product_next_eval")):
                queries.append(VerifierQuery(point=point, commitment=comm,
                                             eval=evs[key]))

    for qi, (column, at) in enumerate(cs.fixed_queries):
        queries.append(VerifierQuery(
            point=domain.rotate_omega(x, at.value),
            commitment=vk.fixed_commitments[column.index],
            eval=fixed_evals[qi]))
    for comm, ev in zip(vk.permutation_commitments, permutations_common):
        queries.append(VerifierQuery(point=x, commitment=comm, eval=ev))
    # vanishing queries (vanishing/verifier.rs:110-130)
    queries.append(VerifierQuery(point=x, commitment=h_msm,
                                 eval=expected_h_eval))
    queries.append(VerifierQuery(point=x, commitment=random_poly_commitment,
                                 eval=random_eval))

    return strategy.process(
        lambda msm: multiopen_verify_proof(params, transcript, queries, msm))


class SingleVerifier:
    """verifier.rs:36-64: expand challenges, one final MSM."""

    def __init__(self, params: Params):
        self.params = params

    def process(self, f):
        guard = f(self.params.empty_msm())
        msm = guard.use_challenges()
        if not msm.eval():
            raise VerificationError("ConstraintSystemFailure")
        return None


class AccumulatorStrategy:
    """Recursion-style strategy: G from the challenges by one MSM over g
    (Guard.compute_g), then the Guard's use_g exit; returns the
    Accumulator (commitment/verifier.rs:44-53)."""

    def __init__(self, params: Params):
        self.params = params

    def process(self, f):
        guard = f(self.params.empty_msm())
        g = guard.compute_g()
        msm, accumulator = guard.use_g(g)
        if not msm.eval():
            raise VerificationError("ConstraintSystemFailure")
        return accumulator


class _Collect:
    """BatchVerifier's per-proof strategy: keeps the expanded MSM."""

    def __init__(self, params: Params):
        self.params = params
        self.msm = None

    def process(self, f):
        self.msm = f(self.params.empty_msm()).use_challenges()


class BatchVerifier:
    """Batch verification: queue proofs, then scale each proof's MSM by a
    random factor, merge them and evaluate one MSM
    (plonk/verifier/batch.rs:44-124)."""

    def __init__(self, params: Params):
        self.params = params
        self.items: list[tuple[list, bytes]] = []

    def add_proof(self, instances: list[list[list[int]]],
                  proof: bytes) -> None:
        self.items.append((instances, proof))

    def finalize(self, vk: VerifyingKey, rng=None) -> bool:
        """True iff every queued proof verifies. A malformed or failing
        proof fails the whole batch (batch.rs:95-117)."""
        rng = rng or random.Random(0xBA7C4)
        acc = self.params.empty_msm()
        for instances, proof in self.items:
            strategy = _Collect(self.params)
            try:
                verify_proof(self.params, vk, strategy, instances,
                             TranscriptRead(self.params.curve, proof))
            except (VerificationError, Error, TranscriptError):
                return False
            item = strategy.msm
            item.scale(self.params.curve.scalar.rand(rng))
            acc.add_msm(item)
        return acc.eval()
