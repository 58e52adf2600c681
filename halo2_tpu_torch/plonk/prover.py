"""The PLONK prover: the Fiat-Shamir proof construction.

Port of halo2_tpu/plonk/prover.py (halo2_proofs/src/plonk/prover.rs:
35-725) without the jitted gate chunks or the mesh mode. The phase order
-- and therefore the proof byte layout and the order of every draw from
the caller's `rng` -- is the reference's exactly:
  vk.hash_into -> instance commitments -> witness synthesis -> advice
  commitments -> theta -> lookup permuted commitments -> beta, gamma ->
  permutation z commitments -> lookup product commitments -> vanishing
  random commitment -> y -> h(X) commitments -> x -> instance / advice /
  fixed evals -> vanishing eval -> permutation evals -> lookup evals ->
  multiopen.

All O(n) work (commitments, NTTs, gate evaluation, scans) runs on the
Params device; the host sequences phases and hashes the transcript.
"""
from __future__ import annotations

import time

import torch

from ..ops.field_kernels import fadd, fmul
from ..poly.commitment import Params, DEFAULT_BLIND, NATIVE_IPA_THRESHOLD
from ..poly.multiopen import ProverQuery, multiopen_create_proof
from ..poly.utils import MemoEval
from ..circuit.value import Value
from ..circuit.layouter import Circuit
from .circuit import ConstraintSystem, Column
from .assigned import Assigned, batch_evaluate_assigned
from .keys import ProvingKey
from .keygen import NotEnoughRowsAvailable
from .evaluation import (evaluate_expression, coset_points,
                         expression_share_counts, fresh_memo)
from .permutation import (permutation_commit, permutation_h_terms,
                          permutation_evaluate, permutation_pk_evaluate)
from .lookup import (lookup_commit_permuted, lookup_commit_product,
                     lookup_h_terms, lookup_evaluate)
from .vanishing import (vanishing_commit, vanishing_construct,
                        vanishing_evaluate)


class PhaseTimer:
    """Wall-clock per prover phase. The device queue is drained at every
    lap (torch.cuda.synchronize) so each phase owns the kernels it
    launched. `laps` keeps (name, seconds)."""

    def __init__(self, device):
        self.device = device
        self.laps: list = []
        self._sync()
        self.t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lap(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        self.t = now


# The last create_proof's phase split, for benchmarks and chip_smoke.py.
LAST_PHASES: list = []


class WitnessCollection:
    """Assignment sink capturing advice values (prover.rs:155-262)."""

    def __init__(self, cs: ConstraintSystem, fs, n: int, k: int,
                 instances: list[list[int]], usable_rows: int):
        self.fs = fs
        self.k = k
        self.advice: list[list[Assigned]] = [
            [Assigned.zero()] * n for _ in range(cs.num_advice_columns)]
        self.instances = instances
        self.usable_rows = usable_rows

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def enable_selector(self, annotation, selector, row):
        pass  # selectors are fixed by keygen

    def query_instance(self, column: Column, row: int) -> Value:
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.instances[column.index]
        v = col[row] if row < len(col) else 0
        return Value.known(v)

    def assign_advice(self, annotation, column: Column, row: int, to):
        if row >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        v = to()
        v = v if isinstance(v, Value) else Value.known(v)
        if v.is_known():
            inner = v.inner()
            self.advice[column.index][row] = (
                inner if isinstance(inner, Assigned)
                else Assigned.trivial(inner % self.fs.modulus))

    def assign_fixed(self, annotation, column, row, to):
        pass  # fixed by keygen

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    # ---- batch synthesis extension (Layouter.assign_regions) ----
    def assign_advice_batch(self, annotation, column: Column,
                            rows: list[int], values: list) -> None:
        if rows and max(rows) >= self.usable_rows:
            raise NotEnoughRowsAvailable(self.k)
        col = self.advice[column.index]
        p = self.fs.modulus
        for r, v in zip(rows, values):
            if isinstance(v, Value):
                if not v.is_known():
                    continue
                v = v.inner()
            col[r] = (v if isinstance(v, Assigned)
                      else Assigned.trivial(v % p))

    def assign_fixed_batch(self, annotation, column, rows, values):
        pass  # fixed by keygen

    def enable_selector_batch(self, annotation, selector, rows):
        pass  # selectors are fixed by keygen

    def copy_batch(self, col_a, rows_a, col_b, rows_b):
        pass

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


def _gates_h_fold(pk, cs, df, rot_scale: int, y_m, h_acc, advice_c,
                  fixed_c, instance_c):
    """Fold every gate polynomial into the quotient accumulator,
    h = h*y + t, one field op per distinct expression node: the
    use-counted memo hash-conses repeated subtrees across the gate set and
    frees each shared value after its last use."""
    tmpl = getattr(pk, "_h_share_counts", None)
    if tmpl is None:
        tmpl = pk._h_share_counts = expression_share_counts(
            [e for g in cs.gates for e in g.polys])
    memo = fresh_memo(tmpl)
    for gate in cs.gates:
        for expr in gate.polys:
            t = evaluate_expression(
                df, expr, advice=advice_c, fixed=fixed_c,
                instance=instance_c, rot_scale=rot_scale, memo=memo)
            h_acc = t if h_acc is None else fadd(df, fmul(df, h_acc, y_m), t)
    return h_acc


def create_proof(params: Params, pk: ProvingKey, circuits: list[Circuit],
                 instances: list[list[list[int]]], rng, transcript,
                 native_ipa_threshold: int = NATIVE_IPA_THRESHOLD) -> None:
    """prover.rs:35-725. `instances[i][j]` is the j-th instance column of
    the i-th circuit instance. IPA rounds with half > native_ipa_threshold
    run on the device, the rest in the native host library
    (poly/commitment.py::ipa_create_proof); the proof is the same."""
    if len(circuits) != len(instances):
        raise ValueError("circuits/instances length mismatch")
    cs = pk.vk.cs
    fs = params.curve.scalar
    df = params.scalar_df
    dev = params.device
    domain = pk.vk.domain
    n = params.n

    prof = PhaseTimer(dev)
    pk.vk.hash_into(transcript)

    # ---- instance commitments (common inputs) + polys + cosets ----
    instance_singles = []
    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise ValueError("wrong number of instance columns")
        values_l = []
        for values in inst:
            if len(values) > n - (cs.blinding_factors() + 1):
                raise ValueError("InstanceTooLarge")
            padded = list(values) + [0] * (n - len(values))
            values_l.append(df.upload_values(padded, dev))
        commitments = params.commit_many(
            values_l, [DEFAULT_BLIND] * len(values_l), lagrange=True)
        polys_l, cosets_l = domain.lagrange_to_coeff_extended_many(values_l)
        for c in commitments:
            transcript.common_point(c)
        instance_singles.append(
            {"values": values_l, "polys": polys_l, "cosets": cosets_l})
    prof.lap("instance commit+ntt")

    # ---- witness synthesis + advice commitments ----
    unusable_rows_start = n - (cs.blinding_factors() + 1)
    advice_singles = []
    for circuit, inst in zip(circuits, instances):
        witness_cs = ConstraintSystem()
        config = type(circuit).configure(witness_cs)
        witness = WitnessCollection(witness_cs, fs, n, params.k, inst,
                                    unusable_rows_start)
        from ..circuit import synthesize_circuit
        plan_cache = getattr(pk, "_synth_plan", None)
        if plan_cache is None:
            plan_cache = pk._synth_plan = {}
        synthesize_circuit(witness, circuit, config, witness_cs.constants,
                           plan_cache=plan_cache)
        prof.lap("advice: synthesis")

        advice_cols = []
        for col in witness.advice:
            ints = batch_evaluate_assigned(fs, col)
            for row in range(unusable_rows_start, n):   # blinding rows
                ints[row] = fs.rand(rng)
            advice_cols.append(df.upload_values(ints, dev))
        advice_blinds = [fs.rand(rng) for _ in advice_cols]
        for pt in params.commit_many(advice_cols, advice_blinds,
                                     lagrange=True):
            transcript.write_point(pt)
        prof.lap("advice: commit")
        polys, cosets = domain.lagrange_to_coeff_extended_many(advice_cols)
        advice_singles.append({"values": advice_cols, "polys": polys,
                               "cosets": cosets, "blinds": advice_blinds})
    prof.lap("advice: ntt+extend")
    theta = transcript.squeeze_challenge()

    # ---- lookups: permuted commitments ----
    lookups_permuted = [
        [lookup_commit_permuted(argument, cs, params, domain, theta,
                                adv_s["values"], pk.fixed_values,
                                inst_s["values"], rng, transcript)
         for argument in cs.lookups]
        for inst_s, adv_s in zip(instance_singles, advice_singles)]
    prof.lap("lookup permuted")
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # ---- permutation z commitments ----
    permutations_committed = []
    for inst_s, adv_s in zip(instance_singles, advice_singles):
        permutations_committed.append(permutation_commit(
            cs, params, domain, pk.permutation,
            adv_s["values"], pk.fixed_values, inst_s["values"],
            beta, gamma, rng, transcript))
    prof.lap("permutation z")

    # ---- lookups: product commitments ----
    lookups_committed = [
        [lookup_commit_product(permuted, cs, params, domain, beta, gamma,
                               rng, transcript)
         for permuted in per_instance]
        for per_instance in lookups_permuted]
    prof.lap("lookup products")

    # ---- vanishing: random poly ----
    vanishing = vanishing_commit(params, domain, rng, transcript)
    prof.lap("vanishing random")
    y = transcript.squeeze_challenge()

    # ---- h(X): streamed y-fold of the constraint terms (the reference's
    # evaluator folds incrementally too, poly/evaluator.rs:210-227) ----
    coset_pts = coset_points(domain)
    rot_scale = 1 << (domain.extended_k - domain.k)
    ext_n = domain.extended_n
    y_m = df.scalar(y, dev)
    h_acc = None
    for inst_s, adv_s, perm_sets, lk_committed in zip(
            instance_singles, advice_singles, permutations_committed,
            lookups_committed):
        h_acc = _gates_h_fold(pk, cs, df, rot_scale, y_m, h_acc,
                              adv_s["cosets"], pk.fixed_cosets,
                              inst_s["cosets"])
        terms = permutation_h_terms(
            cs, domain, pk.permutation, perm_sets,
            adv_s["cosets"], pk.fixed_cosets, inst_s["cosets"],
            pk.l0, pk.l_blind, pk.l_last, coset_pts, beta, gamma)
        for committed in lk_committed:
            terms += lookup_h_terms(
                committed, domain, theta, beta, gamma, adv_s["cosets"],
                pk.fixed_cosets, inst_s["cosets"], pk.l0, pk.l_blind,
                pk.l_last)
        for term in terms:
            h_acc = term if h_acc is None else fadd(
                df, fmul(df, h_acc, y_m), term)
    h_terms = ([] if h_acc is None
               else [h_acc.expand(ext_n, h_acc.shape[-1]).contiguous()])
    prof.lap("h terms build")
    constructed = vanishing_construct(vanishing, params, domain, h_terms, y,
                                      rng, transcript)
    prof.lap("vanishing construct (h commit)")
    x = transcript.squeeze_challenge()
    xn = pow(x, n, fs.modulus)

    # ---- every scalar open between the x and x1 squeezes in one batched
    # evaluation (poly/utils.py::MemoEval) ----
    memo = MemoEval(df)
    for inst_s in instance_singles:
        for column, at in cs.instance_queries:
            memo.collect(inst_s["polys"][column.index],
                         domain.rotate_omega(x, at.value))
    for adv_s in advice_singles:
        for column, at in cs.advice_queries:
            memo.collect(adv_s["polys"][column.index],
                         domain.rotate_omega(x, at.value))
    for column, at in cs.fixed_queries:
        memo.collect(pk.fixed_polys[column.index],
                     domain.rotate_omega(x, at.value))
    x_next = domain.rotate_omega(x, 1)
    x_inv = domain.rotate_omega(x, -1)
    x_last = domain.rotate_omega(x, -(cs.blinding_factors() + 1))
    for poly in pk.permutation.polys:
        memo.collect(poly, x)
    for perm_sets in permutations_committed:
        for i, s in enumerate(perm_sets):
            memo.collect(s.z_poly, x)
            memo.collect(s.z_poly, x_next)
            if i < len(perm_sets) - 1:
                memo.collect(s.z_poly, x_last)
    for lk_committed in lookups_committed:
        for committed in lk_committed:
            memo.collect(committed.product_poly, x)
            memo.collect(committed.product_poly, x_next)
            memo.collect(committed.permuted.permuted_input_poly, x)
            memo.collect(committed.permuted.permuted_input_poly, x_inv)
            memo.collect(committed.permuted.permuted_table_poly, x)
    memo.collect(vanishing.random_poly, x)
    memo.compute()
    ev = memo.ev

    for inst_s in instance_singles:
        for column, at in cs.instance_queries:
            transcript.write_scalar(
                ev(inst_s["polys"][column.index],
                   domain.rotate_omega(x, at.value)))
    for adv_s in advice_singles:
        for column, at in cs.advice_queries:
            transcript.write_scalar(
                ev(adv_s["polys"][column.index],
                   domain.rotate_omega(x, at.value)))
    for column, at in cs.fixed_queries:
        transcript.write_scalar(
            ev(pk.fixed_polys[column.index],
               domain.rotate_omega(x, at.value)))
    h_poly, h_blind = vanishing_evaluate(constructed, params, x, xn,
                                         transcript, eval_fn=ev)
    permutation_pk_evaluate(pk.permutation, df, x, transcript, eval_fn=ev)
    for perm_sets in permutations_committed:
        permutation_evaluate(perm_sets, domain, cs, x, df, transcript,
                             eval_fn=ev)
    for lk_committed in lookups_committed:
        for committed in lk_committed:
            lookup_evaluate(committed, domain, x, transcript, ev)
    prof.lap("evals")

    # ---- multiopen queries (prover.rs:676-724) ----
    queries: list[ProverQuery] = []
    for inst_s, adv_s, perm_sets, lk_committed in zip(
            instance_singles, advice_singles, permutations_committed,
            lookups_committed):
        for column, at in cs.instance_queries:
            queries.append(ProverQuery(
                point=domain.rotate_omega(x, at.value),
                poly=inst_s["polys"][column.index], blind=DEFAULT_BLIND))
        for column, at in cs.advice_queries:
            queries.append(ProverQuery(
                point=domain.rotate_omega(x, at.value),
                poly=adv_s["polys"][column.index],
                blind=adv_s["blinds"][column.index]))
        # permutation opens (permutation/prover.rs:386-420)
        for s in perm_sets:
            queries.append(ProverQuery(point=x, poly=s.z_poly,
                                       blind=s.blind))
            queries.append(ProverQuery(point=x_next, poly=s.z_poly,
                                       blind=s.blind))
        for s in list(reversed(perm_sets))[1:]:
            queries.append(ProverQuery(point=x_last, poly=s.z_poly,
                                       blind=s.blind))
        # lookup opens (lookup/prover.rs:513-552)
        for committed in lk_committed:
            perm = committed.permuted
            for point, poly, blind in (
                    (x, committed.product_poly, committed.product_blind),
                    (x, perm.permuted_input_poly, perm.permuted_input_blind),
                    (x, perm.permuted_table_poly, perm.permuted_table_blind),
                    (x_inv, perm.permuted_input_poly,
                     perm.permuted_input_blind),
                    (x_next, committed.product_poly,
                     committed.product_blind)):
                queries.append(ProverQuery(point=point, poly=poly,
                                           blind=blind))
    for column, at in cs.fixed_queries:
        queries.append(ProverQuery(
            point=domain.rotate_omega(x, at.value),
            poly=pk.fixed_polys[column.index], blind=DEFAULT_BLIND))
    for poly in pk.permutation.polys:
        queries.append(ProverQuery(point=x, poly=poly, blind=DEFAULT_BLIND))
    # vanishing opens: h at x, random at x (vanishing/prover.rs:155-172)
    queries.append(ProverQuery(point=x, poly=h_poly, blind=h_blind))
    queries.append(ProverQuery(point=x, poly=vanishing.random_poly,
                               blind=vanishing.random_blind))

    multiopen_create_proof(params, rng, transcript, queries,
                           native_ipa_threshold)
    prof.lap("multiopen+ipa")
    LAST_PHASES[:] = prof.laps
