"""The PLONK prover: the Fiat-Shamir proof construction.

Port of halo2_tpu/plonk/prover.py (halo2_proofs/src/plonk/prover.rs:
35-725); its jitted gate chunks are kernel K2 (`h_chunk_nodes`). The
phase order -- and therefore the proof byte layout and the order of
every draw from the caller's `rng` -- is the reference's exactly:
  vk.hash_into -> instance commitments -> witness synthesis -> advice
  commitments -> theta -> lookup permuted commitments -> beta, gamma ->
  permutation z commitments -> lookup product commitments -> vanishing
  random commitment -> y -> h(X) commitments -> x -> instance / advice /
  fixed evals -> vanishing eval -> permutation evals -> lookup evals ->
  multiopen.

All O(n) work (commitments, NTTs, gate evaluation, scans) runs on the
Params device; the host sequences phases and hashes the transcript.

Under a ProverMesh (parallel/context.py) every rank runs this same
prover on the same inputs, and the proof is the single-device proof byte
for byte. Where the mesh takes the circuit's rows (ProverMesh.takes_rows:
D^2 | n, and no argument rolls a column by more than n/D rows), each rank
holds only its rows: the proving key is re-laid once for the mesh
(lay_out_pk; the reference's halo2_tpu/plonk/prover.py:279-297), the
instance and advice values are uploaded as the rank's rows (its :309,
:344), and every column made from them stays the rank's rows. The
elementwise phases run on those rows, rotations take a neighbour's edge
rows, and the commits, transforms and grand products take their sharded
branches without a gather. Whole columns are gathered only where a phase
needs them: the lookup's permute (plonk/lookup.py), the multiopen's q
polys and the IPA (poly/multiopen.py), and the gate chunks of kernel K2,
which address rotated rows modulo the whole column (_gates_h_fold). The
evaluations at x sum the ranks' partial sums (poly/utils.py::MemoEval).
Otherwise the prover keeps whole tensors and each branch narrows the
rank's rows out and gathers its result. A pk laid out for one mesh is
gathered back whole, once, by a prove without it or under another. A
mesh proof ends with an all_gather of each rank's SHA-256 of the
transcript, and raises on every rank if any differs (ranks given
different RNGs or inputs).
"""
from __future__ import annotations

import hashlib

import torch

from .. import tracing
from ..ops.field_kernels import fadd, fmul
from ..ops.gate_kernels import run_chunk
from ..parallel import context
from ..parallel.context import WHOLE
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
                         expression_share_counts, fresh_memo, compile_chunk)
from .permutation import (permutation_commit, permutation_h_terms,
                          permutation_evaluate, permutation_pk_evaluate)
from .lookup import (lookup_commit_permuted, lookup_commit_product,
                     lookup_h_terms, lookup_evaluate)
from .vanishing import (vanishing_commit, vanishing_construct,
                        vanishing_evaluate)


# The last create_proof's phase split [(name, seconds)], its synced laps
# (tracing.PhaseTimer), for benchmarks and chip_smoke.py.
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


# Max expression-AST nodes of a gate chunk; 0 evaluates the gates
# eagerly, one field-kernel launch a distinct node (the reference's
# default, halo2_tpu/plonk/prover.py:150-160). Above 0 each chunk is one
# launch of kernel K2 (ops/gate_kernels.py) on the card.
H_CHUNK_NODES = 0


def _expr_nodes(e) -> int:
    return e.evaluate(
        constant=lambda v: 1, selector_fn=lambda s: 1,
        fixed_fn=lambda q: 1, advice_fn=lambda q: 1,
        instance_fn=lambda q: 1, negated=lambda a: a + 1,
        sum_fn=lambda a, b: a + b + 1, product=lambda a, b: a + b + 1,
        scaled=lambda a, v: a + 1)


def gate_chunks(cs, max_nodes: int) -> list:
    """The gate polynomials in order, cut into chunks of at most
    max_nodes AST nodes (a polynomial larger than that is a chunk of its
    own): the reference's partition (halo2_tpu/plonk/prover.py:204-218)."""
    chunks, cur, cur_nodes = [], [], 0
    for e in (e for gate in cs.gates for e in gate.polys):
        nn = _expr_nodes(e)
        if cur and cur_nodes + nn > max_nodes:
            chunks.append(cur)
            cur, cur_nodes = [], 0
        cur.append(e)
        cur_nodes += nn
    if cur:
        chunks.append(cur)
    return chunks


def _gates_h_fold(pk, cs, df, rot_scale: int, ext_n: int, y: int, y_m,
                  h_acc, advice_c, fixed_c, instance_c,
                  h_chunk_nodes: int = H_CHUNK_NODES, rows=WHOLE):
    """Fold every gate polynomial into the quotient accumulator,
    h = h*y + t in the gates' order. With h_chunk_nodes <= 0, one field
    op per distinct expression node: the use-counted memo hash-conses
    repeated subtrees across the gate set and frees each shared value
    after its last use. Above 0, the gates in chunks of at most that
    many nodes, each compiled once into a tape (cached on the pk by chunk
    size) and run as h = h*y^k + sum t_i y^(k-i), one K2 launch a chunk
    on the card (the reference's jitted chunks, :241-255). With `rows` a
    ProverMesh the columns and h are the rank's rows; the eager fold runs
    on them, while K2, which reads a rotated row by its index modulo the
    whole column, gets the columns and h gathered whole and the rank
    keeps its rows of the result (a local window with halos would need a
    row offset in the kernel's addressing; the chunked fold is off by
    default)."""
    if h_chunk_nodes <= 0:
        tmpl = getattr(pk, "_h_share_counts", None)
        if tmpl is None:
            tmpl = pk._h_share_counts = expression_share_counts(
                [e for g in cs.gates for e in g.polys])
        memo = fresh_memo(tmpl)
        for gate in cs.gates:
            for expr in gate.polys:
                t = evaluate_expression(
                    df, expr, advice=advice_c, fixed=fixed_c,
                    instance=instance_c, rot_scale=rot_scale, memo=memo,
                    rows=rows)
                h_acc = (t if h_acc is None
                         else fadd(df, fmul(df, h_acc, y_m), t))
        return h_acc
    cache = getattr(pk, "_h_gate_tapes", None)
    if cache is None:
        cache = pk._h_gate_tapes = {}
    tapes = cache.get(h_chunk_nodes)
    if tapes is None:
        tapes = cache[h_chunk_nodes] = [
            compile_chunk(c) for c in gate_chunks(cs, h_chunk_nodes)]
    p = df.spec.modulus
    whole = lambda cols: [rows.gather_rows(c) for c in cols]
    advice_c, fixed_c, instance_c = (whole(advice_c), whole(fixed_c),
                                     whole(instance_c))
    if h_acc is not None:
        h_acc = rows.gather_rows(h_acc)
    for tape in tapes:
        yk_m = df.scalar(pow(y, tape.n_polys, p), y_m.device)
        h_acc = run_chunk(df, tape, h_acc, advice_c, fixed_c, instance_c,
                          rot_scale, y_m, yk_m, ext_n)
    return rows.local_rows(h_acc)


# The proving key's tensors of n or ext_n rows, on the pk and on
# pk.permutation: each a list of tensors or one tensor
_PK_ROWS = ("fixed_values", "fixed_polys", "fixed_cosets", "l0", "l_blind",
            "l_last")
_PERMUTATION_ROWS = ("permutations", "polys", "cosets")


def pk_row_tensors(pk) -> list:
    """(owner, attribute name, value) of every proving-key tensor that
    lay_out_pk re-lays."""
    return ([(pk, a, getattr(pk, a)) for a in _PK_ROWS]
            + [(pk.permutation, a, getattr(pk.permutation, a))
               for a in _PERMUTATION_ROWS])


def _map_pk_rows(pk, f) -> None:
    for owner, name, value in pk_row_tensors(pk):
        setattr(owner, name, [f(t) for t in value]
                if isinstance(value, list) else f(value))


def lay_out_pk(pk, rows) -> None:
    """Lay the proving key's row tensors out for `rows`, once: a ProverMesh
    takes the rank's blocks (each in storage of its own, so the whole
    tensors are freed), WHOLE whole tensors. A pk laid out for a mesh is
    first gathered back whole through that mesh, so that a prove without
    it or under another never runs on a partial pk (every rank of the old
    mesh must then prove too)."""
    held = getattr(pk, "_rows", WHOLE)
    if held.key() == rows.key():
        pk._rows = rows
        return
    if held.local:
        _map_pk_rows(pk, held.gather_rows)
    if rows.local:
        _map_pk_rows(pk, rows.local_rows)
    pk._rows = rows


def max_row_shift(cs) -> int:
    """The most rows (of n) any argument rolls a column by: the gates'
    and lookups' query rotations, and the permutation's last-row link,
    blinding_factors + 1 rows (the lookups' +-1 row is below it)."""
    return max([abs(at.value) for _, at in cs.advice_queries
                + cs.fixed_queries + cs.instance_queries]
               + [cs.blinding_factors() + 1])


def prover_rows(ctx, pk, n: int):
    """The layout of a prove: the active ProverMesh where it takes the
    circuit's rows (ctx.takes_rows), else WHOLE."""
    if ctx is not None and ctx.takes_rows(n, max_row_shift(pk.vk.cs)):
        return ctx
    return WHOLE


def check_ranks_agree(ctx, proof: bytes) -> None:
    """Every rank of the mesh wrote `proof`: an all_gather of each rank's
    SHA-256 of it. A difference raises on every rank: ranks given
    different RNGs or inputs have committed to a mix of their rows."""
    mine = torch.frombuffer(bytearray(hashlib.sha256(proof).digest()),
                            dtype=torch.uint8).to(ctx.mesh.device)
    every = ctx.gather_rows(mine[None])                       # [D, 32]
    if not bool((every == every[0]).all()):
        raise RuntimeError(
            f"the {ctx.ndev} ranks of the mesh made different proofs "
            f"(rank {ctx.rank}'s sha256 {mine.cpu().numpy().tobytes().hex()})"
            ": each rank must prove the same circuit, instances and RNG")


def create_proof(params: Params, pk: ProvingKey, circuits: list[Circuit],
                 instances: list[list[list[int]]], rng, transcript,
                 native_ipa_threshold: int = NATIVE_IPA_THRESHOLD,
                 sanity: bool = False,
                 h_chunk_nodes: int = H_CHUNK_NODES) -> None:
    """prover.rs:35-725. `instances[i][j]` is the j-th instance column of
    the i-th circuit instance. IPA rounds with half > native_ipa_threshold
    run on the device, the rest in the native host library
    (poly/commitment.py::ipa_create_proof); the proof is the same.
    `sanity` runs the reference's debug checks (its HALO2_TPU_SANITY):
    each permuted lookup pair is well formed, each lookup product and the
    permutation product telescope; a failed check raises AssertionError.
    The proof is the same with them on. `h_chunk_nodes` > 0 folds the
    gates in chunks of at most that many expression nodes, one kernel
    launch a chunk (_gates_h_fold); the proof is the same.

    Each proof leaves a record in tracing.PROOFS, raised or not: its
    synced phase laps (LAST_PHASES on success), spans, counters and
    kernel launches."""
    with tracing.record("proof"):
        _create_proof(params, pk, circuits, instances, rng, transcript,
                      native_ipa_threshold, sanity, h_chunk_nodes)


def _create_proof(params, pk, circuits, instances, rng, transcript,
                  native_ipa_threshold, sanity, h_chunk_nodes) -> None:
    if len(circuits) != len(instances):
        raise ValueError("circuits/instances length mismatch")
    cs = pk.vk.cs
    fs = params.curve.scalar
    df = params.scalar_df
    dev = params.device
    domain = pk.vk.domain
    n = params.n
    ctx = context.active()
    rows = prover_rows(ctx, pk, n)
    lay_out_pk(pk, rows)
    start, count = rows.row_span(n)

    prof = tracing.PhaseTimer(dev)
    prof.phase("instance commit+ntt")
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
            values_l.append(df.upload_values(padded[start:start + count],
                                             dev, site="instance"))
        commitments = params.commit_many(
            values_l, [DEFAULT_BLIND] * len(values_l), lagrange=True,
            rows=rows)
        polys_l, cosets_l = domain.lagrange_to_coeff_extended_many(values_l,
                                                                  rows)
        for c in commitments:
            transcript.common_point(c)
        instance_singles.append(
            {"values": values_l, "polys": polys_l, "cosets": cosets_l})

    # ---- witness synthesis + advice commitments ----
    # (a circuit's transforms lap with the next one's synthesis, the last
    # one's as "advice: ntt+extend")
    unusable_rows_start = n - (cs.blinding_factors() + 1)
    advice_singles = []
    prof.phase("advice: synthesis" if circuits else "advice: ntt+extend")
    for i, (circuit, inst) in enumerate(zip(circuits, instances)):
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
        prof.phase("advice: commit")

        advice_cols = []
        for col in witness.advice:
            ints = batch_evaluate_assigned(fs, col)
            for row in range(unusable_rows_start, n):   # blinding rows
                ints[row] = fs.rand(rng)
            advice_cols.append(df.upload_values(ints[start:start + count],
                                                dev, site="advice"))
        advice_blinds = [fs.rand(rng) for _ in advice_cols]
        for pt in params.commit_many(advice_cols, advice_blinds,
                                     lagrange=True, rows=rows):
            transcript.write_point(pt)
        prof.phase("advice: synthesis" if i + 1 < len(circuits)
                   else "advice: ntt+extend")
        polys, cosets = domain.lagrange_to_coeff_extended_many(advice_cols,
                                                               rows)
        advice_singles.append({"values": advice_cols, "polys": polys,
                               "cosets": cosets, "blinds": advice_blinds})
    prof.phase("lookup permuted")
    theta = transcript.squeeze_challenge()

    # ---- lookups: permuted commitments ----
    lookups_permuted = [
        [lookup_commit_permuted(argument, cs, params, domain, theta,
                                adv_s["values"], pk.fixed_values,
                                inst_s["values"], rng, transcript,
                                sanity=sanity, rows=rows)
         for argument in cs.lookups]
        for inst_s, adv_s in zip(instance_singles, advice_singles)]
    prof.phase("permutation z")
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    # ---- permutation z commitments ----
    permutations_committed = []
    for inst_s, adv_s in zip(instance_singles, advice_singles):
        permutations_committed.append(permutation_commit(
            cs, params, domain, pk.permutation,
            adv_s["values"], pk.fixed_values, inst_s["values"],
            beta, gamma, rng, transcript, sanity=sanity, rows=rows))
    prof.phase("lookup products")

    # ---- lookups: product commitments ----
    lookups_committed = [
        [lookup_commit_product(permuted, cs, params, domain, beta, gamma,
                               rng, transcript, sanity=sanity, rows=rows)
         for permuted in per_instance]
        for per_instance in lookups_permuted]
    prof.phase("vanishing random")

    # ---- vanishing: random poly ----
    vanishing = vanishing_commit(params, domain, rng, transcript, rows)
    prof.phase("h terms build")
    y = transcript.squeeze_challenge()

    # ---- h(X): streamed y-fold of the constraint terms (the reference's
    # evaluator folds incrementally too, poly/evaluator.rs:210-227) ----
    with tracing.span("h.coset_points"):
        coset_pts = coset_points(domain, rows)
    rot_scale = 1 << (domain.extended_k - domain.k)
    ext_n = domain.extended_n
    y_m = df.scalar(y, dev)
    h_acc = None
    for inst_s, adv_s, perm_sets, lk_committed in zip(
            instance_singles, advice_singles, permutations_committed,
            lookups_committed):
        with tracing.span("h.gates"):
            h_acc = _gates_h_fold(pk, cs, df, rot_scale, ext_n, y, y_m,
                                  h_acc, adv_s["cosets"], pk.fixed_cosets,
                                  inst_s["cosets"], h_chunk_nodes, rows)
        with tracing.span("h.permutation"):
            terms = permutation_h_terms(
                cs, domain, pk.permutation, perm_sets,
                adv_s["cosets"], pk.fixed_cosets, inst_s["cosets"],
                pk.l0, pk.l_blind, pk.l_last, coset_pts, beta, gamma, rows)
        with tracing.span("h.lookups"):
            for committed in lk_committed:
                terms += lookup_h_terms(
                    committed, domain, theta, beta, gamma, adv_s["cosets"],
                    pk.fixed_cosets, inst_s["cosets"], pk.l0, pk.l_blind,
                    pk.l_last, rows)
        with tracing.span("h.fold"):
            for term in terms:
                h_acc = term if h_acc is None else fadd(
                    df, fmul(df, h_acc, y_m), term)
    h_terms = ([] if h_acc is None
               else [h_acc.expand(rows.row_span(ext_n)[1],
                                  h_acc.shape[-1]).contiguous()])
    prof.phase("vanishing construct (h commit)")
    constructed = vanishing_construct(vanishing, params, domain, h_terms, y,
                                      rng, transcript, rows)
    prof.phase("evals")
    x = transcript.squeeze_challenge()
    xn = pow(x, n, fs.modulus)

    # ---- every scalar open between the x and x1 squeezes in one batched
    # evaluation (poly/utils.py::MemoEval) ----
    memo = MemoEval(df, rows)
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

    with tracing.span("evals.write"):
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
    prof.phase("multiopen+ipa")

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
                           native_ipa_threshold, rows)
    prof.close()
    if ctx is not None:
        check_ranks_agree(ctx, transcript.finalize())
    LAST_PHASES[:] = prof.laps
