"""Gate-expression evaluation over whole field tensors.

Port of halo2_tpu/plonk/evaluation.py (the reference's AST evaluator,
halo2_proofs/src/poly/evaluator.rs:19-615): each `Expression` node is one
whole-tensor field op (kernel launches on CUDA), evaluated eagerly with a
use-counted memo that hash-conses repeated subtrees. Rotations are
`torch.roll` index shifts (scale 2^(extended_k - k) on the extended
domain, rotate_extended, domain.rs:257-275), ProverMesh.roll_rows on a
rank's rows; `LinearTerm` needs the coset
points zeta * omega_ext^i (BasisOps::linear_term, evaluator.rs:584-604).
"""
from __future__ import annotations

import torch

from ..fields.device import DeviceField, fneg
from ..ops.field_kernels import fadd, fmul
from ..parallel.context import WHOLE
from ..poly.domain import EvaluationDomain
from .circuit import Expression


def _rot(values: torch.Tensor, rotation: int, scale: int, rows
         ) -> torch.Tensor:
    if rotation == 0:
        return values
    return rows.roll_rows(values, -rotation * scale)


def evaluate_expression(df: DeviceField, expr: Expression, *,
                        advice, fixed, instance,
                        rot_scale: int = 1,
                        selector_fn=None, memo: dict | None = None,
                        rows=WHOLE):
    """Evaluate one gate Expression over arrays (Lagrange basis when
    rot_scale == 1, extended-coset basis when rot_scale == 2^(ek-k)).
    `advice/fixed/instance` are lists of [N, 16] Montgomery tensors: whole
    columns, or with `rows` a ProverMesh the rank's rows of them (a
    rotation then takes its neighbour's edge rows, ProverMesh.roll_rows).
    Constants stay [16] and broadcast through the field ops.

    `memo` (shared across a phase's expressions) hash-conses the
    evaluation: the AST nodes are frozen dataclasses, so structurally
    identical subtrees — repeated column/rotation queries above all,
    each of which otherwise runs its own torch.roll — evaluate
    once. Entries are USE-COUNTED ({expr: [remaining_uses, value]},
    pre-seeded by expression_share_counts): a shared value is dropped
    after its last use, so the memo never pins more device tensors than
    the in-flight shared subtrees."""

    if selector_fn is None:
        def selector_fn(s):
            raise RuntimeError(
                "virtual selectors are removed during optimization")

    dev = (advice or fixed or instance)[0].device

    if memo is None:
        return expr.evaluate(
            constant=lambda v: df.scalar(v, dev),
            selector_fn=selector_fn,
            fixed_fn=lambda q: _rot(fixed[q.column_index],
                                    q.rotation.value, rot_scale, rows),
            advice_fn=lambda q: _rot(advice[q.column_index],
                                     q.rotation.value, rot_scale, rows),
            instance_fn=lambda q: _rot(instance[q.column_index],
                                       q.rotation.value, rot_scale, rows),
            negated=lambda a: fneg(df, a),
            sum_fn=lambda a, b: fadd(df, a, b),
            product=lambda a, b: fmul(df, a, b),
            scaled=lambda a, v: fmul(df, a, df.scalar(v, dev)),
        )

    from .circuit import (Constant, SelectorExpr, FixedQuery, AdviceQuery,
                          InstanceQuery, Negated, Sum, Product, Scaled)

    def go(e):
        ent = memo.get(e)
        if ent is not None and ent[1] is not _UNSET:
            r = ent[1]
            ent[0] -= 1
            if ent[0] <= 0:
                del memo[e]  # last use: free the device array
            return r
        if isinstance(e, Constant):
            r = df.scalar(e.value, dev)
        elif isinstance(e, FixedQuery):
            r = _rot(fixed[e.column_index], e.rotation.value, rot_scale,
                     rows)
        elif isinstance(e, AdviceQuery):
            r = _rot(advice[e.column_index], e.rotation.value, rot_scale,
                     rows)
        elif isinstance(e, InstanceQuery):
            r = _rot(instance[e.column_index], e.rotation.value,
                     rot_scale, rows)
        elif isinstance(e, Negated):
            r = fneg(df, go(e.expr))
        elif isinstance(e, Sum):
            r = fadd(df, go(e.a), go(e.b))
        elif isinstance(e, Product):
            r = fmul(df, go(e.a), go(e.b))
        elif isinstance(e, Scaled):
            r = fmul(df, go(e.expr), df.scalar(e.scalar, dev))
        elif isinstance(e, SelectorExpr):
            r = selector_fn(e.selector)
        else:
            raise TypeError(f"unknown expression node {type(e)}")
        if ent is not None:  # shared node: keep for its remaining uses
            ent[0] -= 1
            if ent[0] <= 0:
                del memo[e]
            else:
                ent[1] = r
        return r

    return go(expr)


_UNSET = object()


def expression_share_counts(exprs) -> dict:
    """Occurrence counts of structurally repeated subtrees across a set
    of expressions; returns a memo template {expr: [count, _UNSET]} with
    only count >= 2 entries (pass a fresh copy per evaluation pass)."""
    from .circuit import Negated, Sum, Product, Scaled
    counts: dict = {}

    def walk(e):
        c = counts.get(e)
        counts[e] = (c or 0) + 1
        if c is not None:
            return  # children already counted for the shared subtree
        if isinstance(e, (Negated, Scaled)):
            walk(e.expr)
        elif isinstance(e, (Sum, Product)):
            walk(e.a)
            walk(e.b)

    for e in exprs:
        walk(e)
    return {e: [n, _UNSET] for e, n in counts.items() if n >= 2}


def fresh_memo(template: dict) -> dict:
    return {e: [n, _UNSET] for e, (n, _) in template.items()}


def evaluate_expression_host(f, expr: Expression, *,
                             advice_evals, fixed_evals, instance_evals):
    """Evaluate an Expression on host scalars using the vk's query indices
    (the verifier path, plonk/verifier.rs:230-253)."""
    p = f.modulus
    return expr.evaluate(
        constant=lambda v: v % p,
        selector_fn=lambda s: (_ for _ in ()).throw(
            RuntimeError("virtual selectors are removed")),
        fixed_fn=lambda q: fixed_evals[q.query_index],
        advice_fn=lambda q: advice_evals[q.query_index],
        instance_fn=lambda q: instance_evals[q.query_index],
        negated=lambda a: (-a) % p,
        sum_fn=lambda a, b: (a + b) % p,
        product=lambda a, b: a * b % p,
        scaled=lambda a, v: a * v % p,
    )


def coset_points(domain: EvaluationDomain, rows=WHOLE) -> torch.Tensor:
    """[zeta * omega_ext^i] for the extended domain (the rows of `rows`'s
    rank), Montgomery form -- the 'LinearTerm' basis array (a host powers
    recurrence started at zeta)."""
    from ..poly.utils import powers
    p = domain.df.spec.modulus
    start, count = rows.row_span(domain.extended_n)
    return powers(domain.df, domain.extended_omega, count, domain.device,
                  start=domain.g_coset * pow(domain.extended_omega, start,
                                             p) % p)


# ---------------------------------------------------------------------------
# gate-chunk tapes (kernel K2, ops/gate_kernels.py)
# ---------------------------------------------------------------------------

def compile_chunk(chunk) -> "GateTape":
    """A chunk of gate polynomials as a tape for kernel K2: the
    instructions that evaluate each polynomial and fold it into the
    chunk's accumulator (acc = acc * y + t, in the chunk's order), one
    instruction per distinct node. The chunk is hash-consed with
    expression_share_counts as the reference's jitted chunk is
    (halo2_tpu/plonk/prover.py:226-233). A sum or product evaluates first
    the operand that needs more slots (Sethi-Ullman labels over the DAG:
    a leaf needs 1, a node with operands of equal need one more than
    they); every field op is exact, so the order changes no value, only
    the instructions' order and slots. Slots are given by liveness over
    the emitted instructions: a value holds its slot from the instruction
    that makes it to the last instruction that reads it (a shared node's
    first reader may come after its last visit), and the slot is then
    free for the next value. The op word's flag bits let the kernel keep
    the previous result in registers: OPF_X_LAST / OPF_Y_LAST on an
    operand that the previous instruction made, OPF_KEEP on a result that
    only the next instruction reads (the kernel does not write its
    slot)."""
    from ..ops.gate_kernels import (GateTape, OP_QUERY, OP_CONST, OP_NEG,
                                    OP_ADD, OP_MUL, OP_SCALE, OP_FOLD,
                                    OPF_KEEP, OPF_X_LAST, OPF_Y_LAST,
                                    KIND_ADVICE, KIND_FIXED, KIND_INSTANCE)
    from .circuit import (Constant, SelectorExpr, FixedQuery, AdviceQuery,
                          InstanceQuery, Negated, Sum, Product, Scaled)
    kinds = {AdviceQuery: KIND_ADVICE, FixedQuery: KIND_FIXED,
             InstanceQuery: KIND_INSTANCE}
    shared = expression_share_counts(chunk)
    made: dict = {}               # shared node -> its value
    consts: dict = {}             # constant -> index in the constant table
    code: list = []               # (op, value made or None, x, y, reads)
    needs: dict = {}

    def need(e) -> int:
        """Slots e's evaluation needs (its Sethi-Ullman label)."""
        v = needs.get(e)
        if v is None:
            if isinstance(e, (Negated, Scaled)):
                v = need(e.expr)
            elif isinstance(e, (Sum, Product)):
                la, lb = need(e.a), need(e.b)
                v = la + 1 if la == lb else max(la, lb)
            else:
                v = 1
            needs[e] = v
        return v

    def const_index(v: int) -> int:
        return consts.setdefault(v, len(consts))

    def go(e) -> int:
        """The value (the index of the instruction that makes it) of e."""
        v = made.get(e)
        if v is not None:
            return v
        if isinstance(e, Constant):
            ins = (OP_CONST, const_index(e.value), 0, ())
        elif isinstance(e, (FixedQuery, AdviceQuery, InstanceQuery)):
            ins = (OP_QUERY, (kinds[type(e)] << 16) | e.column_index,
                   e.rotation.value, ())
        elif isinstance(e, Negated):
            a = go(e.expr)
            ins = (OP_NEG, a, 0, (a,))
        elif isinstance(e, Scaled):
            a = go(e.expr)
            ins = (OP_SCALE, a, const_index(e.scalar), (a,))
        elif isinstance(e, (Sum, Product)):
            if need(e.b) > need(e.a):
                b = go(e.b)
                a = go(e.a)
            else:
                a = go(e.a)
                b = go(e.b)
            ins = (OP_ADD if isinstance(e, Sum) else OP_MUL, a, b, (a, b))
        elif isinstance(e, SelectorExpr):
            raise RuntimeError(
                "virtual selectors are removed during optimization")
        else:
            raise TypeError(f"unknown expression node {type(e)}")
        code.append(ins)
        v = len(code) - 1
        if e in shared:
            made[e] = v
        return v

    for i, e in enumerate(chunk):
        v = go(e)
        code.append((OP_FOLD, v, int(i == 0), (v,)))
    last, readers = {}, {}
    for i, (*_, reads) in enumerate(code):
        for v in reads:
            last[v] = i
            readers.setdefault(v, set()).add(i)
    slot, free, out, n_slots = {}, [], [], 0
    for i, (op, x, y, reads) in enumerate(code):
        for v in set(reads):      # read before the result is written
            if last[v] == i:
                free.append(slot[v])
        sx = slot[x] if op in (OP_NEG, OP_SCALE, OP_ADD, OP_MUL,
                               OP_FOLD) else x
        sy = slot[y] if op in (OP_ADD, OP_MUL) else y
        dst = 0
        if op != OP_FOLD:
            if free:
                free.sort()
                dst = free.pop(0)
            else:
                dst, n_slots = n_slots, n_slots + 1
            slot[i] = dst
        # the register flags: the previous instruction's result as an
        # operand, and a result that the next instruction alone reads
        word = op
        prev = i - 1 if i and code[i - 1][0] != OP_FOLD else None
        if prev is not None and reads:
            if reads[0] == prev:
                word |= OPF_X_LAST
            if len(reads) == 2 and reads[1] == prev:
                word |= OPF_Y_LAST
        if op != OP_FOLD and readers[i] == {i + 1}:
            word |= OPF_KEEP
        out.append((word, dst, sx, sy))
    return GateTape(code=out, consts=list(consts), n_slots=n_slots,
                    n_polys=len(chunk))
