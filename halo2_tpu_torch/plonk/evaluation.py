"""Gate-expression evaluation over whole field tensors.

Port of halo2_tpu/plonk/evaluation.py (the reference's AST evaluator,
halo2_proofs/src/poly/evaluator.rs:19-615): each `Expression` node is one
whole-tensor field op (kernel launches on CUDA), evaluated eagerly with a
use-counted memo that hash-conses repeated subtrees. Rotations are
`torch.roll` index shifts (scale 2^(extended_k - k) on the extended
domain, rotate_extended, domain.rs:257-275); `LinearTerm` needs the coset
points zeta * omega_ext^i (BasisOps::linear_term, evaluator.rs:584-604).
"""
from __future__ import annotations

import torch

from ..fields.device import DeviceField, fneg
from ..ops.field_kernels import fadd, fmul
from ..poly.domain import EvaluationDomain
from .circuit import Expression


def _rot(values: torch.Tensor, rotation: int, scale: int) -> torch.Tensor:
    if rotation == 0:
        return values
    return torch.roll(values, -rotation * scale, dims=0)


def evaluate_expression(df: DeviceField, expr: Expression, *,
                        advice, fixed, instance,
                        rot_scale: int = 1,
                        selector_fn=None, memo: dict | None = None):
    """Evaluate one gate Expression over arrays (Lagrange basis when
    rot_scale == 1, extended-coset basis when rot_scale == 2^(ek-k)).
    `advice/fixed/instance` are lists of [N, 16] Montgomery tensors.
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
                                    q.rotation.value, rot_scale),
            advice_fn=lambda q: _rot(advice[q.column_index],
                                     q.rotation.value, rot_scale),
            instance_fn=lambda q: _rot(instance[q.column_index],
                                       q.rotation.value, rot_scale),
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
            r = _rot(fixed[e.column_index], e.rotation.value, rot_scale)
        elif isinstance(e, AdviceQuery):
            r = _rot(advice[e.column_index], e.rotation.value, rot_scale)
        elif isinstance(e, InstanceQuery):
            r = _rot(instance[e.column_index], e.rotation.value,
                     rot_scale)
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


def coset_points(domain: EvaluationDomain) -> torch.Tensor:
    """[zeta * omega_ext^i] for the extended domain, Montgomery form -- the
    'LinearTerm' basis array (a host powers recurrence started at zeta)."""
    from ..poly.utils import powers
    return powers(domain.df, domain.extended_omega, domain.extended_n,
                  domain.device, start=domain.g_coset)
