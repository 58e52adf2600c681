"""Selector compression: pack mutually-exclusive simple selectors into
shared fixed columns.

Exact port of the reference algorithm (vk-critical):
halo2_proofs/src/plonk/circuit/compress_selectors.rs:51-220 and
ConstraintSystem::compress_selectors (plonk/circuit.rs:1237-1343):
  - per-selector max gate degree (0 for complex/unused selectors);
  - degree-0 selectors get direct fixed columns;
  - exclusion matrix over row overlap, then greedy first-fit packing
    under the gate degree bound (combination degree =
    max(member degree − 1) + #members + 1 constraint);
  - substituted expression q·∏_{root ≠ assigned}(root − q) over the
    combination column whose values are the assigned roots (0 = none).

Copied unchanged from halo2_tpu/plonk/compress_selectors.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from .circuit import (ConstraintSystem, Column, Expression, SelectorExpr,
                      FixedQuery, Negated, Sum, Product, Scaled, Constant,
                      Gate, FIXED)
from ..poly.polynomial import Rotation


@dataclass
class SelectorDescription:
    selector: int
    activations: list[bool]
    max_degree: int


@dataclass
class SelectorAssignment:
    selector: int
    combination_index: int
    expression: Expression


def process(selectors: list[SelectorDescription], max_degree: int,
            allocate_fixed_column):
    """compress_selectors.rs:51-220."""
    if not selectors:
        return [], []
    n = len(selectors[0].activations)
    assert all(len(s.activations) == n for s in selectors)

    combination_assignments: list[list[int]] = []
    selector_assignments: list[SelectorAssignment] = []

    remaining = []
    for sel in selectors:
        if sel.max_degree == 0:
            expression = allocate_fixed_column()
            combination_assignments.append(
                [1 if b else 0 for b in sel.activations])
            selector_assignments.append(SelectorAssignment(
                selector=sel.selector,
                combination_index=len(combination_assignments) - 1,
                expression=expression))
        else:
            remaining.append(sel)
    selectors = remaining

    # exclusion matrix (lower triangular)
    exclusion = [[False] * i for i in range(len(selectors))]
    for i, sel in enumerate(selectors):
        for j in range(i):
            other = selectors[j]
            if any(l and r for l, r in zip(sel.activations,
                                           other.activations)):
                exclusion[i][j] = True

    added = [False] * len(selectors)
    for i, selector in enumerate(selectors):
        if added[i]:
            continue
        added[i] = True
        assert selector.max_degree <= max_degree
        d = selector.max_degree - 1
        combination = [selector]
        combination_added = [i]

        for j in range(i + 1, len(selectors)):
            if d + len(combination) == max_degree:
                break
            if added[j]:
                continue
            if any(exclusion[j][k] for k in combination_added):
                continue
            new_d = max(d, selectors[j].max_degree - 1)
            if new_d + len(combination) + 1 > max_degree:
                continue
            d = new_d
            combination.append(selectors[j])
            combination_added.append(j)
            added[j] = True

        combination_assignment = [0] * n
        combination_len = len(combination)
        combination_index = len(combination_assignments)
        query = allocate_fixed_column()

        assigned_root = 1
        for sel in combination:
            expression = query
            for root in range(1, combination_len + 1):
                if root != assigned_root:
                    expression = expression * (Constant(root) - query)
            for row, active in enumerate(sel.activations):
                if active:
                    combination_assignment[row] = assigned_root
            selector_assignments.append(SelectorAssignment(
                selector=sel.selector,
                combination_index=combination_index,
                expression=expression))
            assigned_root += 1
        combination_assignments.append(combination_assignment)

    return combination_assignments, selector_assignments


def replace_selectors(expr: Expression, replacements: list[Expression],
                      must_be_nonsimple: bool = False) -> Expression:
    if isinstance(expr, SelectorExpr):
        if must_be_nonsimple:
            assert not expr.selector.simple, \
                "simple selectors are prohibited in lookup arguments"
        return replacements[expr.selector.index]
    if isinstance(expr, Negated):
        return Negated(replace_selectors(expr.expr, replacements,
                                         must_be_nonsimple))
    if isinstance(expr, Sum):
        return Sum(replace_selectors(expr.a, replacements,
                                     must_be_nonsimple),
                   replace_selectors(expr.b, replacements,
                                     must_be_nonsimple))
    if isinstance(expr, Product):
        return Product(replace_selectors(expr.a, replacements,
                                         must_be_nonsimple),
                       replace_selectors(expr.b, replacements,
                                         must_be_nonsimple))
    if isinstance(expr, Scaled):
        return Scaled(replace_selectors(expr.expr, replacements,
                                        must_be_nonsimple), expr.scalar)
    return expr


def compress_selectors(cs: ConstraintSystem, selectors: list[list[bool]]
                       ) -> tuple[ConstraintSystem, list[list[int]]]:
    """ConstraintSystem::compress_selectors (plonk/circuit.rs:1237-1343).
    Returns (mutated cs, new fixed column value vectors)."""
    assert len(selectors) == cs.num_selectors

    degrees = [0] * len(selectors)
    for gate in cs.gates:
        for poly in gate.polys:
            sel = poly.extract_simple_selector()
            if sel is not None:
                degrees[sel.index] = max(degrees[sel.index], poly.degree())

    max_degree = cs.degree()
    new_columns: list[Column] = []

    def allocate():
        column = cs.fixed_column()
        new_columns.append(column)
        return FixedQuery(
            query_index=cs.query_fixed_index(column, Rotation(0)),
            column_index=column.index, rotation=Rotation(0))

    polys, selector_assignment = process(
        [SelectorDescription(selector=i, activations=act,
                             max_degree=degrees[i])
         for i, act in enumerate(selectors)],
        max_degree, allocate)

    selector_map: list = [None] * len(selector_assignment)
    replacements: list = [None] * len(selector_assignment)
    for assignment in selector_assignment:
        replacements[assignment.selector] = assignment.expression
        selector_map[assignment.selector] = \
            new_columns[assignment.combination_index]
    cs.selector_map = selector_map

    cs.gates = [
        Gate(name=g.name, constraint_names=g.constraint_names,
             polys=[replace_selectors(p, replacements) for p in g.polys],
             queried_selectors=g.queried_selectors,
             queried_cells=g.queried_cells)
        for g in cs.gates]
    for lk in cs.lookups:
        lk.input_expressions = [
            replace_selectors(e, replacements, must_be_nonsimple=True)
            for e in lk.input_expressions]
        lk.table_expressions = [
            replace_selectors(e, replacements, must_be_nonsimple=True)
            for e in lk.table_expressions]
    return cs, polys
