"""Byte-exact rendering of the pinned verification key.

The reference computes vk.transcript_repr by hashing the Rust `{:?}`
(derived Debug) text of `PinnedVerificationKey` (plonk.rs:75-90); its
test suite pins the `{:#?}` (alternate) form of the same structure
(halo2_proofs/tests/plonk_api.rs:587-957).  This module reproduces both
renderings byte-for-byte:

 * derived-Debug layout rules for structs / tuple structs / lists /
   plain tuples (std `fmt::DebugStruct` etc.): compact one-line form for
   `{:?}`, 4-space-indented multi-line form with trailing commas for
   `{:#?}`; empty lists and empty structs stay inline in both.
 * pasta field elements print as `0x` + 64 lowercase hex digits; affine
   points use a custom single-line `(x, y)` Debug (never expanded, as
   visible in the plonk_api golden text), identity prints `Infinity`.
 * `Expression`'s custom Debug (circuit.rs:676-720) prints query enum
   variants as structs `Fixed/Advice/Instance { query_index,
   column_index, rotation }` and the rest as tuple variants.

Field orders follow the struct declarations (derived Debug order):
PinnedVerificationKey (plonk.rs:121-128), PinnedEvaluationDomain
(domain.rs:494-498), PinnedConstraintSystem (circuit.rs:971-984, note
advice_queries precedes instance_queries precedes fixed_queries),
permutation::Argument (permutation.rs:13-16), lookup::Argument
(lookup.rs:8-11), permutation::VerifyingKey (permutation.rs:74-76).

Copied unchanged from halo2_tpu/plonk/pinned.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from .circuit import (ADVICE, FIXED, INSTANCE, Column, Constant,
                      SelectorExpr, FixedQuery, AdviceQuery, InstanceQuery,
                      Negated, Sum, Product, Scaled)

_TYPE_NAME = {ADVICE: "Advice", FIXED: "Fixed", INSTANCE: "Instance"}


# ---------------------------------------------------------------- nodes
# ("s", name, [(field, node), ...])   struct        Name { f: v }
# ("t", name, [node, ...])            tuple struct  Name(v); name "" = tuple
# ("l", [node, ...])                  list          [v, w]
# ("r", text)                         raw token     17, None, Advice, 0x...
# ("q", text)                         quoted str    "0x..."

def render_compact(n) -> str:
    kind = n[0]
    if kind == "r":
        return n[1]
    if kind == "q":
        return '"' + n[1] + '"'
    if kind == "s":
        _, name, fields = n
        if not fields:
            return name
        inner = ", ".join(f + ": " + render_compact(v) for f, v in fields)
        return name + " { " + inner + " }"
    if kind == "t":
        _, name, items = n
        return name + "(" + ", ".join(render_compact(v) for v in items) + ")"
    if kind == "l":
        return "[" + ", ".join(render_compact(v) for v in n[1]) + "]"
    raise ValueError(kind)


def render_alternate(n, indent: int = 0) -> str:
    kind = n[0]
    if kind == "r":
        return n[1]
    if kind == "q":
        return '"' + n[1] + '"'
    pad = " " * indent
    inner = " " * (indent + 4)
    if kind == "s":
        _, name, fields = n
        if not fields:
            return name
        body = "".join(inner + f + ": " + render_alternate(v, indent + 4) +
                       ",\n" for f, v in fields)
        return name + " {\n" + body + pad + "}"
    if kind == "t":
        _, name, items = n
        body = "".join(inner + render_alternate(v, indent + 4) + ",\n"
                       for v in items)
        return name + "(\n" + body + pad + ")"
    if kind == "l":
        items = n[1]
        if not items:
            return "[]"
        body = "".join(inner + render_alternate(v, indent + 4) + ",\n"
                       for v in items)
        return "[\n" + body + pad + "]"
    raise ValueError(kind)


# ------------------------------------------------------------- builders
def _fe(v: int):
    return ("r", f"0x{v:064x}")


def _point(curve, pt):
    if pt is None:
        return ("r", "Infinity")
    return ("r", f"(0x{pt[0]:064x}, 0x{pt[1]:064x})")


def _rotation(rot):
    return ("t", "Rotation", [("r", str(rot.value))])


def _column(col: Column):
    return ("s", "Column", [("index", ("r", str(col.index))),
                            ("column_type",
                             ("r", _TYPE_NAME[col.column_type]))])


def _query_list(queries):
    return ("l", [("t", "", [_column(c), _rotation(r)])
                  for c, r in queries])


def expression_node(e):
    """Expression's custom Debug impl (circuit.rs:676-720)."""
    if isinstance(e, Constant):
        return ("t", "Constant", [_fe(e.value)])
    if isinstance(e, SelectorExpr):
        simple = "true" if e.selector.simple else "false"
        return ("t", "Selector",
                [("t", "Selector", [("r", str(e.selector.index)),
                                    ("r", simple)])])
    for cls, name in ((FixedQuery, "Fixed"), (AdviceQuery, "Advice"),
                      (InstanceQuery, "Instance")):
        if isinstance(e, cls):
            return ("s", name,
                    [("query_index", ("r", str(e.query_index))),
                     ("column_index", ("r", str(e.column_index))),
                     ("rotation", _rotation(e.rotation))])
    if isinstance(e, Negated):
        return ("t", "Negated", [expression_node(e.expr)])
    if isinstance(e, Sum):
        return ("t", "Sum", [expression_node(e.a), expression_node(e.b)])
    if isinstance(e, Product):
        return ("t", "Product", [expression_node(e.a), expression_node(e.b)])
    if isinstance(e, Scaled):
        return ("t", "Scaled", [expression_node(e.expr), _fe(e.scalar)])
    raise TypeError(f"unknown expression {type(e)}")


def pinned_cs_node(cs):
    gates = ("l", [expression_node(p) for g in cs.gates for p in g.polys])
    lookups = ("l", [
        ("s", "Argument",
         [("input_expressions",
           ("l", [expression_node(x) for x in lk.input_expressions])),
          ("table_expressions",
           ("l", [expression_node(x) for x in lk.table_expressions]))])
        for lk in cs.lookups])
    mind = (("r", "None") if cs.minimum_degree is None
            else ("t", "Some", [("r", str(cs.minimum_degree))]))
    return ("s", "PinnedConstraintSystem", [
        ("num_fixed_columns", ("r", str(cs.num_fixed_columns))),
        ("num_advice_columns", ("r", str(cs.num_advice_columns))),
        ("num_instance_columns", ("r", str(cs.num_instance_columns))),
        ("num_selectors", ("r", str(cs.num_selectors))),
        ("gates", gates),
        ("advice_queries", _query_list(cs.advice_queries)),
        ("instance_queries", _query_list(cs.instance_queries)),
        ("fixed_queries", _query_list(cs.fixed_queries)),
        ("permutation",
         ("s", "Argument",
          [("columns", ("l", [_column(c)
                              for c in cs.permutation.columns]))])),
        ("lookups", lookups),
        ("constants", ("l", [_column(c) for c in cs.constants])),
        ("minimum_degree", mind),
    ])


def pinned_vk_node(vk):
    curve = vk.curve
    d = vk.domain.pinned()
    return ("s", "PinnedVerificationKey", [
        ("base_modulus", ("q", f"0x{curve.base.modulus:064x}")),
        ("scalar_modulus", ("q", f"0x{curve.scalar.modulus:064x}")),
        ("domain", ("s", "PinnedEvaluationDomain",
                    [("k", ("r", str(d["k"]))),
                     ("extended_k", ("r", str(d["extended_k"]))),
                     ("omega", _fe(d["omega"]))])),
        ("cs", pinned_cs_node(vk.cs)),
        ("fixed_commitments",
         ("l", [_point(curve, c) for c in vk.fixed_commitments])),
        ("permutation",
         ("s", "VerifyingKey",
          [("commitments",
            ("l", [_point(curve, c)
                   for c in vk.permutation_commitments]))])),
    ])
