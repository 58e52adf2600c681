"""CircuitCost: static cost model with byte-exact proof sizes.

Reference: halo2_proofs/src/dev/cost.rs:26-416 — counts commitments and
evaluations per proof instance and computes the exact proof size
(validated against real proofs in tests/plonk_api.rs:491-496):
  per instance: advice commitments ×32 + query evals ×32;
  lookup = 3 commitments + 5 evals; permutation chunk = 1 commitment +
  (3·chunks − 1) evals; vanishing = quotient_degree commitments + 1 eval +
  random commitment; multiopen = 1 commitment + |point_sets| evals;
  polycomm (IPA) = (1 + 2k) commitments + 2 scalars.

Copied from halo2_tpu/dev/cost.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..plonk.circuit import ConstraintSystem


@dataclass
class ProofSize:
    point_bytes: int
    scalar_bytes: int

    @property
    def total(self) -> int:
        return self.point_bytes + self.scalar_bytes


class CircuitCost:
    def __init__(self, k: int, cs: ConstraintSystem):
        self.k = k
        self.cs = cs

    @classmethod
    def measure(cls, k: int, circuit) -> "CircuitCost":
        """Configure AND synthesize (empty witness), then compress
        selectors — the proof size depends on the POST-compression
        constraint system (packed selectors share fixed columns, so the
        verifier reads fewer fixed evals than one-per-selector).  The
        reference's CircuitCost::measure also runs full synthesis
        (dev/cost.rs Layout assignment)."""
        cs = ConstraintSystem()
        config = type(circuit).configure(cs)
        try:
            from ..plonk.keygen import Assembly, _synthesize
            from ..plonk.compress_selectors import compress_selectors
            from ..fields.host import FP

            class _P:
                n = 1 << k
                pass
            _P.k = k
            asm = Assembly(cs, _P, FP)
            _synthesize(circuit.without_witnesses(), config, asm,
                        cs.constants)
            cs, _polys = compress_selectors(cs, asm.selectors)
            compressed = True
        except Exception:
            compressed = False  # fall back to the configure-only view
        out = cls(k, cs)
        out._compressed = compressed
        return out

    def proof_size_exact(self, instance_count: int = 1) -> ProofSize:
        """Byte-exact proof size: symbolically replay the verifier's read
        schedule and multiopen grouping (dev/cost.rs:347-416, validated
        like tests/plonk_api.rs:491-496)."""
        from ..poly.multiopen import construct_intermediate_sets
        cs = self.cs
        k = self.k
        chunk_len = max(cs.degree() - 2, 1)
        perm_chunks = ((len(cs.permutation.columns) + chunk_len - 1)
                       // chunk_len if cs.permutation.columns else 0)
        quotient_degree = max(cs.degree() - 1, 1)

        points = 0   # curve points written to the proof
        scalars = 0  # field elements written to the proof

        # commitments (in transcript write order)
        points += instance_count * cs.num_advice_columns
        points += instance_count * 2 * len(cs.lookups)   # permuted A', S'
        points += instance_count * perm_chunks           # permutation z
        points += instance_count * len(cs.lookups)       # lookup products
        points += 1                                      # vanishing random
        points += quotient_degree                        # h pieces
        # evals
        # After selector compression (measure() runs it), the packed
        # selector columns' queries are already in cs.fixed_queries; the
        # configure-only fallback approximates one column per selector.
        extra_selector_queries = (0 if getattr(self, "_compressed", False)
                                  else cs.num_selectors)
        num_fixed_queries = len(cs.fixed_queries) + extra_selector_queries
        scalars += instance_count * len(cs.instance_queries)
        scalars += instance_count * len(cs.advice_queries)
        scalars += num_fixed_queries
        scalars += 1                                     # random_eval
        scalars += len(cs.permutation.columns)           # sigma evals
        scalars += instance_count * (3 * perm_chunks - 1
                                     if perm_chunks else 0)
        scalars += instance_count * 5 * len(cs.lookups)

        # multiopen point-set structure: replay the verifier's queries
        # with symbolic commitments / rotation labels
        queries = []  # (point_label, commitment_key)

        def add(comm_key, rot_label):
            queries.append((rot_label, comm_key))

        X, X_NEXT, X_INV, X_LAST = "x", "x_next", "x_inv", "x_last"
        for pf in range(instance_count):
            for qi, (column, at) in enumerate(cs.instance_queries):
                add(("inst", pf, column.index), ("rot", at.value))
            for qi, (column, at) in enumerate(cs.advice_queries):
                add(("adv", pf, column.index), ("rot", at.value))
            for s in range(perm_chunks):
                add(("permz", pf, s), ("rot", 0))
                add(("permz", pf, s), ("rot", 1))
            for s in range(perm_chunks - 1):
                add(("permz", pf, s), X_LAST)
            for li in range(len(cs.lookups)):
                add(("lkprod", pf, li), ("rot", 0))
                add(("lkin", pf, li), ("rot", 0))
                add(("lktab", pf, li), ("rot", 0))
                add(("lkin", pf, li), ("rot", -1))
                add(("lkprod", pf, li), ("rot", 1))
        for qi, (column, at) in enumerate(cs.fixed_queries):
            add(("fix", column.index), ("rot", at.value))
        for si in range(extra_selector_queries):
            add(("selfix", si), ("rot", 0))
        for ci in range(len(cs.permutation.columns)):
            add(("sigma", ci), ("rot", 0))
        add(("h",), ("rot", 0))
        add(("rand",), ("rot", 0))

        result = construct_intermediate_sets(
            queries, get_point=lambda q: q[0], get_eval=lambda q: 0,
            get_key=lambda q: q[1], track_evals=False)
        _, point_sets = result
        scalars += len(point_sets)                       # multiopen u_i

        points += 1                                      # multiopen q'
        points += 1 + 2 * k                              # IPA S, L/R
        scalars += 2                                     # IPA c, f
        return ProofSize(point_bytes=points * 32,
                         scalar_bytes=scalars * 32)

    def _point_sets_and_evals(self, instance_count: int = 1):
        """Count distinct opening points and per-proof evaluations,
        mirroring cost.rs:347-416."""
        cs = self.cs
        chunk_len = max(cs.degree() - 2, 1)
        perm_chunks = ((len(cs.permutation.columns) + chunk_len - 1)
                       // chunk_len)

        # distinct rotations queried (x is rotation 0)
        rotations = set()
        for _, rot in (cs.advice_queries + cs.instance_queries
                       + cs.fixed_queries):
            rotations.add(rot.value)
        rotations.add(0)
        if cs.lookups:
            rotations.update({-1, 1})
        if cs.permutation.columns:
            rotations.update({1})
        point_sets = set()
        # commitment point-sets: queries at {rot set per commitment}
        # conservative exact construction mirrors the verifier queries:
        def column_rots(queries, column):
            return frozenset(r.value for c, r in queries if c == column)
        for column, _ in cs.advice_queries:
            point_sets.add(column_rots(cs.advice_queries, column))
        for column, _ in cs.instance_queries:
            point_sets.add(column_rots(cs.instance_queries, column))
        for column, _ in cs.fixed_queries:
            point_sets.add(column_rots(cs.fixed_queries, column))
        if cs.permutation.columns:
            point_sets.add(frozenset({0, 1}))        # z first sets
            if perm_chunks > 1:
                pass  # last-rotation set counted below
            point_sets.add(frozenset({0}))           # sigma polys
        if cs.lookups:
            point_sets.add(frozenset({0, 1}))        # product
            point_sets.add(frozenset({0, -1}))       # permuted input
            point_sets.add(frozenset({0}))           # permuted table
        point_sets.add(frozenset({0}))               # h, random
        return perm_chunks, point_sets

    def proof_size(self, instance_count: int = 1) -> ProofSize:
        return self.proof_size_exact(instance_count)

    def _proof_size_heuristic(self, instance_count: int = 1) -> ProofSize:
        cs = self.cs
        k = self.k
        perm_chunks, point_sets = self._point_sets_and_evals(instance_count)
        quotient_degree = max(cs.degree() - 1, 1)

        points = 0
        scalars = 0
        per_instance_points = (
            cs.num_advice_columns
            + 3 * len(cs.lookups)       # permuted input, table, product
            + perm_chunks)              # permutation z commitments
        per_instance_scalars = (
            len(cs.instance_queries)
            + len(cs.advice_queries)
            + 5 * len(cs.lookups)
            + (3 * perm_chunks - 1 if perm_chunks else 0))

        points += instance_count * per_instance_points
        scalars += instance_count * per_instance_scalars

        # shared: vanishing random + h pieces; fixed evals; sigma evals
        points += 1 + quotient_degree
        scalars += 1  # random_eval
        scalars += len(cs.fixed_queries)
        scalars += len(cs.permutation.columns)

        # multiopen: q' commitment + per-point-set evals u_i
        points += 1
        scalars += len(point_sets)

        # IPA: S commitment + 2k L/R points + c, f scalars
        points += 1 + 2 * k
        scalars += 2

        return ProofSize(point_bytes=points * 32, scalar_bytes=scalars * 32)


def _format_value(v: int) -> str:
    """dev/util.rs:58-74: 0 / 1 / -1 / bare hex without 0x-padding."""
    if v == 0:
        return "0"
    if v == 1:
        return "1"
    if v == -1:
        return "-1"
    return hex(v)[2:].lstrip("0") or "0"


def _format_expr(poly) -> str:
    """The reference's expression pretty-printer (gates.rs:119-152)."""
    def neg(a):
        return f"-({a})" if " " in a else f"-{a}"

    def add(a, b):
        if b.startswith("-"):
            return f"{a} - {b[1:]}"
        return f"{a} + {b}"

    def mul(a, b):
        a = f"({a})" if " " in a else a
        b = f"({b})" if " " in b else b
        return f"{a} * {b}"

    def scaled(a, s):
        a = f"({a})" if " " in a else a
        return f"{a} * {_format_value(s)}"

    return poly.evaluate(
        constant=_format_value,
        selector_fn=lambda s: f"S{s.index}",
        fixed_fn=lambda q: f"F{q.column_index}@{q.rotation.value}",
        advice_fn=lambda q: f"A{q.column_index}@{q.rotation.value}",
        instance_fn=lambda q: f"I{q.column_index}@{q.rotation.value}",
        negated=neg, sum_fn=add, product=mul, scaled=scaled)


def _expr_queries(poly) -> set:
    return poly.evaluate(
        constant=lambda v: set(),
        selector_fn=lambda s: {f"S{s.index}"},
        fixed_fn=lambda q: {f"F{q.column_index}@{q.rotation.value}"},
        advice_fn=lambda q: {f"A{q.column_index}@{q.rotation.value}"},
        instance_fn=lambda q: {f"I{q.column_index}@{q.rotation.value}"},
        negated=lambda a: a, sum_fn=lambda a, b: a | b,
        product=lambda a, b: a | b, scaled=lambda a, s: a)


class CircuitGates:
    """Static gate inventory with the reference's expression formatting,
    op totals, Display string and query CSV (dev/gates.rs:94-262)."""

    def __init__(self, gates, totals):
        # gates: [(gate_name, [(constraint_name, expr_str, queries)])]
        self.gates = gates
        (self.total_negations, self.total_additions,
         self.total_multiplications) = totals

    @classmethod
    def collect(cls, circuit_cls) -> "CircuitGates":
        cs = ConstraintSystem()
        circuit_cls.configure(cs)
        gates = []
        tot = (0, 0, 0)
        for gate in cs.gates:
            constraints = []
            for name, poly in zip(gate.constraint_names, gate.polys):
                constraints.append((name or "", _format_expr(poly),
                                    _expr_queries(poly)))
                n, a, m = poly.evaluate(
                    constant=lambda v: (0, 0, 0),
                    selector_fn=lambda s: (0, 0, 0),
                    fixed_fn=lambda q: (0, 0, 0),
                    advice_fn=lambda q: (0, 0, 0),
                    instance_fn=lambda q: (0, 0, 0),
                    negated=lambda t: (t[0] + 1, t[1], t[2]),
                    sum_fn=lambda t, u: (t[0] + u[0], t[1] + u[1] + 1,
                                         t[2] + u[2]),
                    product=lambda t, u: (t[0] + u[0], t[1] + u[1],
                                          t[2] + u[2] + 1),
                    scaled=lambda t, s: (t[0], t[1], t[2] + 1))
                tot = (tot[0] + n, tot[1] + a, tot[2] + m)
            gates.append((gate.name, constraints))
        return cls(gates, tot)

    def queries_to_csv(self) -> str:
        """gates.rs:218-249: query-membership grid, one row per
        constraint, sorted query columns."""
        queries = sorted({q for _g, cons in self.gates
                          for _n, _e, qs in cons for q in qs})
        lines = ["".join(f"{q}," for q in queries) + "Name"]
        for gname, cons in self.gates:
            for cname, _expr, qs in cons:
                row = "".join("1," if q in qs else "0," for q in queries)
                lines.append(f"{row}{gname}/{cname}")
        return "\n".join(lines) + "\n"

    def __str__(self):
        lines = []
        for gname, cons in self.gates:
            lines.append(f"{gname}:")
            for cname, expr, _qs in cons:
                if not cname:
                    lines.append(f"- {expr}")
                else:
                    lines.append(f"- {cname}:")
                    lines.append(f"  {expr}")
        lines.append(f"Total gates: {len(self.gates)}")
        lines.append("Total custom constraint polynomials: "
                     + str(sum(len(c) for _g, c in self.gates)))
        lines.append(f"Total negations: {self.total_negations}")
        lines.append(f"Total additions: {self.total_additions}")
        lines.append(f"Total multiplications: {self.total_multiplications}")
        return "\n".join(lines) + "\n"
