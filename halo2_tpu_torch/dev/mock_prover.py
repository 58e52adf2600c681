"""MockProver: the universal circuit oracle — synthesize + check every
constraint in the clear, no commitments or FFTs.

Reference: halo2_proofs/src/dev.rs:271-924 —
  run (:485-567): bounds checks, instance padding, advice pre-poisoned
  beyond usable rows, synthesis recording regions/selectors/copies,
  selector compression;
  verify (:576-904): four error streams — queried-but-unassigned cells in
  selector-active regions, gate satisfaction row-by-row with Poison
  semantics (Mul-by-zero annihilates Poison, dev.rs:126-156), lookup
  containment, permutation consistency.

Port of halo2_tpu/dev/mock_prover.py: `run` and the host `verify` are
copied unchanged; `verify_vectorized` evaluates the gates over torch
tensors on the device it is given (kernel B1 and the field add/subtract
kernel on CUDA, their plain versions on the CPU).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fields.host import FieldSpec
from ..circuit.value import Value, SynthesisError
from ..circuit.layouter import Circuit
from ..plonk.circuit import (ConstraintSystem, Column, Selector, ADVICE,
                             FIXED, INSTANCE)
from ..plonk.assigned import Assigned
from ..plonk.compress_selectors import compress_selectors
from ..plonk.permutation import PermutationAssembly
from .failure import (FailureLocation, CellNotAssigned,
                      ConstraintNotSatisfied, ConstraintPoisoned,
                      LookupFailure, PermutationFailure)


class _Poison:
    """Blinding-row marker value (dev.rs:76-156)."""
    __slots__ = ()

    def __repr__(self):
        return "Poison"


POISON = _Poison()
UNASSIGNED = None


@dataclass
class Region:
    index: int
    name: str
    columns: set = field(default_factory=set)
    rows: tuple | None = None  # (start, end) inclusive
    enabled_selectors: dict = field(default_factory=dict)
    cells: dict = field(default_factory=dict)  # (column, row) -> True

    def track_row(self, row: int):
        if self.rows is None:
            self.rows = (row, row)
        else:
            self.rows = (min(self.rows[0], row), max(self.rows[1], row))


class MockProver:
    """dev.rs:271-567."""

    def __init__(self, fs: FieldSpec, k: int, cs: ConstraintSystem,
                 instance: list[list[int]]):
        self.fs = fs
        self.k = k
        self.n = 1 << k
        self.cs = cs
        self.usable_rows = self.n - (cs.blinding_factors() + 1)
        self.instance = instance
        self.regions: list[Region] = []
        self.current_region: Region | None = None
        self.fixed = [[UNASSIGNED] * self.n
                      for _ in range(cs.num_fixed_columns)]
        # advice poisoned beyond usable rows (dev.rs:526-536)
        self.advice = [
            [UNASSIGNED] * self.usable_rows
            + [POISON] * (self.n - self.usable_rows)
            for _ in range(cs.num_advice_columns)]
        self.selectors = [[False] * self.n for _ in range(cs.num_selectors)]
        self.permutation = PermutationAssembly(self.n, cs.permutation)

    # ---------------- Assignment interface ----------------
    def enter_region(self, name):
        assert self.current_region is None
        self.current_region = Region(index=len(self.regions), name=str(name))

    def exit_region(self):
        self.regions.append(self.current_region)
        self.current_region = None

    def enable_selector(self, annotation, selector: Selector, row: int):
        if row >= self.usable_rows:
            raise SynthesisError(f"not enough rows (k={self.k})")
        if self.current_region is not None:
            self.current_region.track_row(row)
            self.current_region.enabled_selectors.setdefault(
                selector, []).append(row)
        self.selectors[selector.index][row] = True

    def query_instance(self, column: Column, row: int) -> Value:
        if row >= self.usable_rows:
            raise SynthesisError(f"not enough rows (k={self.k})")
        col = self.instance[column.index]
        return Value.known(col[row] if row < len(col) else 0)

    def assign_advice(self, annotation, column: Column, row: int, to):
        if row >= self.usable_rows:
            raise SynthesisError(f"not enough rows (k={self.k})")
        if self.current_region is not None:
            self.current_region.track_row(row)
            self.current_region.columns.add(column)
            self.current_region.cells[(column, row)] = True
        v = to()
        v = v if isinstance(v, Value) else Value.known(v)
        if v.is_known():
            inner = v.inner()
            a = (inner if isinstance(inner, Assigned)
                 else Assigned.trivial(inner % self.fs.modulus))
            self.advice[column.index][row] = a.evaluate(self.fs)

    def assign_fixed(self, annotation, column: Column, row: int, to):
        if row >= self.usable_rows:
            raise SynthesisError(f"not enough rows (k={self.k})")
        if self.current_region is not None:
            self.current_region.track_row(row)
            self.current_region.columns.add(column)
            self.current_region.cells[(column, row)] = True
        v = to()
        v = v if isinstance(v, Value) else Value.known(v)
        if v.is_known():
            inner = v.inner()
            a = (inner if isinstance(inner, Assigned)
                 else Assigned.trivial(inner % self.fs.modulus))
            self.fixed[column.index][row] = a.evaluate(self.fs)

    def copy(self, left_column, left_row, right_column, right_row):
        if (left_row >= self.usable_rows or right_row >= self.usable_rows):
            raise SynthesisError(f"not enough rows (k={self.k})")
        self.permutation.copy(left_column, left_row, right_column, right_row)

    def fill_from_row(self, column: Column, from_row: int, value):
        if from_row >= self.usable_rows:
            raise SynthesisError(f"not enough rows (k={self.k})")
        inner = value.inner() if isinstance(value, Value) else value
        if inner is None:
            raise SynthesisError("fill value unknown")
        a = (inner if isinstance(inner, Assigned)
             else Assigned.trivial(inner % self.fs.modulus))
        v = a.evaluate(self.fs)
        col = self.fixed[column.index]
        for row in range(from_row, self.usable_rows):
            col[row] = v

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass

    # ---------------- entry point ----------------
    @classmethod
    def run(cls, k: int, circuit: Circuit, instance: list[list[int]],
            fs: FieldSpec | None = None) -> "MockProver":
        from ..fields.host import FQ
        fs = fs or FQ  # Pallas scalar field (the proving field)
        cs = ConstraintSystem()
        config = type(circuit).configure(cs)
        n = 1 << k
        if n < cs.minimum_rows():
            raise SynthesisError(f"n={n} < minimum_rows={cs.minimum_rows()}")
        if len(instance) != cs.num_instance_columns:
            raise SynthesisError("invalid number of instance columns")
        for col in instance:
            if len(col) > n - (cs.blinding_factors() + 1):
                raise SynthesisError("instance too large")

        prover = cls(fs, k, cs, [list(c) for c in instance])
        from ..circuit import synthesize_circuit
        synthesize_circuit(prover, circuit, config, cs.constants)

        # materialize selectors into fixed columns (dev.rs:556-564)
        prover.cs, selector_polys = compress_selectors(cs, prover.selectors)
        for poly in selector_polys:
            prover.fixed.append([v for v in poly])
        return prover

    # ---------------- verification ----------------
    def _cell_value(self, kind: str, column_index: int, row: int):
        row %= self.n
        if kind == ADVICE:
            v = self.advice[column_index][row]
            return 0 if v is UNASSIGNED else v
        if kind == FIXED:
            v = self.fixed[column_index][row]
            return 0 if v is UNASSIGNED else v
        col = self.instance[column_index]
        return col[row] if row < len(col) else 0

    def _collect_cell_values(self, poly, row: int) -> tuple:
        """The queried-cell table of a failing constraint at `row`:
        ((column_label, rotation), hex) per virtual cell, in query order
        (dev.rs:668-699 cell_values)."""
        seen = {}

        def visit(kind, letter, q):
            key = (f"{letter}{q.column_index}", q.rotation.value)
            if key not in seen:
                v = self._cell_value(kind, q.column_index,
                                     row + q.rotation.value)
                if v is POISON:
                    seen[key] = "poisoned"
                else:
                    seen[key] = hex(v)
            return 0

        poly.evaluate(
            constant=lambda v: 0,
            selector_fn=lambda q: 0,
            fixed_fn=lambda q: visit(FIXED, "F", q),
            advice_fn=lambda q: visit(ADVICE, "A", q),
            instance_fn=lambda q: visit(INSTANCE, "I", q),
            negated=lambda a: 0, sum_fn=lambda a, b: 0,
            product=lambda a, b: 0, scaled=lambda a, v: 0)
        return tuple(seen.items())

    def gate_zero_flags(self, device=None) -> list:
        """Device-vectorized gate evaluation: every gate polynomial over
        ALL rows, one whole-tensor field op per Expression node (the
        device MockProver formulation, SURVEY.md §7.10). Returns
        [(gate, constraint_name, poly, ok)] per constraint, `ok` a bool
        [n] tensor on the device (True where the constraint is zero).
        Unassigned and poisoned cells are packed as 0. `device` defaults
        to the card (resolve_device)."""
        import torch
        from ..device import resolve_device
        from ..fields.device import FP_DEV, FQ_DEV, NLIMBS, is_zero
        from ..plonk.evaluation import evaluate_expression

        dev = resolve_device(device)
        df = FP_DEV if self.fs.modulus == FP_DEV.spec.modulus else FQ_DEV
        n = self.n

        def pack(cols):
            return [df.upload_values(
                [0 if v is UNASSIGNED or v is POISON else v for v in col],
                dev) for col in cols]

        advice = pack(self.advice)
        fixed = pack(self.fixed)
        instance = pack([list(c) + [0] * (n - len(c))
                         for c in self.instance])

        flags = []
        for gate in self.cs.gates:
            for cname, poly in zip(gate.constraint_names, gate.polys):
                vals = evaluate_expression(df, poly, advice=advice,
                                           fixed=fixed, instance=instance,
                                           rot_scale=1)
                vals = vals.expand(n, NLIMBS)
                flags.append((gate, cname, poly, is_zero(df, vals)))
        return flags

    def verify_vectorized(self, device=None) -> list:
        """The gate stream of `verify` on the device: evaluate every gate
        polynomial over all rows (gate_zero_flags) and report at most 10
        failing rows per constraint. Poison semantics are approximated by
        restricting the check to usable rows (blinding rows are
        unconstrained by construction here). Only the indices of the
        failing rows are read back. Lookup and permutation streams reuse
        the host checker."""
        errors = []
        for gate, cname, poly, ok in self.gate_zero_flags(device):
            bad_rows = (~ok[:self.usable_rows]).nonzero().flatten()[:10]
            for row in bad_rows.tolist():
                errors.append(ConstraintNotSatisfied(
                    gate_name=gate.name,
                    constraint_name=cname or "constraint",
                    location=self._locate(int(row)),
                    cell_values=self._collect_cell_values(
                        poly, int(row))))
        return errors

    def verify(self, streams=("cells", "gates", "lookups", "permutation")
               ) -> list:
        """Host checker; `streams` selects which of the four error streams
        run (dev.rs:883-888) — big circuits combine verify_vectorized for
        gates with the host permutation/lookup streams."""
        errors = []
        fs = self.fs
        p = fs.modulus

        # 1. unassigned cells queried by active gates (dev.rs:581-641)
        for region in (self.regions if "cells" in streams else []):
            if region.rows is None:
                continue
            for selector, rows in region.enabled_selectors.items():
                for gate_index, gate in enumerate(self.cs.gates):
                    if selector not in gate.queried_selectors:
                        continue
                    for row in rows:
                        for column, rotation in gate.queried_cells:
                            if column.column_type != ADVICE:
                                continue
                            cell_row = (row + rotation.value) % self.n
                            v = self.advice[column.index][cell_row]
                            if v is UNASSIGNED:
                                errors.append(CellNotAssigned(
                                    gate_name=gate.name,
                                    region_index=region.index,
                                    region_name=region.name,
                                    gate_offset=row,
                                    column=column,
                                    offset=cell_row - region.rows[0]))

        # 2. gate satisfaction with Poison semantics (dev.rs:643-707)
        def ev(expr, row):
            def mul(a, b):
                if a is POISON and b is POISON:
                    return POISON
                if a is POISON:
                    return POISON if b % p != 0 else 0
                if b is POISON:
                    return POISON if a % p != 0 else 0
                return a * b % p

            return expr.evaluate(
                constant=lambda v: v % p,
                selector_fn=lambda s: (_ for _ in ()).throw(
                    RuntimeError("virtual selectors are removed")),
                fixed_fn=lambda q: self._cell_value(
                    FIXED, q.column_index, row + q.rotation.value),
                advice_fn=lambda q: self._cell_value(
                    ADVICE, q.column_index, row + q.rotation.value),
                instance_fn=lambda q: self._cell_value(
                    INSTANCE, q.column_index, row + q.rotation.value),
                negated=lambda a: POISON if a is POISON else (-a) % p,
                sum_fn=lambda a, b: (POISON if a is POISON or b is POISON
                                     else (a + b) % p),
                product=mul,
                scaled=lambda a, v: (POISON if a is POISON
                                     else a * v % p),
            )

        for gate_index, gate in enumerate(
                self.cs.gates if "gates" in streams else []):
            for cname, poly in zip(gate.constraint_names, gate.polys):
                name = cname or f"constraint {gate_index}"
                for row in range(self.n):
                    # treat unassigned advice as zero for gate checks
                    try:
                        value = ev(poly, row)
                    except TypeError:
                        value = 0  # unassigned treated as zero
                    if value is POISON:
                        if row < self.usable_rows:
                            errors.append(ConstraintPoisoned(
                                gate_name=gate.name, constraint_name=name))
                    elif value is not None and value % p != 0:
                        errors.append(ConstraintNotSatisfied(
                            gate_name=gate.name, constraint_name=name,
                            location=self._locate(row),
                            cell_values=self._collect_cell_values(
                                poly, row)))

        # 3. lookups (dev.rs:709-833)
        for lookup_index, argument in enumerate(
                self.cs.lookups if "lookups" in streams else []):
            # table values over usable rows
            def ev_scalar(expr, row):
                v = ev(expr, row)
                return 0 if v is POISON else v

            table = set()
            for row in range(self.usable_rows):
                entry = tuple(ev_scalar(e, row)
                              for e in argument.table_expressions)
                table.add(entry)
            for row in range(self.usable_rows):
                inputs = tuple(ev_scalar(e, row)
                               for e in argument.input_expressions)
                if inputs not in table:
                    errors.append(LookupFailure(
                        name=argument.name, lookup_index=lookup_index,
                        location=self._locate(row)))

        # 4. permutation consistency (dev.rs:835-881)
        pa = self.permutation
        for ci, column in enumerate(
                pa.columns if "permutation" in streams else []):
            for row in range(self.n):
                mc, mr = int(pa.map_col[ci, row]), int(pa.map_row[ci, row])
                if (mc, mr) == (ci, row):
                    continue
                orig = self._cell_value(column.column_type, column.index, row)
                tgt_col = pa.columns[mc]
                tgt = self._cell_value(tgt_col.column_type, tgt_col.index, mr)
                o = 0 if orig in (UNASSIGNED, POISON) else orig
                t = 0 if tgt in (UNASSIGNED, POISON) else tgt
                if o != t:
                    errors.append(PermutationFailure(column=column, row=row))

        return errors

    def _locate(self, row: int) -> FailureLocation:
        for region in self.regions:
            if region.rows and region.rows[0] <= row <= region.rows[1]:
                return FailureLocation.in_region(region.index, region.name,
                                                row - region.rows[0])
        return FailureLocation.outside_region(row)

    def assert_satisfied(self) -> None:
        """dev.rs:915-923."""
        errors = self.verify()
        if errors:
            msgs = "\n".join(str(e) for e in errors)
            raise AssertionError(f"circuit was not satisfied:\n{msgs}")
