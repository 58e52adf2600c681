"""Circuit construction API: Region, Table, Layouter, SimpleFloorPlanner.

Reference: halo2_proofs/src/circuit.rs (Chip/Cell/AssignedCell/Region/
Table/Layouter, :28-580), circuit/layouter.rs (RegionLayouter/RegionShape,
:45-285), circuit/floor_planner/single_pass.rs (SingleChipLayouter,
:26-216), circuit/table_layouter.rs (SimpleTableLayouter, :19-150).

Synthesis is host work (O(assigned cells), not O(n) device work); the
collected columns are batch-packed to device arrays afterwards. The
placement algorithm is reproduced exactly because layout is
consensus-relevant (it changes the vk).

Copied from halo2_tpu/circuit/layouter.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu. One difference: a
SimplePlan records whether a region's closure raised while it was
measured (`replayable`), and synthesize_circuit does not replay such a
layout; the reference replays it and breaks on the next proof.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

from ..fields.host import FieldSpec
from ..plonk.circuit import (Column, Selector, TableColumn, ConstraintSystem,
                             ADVICE, FIXED, INSTANCE)
from ..plonk.assigned import Assigned
from .value import Value, SynthesisError


class Cell:
    """(region, offset, column) handle — __slots__ plain class rather
    than a dataclass: Cells are built once per assigned cell on the
    synthesis hot path."""

    __slots__ = ("region_index", "row_offset", "column")

    def __init__(self, region_index: int, row_offset: int, column: Column):
        self.region_index = region_index
        self.row_offset = row_offset
        self.column = column

    def __eq__(self, other):
        return (isinstance(other, Cell)
                and self.region_index == other.region_index
                and self.row_offset == other.row_offset
                and self.column == other.column)

    def __hash__(self):
        return hash((self.region_index, self.row_offset, self.column))

    def __repr__(self):
        return (f"Cell(region_index={self.region_index}, "
                f"row_offset={self.row_offset}, column={self.column})")


class AssignedCell:
    __slots__ = ("value", "cell")

    def __init__(self, value: Value, cell: Cell):
        self.value = value
        self.cell = cell

    def copy_advice(self, annotation, region: "Region", column: Column,
                    offset: int) -> "AssignedCell":
        """circuit.rs:152-177."""
        assigned = region.assign_advice(annotation, column, offset,
                                        lambda: self.value)
        region.constrain_equal(assigned.cell, self.cell)
        return assigned

    def __repr__(self):
        return f"AssignedCell(value={self.value!r}, cell={self.cell!r})"


# RegionColumn: a Column or a Selector (layouter.rs:126-161)
RegionColumn = Union[Column, Selector]


class RegionShape:
    """Measurement pass recorder (layouter.rs:189-285)."""

    def __init__(self, region_index: int):
        self.region_index = region_index
        self.columns: set = set()
        self.row_count = 0

    # -- RegionLayouter interface (measure mode) --
    def enable_selector(self, annotation, selector: Selector, offset: int):
        self.columns.add(selector)
        self.row_count = max(self.row_count, offset + 1)

    def assign_advice(self, annotation, column, offset, to):
        self.columns.add(column)
        self.row_count = max(self.row_count, offset + 1)
        return AssignedCell(Value.unknown(),
                            Cell(self.region_index, offset, column))

    def assign_advice_from_constant(self, annotation, column, offset, constant):
        return self.assign_advice(annotation, column, offset, None)

    def assign_advice_from_instance(self, annotation, instance, row, advice,
                                    offset):
        self.columns.add(advice)
        self.row_count = max(self.row_count, offset + 1)
        return AssignedCell(Value.unknown(),
                            Cell(self.region_index, offset, advice))

    def instance_value(self, instance, row):
        return Value.unknown()

    def assign_fixed(self, annotation, column, offset, to):
        self.columns.add(column)
        self.row_count = max(self.row_count, offset + 1)
        return Cell(self.region_index, offset, column)

    def constrain_constant(self, cell, constant):
        pass

    def constrain_equal(self, left, right):
        pass


class Region:
    """User-facing region handle (circuit.rs:190-376); delegates to either
    a RegionShape (measure pass) or a real region layouter."""

    def __init__(self, inner):
        self._inner = inner

    def enable_selector(self, annotation, selector: Selector, offset: int):
        return self._inner.enable_selector(annotation, selector, offset)

    def assign_advice(self, annotation, column: Column, offset: int,
                      to: Callable[[], Value]) -> AssignedCell:
        return self._inner.assign_advice(annotation, column, offset, to)

    def assign_advice_from_constant(self, annotation, column: Column,
                                    offset: int, constant) -> AssignedCell:
        return self._inner.assign_advice_from_constant(
            annotation, column, offset, constant)

    def assign_advice_from_instance(self, annotation, instance: Column,
                                    row: int, advice: Column,
                                    offset: int) -> AssignedCell:
        return self._inner.assign_advice_from_instance(
            annotation, instance, row, advice, offset)

    def instance_value(self, instance: Column, row: int) -> Value:
        return self._inner.instance_value(instance, row)

    def assign_fixed(self, annotation, column: Column, offset: int,
                     to: Callable[[], Value]):
        return self._inner.assign_fixed(annotation, column, offset, to)

    def constrain_constant(self, cell: Cell, constant) -> None:
        return self._inner.constrain_constant(cell, constant)

    def constrain_equal(self, left: Cell, right: Cell) -> None:
        return self._inner.constrain_equal(left, right)


class BatchCell:
    """Handle for one per-stamp assignment across `count` regions stamped
    by Layouter.assign_regions: `cell(i)` is the concrete Cell in the
    i-th stamped region."""

    __slots__ = ("first_region", "row_offset", "column", "count")

    def __init__(self, first_region: int, row_offset: int, column: Column,
                 count: int):
        self.first_region = first_region
        self.row_offset = row_offset
        self.column = column
        self.count = count

    def cell(self, i: int) -> Cell:
        return Cell(self.first_region + i, self.row_offset, self.column)


class BatchRegion:
    """Region proxy for the TPU-native batch synthesis extension
    (Layouter.assign_regions): the assignment closure runs ONCE and every
    method takes a VECTOR of values — one entry per stamped region. The
    resulting layout, permutation cycles, and vk are byte-identical to
    `count` sequential assign_region calls over the same column set
    (asserted by tests/test_batch_synthesis.py).

    This is the "batch assignments per region" design the reference's
    closure-per-cell API can't express (SURVEY.md §7 hard parts): witness
    synthesis collapses from O(cells) Python call chains to O(distinct
    cell kinds) vector ops."""

    def __init__(self, first_region: int, count: int):
        self.first_region = first_region
        self.count = count
        self.columns: set = set()
        self.row_count = 0
        self.ops: list[tuple] = []

    def _vec(self, values):
        values = list(values)
        if len(values) != self.count:
            raise SynthesisError(
                f"batch value vector has {len(values)} entries for "
                f"{self.count} stamped regions")
        return values

    def enable_selector(self, annotation, selector: Selector, offset: int):
        self.columns.add(selector)
        self.row_count = max(self.row_count, offset + 1)
        self.ops.append(("selector", annotation, selector, offset))

    def assign_advice(self, annotation, column: Column, offset: int,
                      values) -> BatchCell:
        self.columns.add(column)
        self.row_count = max(self.row_count, offset + 1)
        self.ops.append(("advice", annotation, column, offset,
                         self._vec(values)))
        return BatchCell(self.first_region, offset, column, self.count)

    def assign_fixed(self, annotation, column: Column, offset: int,
                     values) -> None:
        self.columns.add(column)
        self.row_count = max(self.row_count, offset + 1)
        self.ops.append(("fixed", annotation, column, offset,
                         self._vec(values)))

    def constrain_equal(self, left: BatchCell, right: BatchCell) -> None:
        """Stamp-wise equality: left.cell(i) == right.cell(i). Both
        operands must come from THIS assign_regions call (cross-call
        copies go through Layouter.constrain_equal_batch)."""
        self.ops.append(("copy", left, right))


class Table:
    """Lookup-table assignment handle (circuit.rs:379-414)."""

    def __init__(self, inner):
        self._inner = inner

    def assign_cell(self, annotation, column: TableColumn, offset: int,
                    to: Callable[[], Value]) -> None:
        return self._inner.assign_cell(annotation, column, offset, to)


class Layouter:
    """Layouter trait (circuit.rs:421-495)."""

    def assign_region(self, name, assignment: Callable[[Region], object]):
        raise NotImplementedError

    def assign_regions(self, name, count: int,
                       assignment: Callable[[BatchRegion], object]):
        """TPU-native extension: stamp `count` structurally identical
        regions in one call. `assignment` runs ONCE over a BatchRegion
        whose methods take length-`count` value vectors; layout and vk
        are identical to `count` sequential assign_region calls."""
        raise NotImplementedError

    def constrain_equal_batch(self, left: BatchCell, right: BatchCell):
        """Stamp-wise copy constraints between two BatchCells (possibly
        from different assign_regions calls)."""
        raise NotImplementedError

    def assign_table(self, name, assignment: Callable[[Table], None]):
        raise NotImplementedError

    def constrain_instance(self, cell: Cell, column: Column, row: int):
        raise NotImplementedError

    def get_challenge(self, challenge):
        raise NotImplementedError

    def namespace(self, name) -> "NamespacedLayouter":
        self.push_namespace(name)
        return NamespacedLayouter(self)

    def push_namespace(self, name):
        pass

    def pop_namespace(self, gadget_name=None):
        pass


class NamespacedLayouter(Layouter):
    def __init__(self, parent: Layouter):
        self.parent = parent

    def assign_region(self, name, assignment):
        return self.parent.assign_region(name, assignment)

    def assign_regions(self, name, count, assignment):
        return self.parent.assign_regions(name, count, assignment)

    def constrain_equal_batch(self, left, right):
        return self.parent.constrain_equal_batch(left, right)

    def assign_table(self, name, assignment):
        return self.parent.assign_table(name, assignment)

    def constrain_instance(self, cell, column, row):
        return self.parent.constrain_instance(cell, column, row)

    def push_namespace(self, name):
        self.parent.push_namespace(name)

    def __del__(self):
        try:
            self.parent.pop_namespace(None)
        except Exception:
            pass


class SimpleTableLayouter:
    """table_layouter.rs:39-115: tracks (default value, assignment mask)
    per table column; the first assigned value at offset 0 becomes the
    default used to fill the rest of the column."""

    def __init__(self, cs, assignment, used_columns):
        self.cs = cs
        self.assignment = assignment
        self.used_columns = used_columns
        # TableColumn -> (Optional[Value default], list[bool] assigned)
        self.default_and_assigned: dict = {}

    def assign_cell(self, annotation, column: TableColumn, offset: int, to):
        if column in self.used_columns:
            raise SynthesisError(f"table column {column} already used")
        entry = self.default_and_assigned.setdefault(column, [None, []])

        value_holder = {}

        def wrapped():
            v = to()
            v = v if isinstance(v, Value) else Value.known(v)
            value_holder["v"] = v
            return v

        self.assignment.assign_fixed(annotation, column.inner, offset,
                                     wrapped)
        if offset == 0:
            if entry[0] is None:
                entry[0] = value_holder.get("v", Value.unknown())
            else:
                raise SynthesisError("table column default already set")
        mask = entry[1]
        while len(mask) <= offset:
            mask.append(False)
        if mask[offset]:
            raise SynthesisError("table cell assigned twice")
        mask[offset] = True


def compute_table_lengths(default_and_assigned: dict) -> int:
    """table_layouter.rs:118-150: all table columns must be fully assigned
    prefixes of equal length."""
    lengths = []
    for column, (default, assigned) in default_and_assigned.items():
        if default is None:
            raise SynthesisError(f"table column {column} has no default")
        if not all(assigned):
            raise SynthesisError(f"table column {column} has gaps")
        lengths.append(len(assigned))
    if not lengths:
        raise SynthesisError("empty table")
    if len(set(lengths)) != 1:
        raise SynthesisError("table columns have uneven lengths")
    return lengths[0]


class _SingleChipRegion:
    """Real-pass region layouter (single_pass.rs:219-372)."""

    def __init__(self, layouter: "SingleChipLayouter", region_index: int):
        self.layouter = layouter
        self.region_index = region_index
        self.constants: list[tuple[object, Cell]] = []

    def _abs(self, offset: int) -> int:
        return self.layouter.regions[self.region_index] + offset

    def enable_selector(self, annotation, selector, offset):
        self.layouter.cs_assignment.enable_selector(
            annotation, selector, self._abs(offset))

    def assign_advice(self, annotation, column, offset, to):
        value_holder = [None]

        def wrapped():
            v = to()
            v = v if isinstance(v, Value) else Value.known(v)
            value_holder[0] = v
            return v

        self.layouter.cs_assignment.assign_advice(
            annotation, column, self._abs(offset), wrapped)
        return AssignedCell(value_holder[0] or Value.unknown(),
                            Cell(self.region_index, offset, column))

    def assign_advice_from_constant(self, annotation, column, offset,
                                    constant):
        cell = self.assign_advice(annotation, column, offset,
                                  lambda: Value.known(constant))
        self.constrain_constant(cell.cell, constant)
        return cell

    def assign_advice_from_instance(self, annotation, instance, row, advice,
                                    offset):
        value = self.layouter.cs_assignment.query_instance(instance, row)
        cell = self.assign_advice(annotation, advice, offset, lambda: value)
        self.layouter.cs_assignment.copy(
            instance, row, advice, self._abs(offset))
        return cell

    def instance_value(self, instance, row):
        return self.layouter.cs_assignment.query_instance(instance, row)

    def assign_fixed(self, annotation, column, offset, to):
        def wrapped():
            v = to()
            return v if isinstance(v, Value) else Value.known(v)
        self.layouter.cs_assignment.assign_fixed(
            annotation, column, self._abs(offset), wrapped)
        return Cell(self.region_index, offset, column)

    def constrain_constant(self, cell, constant):
        self.constants.append((constant, cell))

    def constrain_equal(self, left: Cell, right: Cell):
        self.layouter.cs_assignment.copy(
            left.column,
            self.layouter.regions[left.region_index] + left.row_offset,
            right.column,
            self.layouter.regions[right.region_index] + right.row_offset)


class SimplePlan:
    """Recorded layout of one SingleChipLayouter synthesis: per-region
    start rows and per-region first constants rows. Layout depends only
    on the circuit *shape* (the measurement pass ignores witness values
    — the same contract floor_planner V1's dual-pass relies on,
    v1.rs:60-141), so a plan recorded once (e.g. at keygen) lets every
    later proof of the same circuit skip the measurement pass."""

    __slots__ = ("starts", "const_starts", "replayable")

    def __init__(self):
        self.starts: list[int] = []
        self.const_starts: list[int] = []
        # False once a region's closure raised while measured: such a
        # region takes no index and no rows, but a replay would give it
        # the next region's and keep what it assigned before raising
        self.replayable = True


class SingleChipLayouter(Layouter):
    """SimpleFloorPlanner: single-pass measure-then-assign per region
    (single_pass.rs:26-216). Pass a previously recorded `plan` to skip
    the measurement pass (witness-only re-synthesis in the prover)."""

    def __init__(self, cs_assignment, constants: list[Column],
                 plan: SimplePlan | None = None):
        self.cs_assignment = cs_assignment
        self.constants = constants
        self.regions: list[int] = []       # region_index -> start row
        self.columns: dict = {}            # RegionColumn -> first free row
        self.table_columns: list[TableColumn] = []
        self.plan = plan
        self.recorded = SimplePlan()

    def assign_region(self, name, assignment):
        region_index = len(self.regions)

        if self.plan is not None:
            region_start = self.plan.starts[region_index]
            self.regions.append(region_start)
        else:
            # measurement pass
            shape = RegionShape(region_index)
            try:
                assignment(Region(shape))
            except Exception:
                self.recorded.replayable = False
                raise

            # layout: first free row across all used columns
            region_start = 0
            for column in shape.columns:
                region_start = max(region_start,
                                   self.columns.get(column, 0))
            self.regions.append(region_start)
            for column in shape.columns:
                self.columns[column] = region_start + shape.row_count
        self.recorded.starts.append(region_start)

        # assignment pass
        self.cs_assignment.enter_region(name)
        region = _SingleChipRegion(self, region_index)
        result = assignment(Region(region))
        self.cs_assignment.exit_region()

        # assign constants (single_pass.rs:119-145)
        if region.constants:
            if not self.constants:
                raise SynthesisError("no constants columns configured")
            constants_column = self.constants[0]
            if self.plan is not None:
                next_constant_row = self.plan.const_starts[region_index]
            else:
                next_constant_row = self.columns.get(constants_column, 0)
            self.recorded.const_starts.append(next_constant_row)
            for constant, advice_cell in region.constants:
                self.cs_assignment.assign_fixed(
                    "constant", constants_column, next_constant_row,
                    lambda c=constant: Value.known(c))
                self.cs_assignment.copy(
                    constants_column, next_constant_row,
                    advice_cell.column,
                    self.regions[advice_cell.region_index]
                    + advice_cell.row_offset)
                next_constant_row += 1
            if self.plan is None:
                self.columns[constants_column] = next_constant_row
        else:
            self.recorded.const_starts.append(-1)

        return result

    def assign_regions(self, name, count, assignment):
        """Stamp `count` structurally identical regions (see
        Layouter.assign_regions). Layout matches `count` sequential
        assign_region calls because every stamp shares one column set:
        SimpleFloorPlanner places each at the running max first-free
        row, which for a shared column set is exactly consecutive
        `row_count`-sized blocks."""
        if count == 0:
            return None
        base = len(self.regions)
        br = BatchRegion(base, count)
        result = assignment(br)
        rows = br.row_count

        if self.plan is not None:
            starts = self.plan.starts[base:base + count]
        else:
            start0 = 0
            for column in br.columns:
                start0 = max(start0, self.columns.get(column, 0))
            starts = [start0 + i * rows for i in range(count)]
            for column in br.columns:
                self.columns[column] = start0 + count * rows
        self.regions.extend(starts)
        self.recorded.starts.extend(starts)
        self.recorded.const_starts.extend([-1] * count)

        sink = self.cs_assignment
        if hasattr(sink, "assign_advice_batch"):
            sink.enter_region(name)
            for op in br.ops:
                kind = op[0]
                if kind == "advice":
                    _, ann, col, off, vals = op
                    sink.assign_advice_batch(
                        ann, col, [s + off for s in starts], vals)
                elif kind == "fixed":
                    _, ann, col, off, vals = op
                    sink.assign_fixed_batch(
                        ann, col, [s + off for s in starts], vals)
                elif kind == "selector":
                    _, ann, sel, off = op
                    sink.enable_selector_batch(
                        ann, sel, [s + off for s in starts])
                else:  # copy
                    _, left, right = op
                    sink.copy_batch(
                        left.column,
                        [self.regions[left.first_region + i]
                         + left.row_offset for i in range(count)],
                        right.column,
                        [self.regions[right.first_region + i]
                         + right.row_offset for i in range(count)])
            sink.exit_region()
        else:
            # per-stamp fallback: byte-identical to sequential
            # assign_region calls for sinks without batch methods
            # (MockProver, tracing wrappers)
            for i in range(count):
                sink.enter_region(name)
                for op in br.ops:
                    kind = op[0]
                    if kind == "advice":
                        _, ann, col, off, vals = op
                        sink.assign_advice(ann, col, starts[i] + off,
                                           lambda v=vals[i]: v)
                    elif kind == "fixed":
                        _, ann, col, off, vals = op
                        sink.assign_fixed(ann, col, starts[i] + off,
                                          lambda v=vals[i]: v)
                    elif kind == "selector":
                        _, ann, sel, off = op
                        sink.enable_selector(ann, sel, starts[i] + off)
                    else:
                        _, left, right = op
                        sink.copy(
                            left.column,
                            self.regions[left.first_region + i]
                            + left.row_offset,
                            right.column,
                            self.regions[right.first_region + i]
                            + right.row_offset)
                sink.exit_region()
        return result

    def constrain_equal_batch(self, left: BatchCell, right: BatchCell):
        assert left.count == right.count
        sink = self.cs_assignment
        rows_l = [self.regions[left.first_region + i] + left.row_offset
                  for i in range(left.count)]
        rows_r = [self.regions[right.first_region + i] + right.row_offset
                  for i in range(right.count)]
        if hasattr(sink, "copy_batch"):
            sink.copy_batch(left.column, rows_l, right.column, rows_r)
        else:
            for rl, rr in zip(rows_l, rows_r):
                sink.copy(left.column, rl, right.column, rr)

    def assign_table(self, name, assignment):
        self.cs_assignment.enter_region(name)
        table = SimpleTableLayouter(None, self.cs_assignment,
                                    self.table_columns)
        assignment(Table(table))
        default_and_assigned = table.default_and_assigned
        self.cs_assignment.exit_region()

        first_unused = compute_table_lengths(default_and_assigned)
        for column, (default, _) in default_and_assigned.items():
            self.table_columns.append(column)
            self.cs_assignment.fill_from_row(column.inner, first_unused,
                                             default)

    def constrain_instance(self, cell: Cell, column: Column, row: int):
        self.cs_assignment.copy(
            cell.column,
            self.regions[cell.region_index] + cell.row_offset,
            column, row)

    def push_namespace(self, name):
        self.cs_assignment.push_namespace(name)

    def pop_namespace(self, gadget_name=None):
        self.cs_assignment.pop_namespace(gadget_name)


class Chip:
    """Chip trait (circuit.rs:28-49)."""

    def config(self):
        raise NotImplementedError

    def loaded(self):
        raise NotImplementedError


class Circuit:
    """Circuit trait (plonk/circuit.rs:466-485). Subclasses implement:
    - without_witnesses(self) -> Circuit
    - configure(meta: ConstraintSystem) -> config   [classmethod]
    - synthesize(self, config, layouter) -> None
    """
    floor_planner = "simple"

    def without_witnesses(self) -> "Circuit":
        raise NotImplementedError

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        raise NotImplementedError

    def synthesize(self, config, layouter: Layouter) -> None:
        raise NotImplementedError
