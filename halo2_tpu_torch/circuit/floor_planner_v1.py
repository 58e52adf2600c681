"""Floor planner V1: dual-pass measure-then-layout with greedy first-fit.

Reference: halo2_proofs/src/circuit/floor_planner/v1.rs:19-141 +
v1/strategy.rs:100-242 — regions measured as rectangles, sorted by advice
area (stable sort, descending; region order preserved for equal keys),
placed by a recursive first-fit over per-column free-interval sets;
constants are packed into the gaps of the constants columns below the
first unassigned row. Layout is consensus-relevant (it changes the vk),
so the algorithm is reproduced exactly.

Port of halo2_tpu/circuit/floor_planner_v1.py. One difference: the
legacy region order is the keyword `legacy_pdqsort` of
`slot_in_biggest_advice_first` and `synthesize_v1` (synthesize_circuit
fills it from the circuit class's `legacy_pdqsort` attribute), where the
reference reads the environment variable HALO2_TPU_LEGACY_PDQSORT.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..plonk.circuit import Column, Selector, TableColumn, ADVICE
from .value import Value
from .layouter import (Layouter, Region, RegionShape, AssignedCell, Cell,
                       Table, SimpleTableLayouter, compute_table_lengths)


def _region_column_key(col):
    """RegionColumn Ord: Column variant < Selector variant
    (circuit/layouter.rs:126-161); Columns by (type order, index)."""
    if isinstance(col, Selector):
        return (1, 0, col.index)
    return (0,) + col.sort_key()


@dataclass
class Allocations:
    """Sorted list of allocated (start, length) intervals per column."""
    allocated: list = field(default_factory=list)

    def unbounded_interval_start(self) -> int:
        if not self.allocated:
            return 0
        last = max(s + l for s, l in self.allocated)
        return last

    def free_intervals(self, start: int, end: int | None):
        """Yield (start, end_or_None) free gaps intersecting [start, end)."""
        intervals = sorted(self.allocated)
        cur = start
        for s, l in intervals:
            e = s + l
            if e <= cur:
                continue
            if end is not None and s >= end:
                break
            if s > cur:
                gap_end = s if end is None else min(s, end)
                if gap_end > cur:
                    yield (cur, gap_end)
            cur = max(cur, e)
        if end is None:
            yield (cur, None)
        elif cur < end:
            yield (cur, end)

    def insert(self, start: int, length: int) -> None:
        self.allocated.append((start, length))


def first_fit_region(column_allocations: dict, region_columns: list,
                     region_length: int, start: int,
                     slack: int | None) -> int | None:
    """strategy.rs:106-160."""
    if not region_columns:
        return start
    c, remaining = region_columns[0], region_columns[1:]
    end = None if slack is None else start + region_length + slack
    alloc = column_allocations.setdefault(c, Allocations())
    for space_start, space_end in list(alloc.free_intervals(start, end)):
        s_slack = (None if space_end is None
                   else (space_end - space_start) - region_length)
        if slack is not None and s_slack is not None:
            assert s_slack <= slack
        if s_slack is None or s_slack >= 0:
            row = first_fit_region(column_allocations, remaining,
                                   region_length, space_start, s_slack)
            if row is not None:
                if end is not None:
                    assert row + region_length <= end
                column_allocations[c].insert(row, region_length)
                return row
    return None


def slot_in_biggest_advice_first(region_shapes: list[RegionShape],
                                 legacy_pdqsort: bool = False
                                 ) -> tuple[list[int], dict]:
    """strategy.rs:196-242. `legacy_pdqsort=True` selects the
    `floor-planner-v1-legacy-pdqsort` compatibility mode: region order
    for equal advice areas follows the Rust 1.56.1 unstable sort
    (strategy.rs:222-230) instead of the stable sort — layout is
    vk-affecting, so legacy circuits need the legacy order."""

    def sort_key(shape: RegionShape) -> int:
        advice_cols = sum(
            1 for c in shape.columns
            if isinstance(c, Column) and c.column_type == ADVICE)
        return advice_cols * shape.row_count

    if legacy_pdqsort:
        from .legacy_pdqsort import quicksort
        sorted_regions = list(region_shapes)
        quicksort(sorted_regions, lambda a, b: sort_key(a) < sort_key(b))
    else:
        sorted_regions = sorted(region_shapes, key=sort_key)  # stable asc
    sorted_regions.reverse()

    column_allocations: dict = {}
    placed = []
    for region in sorted_regions:
        region_columns = sorted(region.columns, key=_region_column_key)
        start = first_fit_region(column_allocations, region_columns,
                                 region.row_count, 0, None)
        assert start is not None
        placed.append((start, region))

    placed.sort(key=lambda p: p[1].region_index)
    return [start for start, _ in placed], column_allocations


class _V1Region:
    """Assignment-pass region layouter (v1.rs AssignmentPass)."""

    def __init__(self, layouter: "V1Layouter", region_index: int):
        self.layouter = layouter
        self.region_index = region_index

    def _abs(self, offset: int) -> int:
        return self.layouter.regions[self.region_index] + offset

    def enable_selector(self, annotation, selector, offset):
        self.layouter.cs_assignment.enable_selector(
            annotation, selector, self._abs(offset))

    def assign_advice(self, annotation, column, offset, to):
        holder = {}

        def wrapped():
            v = to()
            v = v if isinstance(v, Value) else Value.known(v)
            holder["v"] = v
            return v

        self.layouter.cs_assignment.assign_advice(
            annotation, column, self._abs(offset), wrapped)
        return AssignedCell(holder.get("v", Value.unknown()),
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
        self.layouter.cs_assignment.copy(instance, row, advice,
                                         self._abs(offset))
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
        self.layouter.constants_to_assign.append((constant, cell))

    def constrain_equal(self, left: Cell, right: Cell):
        lay = self.layouter
        lay.cs_assignment.copy(
            left.column, lay.regions[left.region_index] + left.row_offset,
            right.column, lay.regions[right.region_index] + right.row_offset)


class V1Layouter(Layouter):
    """Two-phase layouter. Phase 'measure' records shapes; phase 'assign'
    replays with planned region starts."""

    def __init__(self, cs_assignment, constants: list[Column]):
        self.cs_assignment = cs_assignment
        self.constants = constants
        self.phase = "measure"
        self.shapes: list[RegionShape] = []
        self.regions: list[int] = []
        self.region_counter = 0
        self.constants_to_assign: list = []
        self.table_columns: list[TableColumn] = []

    def assign_region(self, name, assignment):
        index = self.region_counter
        self.region_counter += 1
        if self.phase == "measure":
            shape = RegionShape(index)
            result = assignment(Region(shape))
            self.shapes.append(shape)
            return result
        self.cs_assignment.enter_region(name)
        region = _V1Region(self, index)
        result = assignment(Region(region))
        self.cs_assignment.exit_region()
        return result

    def assign_table(self, name, assignment):
        if self.phase == "measure":
            return
        self.cs_assignment.enter_region(name)
        table = SimpleTableLayouter(None, self.cs_assignment,
                                    self.table_columns)
        assignment(Table(table))
        self.cs_assignment.exit_region()
        first_unused = compute_table_lengths(table.default_and_assigned)
        for column, (default, _) in table.default_and_assigned.items():
            self.table_columns.append(column)
            self.cs_assignment.fill_from_row(column.inner, first_unused,
                                             default)

    def constrain_instance(self, cell: Cell, column, row):
        if self.phase == "measure":
            return
        self.cs_assignment.copy(
            cell.column, self.regions[cell.region_index] + cell.row_offset,
            column, row)

    def push_namespace(self, name):
        self.cs_assignment.push_namespace(name)

    def pop_namespace(self, gadget_name=None):
        self.cs_assignment.pop_namespace(gadget_name)


class V1Plan:
    """Recorded V1 layout (region starts + constant positions): lets a
    re-synthesis of the same circuit shape skip the measurement pass and
    the first-fit solve (the layout depends only on the shape,
    v1.rs:60-141)."""

    __slots__ = ("regions", "positions")

    def __init__(self, regions, positions):
        self.regions = regions
        self.positions = positions


def synthesize_v1(cs_assignment, circuit, config, constants: list[Column],
                  plan: V1Plan | None = None, plan_out: dict | None = None,
                  legacy_pdqsort: bool = False) -> None:
    """FloorPlanner::synthesize for V1 (v1.rs:60-141)."""
    from ..plonk.error import NotEnoughColumnsForConstants

    layouter = V1Layouter(cs_assignment, constants)
    if plan is not None:
        regions, positions = plan.regions, plan.positions
    else:
        # pass 1: measurement on the witness-free circuit
        circuit.without_witnesses().synthesize(config, layouter)
        regions, column_allocations = slot_in_biggest_advice_first(
            layouter.shapes, legacy_pdqsort)

        first_unassigned_row = max(
            (a.unbounded_interval_start()
             for a in column_allocations.values()), default=0)

        def constant_positions():
            for c in constants:
                alloc = column_allocations.get(c, Allocations())
                for s, e in alloc.free_intervals(0, first_unassigned_row):
                    for i in range(s, e):
                        yield (c, i)

        positions = list(constant_positions())
        if plan_out is not None:
            plan_out["v1"] = V1Plan(regions, positions)

    # pass 2: assignment
    layouter.phase = "assign"
    layouter.regions = regions
    layouter.region_counter = 0
    circuit.synthesize(config, layouter)

    if len(positions) < len(layouter.constants_to_assign):
        raise NotEnoughColumnsForConstants()
    for (fixed_column, fixed_row), (value, advice_cell) in zip(
            positions, layouter.constants_to_assign):
        cs_assignment.assign_fixed(
            f"Constant({value})", fixed_column, fixed_row,
            lambda v=value: Value.known(v))
        cs_assignment.copy(
            fixed_column, fixed_row, advice_cell.column,
            regions[advice_cell.region_index] + advice_cell.row_offset)
