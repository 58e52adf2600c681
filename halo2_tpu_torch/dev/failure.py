"""Structured verification-failure types for MockProver.

Reference: halo2_proofs/src/dev/failure.rs:20-186 — six failure kinds with
region/gate/cell metadata and a pretty emitter.

Copied from halo2_tpu/dev/failure.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FailureLocation:
    """InRegion or OutsideRegion (failure.rs:20-70)."""
    region_index: Optional[int] = None
    region_name: str = ""
    offset: Optional[int] = None
    row: Optional[int] = None

    @staticmethod
    def in_region(index: int, name: str, offset: int) -> "FailureLocation":
        return FailureLocation(region_index=index, region_name=name,
                               offset=offset)

    @staticmethod
    def outside_region(row: int) -> "FailureLocation":
        return FailureLocation(row=row)

    def __str__(self):
        if self.region_index is not None:
            return (f"in Region {self.region_index} ('{self.region_name}') "
                    f"at offset {self.offset}")
        return f"outside any region, on row {self.row}"


@dataclass(frozen=True)
class CellNotAssigned:
    gate_name: str
    region_index: int
    region_name: str
    gate_offset: int
    column: object
    offset: int

    def __str__(self):
        return (f"Cell {self.column}@{self.offset} not assigned in region "
                f"{self.region_index} ('{self.region_name}') but queried by "
                f"gate '{self.gate_name}'")


@dataclass(frozen=True)
class ConstraintNotSatisfied:
    """dev/failure.rs:111-131 ConstraintNotSatisfied — `cell_values` is
    the reference's queried-cell table: ((column_label, rotation),
    hex_value) per virtual cell of the failing constraint, rendered in
    the emitter style (failure/emitter.rs render_cell_layout)."""
    gate_name: str
    constraint_name: str
    location: FailureLocation
    cell_values: tuple = ()

    def __str__(self):
        head = (f"Constraint '{self.constraint_name}' in gate "
                f"'{self.gate_name}' is not satisfied {self.location}")
        if not self.cell_values:
            return head
        lines = [head]
        labels = {cell: f"x{i}" for i, (cell, _v)
                  in enumerate(self.cell_values)}
        columns = sorted({col for (col, _rot), _v in self.cell_values})
        rotations = sorted({rot for (_col, rot), _v in self.cell_values})
        off = self.location.offset
        if off is not None:
            lines.append(
                f"  Cell layout in region '{self.location.region_name}':")
            rowhdr = "Offset"
        else:
            lines.append(f"  Cell layout at row {self.location.row}:")
            rowhdr = "Rotation"
        widths = [max(len(c), 2) for c in columns]
        lines.append("    | " + rowhdr + " | "
                     + " | ".join(c.ljust(w)
                                  for c, w in zip(columns, widths))
                     + " |")
        for rot in rotations:
            row_label = str(rot + off if off is not None else rot)
            cells = []
            for col, w in zip(columns, widths):
                cells.append(labels.get((col, rot), "").ljust(w))
            lines.append(f"    | {row_label.rjust(len(rowhdr))} | "
                         + " | ".join(cells) + " |")
        lines.append(f"  Constraint '{self.constraint_name}':")
        for cell, v in self.cell_values:
            lines.append(f"    {labels[cell]} = {v}")
        return "\n".join(lines)


@dataclass(frozen=True)
class ConstraintPoisoned:
    gate_name: str
    constraint_name: str

    def __str__(self):
        return (f"Constraint '{self.constraint_name}' in gate "
                f"'{self.gate_name}' is active on an unusable row")


@dataclass(frozen=True)
class LookupFailure:
    name: str
    lookup_index: int
    location: FailureLocation

    def __str__(self):
        return (f"Lookup '{self.name}' (index {self.lookup_index}) is not "
                f"satisfied {self.location}")


@dataclass(frozen=True)
class PermutationFailure:
    column: object
    row: int

    def __str__(self):
        return f"Equality constraint not satisfied at {self.column}, row {self.row}"


@dataclass(frozen=True)
class InstanceInstanceMismatch:
    column: object
    row: int
    instance_value: int
    cell_value: int

    def __str__(self):
        return (f"Instance value mismatch at {self.column}, row {self.row}: "
                f"cell={self.cell_value} instance={self.instance_value}")
