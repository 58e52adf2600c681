"""Stable metadata types for dev tooling output.

Reference: halo2_proofs/src/dev/metadata.rs — `Column` (:8), `VirtualCell`
(:39), `Gate` (:87), `Constraint` (:110), `Region` (:147) — the
presentation-stable identifiers used in failure messages and cost
reports.

Copied from halo2_tpu/dev/metadata.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Column:
    column_type: str
    index: int

    def __str__(self):
        return f"Column('{self.column_type}', {self.index})"


@dataclass(frozen=True)
class VirtualCell:
    column: Column
    rotation: int

    def __str__(self):
        return f"{self.column}@{self.rotation}"


@dataclass(frozen=True)
class Gate:
    index: int
    name: str

    def __str__(self):
        return f"Gate {self.index} ('{self.name}')"


@dataclass(frozen=True)
class Constraint:
    gate: Gate
    index: int
    name: str

    def __str__(self):
        label = f" ('{self.name}')" if self.name else ""
        return f"Constraint {self.index}{label} in {self.gate}"


@dataclass(frozen=True)
class Region:
    index: int
    name: str

    def __str__(self):
        return f"Region {self.index} ('{self.name}')"
