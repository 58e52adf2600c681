"""ECC gadget API: typed wrappers over an ECC chip.

Reference: halo2_gadgets/src/ecc.rs — `EccInstructions` (:16-166) and the
wrapper types `Point` / `NonIdentityPoint` / `ScalarVar` (:190-1027),
which carry the chip alongside the assigned coordinates and expose
add / add_incomplete / mul / constrain_equal as methods.

Copied from halo2_tpu/gadgets/ecc/gadget.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...circuit.value import Value
from .chip import EccChip, EccPoint


@dataclass
class Point:
    """A possibly-identity curve point (ecc.rs Point)."""
    chip: EccChip
    inner: EccPoint

    @classmethod
    def new(cls, chip: EccChip, layouter, value: Value) -> "Point":
        return cls(chip, chip.witness_point(layouter, value))

    def add(self, layouter, other: "Point | NonIdentityPoint") -> "Point":
        return Point(self.chip,
                     self.chip.add(layouter, self.inner, other.inner))

    def mul(self, layouter, scalar_cell) -> "Point":
        """Variable-base mul by a witnessed base-field element cell
        (ScalarVar::BaseFieldElem semantics, ecc.rs:214-221)."""
        result, _zs = self.chip.mul(layouter, scalar_cell, self.inner)
        return Point(self.chip, result)

    def constrain_equal(self, layouter, other) -> None:
        def region_fn(region):
            region.constrain_equal(self.inner.x.cell, other.inner.x.cell)
            region.constrain_equal(self.inner.y.cell, other.inner.y.cell)
        layouter.assign_region("constrain equal", region_fn)

    def x(self):
        return self.inner.x

    def y(self):
        return self.inner.y


@dataclass
class NonIdentityPoint:
    """A point constrained to be on-curve and non-identity
    (ecc.rs NonIdentityPoint)."""
    chip: EccChip
    inner: EccPoint

    @classmethod
    def new(cls, chip: EccChip, layouter, value: Value
            ) -> "NonIdentityPoint":
        return cls(chip, chip.witness_point_non_id(layouter, value))

    def add_incomplete(self, layouter, other: "NonIdentityPoint"
                       ) -> "NonIdentityPoint":
        return NonIdentityPoint(
            self.chip,
            self.chip.add_incomplete(layouter, self.inner, other.inner))

    def add(self, layouter, other) -> Point:
        return Point(self.chip,
                     self.chip.add(layouter, self.inner, other.inner))

    def x(self):
        return self.inner.x

    def y(self):
        return self.inner.y
