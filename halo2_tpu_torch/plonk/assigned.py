"""Assigned rationals: deferred-division witness values.

Reference: halo2_proofs/src/plonk/assigned.rs — `Assigned<F>` is
{Zero, Trivial(F), Rational(F, F)} so circuit synthesis never performs a
field inversion; all witnessed cells are batch-inverted at once
(batch_invert_assigned, poly.rs:135-162). Here numerators/denominators are
Python ints; the batch inversion happens on device (fields.device.batch_inv)
when columns are packed.

Copied unchanged from halo2_tpu/plonk/assigned.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields.host import FieldSpec


class Assigned:
    """numerator / denominator (denominator == None means trivial).
    __slots__ plain class (not a dataclass): one is built per witnessed
    cell on the synthesis hot path."""

    __slots__ = ("numerator", "denominator")

    def __init__(self, numerator: int, denominator: int | None = None):
        self.numerator = numerator
        self.denominator = denominator  # None => 1

    def __eq__(self, other):
        return (isinstance(other, Assigned)
                and self.numerator == other.numerator
                and self.denominator == other.denominator)

    def __hash__(self):
        return hash((self.numerator, self.denominator))

    def __repr__(self):
        return (f"Assigned(numerator={self.numerator}, "
                f"denominator={self.denominator})")

    @staticmethod
    def zero() -> "Assigned":
        return Assigned(0)

    @staticmethod
    def trivial(v: int) -> "Assigned":
        return Assigned(v)

    def is_zero_vartime(self) -> bool:
        return self.numerator == 0

    def num_den(self) -> tuple[int, int]:
        return self.numerator, (1 if self.denominator is None
                                else self.denominator)

    def add(self, other: "Assigned", f: FieldSpec) -> "Assigned":
        n1, d1 = self.num_den()
        n2, d2 = other.num_den()
        p = f.modulus
        if d1 == 1 and d2 == 1:
            return Assigned((n1 + n2) % p)
        return Assigned((n1 * d2 + n2 * d1) % p, d1 * d2 % p)

    def sub(self, other: "Assigned", f: FieldSpec) -> "Assigned":
        return self.add(other.neg(f), f)

    def neg(self, f: FieldSpec) -> "Assigned":
        return Assigned((-self.numerator) % f.modulus, self.denominator)

    def mul(self, other: "Assigned", f: FieldSpec) -> "Assigned":
        n1, d1 = self.num_den()
        n2, d2 = other.num_den()
        p = f.modulus
        d = None if d1 == 1 and d2 == 1 else d1 * d2 % p
        return Assigned(n1 * n2 % p, d)

    def invert(self) -> "Assigned":
        n, d = self.num_den()
        return Assigned(d, n)

    def evaluate(self, f: FieldSpec) -> int:
        """Perform the deferred division (for use outside batch contexts)."""
        n, d = self.num_den()
        if d == 1:
            return n % f.modulus
        if n == 0:
            return 0
        return n * f.inv(d) % f.modulus


def batch_evaluate_assigned(f: FieldSpec, values: list[Assigned]) -> list[int]:
    """Evaluate many Assigned at once with one batched inversion
    (poly.rs:135-162). Zero denominators map the value to zero (matching
    Assigned semantics where 0/0 == 0)."""
    from ..fields.host import batch_invert
    dens = [(1 if a.denominator is None else a.denominator) for a in values]
    inv = batch_invert(f, dens)
    p = f.modulus
    return [a.numerator * i % p for a, i in zip(values, inv)]
