"""Gadget utilities (halo2_gadgets/src/utilities.rs:17-496).

Expression helpers shared by the chips: bool_check, ternary, range_check,
plus bit decomposition helpers used by the running-sum / range-check
gadgets.

Copied from halo2_tpu/gadgets/utilities/__init__.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from ...plonk.circuit import Expression, Constant


def bool_check(value: Expression) -> Expression:
    """value * (1 - value) (utilities.rs:133)."""
    return range_check(value, 2)


def ternary(a: Expression, b: Expression, c: Expression) -> Expression:
    """a·b + (1-a)·c — `a` must be boolean-constrained (utilities.rs:137)."""
    one_minus_a = Constant(1) - a
    return a * b + one_minus_a * c


def range_check(word: Expression, rng: int) -> Expression:
    """word · (1-word) · (2-word) · ... · (rng-1 - word)
    (utilities.rs range_check)."""
    acc = word
    for i in range(1, rng):
        acc = acc * (Constant(i) - word)
    return acc


def lebs2ip(bits: list[bool]) -> int:
    """Little-endian bit list -> int (utilities.rs lebs2ip)."""
    acc = 0
    for i, b in enumerate(bits):
        acc |= int(b) << i
    return acc


def i2lebsp(value: int, length: int) -> list[bool]:
    """int -> little-endian bits of given length (utilities.rs i2lebsp)."""
    assert value < (1 << length)
    return [(value >> i) & 1 == 1 for i in range(length)]


def bitrange_subset(field_modulus: int, value: int, lo: int, hi: int) -> int:
    """Bits [lo, hi) of a field element, as a field element
    (utilities.rs bitrange_subset)."""
    return (value >> lo) & ((1 << (hi - lo)) - 1)


from .lookup_range_check import LookupRangeCheckConfig  # noqa: E402
from .decompose_running_sum import RunningSumConfig      # noqa: E402
from .cond_swap import CondSwapChip, CondSwapConfig      # noqa: E402
