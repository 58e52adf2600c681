"""Polynomial rotation over device arrays.

Copied from halo2_tpu/poly/polynomial.py with the roll on torch tensors.

Reference: halo2_proofs/src/poly.rs:33-323. The reference's
`Polynomial<F, B>` phantom-basis wrapper is deliberately NOT mirrored: on
the device a polynomial is a raw Montgomery-form int32 [n, 16] tensor of
16-bit digits, passed between functions without unwrap/rewrap; basis
discipline lives in the EvaluationDomain method names
(lagrange_to_coeff / coeff_to_extended / ...), whose input/output bases
are part of their contracts. Rotation is `torch.roll` (an index shift,
never a copy of rotated data into the expression graph — matching the
reference's no-materialization design, poly.rs:236-285).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Rotation:
    """Query offset in ω-steps: cur=0, prev=-1, next=1
    (poly.rs:305-323)."""
    value: int = 0

    @staticmethod
    def cur() -> "Rotation":
        return Rotation(0)

    @staticmethod
    def prev() -> "Rotation":
        return Rotation(-1)

    @staticmethod
    def next() -> "Rotation":
        return Rotation(1)


def rotate(values: torch.Tensor, rotation: int) -> torch.Tensor:
    """Rotate a Lagrange evaluation vector: index i -> value at ω^(i+rot).
    (Polynomial::rotate, poly.rs:196-234: rotate_left for positive.)"""
    return torch.roll(values, -rotation, dims=0)
