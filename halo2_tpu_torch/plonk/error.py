"""Error taxonomy for the proving system API.

Reference: halo2_proofs/src/plonk/error.rs:12-80 — the user-facing error
kinds with their guidance messages (NotEnoughRowsAvailable's "try using a
larger value of k", error.rs:76-80).

Copied unchanged from halo2_tpu/plonk/error.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations


class Error(Exception):
    """Base class (plonk::Error)."""


class SynthesisError(Error):
    """Error::Synthesis — generic synthesis failure."""


class InvalidInstances(Error):
    """Error::InvalidInstances — mismatched instance column count."""


class ConstraintSystemFailure(Error):
    """Error::ConstraintSystemFailure — the constraint system is not
    satisfied."""


class BoundsFailure(Error):
    """Error::BoundsFailure — out-of-bounds index."""


class OpeningError(Error):
    """Error::Opening — multi-opening verification failure."""


class TranscriptError(Error):
    """Error::Transcript — transcript IO failure."""


class NotEnoughRowsAvailable(Error):
    """Error::NotEnoughRowsAvailable { current_k } (error.rs:16-18,
    76-80)."""

    def __init__(self, current_k: int):
        self.current_k = current_k
        super().__init__(
            f"k = {current_k} is too small for the given circuit; "
            f"try using a larger value of k")


class InstanceTooLarge(Error):
    """Error::InstanceTooLarge."""


class NotEnoughColumnsForConstants(Error):
    """Error::NotEnoughColumnsForConstants."""

    def __init__(self):
        super().__init__(
            "Too few fixed columns are enabled for global constants usage")


class ColumnNotInPermutation(Error):
    """Error::ColumnNotInPermutation(Column)."""

    def __init__(self, column):
        self.column = column
        super().__init__(
            f"Column {column} must be included in the permutation. "
            f"Help: try applying `meta.enable_equality` on the column")


class TableError(Error):
    """Error::TableError — lookup table assignment failure
    (table_layouter.rs)."""


class IllegalHashFromPrivatePoint(Error):
    """Error::IllegalHashFromPrivatePoint — Sinsemilla private-init used
    without `allow_init_from_private_point` (error.rs:44)."""
