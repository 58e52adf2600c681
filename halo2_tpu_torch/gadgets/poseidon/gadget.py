"""Poseidon gadget API: typestate sponge + hash wrapper over a chip.

Reference: halo2_gadgets/src/poseidon.rs — `PoseidonInstructions` /
`PoseidonSpongeInstructions` traits (:28-67), `Sponge` (absorb/squeeze
typestate), `Hash` (ConstantLength), `PaddedWord` Message/Padding.

Copied from halo2_tpu/gadgets/poseidon/gadget.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...circuit.value import Value
from ...circuit.layouter import AssignedCell
from .primitive import ConstantLength
from .pow5 import Pow5Chip


@dataclass
class PaddedWord:
    """Message(cell) or Padding(constant) (poseidon.rs PaddedWord)."""
    message: AssignedCell | None = None
    padding: int | None = None

    def as_chip_input(self):
        return self.message if self.message is not None else self.padding


class Sponge:
    """Absorb/squeeze sponge over a Pow5Chip (poseidon.rs Sponge)."""

    def __init__(self, chip: Pow5Chip, layouter, domain: ConstantLength):
        self.chip = chip
        self.layouter = layouter
        self.domain = domain
        self.rate = chip.config().rate
        self.state = chip.initial_state(layouter, domain)
        self.buffer: list = []
        self._squeeze_buffer: list | None = None

    def absorb(self, word: PaddedWord) -> None:
        if len(self.buffer) == self.rate:
            self._process()
        self.buffer.append(word.as_chip_input())

    def _process(self) -> None:
        words = list(self.buffer) + [0] * (self.rate - len(self.buffer))
        self.state = self.chip.add_input(self.layouter, self.state, words)
        self.state = self.chip.permute(self.layouter, self.state)
        self.buffer = []

    def finish_absorbing(self) -> "Sponge":
        self._process()
        self._squeeze_buffer = list(self.state[:self.rate])
        return self

    def squeeze(self) -> AssignedCell:
        if self._squeeze_buffer is None:
            self.finish_absorbing()
        if not self._squeeze_buffer:
            self.state = self.chip.permute(self.layouter, self.state)
            self._squeeze_buffer = list(self.state[:self.rate])
        return self._squeeze_buffer.pop(0)


class Hash:
    """Hash<ConstantLength<L>> gadget (poseidon.rs Hash)."""

    def __init__(self, chip: Pow5Chip, layouter, length: int):
        self.chip = chip
        self.layouter = layouter
        self.domain = ConstantLength(length)

    def hash(self, message: list[AssignedCell]) -> AssignedCell:
        assert len(message) == self.domain.length
        sponge = Sponge(self.chip, self.layouter, self.domain)
        for cell in message:
            sponge.absorb(PaddedWord(message=cell))
        for pad in self.domain.padding(self.chip.config().rate):
            sponge.absorb(PaddedWord(padding=pad))
        return sponge.finish_absorbing().squeeze()
