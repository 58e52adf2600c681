"""Sinsemilla gadget-level API: hash and commit domains over the chips.

Reference: halo2_gadgets/src/sinsemilla.rs:280-470 — `HashDomain` /
`CommitDomain` gadget structs pairing a SinsemillaChip with an EccChip:
  commit(m, r) = hash_to_point(Q_D, m) + [r]·R_D  (mul_fixed + add)
  short_commit = extract_x(commit).

Copied from halo2_tpu/gadgets/sinsemilla/gadget.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...circuit.value import Value
from ..ecc.chip import EccChip, EccPoint
from .chip import SinsemillaChip, MessagePiece
from . import primitive


@dataclass
class HashDomainGadget:
    chip: SinsemillaChip
    domain: primitive.HashDomain

    @classmethod
    def new(cls, chip: SinsemillaChip, domain_name: str):
        return cls(chip=chip, domain=primitive.HashDomain(domain_name))

    def hash_to_point(self, layouter, pieces: list[MessagePiece]):
        return self.chip.hash_to_point(layouter, self.domain.Q, pieces)

    def hash(self, layouter, pieces: list[MessagePiece]):
        point, zs = self.hash_to_point(layouter, pieces)
        return point.x, zs


@dataclass
class CommitDomainGadget:
    sinsemilla_chip: SinsemillaChip
    ecc_chip: EccChip
    M: HashDomainGadget
    R: object  # fixed blinding base (FixedPointBase)

    @classmethod
    def new(cls, sinsemilla_chip: SinsemillaChip, ecc_chip: EccChip,
            domain_name: str):
        from ..ecc.chip import FixedPointBase
        from ..ecc.constants import NUM_WINDOWS
        cd = primitive.CommitDomain(domain_name)
        return cls(sinsemilla_chip=sinsemilla_chip, ecc_chip=ecc_chip,
                   M=HashDomainGadget(chip=sinsemilla_chip, domain=cd.M),
                   R=FixedPointBase(cd.R, NUM_WINDOWS))

    def commit(self, layouter, pieces: list[MessagePiece], r: Value
               ) -> EccPoint:
        """sinsemilla.rs:488-505: blind = [r]R first, then hash, then
        complete add (region order is vk-relevant)."""
        blind = self.ecc_chip.mul_fixed(layouter, r, self.R)
        hashed, _zs = self.M.hash_to_point(layouter, pieces)
        return self.ecc_chip.add(layouter, hashed, blind)

    def short_commit(self, layouter, pieces: list[MessagePiece],
                     r: Value):
        return self.commit(layouter, pieces, r).x
