"""Verifying and proving keys.

Reference: halo2_proofs/src/plonk.rs:41-141. The vk's transcript_repr
binds the full pinned verification key (both moduli, pinned domain, pinned
constraint system, fixed and permutation commitments) into every proof
transcript via BLAKE2b-512 with personalization b"Halo2-Verify-Key"
(plonk.rs:56-101). The pinned text format here is a canonical rendering of
the same data (the reference hashes a Rust Debug string; byte parity of
that string is tracked in PARITY.md).

Port of halo2_tpu/plonk/keys.py; the proving-key arrays are tensors on
the Params device."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import torch

from ..curves.host import CurveSpec, Point
from ..poly.domain import EvaluationDomain
from .circuit import ConstraintSystem
from .permutation import PermutationProvingKey


@dataclass
class VerifyingKey:
    curve: CurveSpec
    domain: EvaluationDomain
    fixed_commitments: list[Point]
    permutation_commitments: list[Point]
    cs: ConstraintSystem
    cs_degree: int
    selectors: list[list[bool]] = field(default_factory=list)

    def pinned_text(self) -> str:
        """The Rust `{:#?}` (alternate Debug) text of the pinned
        verification key — byte-identical to the reference's
        `format!("{:#?}", vk.pinned())` (tests/plonk_api.rs:589)."""
        from .pinned import pinned_vk_node, render_alternate
        return render_alternate(pinned_vk_node(self))

    def pinned_text_compact(self) -> str:
        """The Rust `{:?}` text of the pinned vk — exactly the string the
        reference hashes into transcript_repr (plonk.rs:80)."""
        from .pinned import pinned_vk_node, render_compact
        return render_compact(pinned_vk_node(self))

    def transcript_repr(self) -> int:
        """plonk.rs:75-90: blake2b-512(person=b"Halo2-Verify-Key") over
        u64-le(len(s)) || s where s = format!("{:?}", vk.pinned())."""
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        text = self.pinned_text_compact().encode()
        h.update(len(text).to_bytes(8, "little"))
        h.update(text)
        return self.curve.scalar.from_uniform_bytes(h.digest())

    def hash_into(self, transcript) -> None:
        """plonk.rs:94-101."""
        transcript.common_scalar(self.transcript_repr())


@dataclass
class ProvingKey:
    vk: VerifyingKey
    l0: torch.Tensor            # extended basis
    l_blind: torch.Tensor
    l_last: torch.Tensor
    l_active_row_info: tuple   # (blinding_factors,)
    fixed_values: list         # Lagrange tensors
    fixed_polys: list          # coeff tensors
    fixed_cosets: list         # extended tensors
    permutation: PermutationProvingKey
