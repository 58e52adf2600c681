"""Poseidon: the permutation, its Pow5 chip and the sponge gadget.

Copied from halo2_tpu/gadgets/poseidon/__init__.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from .primitive import (Spec, P128Pow5T3, Grain, generate_constants,
                        generate_mds, permute, Sponge, ConstantLength,
                        poseidon_hash)
from .pow5 import Pow5Chip, Pow5Config, poseidon_hash_gadget
from .gadget import Sponge, Hash, PaddedWord
