"""The gadget library: utilities, ECC, Poseidon, Sinsemilla and Merkle.

Copied from halo2_tpu/gadgets/__init__.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
