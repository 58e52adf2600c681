"""Sinsemilla: the hash primitive, its chip, the domains and Merkle paths.

Copied from halo2_tpu/gadgets/sinsemilla/__init__.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from .primitive import (K, C, HashDomain, CommitDomain, hash_to_point,
                        hash_value, sinsemilla_s, sinsemilla_q)
