"""In-circuit Pallas curve arithmetic (halo2_gadgets/src/ecc.rs).

Copied from halo2_tpu/gadgets/ecc/__init__.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from .chip import EccChip, EccConfig, EccPoint, FixedPointBase
from .gadget import Point, NonIdentityPoint
