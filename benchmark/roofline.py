"""The roofline yardstick, frozen here so that a later change to the
program cannot move it: the card's peaks and the least time a kernel's
work could take. No metric reads it yet; a `<kernel>_roofline` reader
will divide `bound_ms` of a launch's counted bytes and multiply-adds by
its device time, once the program counts them per launch.

Copied from halo2_tpu_torch/parallel/profiling.py (`bound_ms` and its
constants), measured there on an NVIDIA H100 80GB HBM3 at 700 W.
"""
from __future__ import annotations

# HBM rate of an NVIDIA H100 SXM at 700 W (its data sheet)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds a second: 64 results a clock an SM (the
# IMAD pipe at half the float rate) x 132 SMs x 1.98 GHz, as the
# program's integer-peak microbenchmark measured (1.6728e13 IMAD
# results/s); a 32x32->64 product counts as two
MULADD_PER_S = 16.7e12
# multiply-adds of one Montgomery product of 8 x 32-bit limbs: 64
# products for a*b and 48 for the reduction, two words each
MONT_MULADDS = 2 * 112


def bound_ms(nbytes: float, muladds: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes (each input read once, each output written once) and
    issue muladds 32-bit multiply-adds, and which of the two bounds it."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = muladds / MULADD_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
