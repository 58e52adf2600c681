"""The kernels' roofline model.

Port of halo2_tpu/parallel/profiling.py. The reference's model counts a
TPU v5e's VPU lanes and reads its HBM rate from HALO2_TPU_HBM_GBPS; the
port's counts one NVIDIA H100's 32-bit integer multiply-adds and its HBM
rate, as keyword defaults (no environment variable). `bound_ms` is the
least time the card could take for a kernel's work: the larger of its
bytes over the HBM rate and its multiply-adds over the integer rate, the
bound every kernel's time is held against (chip_smoke.py, PERF.md).
The reference's `compiled_bytes_accessed` (XLA's cost model) has no
counterpart: `bandwidth_fraction` takes the caller's byte count. Each
launch's work is recorded by halo2_tpu_torch/tracing.py.
"""
from __future__ import annotations

from ..ops.field_kernels import MONT_MULADDS  # noqa: F401 (re-export)

# HBM rate of an NVIDIA H100 SXM at 700 W (its data sheet)
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds a second: 64 results a clock an SM (the
# IMAD pipe runs at half the float rate) x 132 SMs x 1.98 GHz, as
# chip_smoke.py's [peak] measures on an H100 80GB HBM3 at 700 W
# (1.6728e13 IMAD results/s; IMAD.WIDE 1.2874e13 32-bit words/s, IMAD.HI
# 7.7605e12); a 32x32->64 product counts as two (low and high word)
MULADD_PER_S = 16.7e12
# IMAD-pipe SASS instructions of one product in kernel B1 as built for
# sm_90a (91 IMAD.WIDE, 102 IMAD.X, moves and shifts; PERF.md)
B1_IMAD_PIPE_INSTRUCTIONS = 249


def modmul_speed_of_light(muladd_per_s: float = MULADD_PER_S,
                          muladds_per_mul: int = MONT_MULADDS) -> float:
    """Upper bound on Montgomery products a second on the card: its
    integer multiply-add rate over the multiply-adds one product needs.
    The cross-kernel yardstick; modmul_vpu_ops_measured gives what B1
    issues, which bounds what tuning B1 alone can reach."""
    return muladd_per_s / muladds_per_mul


def modmul_vpu_ops_measured() -> int:
    """Instructions B1 issues on the card's integer multiply-add pipe
    per product (its SASS as built for sm_90a): 249 against the 224
    multiply-adds modmul_speed_of_light counts. The name is the
    reference's (a TPU VPU lane-op count there)."""
    return B1_IMAD_PIPE_INSTRUCTIONS


def kernel_efficiency(measured_per_s: float, **sol_kwargs) -> float:
    """measured / speed-of-light fraction for the product kernel."""
    return measured_per_s / modmul_speed_of_light(**sol_kwargs)


def hbm_bandwidth_bytes_per_s(bytes_per_s: float = HBM_BYTES_PER_S
                              ) -> float:
    """Peak HBM rate of the card (an H100 SXM: 3.35 TB/s)."""
    return bytes_per_s


def bandwidth_fraction(nbytes: float, measured_seconds: float,
                       bytes_per_s: float = HBM_BYTES_PER_S) -> float:
    """nbytes / measured_seconds over the card's peak HBM rate: above
    about 0.5 the call is bandwidth-bound. nbytes: what the function
    must move (each input read once, each output written once)."""
    if nbytes <= 0 or measured_seconds <= 0:
        return 0.0
    return nbytes / measured_seconds / bytes_per_s


def bound_ms(nbytes: float, muladds: float,
             bytes_per_s: float = HBM_BYTES_PER_S,
             muladd_per_s: float = MULADD_PER_S) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes and issue muladds 32-bit multiply-adds, and which of
    the two bounds it."""
    tb = nbytes / bytes_per_s * 1e3
    to = muladds / muladd_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")

