"""kernel_ms.points: device milliseconds per traced proof of the point
kernels of csrc/point_kernels.cu: B2 (one thread and group forms), B3,
B4, B5 and B6 (lane and group doublings), the bucket-run kernel, the GLV
ladder and the scalar-multiplication ladder."""
from benchmark.trace import short_name

KERNELS = {
    "pmixed_masked_kernel", "pmixed_masked_group_kernel",     # B2
    "padd_masked_kernel",                                      # B3
    "padd_kernel",                                             # B4
    "pdouble_lane_kernel", "pdouble_group_kernel",             # B5, B6
    "pmixed_bucket_runs_kernel", "pmixed_bucket_runs_group_kernel",
    "glv_ladder_kernel", "glv_ladder_group_kernel",
    "scalar_mul_ladder_kernel",
}


def read(run):
    trace = run["trace"]
    if not trace:
        return None
    hits = [s for name, s in trace["device_seconds"].items()
            if short_name(name) in KERNELS]
    if not hits:
        return None
    return 1000.0 * sum(hits) / trace["proofs"]
