"""kernel_ms.field: device milliseconds per traced proof of the field,
transform and gate kernels: B1 and B8 (field_kernels.cu), the
add/subtract, B7 (ntt_kernels.cu), K1 (mxu_kernels.cu) and K2
(gate_kernels.cu)."""
from benchmark.trace import short_name

KERNELS = {
    "fmul_kernel", "fmul_limbs_first_kernel",                  # B1, B8
    "faddsub_kernel",                                          # add/sub
    "ntt_pass_kernel",                                         # B7
    "mxu_pass_kernel", "mxu_const_mul_kernel",                 # K1
    "gate_chunk_kernel",                                       # K2
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
