"""padd_masked_roofline: kernel B3's share of its roofline over the
traced proofs, in %: 100 x the least time the card could take for the
work of every B3 launch (benchmark/roofline.py::bound_ms of the bytes
and multiply-adds the program counted at its launches) over B3's device
time in the trace. A live lane moves 580 or 588 bytes against 12
products, a masked-off lane 388 bytes and none, so every B3 launch is
bound by its bytes and the bound of the sums is the sum of the
launches' bounds."""
from benchmark.program_spans import traced
from benchmark.roofline import bound_ms
from benchmark.trace import short_name

KERNEL = "padd_masked_kernel"


def read(run):
    records = traced(run)
    if not records:
        return None
    work = [r.kernels["padd_masked"] for r in records
            if "padd_masked" in r.kernels]
    device_s = sum(s for name, s in run["trace"]["device_seconds"].items()
                   if short_name(name) == KERNEL)
    if not work or device_s <= 0:
        return None
    ms, _ = bound_ms(sum(w[2] for w in work), sum(w[3] for w in work))
    return 100.0 * ms * 1e-3 / device_s
