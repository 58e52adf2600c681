"""Runs one cell of BENCHMARK.json once on the GPU and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (library loads, Params, keygen and one
warm-up proof) counts from the start of this script to the first timed
proof; the window then proves in a closed loop for --seconds and ends
with the first proof that finishes after it. After the window the plain
reference (benchmark/reference/) verifies every proof the window
completed. The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key. With --trace 1 the first
proofs of the window run under torch.profiler and the result holds the
per-layer metrics instead of the end-to-end ones.

Exits 2 without a result where there is no CUDA device (or fewer than the
cell asks for), and 1 where a module of JAX or of the JAX package is
loaded once the window has closed, or a file of the benchmark or the
program is missing.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 1
    for reason in result["reference"]["reasons"]:
        print(f"reference: {reason}", file=sys.stderr)
    for name, v in result["limits"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
