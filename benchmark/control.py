"""Runs a cell's control on the GPU: the program proves a statement that
the configuration does not state (circuits/<circuit>.py says which), and
the plain reference has to reject every proof it checks. The benchmark's
own runs never run this.

    python3 benchmark/control.py --workload <cell> --seconds 5 --seeds 11,12,13

Prints, for each seed, one JSON line with the numbers compared and
`correct`, which must come out false; exits 1 if any seed's run is
correct.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    any_correct = False
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(cell, seed, args.seconds, False,
                                  device="cuda", t0=time.perf_counter(),
                                  control=True)
        any_correct |= result["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": True, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "reference": result["reference"],
                          "limits": result["limits"]}), flush=True)
    return 1 if any_correct else 0


if __name__ == "__main__":
    sys.exit(main())
