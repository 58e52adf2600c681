"""Puts the card's idle time in warm proofs of a benchmark cell down to
the program's own spans, on the profiler's clock.

    python3 scripts/trace_spans.py --workload dev_lookup_k18.single \
        --seed 5 --proofs 3 [--json trace_spans.json]

From the root of a checkout, on a CUDA card. Sets up the cell as the
benchmark does (benchmark/harness.py: Params, keygen, one warm-up proof
at the cell's shapes), then proves --proofs proofs under torch.profiler.
The recorder (halo2_tpu_torch/tracing.py) opens a "halo2.<name>" range
for every phase and span while a profiler records, so each idle stretch
of the card inside a proof (no kernel or copy running) lies inside the
innermost of them. Prints, and writes as JSON, the idle seconds a proof
by phase and by innermost span within each phase, and the share of each
phase's idle time that a span inside the phase holds. No number of the
benchmark comes from this script.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "trace_spans.proof."
RANGE = "halo2."


def innermost(ranges, t: float):
    """The name of the range of `ranges` [(name, start, end)] that holds t
    and started last (ranges of one thread nest), or None."""
    best = None
    for name, start, end in ranges:
        if start <= t < end and (best is None or start >= best[1]):
            best = (name, start)
    return None if best is None else best[0]


def idle_by_span(proof, ranges, device, phases) -> dict:
    """{(phase, innermost range): idle seconds} in one proof's interval
    `proof`: `ranges` its halo2 ranges, `device` the card's busy
    intervals merged and sorted, `phases` the names of the laps."""
    from benchmark.trace import clip, gaps
    p_start, p_end = proof
    inside = [(n, s, e) for n, s, e in ranges if e > p_start and s < p_end]
    laps = [(n, s, e) for n, s, e in inside if n in phases]
    cuts = sorted({t for _, s, e in inside for t in (s, e)})
    out: dict = {}
    for g_start, g_end in gaps(clip(device, p_start, p_end), p_start, p_end):
        lo = bisect.bisect_right(cuts, g_start)
        hi = bisect.bisect_left(cuts, g_end)
        edges = [g_start] + cuts[lo:hi] + [g_end]
        for a, b in zip(edges, edges[1:]):
            mid = (a + b) / 2
            key = (innermost(laps, mid) or "(between phases)",
                   innermost(inside, mid) or "(no span)")
            out[key] = out.get(key, 0.0) + (b - a)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="dev_lookup_k18.single")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--proofs", type=int, default=3)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import importlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from benchmark.trace import union
    from halo2_tpu_torch.curves import native
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.ops import cuda_build
    from halo2_tpu_torch.plonk import prover
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.poly.commitment import Params

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    cfg = cell["config"]
    program = importlib.import_module("benchmark.circuits." + cfg["circuit"])
    cuda_build.build_all()
    native._load()
    params = Params.new(PALLAS, cfg["k"], device="cuda")
    keyed = program.keygen_circuit(cfg, False)
    pk = keygen_pk(params, keygen_vk(params, keyed), keyed)

    def prove(index):
        witnesses, rng = harness.make_job(cell, args.seed, index)
        harness.prove_once(params, pk,
                           [program.circuit(cfg, w, False) for w in witnesses],
                           [program.instance(cfg, w, False) for w in witnesses],
                           rng)
        torch.cuda.synchronize()

    prove("warmup")
    laps = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.proofs):
            with torch.profiler.record_function(f"{MARK}{i}"):
                prove(i)
            laps.append(list(prover.LAST_PHASES))
    marks, ranges, device = {}, [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == DeviceType.CPU:
            if name.startswith(MARK):
                marks[int(name[len(MARK):])] = (start, end)
            elif name.startswith(RANGE):
                ranges.append((name[len(RANGE):], start, end))
        elif e.device_type() == DeviceType.CUDA and not (
                name.startswith(MARK) or name.startswith(RANGE)):
            device.append((start, end))
    busy = union(device)
    phases = {n for proof_laps in laps for n, _ in proof_laps}
    total: dict = {}
    for i in sorted(marks):
        for key, s in idle_by_span(marks[i], ranges, busy, phases).items():
            total[key] = total.get(key, 0.0) + s / len(marks)
    by_phase: dict = {}
    for (phase, _), s in total.items():
        by_phase[phase] = by_phase.get(phase, 0.0) + s
    result = {"workload": args.workload, "seed": args.seed,
              "proofs": len(marks),
              "device": torch.cuda.get_device_name(0),
              "proof_s": sum(e - s for s, e in marks.values()) / len(marks),
              "idle_s_by_phase": by_phase,
              "idle_s_by_span": [[p, n, s] for (p, n), s in sorted(
                  total.items(), key=lambda kv: -kv[1])],
              "in_a_span": {p: sum(s for (q, n), s in total.items()
                                   if q == p and n not in (p, "(no span)"))
                            / v
                            for p, v in by_phase.items() if v > 0},
              "ranges_on_the_card": sum(
                  1 for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and e.name().startswith(RANGE))}
    for phase, s in sorted(by_phase.items(), key=lambda kv: -kv[1]):
        print(f"{phase:34s} idle {s:8.4f} s a proof, "
              f"{100 * result['in_a_span'].get(phase, 0):5.1f}% in a span")
        for p, n, v in result["idle_s_by_span"]:
            if p == phase and v >= 0.005:
                print(f"    {n:30s} {v:8.4f}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
