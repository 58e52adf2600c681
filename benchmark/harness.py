"""One run of one cell: set-up, a closed loop of proofs for a fixed time,
the plain reference's verdict on what the loop produced, and the result.

Everything a cell needs is found by name from BENCHMARK.json:
  configs      the "file" of the cell's configuration (sizes, circuit)
  circuits/    <circuit>.py builds the program's circuit from a witness
  reference/   <circuit>.py describes it plainly and draws its witness
  traffic/     <traffic>.json: the circuits a proof
  metrics/     <metric>.py: read(run) -> number or None, a per-layer metric
So a later cell or metric is new files and new entries, and no edit.

The program under test is halo2_tpu_torch: Params.new, keygen_vk,
keygen_pk and create_proof, the entry that the window drives.
"""
from __future__ import annotations

import gc
import hashlib
import importlib
import importlib.util
import json
import os
import random
import sys
import time
import traceback

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_tpu")
TRACE_PROOFS = 3       # proofs a --trace 1 run records with the profiler
PROOF_MARK = "benchmark.proof."


def set_cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    (The program's own: halo2_tpu_torch/_build/ and .srs_cache/.)"""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's workload entry, configuration, traffic, metrics and the
    readers of its per-layer metrics. Raises KeyError for a name that
    BENCHMARK.json does not hold."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    workload = {w["name"]: w for w in spec["workloads"]}[name]
    entry = {c["name"]: c for c in spec["configs"]}[workload["config"]]
    with open(os.path.join(root, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(BENCH, "traffic", workload["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    readers = {m["name"]: _load_file(
        os.path.join(BENCH, "metrics", m["name"] + ".py"),
        "benchmark.metrics." + m["name"].replace(".", "_")).read
        for m in spec["per_layer"]}
    return {"name": name, "workload": workload, "config": config,
            "traffic": traffic, "end_to_end": spec["end_to_end"],
            "per_layer": spec["per_layer"], "readers": readers}


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def make_job(cell: dict, seed: int, index) -> tuple[list, random.Random]:
    """The witnesses of proof `index` and its prover's RNG, drawn from
    (seed, index): the same seed gives the same proofs' inputs."""
    cfg = cell["config"]
    plain = importlib.import_module("benchmark.reference." + cfg["circuit"])
    witnesses = [plain.witness(cfg, random.Random(f"{seed}:{index}:{j}"))
                 for j in range(cell["traffic"]["circuits_per_proof"])]
    return witnesses, random.Random(f"{seed}:{index}:prover")


def prove_once(params, pk, circuits, instances, rng) -> bytes:
    """The timed path: one create_proof into a Blake2b transcript."""
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.transcript import TranscriptWrite
    transcript = TranscriptWrite(params.curve)
    create_proof(params, pk, circuits, instances, rng, transcript)
    return transcript.finalize()


def _device_events(prof):
    """(proof marks {index: (start, end)}, [(name, start, end)] on the
    card) from a profiler's trace, in seconds on its clock."""
    from torch.autograd import DeviceType
    marks, device = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if name.startswith(PROOF_MARK):
            if e.device_type() == DeviceType.CPU:
                marks[int(name[len(PROOF_MARK):])] = (start, end)
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, start, end))
    return marks, device


def reference_check(cell: dict, seed: int, jobs: list, proofs: list,
                    workers: int) -> dict:
    """The plain reference's verdict on every proof the window completed:
    each transcript replayed, then their openings checked together (one
    by one where that fails)."""
    from benchmark.reference import plonk
    cfg = cell["config"]
    plain = importlib.import_module("benchmark.reference." + cfg["circuit"])
    cs = plain.constraint_system(cfg)
    srs = plonk.Srs(os.path.join(CACHE, "reference"), cfg["k"], workers)
    digest = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode())
    vk = plonk.verifying_key(cs, srs, os.path.join(
        CACHE, "reference", f"vk-{cfg['name']}-{digest.hexdigest()[:16]}.json"))
    done = [i for i, p in enumerate(proofs) if p is not None]
    openings, rejected, reasons = [], 0, []
    for i in done:
        instances = [plain.instance(cfg, w) for w in jobs[i]]
        try:
            openings.append(plonk.replay(cs, vk, srs, instances, proofs[i]))
        except plonk.Rejected as err:
            rejected += 1
            reasons.append(f"proof {i}: {err}")
    if openings and not plonk.check_openings(srs, openings, seed):
        for op in openings:
            if not plonk.check_openings(srs, [op], seed):
                rejected += 1
        reasons.append("an IPA opening does not hold")
    return {"checked": len(done), "rejected": rejected, "reasons": reasons}


def closed_loop(seconds: float, step) -> tuple[int, float]:
    """step(0), step(1), ... until the first call that ends `seconds` or
    more after the first began: whole proofs, none cut. Returns the
    number of calls and the seconds they took together."""
    calls, start = 0, time.perf_counter()
    while True:
        step(calls)
        calls += 1
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            return calls, elapsed


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None, prove=None,
             control: bool = False, workers: int | None = None) -> dict:
    """One run; returns the result line's object. `prove` replaces the
    timed path (the fault tests break it); `control` proves the control
    statement of the cell's circuit module instead of the cell's."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.poly.commitment import Params
    cfg = cell["config"]
    if cfg["curve"] != "pallas":
        raise ValueError("the harness and its reference prove over Pallas")
    program = importlib.import_module("benchmark.circuits." + cfg["circuit"])
    prove = prove or prove_once
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def task(index):
        witnesses, rng = make_job(cell, seed, index)
        circuits = [program.circuit(cfg, w, control) for w in witnesses]
        instances = [program.instance(cfg, w, control) for w in witnesses]
        return witnesses, circuits, instances, rng

    # ---- set-up: libraries, Params, keygen, one proof at the cell's shapes
    if cuda:
        from halo2_tpu_torch.curves import native
        from halo2_tpu_torch.ops import cuda_build
        cuda_build.build_all()
        native._load()
    params = Params.new(PALLAS, cfg["k"], device=device)
    sync()
    t_key = time.perf_counter()
    keyed = program.keygen_circuit(cfg, control)
    vk = keygen_vk(params, keyed)
    pk = keygen_pk(params, vk, keyed)
    sync()
    keygen_s = time.perf_counter() - t_key
    _, circuits, instances, rng = task("warmup")
    warm_proof = prove(params, pk, circuits, instances, rng)
    sync()
    setup_s = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the window: whole proofs until the first that ends after it
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    jobs, proofs, laps, times = [], [], [], []

    def step(i):
        witnesses, circuits, instances, rng = task(i)
        jobs.append(witnesses)
        t_proof = time.perf_counter()
        try:
            if prof is not None and i < TRACE_PROOFS:
                with torch.profiler.record_function(f"{PROOF_MARK}{i}"):
                    proofs.append(prove(params, pk, circuits, instances, rng))
                    sync()
            else:
                proofs.append(prove(params, pk, circuits, instances, rng))
                sync()
        except Exception:                     # counted, and not correct
            print(f"proof {i} raised:", file=sys.stderr)
            traceback.print_exc()
            proofs.append(None)
        times.append(time.perf_counter() - t_proof)
        laps.append(list(pv.LAST_PHASES) if proofs[-1] is not None else [])
        if prof is not None and i + 1 == TRACE_PROOFS:
            prof.__exit__(None, None, None)

    _, window_s = closed_loop(seconds, step)
    if prof is not None and len(proofs) < TRACE_PROOFS:
        prof.__exit__(None, None, None)
    failed = proofs.count(None)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    del pk, vk, params, keyed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- what the traced proofs show, and the per-layer metrics' input
    run = {"keygen_s": keygen_s, "laps": laps[TRACE_PROOFS:] if trace
           and len(laps) > TRACE_PROOFS else laps, "trace": None}
    if prof is not None:
        from benchmark import trace as tr
        marks, device_events = _device_events(prof)
        order = sorted(marks)
        run["trace"] = tr.reduce([marks[i] for i in order],
                                 [laps[i] for i in order], device_events)

    # ---- the plain reference's verdict
    seen, repeated = set(), 0
    for p in [warm_proof] + proofs:
        if p is not None:
            h = hashlib.sha256(p).digest()
            repeated += h in seen
            seen.add(h)
    t_ref = time.perf_counter()
    verdict = reference_check(cell, seed, jobs, proofs,
                              workers or min(8, os.cpu_count() or 1))
    limits = {"failed_proofs": {"value": failed, "limit": 0},
              "rejected_proofs": {"value": verdict["rejected"], "limit": 0},
              "repeated_proofs": {"value": repeated, "limit": 0}}
    correct = verdict["checked"] > 0 and all(
        v["value"] <= v["limit"] for v in limits.values())

    # ---- the result line
    done = len(proofs) - failed
    end_to_end = {"setup_s": setup_s,
                  "prove_s": window_s / done if done else None,
                  "prove_peak_gib": peak_window / 2 ** 30}
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            value = cell["readers"][m["name"]](run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            if end_to_end[m["name"]] is not None:
                metrics[m["name"]] = {"value": end_to_end[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(peak_setup, peak_window)}
    result = {"correct": correct, "attempted": len(proofs),
              "failed": failed + verdict["rejected"], "metrics": metrics,
              "device": dev}
    if trace and run["trace"]:
        from benchmark.trace import top
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {
            "device_ops": top(run["trace"]["device_seconds"]),
            "idle_gaps": top(run["trace"]["idle_by_phase"])}
    result["window"] = {"seconds": window_s, "proof_seconds": times,
                        "keygen_s": keygen_s, "laps": laps}
    result["reference"] = {"checked": verdict["checked"],
                           "reasons": verdict["reasons"][:5],
                           "seconds": time.perf_counter() - t_ref}
    result["limits"] = limits
    return result
