"""CPU tests of the benchmark's harness and plain reference.

    python -m pytest benchmark/test_benchmark_harness.py -q

The runs here prove with halo2_tpu_torch on the CPU (the kernels' plain
versions) at small k; a whole run of the file takes a few minutes, less
with `-n 4`. The test marked `cuda` runs each cell of BENCHMARK.json on
the card for a short window and skips where there is none.
"""
from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys

import pytest

from benchmark import harness, trace
from benchmark.reference import plonk

ROOT = harness.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    SPEC = json.load(fh)
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAFFIC = {"circuits_per_proof": 1}
SMALL = {
    "plonk_bench": {"name": "plonk_bench_k5", "circuit": "plonk_bench",
                    "curve": "pallas", "k": 5},
    "dev_lookup": {"name": "dev_lookup_k6", "circuit": "dev_lookup",
                   "curve": "pallas", "k": 6, "table_bits": 4, "rows": 32},
}
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def _cache_in_tmp(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(harness, "CACHE",
                        str(tmp_path_factory.getbasetemp() / "cache"))


def small_cell(circuit: str) -> dict:
    return {"name": circuit, "workload": {"chips": 1},
            "config": dict(SMALL[circuit]), "traffic": dict(TRAFFIC),
            "end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "prove_s", "unit": "s/proof"}],
            "per_layer": [], "readers": {}}


def run_small(circuit: str, per_proof: int = 1, **kw) -> dict:
    cell = small_cell(circuit)
    cell["traffic"]["circuits_per_proof"] = per_proof
    return harness.run_cell(cell, SEED, 0, False, device="cpu", workers=1,
                            **kw)


# ---- BENCHMARK.json resolves, by name, to files under paths

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell)
    cfg = c["config"]
    assert cfg["name"] == c["workload"]["config"]
    for package in ("circuits", "reference"):
        assert os.path.exists(os.path.join(harness.BENCH, package,
                                           cfg["circuit"] + ".py"))
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s", "prove_s"}
    assert c["per_layer"] and set(c["readers"]) == {
        m["name"] for m in c["per_layer"]}
    assert c["traffic"]["circuits_per_proof"] >= 1


def test_spec_names_and_files():
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in SPEC["configs"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])


# ---- the metric arithmetic over a synthetic trace

def test_union_and_gaps():
    busy = trace.union([(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (4.0, 4.5)])
    assert busy == [(0.0, 2.0), (3.0, 4.5)]
    assert trace.gaps(busy, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.5, 5.0)]
    assert trace.clip(busy, 1.0, 3.5) == [(1.0, 2.0), (3.0, 3.5)]


def test_reduce_synthetic_trace():
    proofs = [(0.0, 10.0), (10.0, 20.0)]
    laps = [[("a", 4.0), ("b", 5.0)], [("a", 6.0), ("b", 4.0)]]
    device = [("void k1<4>(int*)", 1.0, 2.0), ("k1", 1.5, 3.0),
              ("Memcpy HtoD (Pageable -> Device)", 5.0, 5.5),
              ("ns::k2(int)", 12.0, 14.0), ("outside", 25.0, 26.0)]
    r = trace.reduce(proofs, laps, device)
    assert r["proofs"] == 2 and r["window_s"] == 20.0
    assert r["busy_s"] == pytest.approx(2.0 + 0.5 + 2.0)
    assert r["launches"] == 3                    # the copy is no kernel
    assert r["device_seconds"] == pytest.approx(
        {"k1": 2.5, "Memcpy HtoD": 0.5, "ns::k2": 2.0})
    # proof 0: idle [0,1) and [3,4) in a, [4,5) and [5.5,9) in b, [9,10)
    # after the last lap; proof 1: idle [10,12) and [14,16) in a, [16,20) b
    assert r["idle_by_phase"] == pytest.approx(
        {"a": 2.0 + 4.0, "b": 4.5 + 4.0, "(between phases)": 1.0})
    assert trace.top(r["idle_by_phase"], 1) == [["b", 8.5]]


def test_laps_summed_over_proofs():
    laps = [[("advice: synthesis", 0.5), ("evals", 0.1)],
            [("advice: synthesis", 0.25), ("evals", 0.3)]]
    assert trace.per_phase(laps, {"advice: synthesis"}) == 0.375
    assert trace.per_phase(laps, {"evals", "advice: synthesis"}) == 0.575
    assert trace.per_phase(laps, {"lookup permuted"}) is None
    assert trace.per_phase([], {"evals"}) is None


def test_window_counts_whole_proofs():
    clock = {"t": 0.0}
    calls = []

    def step(i):
        calls.append(i)
        clock["t"] += 0.4

    real = harness.time.perf_counter
    harness.time.perf_counter = lambda: clock["t"]
    try:
        n, elapsed = harness.closed_loop(1.0, step)
    finally:
        harness.time.perf_counter = real
    assert (n, calls) == (3, [0, 1, 2])          # the third ends at 1.2 s
    assert elapsed == pytest.approx(1.2)


def test_kernel_readers():
    run = {"keygen_s": 1.5, "laps": [], "trace": {
        "proofs": 2, "window_s": 4.0, "busy_s": 1.0, "launches": 10,
        "device_seconds": {"padd_masked_kernel": 0.003,
                           "glv_ladder_group_kernel": 0.001,
                           "fmul_kernel": 0.002,
                           "at::native::elementwise_kernel": 0.5},
        "idle_by_phase": {}}}
    cell = harness.load_cell(CELLS[0])
    got = {name: read(run) for name, read in cell["readers"].items()}
    assert got["kernel_ms.points"] == pytest.approx(2.0)
    assert got["kernel_ms.field"] == pytest.approx(1.0)
    assert got["device_launches"] == 5
    assert got["device_idle_pct"] == pytest.approx(75.0)
    assert got["keygen_s"] == 1.5
    assert got["synthesis_s"] is None            # no laps, nothing read
    run["trace"] = None
    assert cell["readers"]["device_idle_pct"](run) is None


# ---- no JAX, by whole top-level names

def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "halo2_tpu_torch_like", sys)
    assert "halo2_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib.fake"]


def test_no_jax_after_a_runs_imports():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import harness;"
        "[harness.load_cell(c) for c in sys.argv[2:]];"
        "import torch, torch.profiler;"
        "from halo2_tpu_torch.curves.host import PALLAS;"
        "from halo2_tpu_torch.plonk import prover;"
        "from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk;"
        "from halo2_tpu_torch.poly.commitment import Params;"
        "from halo2_tpu_torch.transcript import TranscriptWrite;"
        "import benchmark.circuits.plonk_bench, benchmark.circuits.dev_lookup;"
        "from benchmark.reference import plonk;"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, ROOT] + CELLS,
                         capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.stdout.strip() == "[]"


# ---- the plain reference against proofs the program made on the CPU

@pytest.fixture(scope="module", params=sorted(SMALL))
def proved(request, tmp_path_factory):
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
    from halo2_tpu_torch.poly.commitment import Params
    import importlib
    cfg = SMALL[request.param]
    program = importlib.import_module("benchmark.circuits." + cfg["circuit"])
    plain = importlib.import_module("benchmark.reference." + cfg["circuit"])
    params = Params.new(PALLAS, cfg["k"], device="cpu", use_cache=False)
    keyed = program.keygen_circuit(cfg)
    vk = keygen_vk(params, keyed)
    pk = keygen_pk(params, vk, keyed)
    w = plain.witness(cfg, random.Random(5))
    proof = harness.prove_once(params, pk, [program.circuit(cfg, w)],
                               [program.instance(cfg, w)], random.Random(6))
    cs = plain.constraint_system(cfg)
    cache = str(tmp_path_factory.mktemp("reference"))
    srs = plonk.Srs(cache, cfg["k"], 1)
    rvk = plonk.verifying_key(cs, srs, os.path.join(cache, "vk.json"))
    return {"cfg": cfg, "plain": plain, "cs": cs, "srs": srs, "rvk": rvk,
            "vk": vk, "params": params, "w": w, "proof": proof}


def _verifies(p, instances, proof) -> bool:
    try:
        op = plonk.replay(p["cs"], p["rvk"], p["srs"], instances, proof)
    except plonk.Rejected:
        return False
    return plonk.check_openings(p["srs"], [op], 3)


def test_reference_works_out_the_program_keys(proved):
    p = proved
    assert p["rvk"]["pinned"] == p["vk"].pinned_text_compact()
    assert p["srs"].w == p["params"].w and p["srs"].u == p["params"].u


def test_reference_accepts_the_program_proof(proved):
    p = proved
    assert _verifies(p, [p["plain"].instance(p["cfg"], p["w"])], p["proof"])


@pytest.mark.parametrize("where", [40, 200, -40])
def test_reference_rejects_a_corrupted_proof(proved, where):
    p = proved
    bad = bytearray(p["proof"])
    bad[where] ^= 0x04
    assert not _verifies(p, [p["plain"].instance(p["cfg"], p["w"])],
                         bytes(bad))
    assert not _verifies(p, [p["plain"].instance(p["cfg"], p["w"])],
                         p["proof"] + b"\x00")


# ---- whole runs at a small size: sound, the control, and the faults

@pytest.mark.parametrize("circuit,per_proof", [
    ("dev_lookup", 1), ("plonk_bench", 1), ("plonk_bench", 2)])
def test_sound_run_is_correct(circuit, per_proof):
    r = run_small(circuit, per_proof)
    assert r["correct"], r["limits"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "limits"
    assert set(r["metrics"]) == {"setup_s", "prove_s"}


@pytest.mark.parametrize("circuit", sorted(SMALL))
def test_control_is_not_correct(circuit):
    """The control: the program proves a statement the configuration does
    not state (plonk_bench: sm = 2 on the raw_multiply rows; dev_lookup:
    the table's top entry moved up by one). Every proof is rejected."""
    r = run_small(circuit, control=True)
    assert not r["correct"]
    assert r["limits"]["rejected_proofs"]["value"] == 1


def _replaying():
    """A timed path that returns its state unchanged: the proof it made
    last (the warm-up's, in the window's first call)."""
    state = {}

    def prove(params, pk, circuits, instances, rng):
        proof = harness.prove_once(params, pk, circuits, instances, rng)
        last = state.get("proof", proof)
        state["proof"] = proof
        return last
    return prove


def _altering(params, pk, circuits, instances, rng):
    """A timed path that alters its answer where it is produced: one bit
    of the IPA's final scalar c."""
    proof = bytearray(harness.prove_once(params, pk, circuits, instances, rng))
    proof[-40] ^= 0x01
    return bytes(proof)


@pytest.mark.parametrize("circuit,fault", [
    ("plonk_bench", "replay"), ("dev_lookup", "replay"),
    ("plonk_bench", "alter"), ("dev_lookup", "alter")])
def test_broken_timed_path_is_not_correct(circuit, fault):
    prove = _replaying() if fault == "replay" else _altering
    r = run_small(circuit, prove=prove)
    assert not r["correct"]
    if fault == "replay":
        assert r["limits"]["repeated_proofs"]["value"] == 1


# ---- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_roofline_bound():
    from benchmark import roofline
    assert roofline.bound_ms(3.35e9, 1e9) == (pytest.approx(1.0), "bytes")
    assert roofline.bound_ms(1e9, 16.7e9) == (pytest.approx(1.0),
                                              "operations")
