"""The port's recorder (halo2_tpu_torch/tracing.py) and the benchmark's
readers of its records (benchmark/program_spans.py and the metrics that
use it), on the CPU.

A dev_lookup proof at K = 5 (the smallest lookup circuit the port
proves; one device IPA round, four native ones) must leave a record
that holds every span of the IPA open inside the `multiopen+ipa` lap;
another, under torch.profiler, must show every lap in the profiler's
trace as a "halo2.<lap>" range of the lap's length. The Params commit by
the native host MSM, as tests/test_torch_gadgets_parity.py's do: the
plain Pippenger takes seconds a commit on a CPU.
"""
import collections
import importlib.util
import os
import random
import types

import pytest
import torch

from halo2_tpu_torch import tracing
from halo2_tpu_torch.bench_circuit import dev_lookup_circuit_class
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.fields.device import FQ_DEV
from halo2_tpu_torch.ops import cuda_build
from halo2_tpu_torch.ops import field_kernels as fk
from halo2_tpu_torch.ops import point_kernels as pk
from halo2_tpu_torch.parallel.context import WHOLE
from halo2_tpu_torch.plonk import prover
from halo2_tpu_torch.plonk.keygen import keygen_pk, keygen_vk
from halo2_tpu_torch.poly import commitment
from halo2_tpu_torch.poly import utils as poly_utils
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite

from benchmark import program_spans
from benchmark.roofline import bound_ms

K, TABLE_BITS, ROWS, SEED = 5, 3, 16, 7
IPA_SPANS = ("multiopen.q_polys", "multiopen.kate", "multiopen.commit",
             "multiopen.evals", "multiopen.p_poly", "ipa.s_poly",
             "ipa.p_prime", "ipa.b_powers", "ipa.device", "ipa.native",
             "ipa.blind")
LAPS = ["instance commit+ntt", "advice: synthesis", "advice: commit",
        "advice: ntt+extend", "lookup permuted", "permutation z",
        "lookup products", "vanishing random", "h terms build",
        "vanishing construct (h commit)", "evals", "multiopen+ipa"]
METRICS = os.path.join(os.path.dirname(__file__), "..", "benchmark",
                       "metrics")
MARK = "test.proof"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the proofs run small plain-version ops, which
    slow down many times over when the suite's workers each spin eight
    threads on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_commit_many(self, polys_mont, blinds, lagrange, rows=WHOLE):
    """Params.commit_many's group elements by the native host MSM."""
    bases = self.g_lagrange if lagrange else self.g
    out = []
    for poly, blind in zip(polys_mont, blinds):
        pt = self.curve.msm(list(self.scalar_df.from_mont_np(poly)), bases)
        blind %= self.curve.scalar.modulus
        if blind:
            pt = self.curve.add(pt, self.curve.mul(self.w, blind))
        out.append(pt)
    return out


@pytest.fixture(scope="module")
def keyed():
    params = Params.new(PALLAS, K, device="cpu", use_cache=False)
    params.commit_many = types.MethodType(_host_commit_many, params)
    cls = dev_lookup_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)
    circuit = cls(TABLE_BITS, ROWS)
    vk = keygen_vk(params, circuit)
    keygen = tracing.LAST_KEYGEN
    pk_ = keygen_pk(params, vk, circuit)
    return params, circuit, pk_, keygen


@pytest.fixture(scope="module")
def proved(keyed):
    """(the record, the laps) of a proof whose first IPA round runs on
    the device."""
    params, circuit, pk_, _ = keyed
    prover.create_proof(params, pk_, [circuit], [[]], random.Random(SEED),
                        TranscriptWrite(PALLAS), native_ipa_threshold=8)
    return tracing.PROOFS[-1], list(prover.LAST_PHASES)


@pytest.fixture(scope="module")
def profiled(keyed):
    """(the laps, the profiler's events) of a proof under torch.profiler
    (every IPA round native)."""
    from torch.profiler import ProfilerActivity, profile
    params, circuit, pk_, _ = keyed
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(MARK):
            prover.create_proof(params, pk_, [circuit], [[]],
                                random.Random(SEED + 1),
                                TranscriptWrite(PALLAS))
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return list(prover.LAST_PHASES), events


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_and_give_self_time(monkeypatch):
    clock = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: next(clock))
    with tracing.record("probe") as rec:
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    pass
    outer, inner1, inner2, leaf = rec.spans
    assert [s.name for s in rec.spans] == ["outer", "inner", "inner", "leaf"]
    assert (outer.parent, inner1.parent, inner2.parent, leaf.parent) == (
        None, 0, 0, 2)
    assert outer.seconds == pytest.approx((outer.end - outer.start) * 1e-9)
    kids = (inner1.end - inner1.start) + (inner2.end - inner2.start)
    assert outer.self_seconds == pytest.approx(
        (outer.end - outer.start - kids) * 1e-9)
    assert inner2.self_seconds == pytest.approx(
        (inner2.end - inner2.start - (leaf.end - leaf.start)) * 1e-9)
    assert rec.seconds("inner") == pytest.approx(
        inner1.seconds + inner2.seconds)
    assert all(s.start >= outer.start and s.end <= outer.end
               for s in rec.spans)


def test_ring_keeps_the_last_proofs_only(monkeypatch):
    monkeypatch.setattr(tracing, "PROOFS",
                        collections.deque(maxlen=tracing.RING))
    ids = []
    for _ in range(tracing.RING + 6):
        with tracing.record("proof") as rec:
            ids.append(rec.id)
    assert tracing.RING >= 64
    assert [r.id for r in tracing.PROOFS] == ids[-tracing.RING:]
    assert len(set(ids)) == len(ids)


def test_counters_and_nothing_outside_a_record():
    assert tracing.current() is None
    tracing.count("stray")                  # no record: nothing happens
    with tracing.span("stray"):
        pass
    with tracing.record("probe") as rec:
        tracing.count("hits")
        tracing.count("hits", 4)
        tracing.h2d("site_a", 100)
        tracing.h2d("site_b", 28)
        with tracing.record("probe") as inner:   # a nested record
            tracing.count("hits")
    assert rec.counters == {"hits": 5, "h2d.bytes": 128,
                            "h2d.bytes.site_a": 100, "h2d.bytes.site_b": 28}
    assert inner.counters == {"hits": 1}
    assert tracing.current() is None


def test_h2d_bytes_equal_one_upload_values():
    values = list(range(1, 38))
    FQ_DEV.upload_values([1], "cpu")     # its R^2 constant, uploaded once
    with tracing.record("probe") as rec:
        x = FQ_DEV.upload_values(values, "cpu", site="probe")
    assert rec.counters["h2d.bytes"] == len(values) * 16 * 4 == x.nbytes
    assert rec.counters["h2d.bytes.probe"] == x.nbytes


def test_launch_counts_into_launches_and_the_record():
    before = fk.LAUNCHES["fmul"]
    tracing.launch("fmul", 8, 1536, 8 * fk.MONT_MULADDS)   # no record
    with tracing.record("probe") as rec:
        tracing.launch("fmul", 8, 1536, 8 * fk.MONT_MULADDS)
        tracing.launch("fmul", 2, 384, 2 * fk.MONT_MULADDS)
    assert fk.LAUNCHES["fmul"] == before + 3
    assert rec.kernels == {"fmul": [2, 10, 1920, 10 * 224]}
    fk.LAUNCHES["fmul"] = before


@pytest.fixture
def fake_card(monkeypatch):
    """The point wrappers' CUDA branch on CPU tensors: a library whose
    kernels return 0 and do nothing."""
    lib = types.SimpleNamespace(h2t_padd_masked=lambda *a: 0)
    monkeypatch.setattr(pk, "_dispatch", lambda a: True)
    monkeypatch.setattr(cuda_build, "library", lambda name: lib)
    monkeypatch.setattr(cuda_build, "stream_ptr", lambda device: 0)
    before = dict(pk.LAUNCHES)
    yield
    pk.LAUNCHES.update(before)


@pytest.mark.parametrize("live", [None, 9])
@pytest.mark.parametrize("form,lane_bytes", [("lane", 580), ("roll", 580),
                                             ("index", 588)])
def test_b3_counts_its_bytes_and_products_a_lane(fake_card, form,
                                                 lane_bytes, live):
    """A live lane moves lane_bytes and takes 12 products; a lane whose
    mask is off reads its mask and a and writes out (388 bytes) and
    multiplies nothing. `live` says how many lanes are on (None: all)."""
    L = 26
    on = L if live is None else live
    a = torch.zeros((48, L), dtype=torch.int32)
    mask = (torch.arange(L) < on).to(torch.int32)
    kw = {"lane": {}, "roll": {"width": 13, "shift": 1},
          "index": {"idx": torch.arange(L) % 5,
                    "sign": torch.zeros(L, dtype=torch.int32)}}[form]
    b = a[:, :5].contiguous() if form == "index" else a
    with tracing.record("probe") as rec:
        pk.padd_masked_flat(FQ_DEV, a, b, mask, live=live, **kw)
    assert rec.kernels["padd_masked"] == [
        1, L, on * lane_bytes + (L - on) * 388, 12 * 224 * on]
    with pytest.raises(TypeError, match="live"):
        pk.padd_masked_flat(FQ_DEV, a, b, mask, live=L + 1, **kw)
    # PERF.md's bound of B3 at 26,624 lanes: bytes, 0.00461 ms
    ms, by = bound_ms(580 * 26624, 12 * 224 * 26624)
    assert by == "bytes" and round(ms, 5) == 0.00461


@pytest.mark.parametrize("path,branch", [
    ("bucket_runs", "_unslot"), ("projective", "_projective_rounds"),
    ("scan", "_segmented_scan")])
def test_msm_gives_b3_the_live_lanes_of_its_masks(monkeypatch, path,
                                                  branch):
    """Every B3 launch of the Pippenger MSM (its summation by parts, the
    top window's slices, the projective bucket rounds, the segmented
    scan) passes the number of set lanes of its mask, which it knows
    without reading the mask back. 128 points: c = 5 slices the top
    window; one all-equal column makes runs long enough for the scan."""
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import DeviceField, ints_to_digits
    from halo2_tpu_torch.ops import msm_pippenger as mp
    seen, real, taken = [], mp.padd_masked_flat, getattr(mp, branch)

    def checked(df, a, b, mask, *args, live=None, **kw):
        seen.append((live, int(mask.sum()), a.shape[1]))
        return real(df, a, b, mask, *args, live=live, **kw)

    def counted(*args):
        seen.append(branch)
        return taken(*args)

    monkeypatch.setattr(mp, "padd_masked_flat", checked)
    monkeypatch.setattr(mp, branch, counted)
    pts = native_srs_g(PALLAS, "tracing-msm", 128)
    df = DeviceField(PALLAS.base)
    proj = pk.points_to_proj(df, pts, "cpu")
    q = PALLAS.scalar.modulus
    rng = random.Random(5)
    col = ([q - 1] * 128 if path == "scan"
           else [rng.randrange(q) for _ in range(128)])
    digits = torch.from_numpy(ints_to_digits(col))[None]
    got = mp.msm_many(PALLAS, df, digits, proj,
                      c=8 if path == "scan" else 5,
                      affine=path != "projective")
    assert got == [PALLAS.msm(col, pts)]
    assert branch in seen
    seen.remove(branch)
    assert seen and all(live == on for live, on, _ in seen)
    assert any(on < lanes for _, on, lanes in seen)      # lanes masked off


def test_powers_hit_and_miss():
    x = random.Random(3).randrange(2, FQ_DEV.spec.modulus)
    with tracing.record("probe") as rec:
        first = poly_utils.powers(FQ_DEV, x, 8, "cpu")
        again = poly_utils.powers(FQ_DEV, x, 8, "cpu")
        poly_utils.powers(FQ_DEV, x + 1, 4, "cpu")
    assert again is first
    assert rec.counters["powers.hit"] == 1
    assert rec.counters["powers.miss"] == 2
    assert rec.counters["powers.rows"] == 12
    assert rec.counters["h2d.bytes.powers"] == 12 * 64
    assert [s.name for s in rec.spans] == ["powers.build"] * 2


def test_params_new_counts_the_srs_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(commitment, "_SRS_CACHE", str(tmp_path))
    Params.new(PALLAS, 3, device="cpu")
    miss = tracing.LAST_PARAMS
    Params.new(PALLAS, 3, device="cpu")
    hit = tracing.LAST_PARAMS
    assert miss.counters["srs_cache.miss"] == 1
    assert hit.counters["srs_cache.hit"] == 1
    assert "srs_cache.hit" not in miss.counters
    assert [s.name for s in hit.spans] == ["params.new"]


def test_keygen_record_holds_its_spans(keyed):
    keygen = keyed[3]
    assert tracing.LAST_KEYGEN is keygen        # keygen_pk continued it
    names = {s.name for s in keygen.spans}
    assert {"keygen.layout", "keygen.permutation", "keygen.fixed_upload",
            "keygen.commit", "keygen.extend", "keygen.indicators"} <= names
    assert keygen.seconds("keygen.layout") > 0
    assert keygen.counters["h2d.bytes.fixed"] > 0


# ---------------------------------------------------------------------------
# a proof
# ---------------------------------------------------------------------------

def test_last_phases_keeps_its_lap_names(proved):
    rec, laps = proved
    assert [name for name, _ in laps] == LAPS
    assert rec.laps == laps
    assert rec.kind == "proof" and rec.error is None


def test_ipa_spans_lie_inside_the_multiopen_lap(proved):
    rec, _ = proved
    (_, lap_start, lap_end), = [b for b in rec.lap_bounds
                                if b[0] == "multiopen+ipa"]
    for name in IPA_SPANS:
        spans = [s for s in rec.spans if s.name == name]
        assert spans, name
        for s in spans:
            assert lap_start <= s.start <= s.end <= lap_end, name
    # every span inside some lap, and the proof's counters
    assert all(any(a <= s.start <= s.end <= b for _, a, b in rec.lap_bounds)
               for s in rec.spans)
    assert rec.counters["h2d.bytes"] > 0
    assert rec.counters["powers.miss"] > 0


def test_every_lap_is_a_profiler_range_of_its_length(profiled):
    laps, events = profiled
    (mark_start, mark_end), = [(s, e) for n, s, e in events if n == MARK]
    ranges = {n[len("halo2."):]: (s, e) for n, s, e in events
              if n.startswith("halo2.") and n[len("halo2."):] in LAPS}
    assert sorted(ranges) == sorted(LAPS)
    for name, seconds in laps:
        start, end = ranges[name]
        assert mark_start <= start <= end <= mark_end, name
        assert abs((end - start) * 1e-9 - seconds) <= max(
            0.05 * seconds, 1e-3), name
    spans = {n for n, _, _ in events if n.startswith("halo2.ipa.")}
    assert {"halo2.ipa.native", "halo2.ipa.s_poly"} <= spans


def test_a_proof_that_raises_leaves_a_record(keyed, monkeypatch):
    params, circuit, pk_, _ = keyed

    def broken(*args, **kwargs):
        raise RuntimeError("broken")

    monkeypatch.setattr(prover, "batch_evaluate_assigned", broken)
    with pytest.raises(RuntimeError, match="broken"):
        prover.create_proof(params, pk_, [circuit], [[]],
                            random.Random(SEED), TranscriptWrite(PALLAS))
    rec = tracing.PROOFS[-1]
    assert rec.error == "RuntimeError"
    assert [n for n, _ in rec.laps] == LAPS[:2]
    assert rec._phase_rf is None and tracing.current() is None
    with pytest.raises(ValueError, match="mismatch"):
        prover.create_proof(params, pk_, [circuit], [],
                            random.Random(SEED), TranscriptWrite(PALLAS))
    assert tracing.PROOFS[-1].error == "ValueError"
    assert tracing.PROOFS[-1].id > rec.id


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name, os.path.join(METRICS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _record(spans=(), counters=None, kernels=None):
    rec = tracing.Record("proof")
    t = 0
    for name, seconds in spans:
        rec.spans.append(tracing.Span(name, None, t))
        t += int(seconds * 1e9)
        rec.spans[-1].end = t
    rec.counters.update(counters or {})
    rec.kernels.update(kernels or {})
    return rec


def _ring(monkeypatch, records, keygen=None):
    monkeypatch.setattr(tracing, "PROOFS", collections.deque(
        records, maxlen=tracing.RING))
    monkeypatch.setattr(tracing, "LAST_KEYGEN", keygen)


def _run(untraced, traced=3, device_seconds=None):
    return {"keygen_s": 1.0, "laps": [[("evals", 1.0)]] * untraced,
            "trace": {"proofs": traced,
                      "device_seconds": device_seconds or {}}}


SPAN_METRICS = [("ipa_native_s", "ipa.native"),
                ("ipa_s_poly_s", "ipa.s_poly"),
                ("multiopen_kate_s", "multiopen.kate"),
                ("powers_s", "powers.build")]


@pytest.mark.parametrize("metric,span", SPAN_METRICS)
def test_span_readers_average_the_untraced_proofs(monkeypatch, metric,
                                                  span):
    traced = [_record([(span, 9.0)]) for _ in range(3)]
    untraced = [_record([(span, 1.0), (span, 0.5)]),
                _record([(span, 2.0), ("other", 7.0)])]
    _ring(monkeypatch, [_record([(span, 5.0)])] + traced + untraced)
    assert _reader(metric)(_run(2)) == pytest.approx(1.75)
    _ring(monkeypatch, untraced[1:])                 # too few records
    assert _reader(metric)(_run(2)) is None
    _ring(monkeypatch, [_record([("other", 1.0)])] * 2)
    assert _reader(metric)(_run(2)) is None          # no such span


@pytest.mark.parametrize("metric,counter,scale", [
    ("powers_misses", "powers.miss", 1),
    ("h2d_mib", "h2d.bytes", 2 ** 20)])
def test_counter_readers_average_the_untraced_proofs(monkeypatch, metric,
                                                     counter, scale):
    records = [_record(counters={counter: 99 * scale})] * 4 + [
        _record(counters={counter: 8 * scale}),
        _record(counters={counter: 6 * scale})]
    _ring(monkeypatch, records)
    assert _reader(metric)(_run(2)) == pytest.approx(7.0)
    _ring(monkeypatch, records[-1:])
    assert _reader(metric)(_run(2)) is None


def test_padd_masked_roofline_reads_the_traced_proofs(monkeypatch):
    work = [2, 2 * 26624, 2 * 580 * 26624, 2 * 12 * 224 * 26624]
    traced = [_record(kernels={"padd_masked": list(work)})
              for _ in range(3)]
    untraced = [_record(kernels={"padd_masked": [1, 1, 10 ** 12, 0]})] * 2
    _ring(monkeypatch, [_record()] + traced + untraced)
    device = {"void padd_masked_kernel<4>(int*)": 0.003,
              "void padd_kernel(int*)": 5.0}
    got = _reader("padd_masked_roofline")(_run(2, 3, device))
    want = 100 * 6 * 580 * 26624 / 3.35e12 / 0.003
    assert got == pytest.approx(want)
    assert 0 < got <= 100
    assert _reader("padd_masked_roofline")(
        _run(2, 3, {"void padd_kernel(int*)": 1.0})) is None
    _ring(monkeypatch, untraced)
    assert _reader("padd_masked_roofline")(_run(2, 3, device)) is None


def test_keygen_layout_reads_the_last_keygen(monkeypatch):
    keygen = _record([("keygen.layout", 2.0), ("keygen.commit", 5.0),
                      ("keygen.layout", 0.25)])
    _ring(monkeypatch, [], keygen)
    assert _reader("keygen_layout_s")(_run(0)) == pytest.approx(2.25)
    _ring(monkeypatch, [], None)
    assert _reader("keygen_layout_s")(_run(0)) is None


def test_readers_give_none_without_the_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "tracing", lambda: None)
    run = _run(2, 3, {"void padd_masked_kernel(int*)": 1.0})
    for name in ("ipa_native_s", "ipa_s_poly_s", "multiopen_kate_s",
                 "powers_s", "powers_misses", "h2d_mib",
                 "padd_masked_roofline", "keygen_layout_s"):
        assert _reader(name)(run) is None, name
