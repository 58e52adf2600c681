"""The port's V1 floor planner (circuit/floor_planner_v1.py) and the
legacy pdqsort (circuit/legacy_pdqsort.py) against the JAX reference, on
the CPU. Everything is compared for equality: free intervals, region
starts, constant positions, the laid-out cells and proof bytes."""
import random

import pytest
import torch

from halo2_tpu.circuit import (Circuit as RCircuit, Value as RValue,
                               synthesize_circuit as r_synthesize_circuit)
from halo2_tpu.circuit import floor_planner_v1 as rv1
from halo2_tpu.circuit.layouter import RegionShape as RRegionShape
from halo2_tpu.circuit.legacy_pdqsort import quicksort as r_quicksort
from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.dev.mock_prover import (MockProver as RMockProver,
                                       POISON as R_POISON)
from halo2_tpu.plonk.circuit import ConstraintSystem as RConstraintSystem
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.transcript import (TranscriptWrite as RTranscriptWrite,
                                  TranscriptRead as RTranscriptRead)
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.bench_circuit import (bench_circuit_class,
                                           expected_output, regions_for_k)
from halo2_tpu_torch.circuit import Circuit, Value, synthesize_circuit
from halo2_tpu_torch.circuit import floor_planner_v1 as v1
from halo2_tpu_torch.circuit.layouter import RegionShape
from halo2_tpu_torch.circuit.legacy_pdqsort import quicksort
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.dev.mock_prover import MockProver, POISON
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof, SingleVerifier
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

SEED = 2024
CONSTANT = 4  # the in-circuit constant of V1Mul


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def v1_mul_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    """tests/test_batch_synthesis.py's V1Mul against either circuit API:
    out = 4 * b under floor_planner 'v1', with `a` pinned to the constant
    4 (the V1 constants pass) and `out` copied to the instance column."""
    class V1Mul(circuit_base):
        floor_planner = "v1"

        def __init__(self, b=None):
            self.b = b

        def without_witnesses(self):
            return V1Mul()

        @classmethod
        def configure(cls, meta):
            col_a = meta.advice_column()
            col_b = meta.advice_column()
            instance = meta.instance_column()
            s_mul = meta.selector()
            meta.enable_equality(col_a)
            meta.enable_equality(instance)
            meta.enable_constant(meta.fixed_column())

            def gate(cells):
                a = cells.query_advice(col_a, rotation_cls(0))
                b = cells.query_advice(col_b, rotation_cls(0))
                out = cells.query_advice(col_a, rotation_cls(1))
                s = cells.query_selector(s_mul)
                return [("mul", s * (a * b - out))]

            meta.create_gate("mul", gate)
            return {"a": col_a, "b": col_b, "instance": instance,
                    "s_mul": s_mul}

        def synthesize(self, config, layouter):
            b = self.b

            def region_fn(region):
                region.enable_selector("s", config["s_mul"], 0)
                region.assign_advice_from_constant("a", config["a"], 0,
                                                   CONSTANT)
                region.assign_advice(
                    "b", config["b"], 0,
                    lambda: value_cls.known(b) if b is not None
                    else value_cls.unknown())
                return region.assign_advice(
                    "out", config["a"], 1,
                    lambda: value_cls.known(fs.mul(CONSTANT, b))
                    if b is not None else value_cls.unknown())

            out = layouter.assign_region("mul", region_fn)
            layouter.constrain_instance(out.cell, config["instance"], 0)

    return V1Mul


def _circuits(name, k):
    """(reference circuit, port circuit, instance) of a named V1 circuit."""
    if name == "v1mul":
        rcls = v1_mul_circuit_class(RCircuit, RValue, RRotation,
                                    R_PALLAS.scalar)
        cls = v1_mul_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)
        return rcls(9), cls(9), [[PALLAS.scalar.mul(CONSTANT, 9)]]
    regions = regions_for_k(k)
    rcls = bench_circuit_class(RCircuit, RValue, RRotation, R_PALLAS.scalar,
                               "v1")
    cls = bench_circuit_class(Circuit, Value, Rotation, PALLAS.scalar, "v1")
    out = expected_output(PALLAS.scalar, 5, regions)
    return rcls(5, regions), cls(5, regions), [[out]]


def _lay_out(mock_cls, cs_cls, synth, circuit, k, instance):
    """Synthesize `circuit` into a MockProver sink with a plan cache;
    returns (the sink, the recorded V1Plan)."""
    cs = cs_cls()
    config = type(circuit).configure(cs)
    sink = mock_cls(PALLAS.scalar if mock_cls is MockProver
                    else R_PALLAS.scalar, k, cs, instance)
    cache = {}
    synth(sink, circuit, config, cs.constants, plan_cache=cache)
    return sink, cache["v1"]


def _cells(columns, poison):
    """Column values with each package's POISON marker as one name."""
    return [["poison" if v is poison else v for v in col]
            for col in columns]


def _positions(plan):
    return [(c.column_type, c.index, row) for c, row in plan.positions]


def _random_shapes(rng, shape_cls, cs, count):
    """Region shapes over a few advice/fixed columns and selectors, with
    areas that often tie (the sort's stable order matters)."""
    advice = [cs.advice_column() for _ in range(3)]
    fixed = [cs.fixed_column() for _ in range(2)]
    selectors = [cs.selector() for _ in range(2)]
    pool = advice + fixed + selectors
    shapes = []
    for i in range(count):
        s = shape_cls(i)
        s.columns = set(rng.sample(pool, rng.randrange(1, 4)))
        s.row_count = rng.randrange(1, 5)
        shapes.append(s)
    return shapes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocations_match_reference(seed):
    rng = random.Random(seed)
    ours, ref = v1.Allocations(), rv1.Allocations()
    for _ in range(40):
        start, length = rng.randrange(200), rng.randrange(1, 12)
        ours.insert(start, length)
        ref.insert(start, length)
        lo = rng.randrange(150)
        hi = None if rng.random() < 0.3 else lo + rng.randrange(1, 80)
        assert (list(ours.free_intervals(lo, hi))
                == list(ref.free_intervals(lo, hi)))
        assert (ours.unbounded_interval_start()
                == ref.unbounded_interval_start())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slot_in_matches_reference(seed):
    shapes = _random_shapes(random.Random(seed), RegionShape,
                            ConstraintSystem(), 60)
    rshapes = _random_shapes(random.Random(seed), RRegionShape,
                             RConstraintSystem(), 60)
    starts, allocs = v1.slot_in_biggest_advice_first(shapes)
    rstarts, rallocs = rv1.slot_in_biggest_advice_first(rshapes)
    assert starts == rstarts
    key = lambda c: repr(c)  # noqa: E731 (same dataclass reprs in both)
    assert ({key(c): sorted(a.allocated) for c, a in allocs.items()}
            == {key(c): sorted(a.allocated) for c, a in rallocs.items()})


@pytest.mark.parametrize("n", [0, 1, 19, 21, 50, 51, 129, 256, 1000, 4096])
def test_legacy_quicksort_matches_reference(n):
    """Equal keys keep their index, so the unstable order itself is
    compared, across the insertion, partition and pattern-breaking
    regimes."""
    rng = random.Random(n)
    inputs = [
        [(rng.randrange(1 << 30), i) for i in range(n)],
        [(rng.randrange(4), i) for i in range(n)],
        [(7, i) for i in range(n)],
        [(v, i) for i, v in enumerate(list(range(n // 2))
                                      + list(range(n // 2))[::-1])],
        [(i % 10, i) for i in range(n)],
        [(n - i, i) for i in range(n)],
    ]
    for vals in inputs:
        ours, ref = list(vals), list(vals)
        quicksort(ours, lambda a, b: a[0] < b[0])
        r_quicksort(ref, lambda a, b: a[0] < b[0])
        assert ours == ref


@pytest.mark.parametrize("name,k", [("v1mul", 5), ("bench", 5)])
def test_v1_layout_matches_reference(name, k):
    """Region starts, constant positions and every laid-out cell, copy
    and selector equal the reference's."""
    rcircuit, circuit, instance = _circuits(name, k)
    sink, plan = _lay_out(MockProver, ConstraintSystem, synthesize_circuit,
                          circuit, k, instance)
    rsink, rplan = _lay_out(RMockProver, RConstraintSystem,
                            r_synthesize_circuit, rcircuit, k, instance)
    assert plan.regions == rplan.regions
    assert _positions(plan) == _positions(rplan)
    assert _cells(sink.advice, POISON) == _cells(rsink.advice, R_POISON)
    assert sink.fixed == rsink.fixed
    assert sink.selectors == rsink.selectors
    assert (sink.permutation.map_col == rsink.permutation.map_col).all()
    assert (sink.permutation.map_row == rsink.permutation.map_row).all()


def test_v1_proof_matches_reference():
    """V1Mul at K = 4: keygen -> create_proof in both packages give the
    same vk and proof bytes; each verifier accepts the other's proof; the
    second proof replays pk._synth_plan['v1'] and is byte-equal."""
    k = 4
    rcircuit, circuit, instance = _circuits("v1mul", k)
    out = instance[0][0]
    rparams = RParams.new(R_PALLAS, k, use_cache=False)
    params = params_from_reference("pallas", k, rparams.g,
                                   rparams.g_lagrange, rparams.w,
                                   rparams.u, "cpu")
    rvk = rplonk.keygen_vk(rparams, rcircuit)
    rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    assert vk.transcript_repr() == rvk.transcript_repr()

    tw = RTranscriptWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                        random.Random(SEED), tw)
    rproof = tw.finalize()

    def prove():
        tw = TranscriptWrite(PALLAS)
        create_proof(params, pk, [circuit], [[[out]]], random.Random(SEED),
                     tw)
        return tw.finalize()

    proof = prove()
    assert "v1" in pk._synth_plan
    assert prove() == proof  # replays the recorded plan
    assert proof == rproof
    verify_proof(params, vk, SingleVerifier(params), [[[out]]],
                 TranscriptRead(PALLAS, rproof))
    rplonk.verify_proof(rparams, rvk, rplonk.SingleVerifier(rparams),
                        [[[out]]], RTranscriptRead(R_PALLAS, proof))


def mixed_regions_circuit_class(circuit_base, value_cls):
    """Regions of one to three rows on one of four advice columns, in a
    seeded order: equal advice areas tie often, so the legacy unstable
    order lays them out differently from the stable one."""
    class MixedRegions(circuit_base):
        floor_planner = "v1"

        def without_witnesses(self):
            return MixedRegions()

        @classmethod
        def configure(cls, meta):
            return [meta.advice_column() for _ in range(4)]

        def synthesize(self, config, layouter):
            rng = random.Random(5)
            for i in range(120):
                column, rows = config[rng.randrange(4)], rng.randrange(1, 4)

                def region_fn(region, column=column, rows=rows, i=i):
                    for offset in range(rows):
                        region.assign_advice("v", column, offset,
                                             lambda: value_cls.known(i))
                layouter.assign_region("r", region_fn)

    return MixedRegions


def test_legacy_keyword_matches_reference_env(monkeypatch):
    """The keyword legacy_pdqsort=True, and a circuit class's
    `legacy_pdqsort` attribute through synthesize_circuit, give the
    layout that the reference gives under HALO2_TPU_LEGACY_PDQSORT=1,
    and it differs from the stable order."""
    shapes = _random_shapes(random.Random(5), RegionShape,
                            ConstraintSystem(), 200)
    rshapes = _random_shapes(random.Random(5), RRegionShape,
                             RConstraintSystem(), 200)
    stable, _ = v1.slot_in_biggest_advice_first(shapes)
    legacy, _ = v1.slot_in_biggest_advice_first(shapes, legacy_pdqsort=True)

    k = 8
    cls = mixed_regions_circuit_class(Circuit, Value)
    _, plan_stable = _lay_out(MockProver, ConstraintSystem,
                              synthesize_circuit, cls(), k, [])
    cls.legacy_pdqsort = True
    _, plan_legacy = _lay_out(MockProver, ConstraintSystem,
                              synthesize_circuit, cls(), k, [])

    monkeypatch.setenv("HALO2_TPU_LEGACY_PDQSORT", "1")
    rlegacy, _ = rv1.slot_in_biggest_advice_first(rshapes)
    rcls = mixed_regions_circuit_class(RCircuit, RValue)
    _, rplan_legacy = _lay_out(RMockProver, RConstraintSystem,
                               r_synthesize_circuit, rcls(), k, [])
    assert legacy == rlegacy and legacy != stable
    assert plan_legacy.regions == rplan_legacy.regions
    assert plan_legacy.regions != plan_stable.regions
