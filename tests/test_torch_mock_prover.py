"""The port's dev tools (halo2_tpu_torch/dev) against the JAX reference,
on the CPU: the MockProver's failures from the host checker and from the
vectorized gate check, the cost model, the layout renderers and the
synthesis tracing. Failures of the two packages are different classes,
so they are compared by class name and dataclasses.astuple, field by
field (cell values included)."""
import dataclasses
import random

import pytest
import torch

from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.dev import (MockProver as RMockProver,
                           CircuitCost as RCircuitCost,
                           CircuitGates as RCircuitGates)
from halo2_tpu.dev.circuits import MulChainCircuit as RMulChainCircuit
from halo2_tpu.dev.graph import (CircuitLayout as RCircuitLayout,
                                 circuit_dot_graph as r_circuit_dot_graph)
from halo2_tpu.dev.tfp import attach_tracing as r_attach_tracing
from halo2_tpu.poly.polynomial import Rotation as RRotation

from halo2_tpu_torch.bench_circuit import (bench_circuit_class,
                                           dev_lookup_circuit_class,
                                           plonk_api_circuit_class,
                                           plonk_api_inputs,
                                           expected_output, regions_for_k)
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.dev import MockProver, CircuitCost, CircuitGates
from halo2_tpu_torch.dev.circuits import MulChainCircuit
from halo2_tpu_torch.dev.graph import CircuitLayout, circuit_dot_graph
from halo2_tpu_torch.dev.tfp import (attach_tracing, detach_tracing,
                                     RegionSpan)
from halo2_tpu_torch.ops import field_kernels as fk
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite

FS = PALLAS.scalar
REF_API = (RCircuit, RValue, RRotation, R_PALLAS.scalar)
PORT_API = (Circuit, Value, Rotation, FS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mul_circuit_class(circuit_base, value_cls, rotation_cls, fs,
                      floor_planner="simple"):
    """tests/test_mock_prover.py's MulCircuit against either circuit API;
    `tamper` breaks the gate, `skip_b` leaves a queried cell unassigned."""
    class MulCircuit(circuit_base):
        def __init__(self, a=None, b=None, tamper=False, skip_b=False):
            self.a, self.b = a, b
            self.tamper, self.skip_b = tamper, skip_b

        def without_witnesses(self):
            return MulCircuit(tamper=self.tamper, skip_b=self.skip_b)

        @classmethod
        def configure(cls, meta):
            col_a = meta.advice_column()
            col_b = meta.advice_column()
            instance = meta.instance_column()
            s_mul = meta.selector()
            meta.enable_equality(col_a)
            meta.enable_equality(instance)

            def gate(cells):
                a = cells.query_advice(col_a, rotation_cls(0))
                b = cells.query_advice(col_b, rotation_cls(0))
                out = cells.query_advice(col_a, rotation_cls(1))
                s = cells.query_selector(s_mul)
                return [("mul", s * (a * b - out))]

            meta.create_gate("mul", gate)
            return {"a": col_a, "b": col_b, "instance": instance,
                    "s": s_mul}

        def synthesize(self, config, layouter):
            known = self.a is not None
            out_val = fs.mul(self.a, self.b) if known else None
            if known and self.tamper:
                out_val = (out_val + 1) % fs.modulus

            def val(v):
                return (lambda: value_cls.known(v)) if known else (
                    lambda: value_cls.unknown())

            def region_fn(region):
                region.enable_selector("s", config["s"], 0)
                region.assign_advice("a", config["a"], 0, val(self.a))
                if not self.skip_b:
                    region.assign_advice("b", config["b"], 0, val(self.b))
                return region.assign_advice("out", config["a"], 1,
                                            val(out_val))

            out = layouter.assign_region("mul", region_fn)
            layouter.constrain_instance(out.cell, config["instance"], 0)

    MulCircuit.floor_planner = floor_planner
    return MulCircuit


def range_check_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    """tests/test_mock_prover.py's RangeCheckCircuit: value < 8 by a
    lookup."""
    class RangeCheckCircuit(circuit_base):
        def __init__(self, value=None):
            self.value = value

        def without_witnesses(self):
            return RangeCheckCircuit()

        @classmethod
        def configure(cls, meta):
            advice = meta.advice_column()
            table = meta.lookup_table_column()
            q = meta.complex_selector()

            def lookup_fn(cells):
                v = cells.query_advice(advice, rotation_cls(0))
                s = cells.query_selector(q)
                return [(s * v, table)]

            meta.lookup("range", lookup_fn)
            return {"advice": advice, "table": table, "q": q}

        def synthesize(self, config, layouter):
            def table_fn(table):
                for i in range(8):
                    table.assign_cell(f"t{i}", config["table"], i,
                                      lambda i=i: value_cls.known(i))
            layouter.assign_table("table", table_fn)

            def region_fn(region):
                region.enable_selector("q", config["q"], 0)
                region.assign_advice("v", config["advice"], 0,
                                     lambda: value_cls.known(self.value))
            layouter.assign_region("value", region_fn)

    return RangeCheckCircuit


def _bench(api):
    regions = regions_for_k(5)
    return (bench_circuit_class(*api)(5, regions),
            [[expected_output(FS, 5, regions)]])


def _mul(**kw):
    instance = kw.pop("instance", FS.mul(3, 5))
    planner = kw.pop("planner", "simple")
    return lambda api: (mul_circuit_class(*api, planner)(3, 5, **kw),
                        [[instance]])


# name -> (k, api -> (circuit, instance), advice cell to corrupt after run)
CASES = {
    "mul-satisfied": (4, _mul(), None),
    "mul-bad-gate": (4, _mul(tamper=True,
                             instance=(FS.mul(3, 5) + 1) % FS.modulus), None),
    "mul-bad-instance": (4, _mul(instance=99), None),
    "mul-unassigned-cell": (4, _mul(skip_b=True), None),
    "mul-v1-bad-instance": (4, _mul(instance=99, planner="v1"), None),
    "range-ok": (4, lambda api: (range_check_circuit_class(*api)(5), []),
                 None),
    "range-bad": (4, lambda api: (range_check_circuit_class(*api)(300), []),
                  None),
    "dev-lookup": (5, lambda api: (dev_lookup_circuit_class(*api)(3, 16),
                                   []), None),
    "dev-lookup-bad-cell": (5, lambda api: (
        dev_lookup_circuit_class(*api)(3, 16), []), (0, 4, 100)),
    "bench": (5, _bench, None),
    "bench-bad-cell": (5, _bench, (0, 7, 1)),
    "bench-bad-last-row": (5, _bench, (0, 25, 2)),
    "mul-chain": (6, lambda api: (
        (MulChainCircuit if api is PORT_API else RMulChainCircuit)(2, 24),
        [[MulChainCircuit(2, 24).expected_out()]]), None),
}


def _run(name, port: bool):
    k, make, corrupt = CASES[name]
    circuit, instance = make(PORT_API if port else REF_API)
    prover = (MockProver if port else RMockProver).run(k, circuit, instance)
    if corrupt is not None:
        column, row, delta = corrupt
        cells = prover.advice[column]
        cells[row] = (cells[row] + delta) % FS.modulus
    return prover


def _norm(errors):
    return [(type(e).__name__, dataclasses.astuple(e)) for e in errors]


@pytest.mark.parametrize("name", list(CASES))
def test_verify_matches_reference(name):
    port, ref = _run(name, True), _run(name, False)
    assert ([(r.index, r.name, r.rows) for r in port.regions]
            == [(r.index, r.name, r.rows) for r in ref.regions])
    errors = port.verify()
    assert _norm(errors) == _norm(ref.verify())
    assert (errors == []) == name.endswith(("satisfied", "ok", "lookup",
                                            "bench", "chain"))


@pytest.mark.parametrize("name", list(CASES))
def test_verify_vectorized_matches_reference(name):
    """The gate check on the CPU (the plain versions of B1 and the
    add/subtract) equals the reference's, and equals the host checker's
    gate stream."""
    port, ref = _run(name, True), _run(name, False)
    before = dict(fk.LAUNCHES)
    errors = port.verify_vectorized(device="cpu")
    assert fk.LAUNCHES == before  # the CPU runs no kernel
    assert _norm(errors) == _norm(ref.verify_vectorized())
    assert _norm(errors) == _norm(port.verify(streams=("gates",)))


def test_instance_failure_kinds_match_reference():
    port = _run("mul-bad-instance", True).verify()
    ref = _run("mul-bad-instance", False).verify()
    kinds = [type(e).__name__ for e in port]
    assert kinds == [type(e).__name__ for e in ref]
    assert "PermutationFailure" in kinds


@pytest.mark.parametrize("name", ["mul", "range", "bench", "dev-lookup",
                                  "plonk-api", "mul-v1"])
def test_cost_and_gates_match_reference(name):
    def make(api):
        if name == "mul":
            return mul_circuit_class(*api)(3, 5), 4
        if name == "mul-v1":
            return mul_circuit_class(*api, "v1")(3, 5), 4
        if name == "range":
            return range_check_circuit_class(*api)(5), 4
        if name == "bench":
            return bench_circuit_class(*api)(5, regions_for_k(5)), 5
        if name == "dev-lookup":
            return dev_lookup_circuit_class(*api)(3, 16), 5
        a, _, table = plonk_api_inputs(api[3])
        return plonk_api_circuit_class(*api)(a, table), 5

    (circuit, k), (rcircuit, _) = make(PORT_API), make(REF_API)
    cost, rcost = CircuitCost.measure(k, circuit), RCircuitCost.measure(
        k, rcircuit)
    for count in (1, 2):
        assert (dataclasses.astuple(cost.proof_size(count))
                == dataclasses.astuple(rcost.proof_size(count)))
        assert (dataclasses.astuple(cost._proof_size_heuristic(count))
                == dataclasses.astuple(rcost._proof_size_heuristic(count)))
    gates = CircuitGates.collect(type(circuit))
    rgates = RCircuitGates.collect(type(rcircuit))
    assert str(gates) == str(rgates)
    assert gates.queries_to_csv() == rgates.queries_to_csv()


def test_cost_proof_size_equals_a_real_proof():
    """proof_size() of MulCircuit at K = 4 is the length of the port's
    proof."""
    circuit = mul_circuit_class(*PORT_API)(3, 5)
    params = Params.new(PALLAS, 4, device="cpu")
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [circuit], [[[FS.mul(3, 5)]]],
                 random.Random(3), tw)
    assert CircuitCost.measure(4, circuit).proof_size().total == len(
        tw.finalize())


@pytest.mark.parametrize("name", ["mul-satisfied", "dev-lookup", "bench"])
def test_layout_renderers_match_reference(name):
    k, make, _ = CASES[name]
    circuit, instance = make(PORT_API)
    rcircuit, _ = make(REF_API)
    layout = CircuitLayout(k, circuit, instance)
    rlayout = RCircuitLayout(k, rcircuit, instance)
    assert layout.render_text() == rlayout.render_text()
    assert layout.render_svg() == rlayout.render_svg()
    assert (circuit_dot_graph(k, circuit, instance)
            == r_circuit_dot_graph(k, rcircuit, instance))


def two_region_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    """tests/test_tfp.py's TwoRegionCircuit: two named regions with a
    known mix of assignments, a namespace and one copy."""
    class TwoRegionCircuit(circuit_base):
        def __init__(self, a=None):
            self.a = a

        def without_witnesses(self):
            return TwoRegionCircuit()

        @classmethod
        def configure(cls, meta):
            col_a = meta.advice_column()
            col_f = meta.fixed_column()
            s = meta.selector()
            meta.enable_equality(col_a)

            def gate(cells):
                a = cells.query_advice(col_a, rotation_cls(0))
                f = cells.query_fixed(col_f)
                sel = cells.query_selector(s)
                return [("g", sel * (a - f))]

            meta.create_gate("g", gate)
            return {"a": col_a, "f": col_f, "s": s}

        def synthesize(self, config, layouter):
            def first(region):
                region.enable_selector("s", config["s"], 0)
                region.assign_fixed("f", config["f"], 0,
                                    lambda: value_cls.known(7))
                return region.assign_advice("a", config["a"], 0,
                                            lambda: value_cls.known(self.a))

            c1 = layouter.namespace("ns1").assign_region("first", first)

            def second(region):
                cell = region.assign_advice("a2", config["a"], 0,
                                            lambda: value_cls.known(self.a))
                region.constrain_equal(cell.cell, c1.cell)
                return cell

            layouter.assign_region("second", second)

    return TwoRegionCircuit


@pytest.mark.parametrize("name", ["two-region", "dev-lookup", "mul-v1"])
def test_tfp_spans_match_reference(name):
    """The RegionSpans of a traced MockProver run equal the reference's."""
    def make(api):
        if name == "two-region":
            return two_region_circuit_class(*api)(7), 4, []
        if name == "mul-v1":
            return mul_circuit_class(*api, "v1")(3, 5), 4, [[15]]
        return dev_lookup_circuit_class(*api)(3, 16), 5, []

    (circuit, k, instance), (rcircuit, _, _) = make(PORT_API), make(REF_API)
    events = attach_tracing(circuit)
    revents = r_attach_tracing(rcircuit)
    MockProver.run(k, circuit, instance).assert_satisfied()
    RMockProver.run(k, rcircuit, instance).assert_satisfied()
    assert events and all(isinstance(e, RegionSpan) for e in events)
    assert ([dataclasses.astuple(e) for e in events]
            == [dataclasses.astuple(e) for e in revents])


def test_traced_proof_equals_untraced():
    """Tracing covers keygen and witness synthesis and only observes:
    the vk and the proof bytes are those of the untraced circuit."""
    cls = two_region_circuit_class(*PORT_API)
    params = Params.new(PALLAS, 4, device="cpu")

    def prove(circuit):
        vk = keygen_vk(params, circuit)
        n_keygen = len(getattr(circuit, "_tfp_events", []))
        pk = keygen_pk(params, vk, circuit)
        tw = TranscriptWrite(PALLAS)
        create_proof(params, pk, [circuit], [[]], random.Random(5), tw)
        return vk.transcript_repr(), tw.finalize(), n_keygen

    vk_plain, proof_plain, _ = prove(cls(7))
    traced = cls(7)
    events = attach_tracing(traced)
    vk_t, proof_t, n_keygen = prove(traced)
    assert n_keygen == 2, "keygen synthesis must be traced"
    assert len(events) > n_keygen, "witness synthesis must be traced"
    assert (vk_t, proof_t) == (vk_plain, proof_plain)

    detach_tracing(traced)
    count = len(events)
    MockProver.run(4, traced, [])
    assert len(events) == count, "detach must stop tracing"
