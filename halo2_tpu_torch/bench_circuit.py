"""BenchCircuit: the standard-PLONK shape of the reference's prove bench
(bench.py:238-289; benches/plonk.rs:21-270 at minimal column count): the
gate s*(a*b - o), a copy chain through column a, and one public input.
Each region takes two rows, so `regions_for_k(k)` fills the usable rows
of a 2^k domain.

`bench_circuit_class` builds the class against a circuit API (the port's
by default), so the same circuit can be handed to the reference prover.
"""
from __future__ import annotations

from .circuit import Circuit, Value
from .curves.host import PALLAS
from .poly.polynomial import Rotation

# blinding_factors() + 1 for this circuit: max(3, 2 queries of column a) + 2
UNUSABLE_ROWS = 6
SEED_A = 5        # the witness: a = 5, out = 5 * 3^regions
PROOF_SEED = 2    # random.Random seed of the recorded proofs


def regions_for_k(k: int) -> int:
    return ((1 << k) - UNUSABLE_ROWS) // 2


def expected_output(fs, a: int, regions: int) -> int:
    return a * pow(3, regions, fs.modulus) % fs.modulus


def bench_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    class BenchCircuit(circuit_base):
        def __init__(self, a=None, regions: int = 16):
            self.a = a
            self.regions = regions

        def without_witnesses(self):
            return BenchCircuit(regions=self.regions)

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
                o = cells.query_advice(col_a, rotation_cls(1))
                s = cells.query_selector(s_mul)
                return [("m", s * (a * b - o))]

            meta.create_gate("m", gate)
            return {"a": col_a, "b": col_b, "i": instance, "s": s_mul}

        def synthesize(self, config, layouter):
            out = None
            cur = self.a
            for _ in range(self.regions):
                def rf(region, cur=cur, prev=out):
                    region.enable_selector("s", config["s"], 0)
                    c = region.assign_advice(
                        "a", config["a"], 0,
                        lambda: value_cls.known(cur) if cur is not None
                        else value_cls.unknown())
                    if prev is not None:
                        region.constrain_equal(c.cell, prev.cell)
                    region.assign_advice("b", config["b"], 0,
                                         lambda: value_cls.known(3))
                    nx = fs.mul(cur, 3) if cur is not None else None
                    return region.assign_advice(
                        "o", config["a"], 1,
                        lambda v=nx: value_cls.known(v) if v is not None
                        else value_cls.unknown())
                out = layouter.assign_region("m", rf)
                if cur is not None:
                    cur = fs.mul(cur, 3)
            layouter.constrain_instance(out.cell, config["i"], 0)

    return BenchCircuit


BenchCircuit = bench_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)
