"""halo2's benches/plonk.rs circuit for the program: StandardPlonk built
with halo2_tpu_torch's circuit API (three advice columns with equality,
four fixed columns, the combined add-mult gate, set_minimum_degree(5)),
synthesizing 2^(k-1) - 3 times {raw_multiply, raw_add, copy, copy} with
the witness a that benchmark/reference/plonk_bench.py draws from the seed.

The control keys and proves a circuit whose raw_multiply rows hold
sm = 2 instead of 1, the witness moved with it (c = 2 a^2): a sound proof
of another relation than the configuration's, which its verifier must
reject."""
from __future__ import annotations

import functools

from benchmark.reference import plonk_bench as plain


@functools.cache
def _circuit_class():
    from halo2_tpu_torch.circuit import Circuit, Value
    from halo2_tpu_torch.poly.polynomial import Rotation

    class StandardPlonk(Circuit):
        def __init__(self, k: int, a=None, control: bool = False):
            self.k, self.a, self.control = k, a, control

        def without_witnesses(self):
            return StandardPlonk(self.k, None, self.control)

        @classmethod
        def configure(cls, meta):
            meta.set_minimum_degree(plain.MINIMUM_DEGREE)
            a, b, c = (meta.advice_column() for _ in range(3))
            for column in (a, b, c):
                meta.enable_equality(column)
            sm, sa, sb, sc = (meta.fixed_column() for _ in range(4))

            def gate(cells):
                qa = cells.query_advice(a, Rotation(0))
                qb = cells.query_advice(b, Rotation(0))
                qc = cells.query_advice(c, Rotation(0))
                qsa = cells.query_fixed(sa)
                qsb = cells.query_fixed(sb)
                qsc = cells.query_fixed(sc)
                qsm = cells.query_fixed(sm)
                return [("", qa * qsa + qb * qsb + qa * qb * qsm - qc * qsc)]

            meta.create_gate("Combined add-mult", gate)
            return {"a": a, "b": b, "c": c, "sa": sa, "sb": sb, "sc": sc,
                    "sm": sm}

        def synthesize(self, config, layouter):
            q = plain.Q
            m = 2 if self.control else 1
            if self.a is None:
                mul_v = add_v = (Value.unknown(),) * 3
            else:
                a2 = m * self.a * self.a % q
                mul_v = tuple(map(Value.known, (self.a, self.a, a2)))
                add_v = tuple(map(Value.known,
                                  (self.a, a2, (self.a + a2) % q)))
            mul_f = plain.MULTIPLY[:3] + (m,)

            def row(values, fixed):
                def assign(region):
                    cells = [region.assign_advice(
                        name, config[name], 0, lambda v=v: v).cell
                        for name, v in zip("abc", values)]
                    for name, f in zip(("sa", "sb", "sc", "sm"), fixed):
                        region.assign_fixed(name, config[name], 0,
                                            lambda f=f: Value.known(f))
                    return cells
                return assign

            def copy(left, right):
                def assign(region):
                    region.constrain_equal(left, right)
                return assign

            raw_multiply, raw_add = row(mul_v, mul_f), row(add_v, plain.ADD)
            for _ in range(plain.iterations({"k": self.k})):
                a0, _, c0 = layouter.assign_region("raw_multiply",
                                                   raw_multiply)
                a1, b1, _ = layouter.assign_region("raw_add", raw_add)
                layouter.assign_region("copy", copy(a0, a1))
                layouter.assign_region("copy", copy(b1, c0))

    return StandardPlonk


def keygen_circuit(cfg, control: bool = False):
    return _circuit_class()(cfg["k"], None, control)


def circuit(cfg, a: int, control: bool = False):
    return _circuit_class()(cfg["k"], a, control)


def instance(cfg, a: int, control: bool = False) -> list[list[int]]:
    return []
