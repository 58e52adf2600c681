"""Reusable benchmark/validation circuits (shared by the mesh parity
tests, the multichip dryrun, and bench scripts — keeping runtime entry
points free of dependencies on the tests/ tree).

Copied from halo2_tpu/dev/circuits.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from ..curves import PALLAS
from ..circuit import Circuit, Value
from ..poly.polynomial import Rotation

FS = PALLAS.scalar


class MulChainCircuit(Circuit):
    """Gate + permutation circuit with enough rows to be worth sharding:
    a chain out_i = a_i * 3 with copies between consecutive regions
    (Pallas curve / Fq witness field)."""

    def __init__(self, a=None, rows=24):
        self.a = a
        self.rows = rows

    def without_witnesses(self):
        return MulChainCircuit(None, self.rows)

    @classmethod
    def configure(cls, meta):
        col_a = meta.advice_column()
        col_b = meta.advice_column()
        instance = meta.instance_column()
        s_mul = meta.selector()
        meta.enable_equality(col_a)
        meta.enable_equality(instance)

        def gate(cells):
            a = cells.query_advice(col_a, Rotation(0))
            b = cells.query_advice(col_b, Rotation(0))
            out = cells.query_advice(col_a, Rotation(1))
            s = cells.query_selector(s_mul)
            return [("mul", s * (a * b - out))]

        meta.create_gate("mul", gate)
        return {"a": col_a, "b": col_b, "instance": instance,
                "s_mul": s_mul}

    def synthesize(self, config, layouter):
        out = None
        cur = self.a
        for i in range(self.rows):
            def region_fn(region, cur=cur, prev=out):
                region.enable_selector("s", config["s_mul"], 0)
                cell_a = region.assign_advice(
                    "a", config["a"], 0,
                    lambda: Value.known(cur) if cur is not None
                    else Value.unknown())
                if prev is not None:
                    region.constrain_equal(cell_a.cell, prev.cell)
                region.assign_advice("b", config["b"], 0,
                                     lambda: Value.known(3))
                nxt = (FS.mul(cur, 3) if cur is not None else None)
                return region.assign_advice(
                    "out", config["a"], 1,
                    lambda v=nxt: Value.known(v) if v is not None
                    else Value.unknown())
            out = layouter.assign_region("mul", region_fn)
            if cur is not None:
                cur = FS.mul(cur, 3)
        layouter.constrain_instance(out.cell, config["instance"], 0)

    def expected_out(self):
        v = self.a
        for _ in range(self.rows):
            v = FS.mul(v, 3)
        return v
