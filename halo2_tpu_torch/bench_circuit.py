"""The circuits that the port's chip runs and tests prove.

BenchCircuit: the standard-PLONK shape of the reference's prove bench
(bench.py:238-289; benches/plonk.rs:21-270 at minimal column count): the
gate s*(a*b - o), a copy chain through column a, and one public input.
Each region takes two rows, so `regions_for_k(k)` fills the usable rows
of a 2^k domain.

DevLookupCircuit: halo2's benches/dev_lookup.rs (mirrored by
scripts/bench_dev_lookup.py): a complex selector, one advice column and
one table column holding 1..2^table_bits, `rows` looked-up rows and the
lookup input s*adv + (1 - s), so every row of the domain is looked up.

PlonkApiCircuit: halo2's tests/plonk_api.rs MyCircuit (mirrored by
tests/test_plonk_api_parity.py): a standard-PLONK gate, a public-input
gate, a single-column lookup and equality on 13 columns.

Each `*_class` function builds the class against a circuit API (the
port's by default), so the same circuit can be handed to the reference
prover. `bench_circuit_class` also takes the floor planner ("simple" or
"v1"), so the same BenchCircuit can be laid out by V1.
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


def bench_circuit_class(circuit_base, value_cls, rotation_cls, fs,
                        floor_planner: str = "simple"):
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

    BenchCircuit.floor_planner = floor_planner
    return BenchCircuit


BenchCircuit = bench_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)


# dev_lookup.rs: an 8-bit table and 2^10 looked-up rows
DEV_LOOKUP_TABLE_BITS = 8
DEV_LOOKUP_ROWS = 1 << 10


def dev_lookup_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    class DevLookupCircuit(circuit_base):
        def __init__(self, table_bits: int = DEV_LOOKUP_TABLE_BITS,
                     rows: int = DEV_LOOKUP_ROWS):
            self.table_bits = table_bits
            self.rows = rows

        def without_witnesses(self):
            return DevLookupCircuit(self.table_bits, self.rows)

        @classmethod
        def configure(cls, meta):
            selector = meta.complex_selector()
            table = meta.lookup_table_column()
            advice = meta.advice_column()

            def lookup(cells):
                s = cells.query_selector(selector)
                adv = cells.query_advice(advice, rotation_cls(0))
                return [(s * adv + (1 - s), table)]

            meta.lookup("lookup", lookup)
            return {"selector": selector, "table": table, "advice": advice}

        def synthesize(self, config, layouter):
            size = 1 << self.table_bits

            def fill_table(table):
                for row in range(size):
                    table.assign_cell(f"row {row}", config["table"], row,
                                      lambda row=row: value_cls.known(row + 1))
            layouter.assign_table(f"{self.table_bits}-bit table", fill_table)

            def assign(region):
                for offset in range(self.rows):
                    region.enable_selector("sel", config["selector"], offset)
                    region.assign_advice(
                        f"offset {offset}", config["advice"], offset,
                        lambda offset=offset:
                        value_cls.known(offset % size + 1))
            layouter.assign_region("assign values", assign)

    return DevLookupCircuit


DevLookupCircuit = dev_lookup_circuit_class(Circuit, Value, Rotation,
                                            PALLAS.scalar)

PLONK_API_K = 5
# the random.Random seed of tests/golden/plonk_api_tpu_proof.bin
PLONK_API_SEED = 1234


def plonk_api_inputs(fs):
    """(a, instance, lookup table) of plonk_api.rs's proof (:438-476)."""
    a = 2834758237 * fs.zeta % fs.modulus
    instance = 2
    return a, instance, [instance, a, a, 0]


def plonk_api_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    class PlonkApiCircuit(circuit_base):
        def __init__(self, a=None, lookup_table=()):
            self.a = a
            self.lookup_table = list(lookup_table)

        def without_witnesses(self):
            return PlonkApiCircuit(None, self.lookup_table)

        @classmethod
        def configure(cls, meta):
            # column creation and enable_equality order fix the column and
            # query indices and the permutation column list
            # (plonk_api.rs:276-345)
            e = meta.advice_column()
            a = meta.advice_column()
            b = meta.advice_column()
            sf = meta.fixed_column()
            c = meta.advice_column()
            d = meta.advice_column()
            p = meta.instance_column()

            meta.enable_equality(a)
            meta.enable_equality(b)
            meta.enable_equality(c)

            sm = meta.fixed_column()
            sa = meta.fixed_column()
            sb = meta.fixed_column()
            sc = meta.fixed_column()
            sp = meta.fixed_column()
            sl = meta.lookup_table_column()

            meta.lookup("", lambda cells: [(cells.query_any(
                a, rotation_cls(0)), sl)])

            def combined_add_mult(cells):
                d_n = cells.query_advice(d, rotation_cls(1))
                a_ = cells.query_advice(a, rotation_cls(0))
                sf_ = cells.query_fixed(sf)
                e_p = cells.query_advice(e, rotation_cls(-1))
                b_ = cells.query_advice(b, rotation_cls(0))
                c_ = cells.query_advice(c, rotation_cls(0))
                sa_ = cells.query_fixed(sa)
                sb_ = cells.query_fixed(sb)
                sc_ = cells.query_fixed(sc)
                sm_ = cells.query_fixed(sm)
                return [a_ * sa_ + b_ * sb_ + a_ * b_ * sm_ - (c_ * sc_)
                        + sf_ * (d_n * e_p)]

            meta.create_gate("Combined add-mult", combined_add_mult)

            def public_input(cells):
                a_ = cells.query_advice(a, rotation_cls(0))
                p_ = cells.query_instance(p, rotation_cls(0))
                sp_ = cells.query_fixed(sp)
                return [sp_ * (a_ - p_)]

            meta.create_gate("Public input", public_input)
            for col in (sf, e, d, p, sm, sa, sb, sc, sp):
                meta.enable_equality(col)
            return {"a": a, "b": b, "c": c, "d": d, "e": e, "sa": sa,
                    "sb": sb, "sc": sc, "sm": sm, "sp": sp, "sf": sf,
                    "sl": sl}

        def _raw(self, cfg, layouter, name, v0, v1, v2, sa, sb, sc, sm):
            """StandardCs::raw_multiply / raw_add (plonk_api.rs:96-260)."""
            def val(x):
                return ((lambda: value_cls.known(x)) if x is not None
                        else (lambda: value_cls.unknown()))

            def pow4(x):
                return (fs.mul(fs.mul(x, x), fs.mul(x, x)) if x is not None
                        else None)

            def region_fn(region):
                lhs = region.assign_advice("lhs", cfg["a"], 0, val(v0))
                region.assign_advice("lhs^4", cfg["d"], 0, val(pow4(v0)))
                rhs = region.assign_advice("rhs", cfg["b"], 0, val(v1))
                region.assign_advice("rhs^4", cfg["e"], 0, val(pow4(v1)))
                out = region.assign_advice("out", cfg["c"], 0, val(v2))
                region.assign_fixed("a", cfg["sa"], 0,
                                    lambda: value_cls.known(sa))
                region.assign_fixed("b", cfg["sb"], 0,
                                    lambda: value_cls.known(sb))
                region.assign_fixed("c", cfg["sc"], 0,
                                    lambda: value_cls.known(sc))
                region.assign_fixed("a * b", cfg["sm"], 0,
                                    lambda: value_cls.known(sm))
                return lhs.cell, rhs.cell, out.cell

            return layouter.assign_region(name, region_fn)

        def synthesize(self, config, layouter):
            def public_input_region(region):
                v = region.assign_advice("value", config["a"], 0,
                                         lambda: value_cls.known(2))
                region.assign_fixed("public", config["sp"], 0,
                                    lambda: value_cls.known(1))
                return v.cell

            layouter.assign_region("public_input", public_input_region)

            a = self.a
            asq = fs.mul(a, a) if a is not None else None
            fin = (asq + a) % fs.modulus if a is not None else None
            for _ in range(10):
                a0, _, c0 = self._raw(config, layouter, "raw_multiply",
                                      a, a, asq, 0, 0, 1, 1)
                a1, b1, _ = self._raw(config, layouter, "raw_add",
                                      a, asq, fin, 1, 1, 1, 0)
                layouter.assign_region(
                    "copy", lambda region, l=a0, r=a1:
                    (region.constrain_equal(l, r),
                     region.constrain_equal(l, r)))
                layouter.assign_region(
                    "copy", lambda region, l=b1, r=c0:
                    (region.constrain_equal(l, r),
                     region.constrain_equal(l, r)))

            def table_fn(table):
                for i, v in enumerate(self.lookup_table):
                    table.assign_cell("table col", config["sl"], i,
                                      lambda v=v: value_cls.known(v))

            layouter.assign_table("", table_fn)

    return PlonkApiCircuit
