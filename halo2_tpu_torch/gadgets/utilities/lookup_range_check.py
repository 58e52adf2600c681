"""Lookup range check: K-bit table + running-sum decomposition.

Reference: halo2_gadgets/src/utilities/lookup_range_check.rs —
combined lookup expression q_lookup·(q_running·(z_cur − 2^K·z_next) +
(1−q_running)·z_cur) against the [0, 2^K) table (:334-366), the short-check
bitshift gate word·2^K·inv_two_pow_s − shifted_word (:370-385), range_check
running sum (:171-240) and short_range_check (:455-490). K = 10 in the
Orchard instantiation.

Copied from halo2_tpu/gadgets/utilities/lookup_range_check.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...plonk.circuit import Constant
from ...poly.polynomial import Rotation
from ...circuit.value import Value
from . import lebs2ip


@dataclass
class LookupRangeCheckConfig:
    k: int
    q_lookup: object
    q_running: object
    q_bitshift: object
    running_sum: object
    table_idx: object
    field: object

    @staticmethod
    def configure(meta, field, running_sum, table_idx, k: int = 10
                  ) -> "LookupRangeCheckConfig":
        meta.enable_equality(running_sum)
        q_lookup = meta.complex_selector()
        q_running = meta.complex_selector()
        q_bitshift = meta.selector()

        def lookup_fn(cells):
            ql = cells.query_selector(q_lookup)
            qr = cells.query_selector(q_running)
            z_cur = cells.query_advice(running_sum, Rotation(0))
            z_next = cells.query_advice(running_sum, Rotation(1))
            # z_next * int -> Scaled, matching the reference's Mul<F>
            # (vk Debug parity: tests/test_gadget_vk_parity.py)
            running_word = z_cur - z_next * (1 << k)
            running_lookup = qr * running_word
            short_lookup = (Constant(1) - qr) * z_cur
            return [(ql * (running_lookup + short_lookup), table_idx)]

        meta.lookup("range check", lookup_fn)

        def bitshift(cells):
            qb = cells.query_selector(q_bitshift)
            word = cells.query_advice(running_sum, Rotation(-1))
            shifted = cells.query_advice(running_sum, Rotation(0))
            inv_two_pow_s = cells.query_advice(running_sum, Rotation(1))
            return [("bitshift",
                     qb * (word * (1 << k) * inv_two_pow_s - shifted))]

        meta.create_gate("Short lookup bitshift", bitshift)
        return LookupRangeCheckConfig(
            k=k, q_lookup=q_lookup, q_running=q_running,
            q_bitshift=q_bitshift, running_sum=running_sum,
            table_idx=table_idx, field=field)

    def load_table(self, layouter) -> None:
        """Fill table_idx with [0, 2^K)."""
        def table_fn(table):
            for i in range(1 << self.k):
                table.assign_cell(f"idx{i}", self.table_idx, i,
                                  lambda i=i: Value.known(i))
        layouter.assign_table("table_idx", table_fn)

    # ----- checks -----
    def witness_check(self, layouter, value: Value, num_words: int,
                      strict: bool):
        def region_fn(region):
            z0 = region.assign_advice("witness element", self.running_sum,
                                      0, lambda: value)
            return self._range_check(region, z0, num_words, strict)
        return layouter.assign_region("witness check", region_fn)

    def copy_check(self, layouter, element, num_words: int, strict: bool):
        def region_fn(region):
            z0 = element.copy_advice("z_0", region, self.running_sum, 0)
            return self._range_check(region, z0, num_words, strict)
        return layouter.assign_region(
            f"{num_words} words range check", region_fn)

    def _range_check(self, region, element, num_words: int, strict: bool):
        f = self.field
        k = self.k
        inv_two_pow_k = pow(1 << k, f.modulus - 2, f.modulus)
        zs = [element]
        z = element
        val = element.value
        for idx in range(num_words):
            word = val.map(lambda v, idx=idx:
                           (v >> (k * idx)) & ((1 << k) - 1))
            region.enable_selector("q_lookup", self.q_lookup, idx)
            region.enable_selector("q_running", self.q_running, idx)
            zval = z.value.zip(word).map(
                lambda zw: (zw[0] - zw[1]) * inv_two_pow_k % f.modulus)
            z = region.assign_advice(f"z_{idx+1}", self.running_sum,
                                     idx + 1, lambda v=zval: v)
            zs.append(z)
        if strict:
            region.constrain_constant(zs[-1].cell, 0)
        return zs

    def copy_short_check(self, layouter, element, num_bits: int):
        assert 0 < num_bits <= self.k

        def region_fn(region):
            el = element.copy_advice("element", region, self.running_sum, 0)
            self._short_range_check(region, el, num_bits)
        layouter.assign_region(f"short range check {num_bits}", region_fn)

    def witness_short_check(self, layouter, value: Value, num_bits: int):
        assert 0 <= num_bits <= self.k

        def region_fn(region):
            el = region.assign_advice("short element", self.running_sum, 0,
                                      lambda: value)
            self._short_range_check(region, el, num_bits)
            return el
        return layouter.assign_region(
            f"witness short range check {num_bits}", region_fn)

    def _short_range_check(self, region, element, num_bits: int):
        f = self.field
        k = self.k
        region.enable_selector("q_lookup0", self.q_lookup, 0)
        region.enable_selector("q_lookup1", self.q_lookup, 1)
        region.enable_selector("q_bitshift", self.q_bitshift, 1)
        shifted = element.value.map(
            lambda v: v * (1 << (k - num_bits)) % f.modulus)
        region.assign_advice(f"element shifted", self.running_sum, 1,
                             lambda: shifted)
        inv_two_pow_s = pow(1 << num_bits, f.modulus - 2, f.modulus)
        region.assign_advice_from_constant(
            f"2^(-{num_bits})", self.running_sum, 2, inv_two_pow_s)


@dataclass
class LookupRangeCheck45BConfig(LookupRangeCheckConfig):
    """The 4_5B variant: a `table_range_check_tag` column lets 4-bit and
    5-bit short checks be single-row lookups instead of the bitshift
    trick.  One COMBINED lookup argument covers the running-sum, short,
    and tagged checks (lookup_range_check.rs:525-640); expression shapes
    mirror configure_with_tag exactly for vk Debug parity."""
    q_range_check_4: object = None
    q_range_check_5: object = None
    table_range_check_tag: object = None

    @staticmethod
    def configure(meta, field, running_sum, table_idx, k: int = 10
                  ) -> "LookupRangeCheck45BConfig":
        """LookupRangeCheck::configure for the 4_5B type: allocates the
        tag table column itself (lookup_range_check.rs:643-650)."""
        tag = meta.lookup_table_column()
        return LookupRangeCheck45BConfig.configure_with_tag(
            meta, field, running_sum, table_idx, tag, k)

    @staticmethod
    def configure_with_tag(meta, field, running_sum, table_idx,
                           table_range_check_tag, k: int = 10
                           ) -> "LookupRangeCheck45BConfig":
        meta.enable_equality(running_sum)
        q_lookup = meta.complex_selector()
        q_running = meta.complex_selector()
        q_bitshift = meta.selector()
        q4 = meta.complex_selector()
        q5 = meta.complex_selector()

        def lookup_fn(cells):
            ql = cells.query_selector(q_lookup)
            qr = cells.query_selector(q_running)
            qr4 = cells.query_selector(q4)
            qr5 = cells.query_selector(q5)
            z_cur = cells.query_advice(running_sum, Rotation(0))
            one = Constant(1)
            z_next = cells.query_advice(running_sum, Rotation(1))
            running_sum_lookup = qr * (z_cur - z_next * (1 << k))
            short_lookup = (one - qr) * z_cur
            # 1 iff q4 or q5
            q_range_check = one - (one - qr4) * (one - qr5)
            # 5 if q5; 4 if q4 and not q5; else 0
            num_bits = (qr5 * Constant(5)
                        + (one - qr5) * qr4 * Constant(4))
            return [
                (ql * ((one - q_range_check)
                       * (running_sum_lookup + short_lookup)
                       + q_range_check * z_cur), table_idx),
                (ql * q_range_check * num_bits, table_range_check_tag),
            ]

        meta.lookup("range check 4/5b", lookup_fn)

        def bitshift(cells):
            qb = cells.query_selector(q_bitshift)
            word = cells.query_advice(running_sum, Rotation(-1))
            shifted = cells.query_advice(running_sum, Rotation(0))
            inv_two_pow_s = cells.query_advice(running_sum, Rotation(1))
            return [("bitshift",
                     qb * (word * (1 << k) * inv_two_pow_s - shifted))]

        meta.create_gate("Short lookup bitshift", bitshift)
        return LookupRangeCheck45BConfig(
            k=k, q_lookup=q_lookup, q_running=q_running,
            q_bitshift=q_bitshift, running_sum=running_sum,
            table_idx=table_idx, field=field,
            q_range_check_4=q4, q_range_check_5=q5,
            table_range_check_tag=table_range_check_tag)

    def _short_range_check(self, region, element, num_bits: int):
        """4/5-bit checks are single-row tagged lookups; other widths
        fall back to the bitshift method (lookup_range_check.rs:829-850)."""
        if num_bits == 4:
            region.enable_selector("q_lookup", self.q_lookup, 0)
            region.enable_selector("q4", self.q_range_check_4, 0)
        elif num_bits == 5:
            region.enable_selector("q_lookup", self.q_lookup, 0)
            region.enable_selector("q5", self.q_range_check_5, 0)
        else:
            LookupRangeCheckConfig._short_range_check(
                self, region, element, num_bits)

    def load_table(self, layouter) -> None:
        """Rows [0,2^K) tag 0, then [0,2^4) tag 4, then [0,2^5) tag 5."""
        def table_fn(table):
            row = 0
            for i in range(1 << self.k):
                table.assign_cell(f"idx{row}", self.table_idx, row,
                                  lambda i=i: Value.known(i))
                table.assign_cell(f"tag{row}", self.table_range_check_tag,
                                  row, lambda: Value.known(0))
                row += 1
            for nbits, tag in ((4, 4), (5, 5)):
                for i in range(1 << nbits):
                    table.assign_cell(f"idx{row}", self.table_idx, row,
                                      lambda i=i: Value.known(i))
                    table.assign_cell(f"tag{row}",
                                      self.table_range_check_tag, row,
                                      lambda t=tag: Value.known(t))
                    row += 1
        layouter.assign_table("table_idx tagged", table_fn)

    def witness_short_check_tagged(self, layouter, value: Value,
                                   num_bits: int):
        """Back-compat alias: 4/5-bit checks now route through the
        standard witness_short_check (tagged single-row lookup)."""
        assert num_bits in (4, 5)
        return self.witness_short_check(layouter, value, num_bits)
