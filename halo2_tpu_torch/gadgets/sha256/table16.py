"""Table16 SHA-256 chip: spread-table (tag/dense/spread) design.

Reference: halo2_gadgets/src/sha256/table16{,.rs,/}  (spread_table.rs,
gates.rs, message_schedule{,.rs,/subregion1-3,schedule_gates,
schedule_util}, compression{,.rs,/compression_gates,compression_util,
subregion_initial,subregion_main,subregion_digest}).

The chip proves SHA-256 with a 2^16-row lookup table of
(tag, dense, spread) rows, where spread interleaves a 16-bit word's
bits with zeros; XOR/AND/MAJ/CH become integer additions of spread
forms whose even/odd bit planes are re-extracted with further lookups.
Row layouts, column roles (a_0..a_9), gate formulas and copy wiring
mirror the reference exactly (there is no stored golden vk for sha256,
so the oracle is MockProver + the FIPS 180-4 host primitive).

Values are modelled as Python ints inside `Value`s: dense pieces are
n-bit ints, spread pieces 2n-bit ints.

Copied from halo2_tpu/gadgets/sha256/table16.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...poly.polynomial import Rotation
from ...plonk.circuit import Constant
from ...circuit.value import Value
from ...circuit.layouter import Chip, AssignedCell
from . import (Sha256Instructions, BlockWord, IV, ROUND_CONSTANTS,
               BLOCK_SIZE, DIGEST_SIZE)

ROUNDS = 64
STATE = 8
MASK_EVEN_32 = 0x55555555
MASK_EVEN_64 = 0x5555555555555555

BITS_7, BITS_10, BITS_11, BITS_13, BITS_14 = (
    1 << 7, 1 << 10, 1 << 11, 1 << 13, 1 << 14)


# --------------------------------------------------------------- util
def get_tag(x: int) -> int:
    """spread_table.rs:28-43."""
    if x < BITS_7:
        return 0
    if x < BITS_10:
        return 1
    if x < BITS_11:
        return 2
    if x < BITS_13:
        return 3
    if x < BITS_14:
        return 4
    return 5


def spread_int(x: int, n: int = 16) -> int:
    """Interleave the n low bits of x with zeros (util.rs spread_bits)."""
    out = 0
    for i in range(n):
        out |= ((x >> i) & 1) << (2 * i)
    return out


def even_bits_int(x: int, half: int) -> int:
    out = 0
    for i in range(half):
        out |= ((x >> (2 * i)) & 1) << i
    return out


def odd_bits_int(x: int, half: int) -> int:
    out = 0
    for i in range(half):
        out |= ((x >> (2 * i + 1)) & 1) << i
    return out


def negate_spread_int(x: int, length: int) -> int:
    """Flip the even bit-plane of a `length`-bit spread value
    (util.rs negate_spread)."""
    assert length % 2 == 0
    mask = sum(1 << (2 * i) for i in range(length // 2))
    return x ^ mask


def sum_with_carry(halves: list[tuple[Value, Value]]
                   ) -> tuple[Value, Value]:
    """util.rs sum_with_carry over (lo16, hi16) Value pairs ->
    (word32 Value, carry Value)."""
    total = Value.known(0)
    for lo, hi in halves:
        total = total.zip(lo.zip(hi)).map(
            lambda t: t[0] + t[1][0] + (t[1][1] << 16))
    word = total.map(lambda s: s & 0xFFFFFFFF)
    carry = total.map(lambda s: s >> 32)
    return word, carry


# -------------------------------------------------------- gate helpers
def ones():
    return Constant(1)


def range_check_expr(value, lo: int, hi: int):
    """gates.rs range_check: prod_{i=lo..hi} (value - i)."""
    expr = ones()
    for i in range(lo, hi + 1):
        expr = expr * (ones() * (-i) + value)
    return expr


def _lagrange_interp(var, points: list[int], evals: list[int]):
    """gates.rs lagrange_interpolate -> (factor, expr) with the whole
    expression scaled by factor = (deg-1)! to avoid divisions."""
    deg = len(points)

    def factorial(n):
        return 1 if n < 2 else n * factorial(n - 1)

    factor = factorial(deg - 1)

    def numerator(eval_v, idx):
        expr = ones()
        for i in range(deg):
            if i != idx:
                expr = expr * (ones() * (-i) + var)
        return expr * eval_v

    def denominator(idx):
        denom = 1
        for i in range(deg):
            if i != idx:
                denom *= idx - i
        if denom < 0:
            return -(factor // (-denom))
        return factor // denom

    expr = ones() * 0
    for idx in range(deg):
        expr = expr + numerator(evals[idx], idx) * denominator(idx)
    return factor, expr


def two_bit_spread_and_range(dense, spread):
    factor, poly = _lagrange_interp(
        dense, [0b00, 0b01, 0b10, 0b11], [0b0000, 0b0001, 0b0100, 0b0101])
    return [("two_bit_range_check", range_check_expr(dense, 0, 3)),
            ("two_bit_spread_check", poly - spread * factor)]


def three_bit_spread_and_range(dense, spread):
    factor, poly = _lagrange_interp(
        dense, list(range(8)),
        [0b000000, 0b000001, 0b000100, 0b000101,
         0b010000, 0b010001, 0b010100, 0b010101])
    return [("three_bit_range_check", range_check_expr(dense, 0, 7)),
            ("three_bit_spread_check", poly - spread * factor)]


# ----------------------------------------------------- spread table
@dataclass
class SpreadInputs:
    tag: object
    dense: object
    spread: object


@dataclass
class SpreadTable:
    tag: object
    dense: object
    spread: object


@dataclass
class SpreadTableConfig:
    input: SpreadInputs
    table: SpreadTable


class SpreadTableChip:
    """spread_table.rs:183-260."""

    @staticmethod
    def configure(meta, input_tag, input_dense, input_spread
                  ) -> SpreadTableConfig:
        table_tag = meta.lookup_table_column()
        table_dense = meta.lookup_table_column()
        table_spread = meta.lookup_table_column()

        def table_map(cells):
            tag_cur = cells.query_advice(input_tag, Rotation(0))
            dense_cur = cells.query_advice(input_dense, Rotation(0))
            spread_cur = cells.query_advice(input_spread, Rotation(0))
            return [(tag_cur, table_tag), (dense_cur, table_dense),
                    (spread_cur, table_spread)]

        meta.lookup("spread table", table_map)
        return SpreadTableConfig(
            input=SpreadInputs(input_tag, input_dense, input_spread),
            table=SpreadTable(table_tag, table_dense, table_spread))

    @staticmethod
    def load(config: SpreadTableConfig, layouter):
        def table_fn(table):
            for idx in range(1 << 16):
                table.assign_cell(
                    "tag", config.table.tag, idx,
                    lambda idx=idx: Value.known(get_tag(idx)))
                table.assign_cell(
                    "dense", config.table.dense, idx,
                    lambda idx=idx: Value.known(idx))
                table.assign_cell(
                    "spread", config.table.spread, idx,
                    lambda idx=idx: Value.known(spread_int(idx)))

        layouter.assign_table("spread table", table_fn)


class SpreadVar:
    """A (tag, dense, spread) triple in advice (spread_table.rs:70-141).
    `dense`/`spread` are AssignedCells whose values are ints."""

    def __init__(self, dense: AssignedCell, spread: AssignedCell,
                 nbits: int):
        self.dense = dense
        self.spread = spread
        self.nbits = nbits

    @staticmethod
    def with_lookup(region, cols: SpreadInputs, row: int,
                    dense_val: Value, nbits: int) -> "SpreadVar":
        tag = dense_val.map(get_tag)
        region.assign_advice("tag", cols.tag, row, lambda: tag)
        dense = region.assign_advice("dense", cols.dense, row,
                                     lambda: dense_val)
        spread = region.assign_advice(
            "spread", cols.spread, row,
            lambda: dense_val.map(lambda v: spread_int(v, nbits)))
        return SpreadVar(dense, spread, nbits)

    @staticmethod
    def without_lookup(region, dense_col, dense_row, spread_col,
                       spread_row, dense_val: Value, nbits: int
                       ) -> "SpreadVar":
        dense = region.assign_advice("dense", dense_col, dense_row,
                                     lambda: dense_val)
        spread = region.assign_advice(
            "spread", spread_col, spread_row,
            lambda: dense_val.map(lambda v: spread_int(v, nbits)))
        return SpreadVar(dense, spread, nbits)


def _assign_spread_outputs(region, lookup: SpreadInputs, a_3, row,
                           r_0_even, r_0_odd, r_1_even, r_1_odd):
    """Table16Assignment::assign_spread_outputs (table16.rs:381-429):
    lookups at rows row-1..row+2, copy of R_1^odd spread into a_3@row.
    Returns ((r0_even, r1_even), (r0_odd, r1_odd)) dense cells."""
    v_r0e = SpreadVar.with_lookup(region, lookup, row - 1, r_0_even, 16)
    v_r0o = SpreadVar.with_lookup(region, lookup, row, r_0_odd, 16)
    v_r1e = SpreadVar.with_lookup(region, lookup, row + 1, r_1_even, 16)
    v_r1o = SpreadVar.with_lookup(region, lookup, row + 2, r_1_odd, 16)
    v_r1o.spread.copy_advice("R_1^odd", region, a_3, row)
    return ((v_r0e.dense, v_r1e.dense), (v_r0o.dense, v_r1o.dense))


def _assign_sigma_outputs(region, lookup, a_3, row, r_0_even, r_0_odd,
                          r_1_even, r_1_odd):
    even, _odd = _assign_spread_outputs(
        region, lookup, a_3, row, r_0_even, r_0_odd, r_1_even, r_1_odd)
    return even


def _split_even_odd(r: Value):
    """r: 64-bit int Value -> (r0_even, r0_odd, r1_even, r1_odd) as
    16-bit int Values."""
    r0 = r.map(lambda v: v & 0xFFFFFFFF)
    r1 = r.map(lambda v: (v >> 32) & 0xFFFFFFFF)
    return (r0.map(lambda v: even_bits_int(v, 16)),
            r0.map(lambda v: odd_bits_int(v, 16)),
            r1.map(lambda v: even_bits_int(v, 16)),
            r1.map(lambda v: odd_bits_int(v, 16)))


# ------------------------------------------------- message schedule
# Row accounting (schedule_util.rs)
DECOMPOSE_0_ROWS = 2
DECOMPOSE_1_ROWS = 2
DECOMPOSE_2_ROWS = 3
DECOMPOSE_3_ROWS = 2
SIGMA_0_V1_ROWS = 4
SIGMA_0_V2_ROWS = 4
SIGMA_1_V1_ROWS = 4
SIGMA_1_V2_ROWS = 4
SUBREGION_0_ROWS = 1 * DECOMPOSE_0_ROWS
SUBREGION_1_WORD = DECOMPOSE_1_ROWS + SIGMA_0_V1_ROWS
SUBREGION_1_ROWS = 13 * SUBREGION_1_WORD
SUBREGION_2_WORD = DECOMPOSE_2_ROWS + SIGMA_0_V2_ROWS + SIGMA_1_V2_ROWS
SUBREGION_2_ROWS = 35 * SUBREGION_2_WORD
SUBREGION_3_WORD = DECOMPOSE_3_ROWS + SIGMA_1_V1_ROWS
SUBREGION_3_ROWS = 13 * SUBREGION_3_WORD


def get_word_row(word_idx: int) -> int:
    """schedule_util.rs:37-55."""
    assert word_idx <= 63
    if word_idx == 0:
        return 0
    if 1 <= word_idx <= 13:
        return SUBREGION_0_ROWS + SUBREGION_1_WORD * (word_idx - 1)
    if 14 <= word_idx <= 48:
        return (SUBREGION_0_ROWS + SUBREGION_1_ROWS
                + SUBREGION_2_WORD * (word_idx - 14) + 1)
    if 49 <= word_idx <= 61:
        return (SUBREGION_0_ROWS + SUBREGION_1_ROWS + SUBREGION_2_ROWS
                + SUBREGION_3_WORD * (word_idx - 49))
    return (SUBREGION_0_ROWS + SUBREGION_1_ROWS + SUBREGION_2_ROWS
            + SUBREGION_3_ROWS + DECOMPOSE_0_ROWS * (word_idx - 62))


def _bits(v: int, lo: int, hi: int) -> int:
    """little-endian bit range [lo, hi) of v as an int."""
    return (v >> lo) & ((1 << (hi - lo)) - 1)


class MessageScheduleConfig:
    """message_schedule.rs."""

    def __init__(self, meta, lookup: SpreadInputs, message_schedule,
                 extras):
        self.lookup = lookup
        self.message_schedule = message_schedule
        self.extras = list(extras)

        self.s_word = meta.selector()
        self.s_decompose_0 = meta.selector()
        self.s_decompose_1 = meta.selector()
        self.s_decompose_2 = meta.selector()
        self.s_decompose_3 = meta.selector()
        self.s_lower_sigma_0 = meta.selector()
        self.s_lower_sigma_1 = meta.selector()
        self.s_lower_sigma_0_v2 = meta.selector()
        self.s_lower_sigma_1_v2 = meta.selector()

        a_0, a_1, a_2 = lookup.tag, lookup.dense, lookup.spread
        a_3, a_4 = extras[0], extras[1]
        a_5 = message_schedule
        a_6, a_7, a_8, a_9 = extras[2], extras[3], extras[4], extras[5]
        R = Rotation

        def s_word_gate(c):
            q = c.query_selector(self.s_word)
            sigma_0_lo = c.query_advice(a_6, R(-1))
            sigma_0_hi = c.query_advice(a_6, R(0))
            sigma_1_lo = c.query_advice(a_7, R(-1))
            sigma_1_hi = c.query_advice(a_7, R(0))
            w_m9_lo = c.query_advice(a_8, R(-1))
            w_m9_hi = c.query_advice(a_8, R(0))
            w_m16_lo = c.query_advice(a_3, R(-1))
            w_m16_hi = c.query_advice(a_4, R(-1))
            word = c.query_advice(a_5, R(0))
            carry = c.query_advice(a_9, R(0))
            lo = sigma_0_lo + sigma_1_lo + w_m9_lo + w_m16_lo
            hi = sigma_0_hi + sigma_1_hi + w_m9_hi + w_m16_hi
            word_check = (lo + hi * (1 << 16)
                          + carry * (1 << 32) * (-1) + word * (-1))
            carry_check = range_check_expr(carry, 0, 3)
            return [("word_check", q * word_check),
                    ("carry_check", q * carry_check)]

        meta.create_gate("s_word for W_[16..64]", s_word_gate)

        def s_dec0(c):
            q = c.query_selector(self.s_decompose_0)
            lo = c.query_advice(a_3, R(0))
            hi = c.query_advice(a_4, R(0))
            word = c.query_advice(a_5, R(0))
            return [("s_decompose_0", q * (lo + hi * (1 << 16) - word))]

        meta.create_gate("s_decompose_0", s_dec0)

        def s_dec1(c):
            q = c.query_selector(self.s_decompose_1)
            a = c.query_advice(a_3, R(1))
            b = c.query_advice(a_4, R(1))
            cc = c.query_advice(a_1, R(1))
            tag_c = c.query_advice(a_0, R(1))
            d = c.query_advice(a_1, R(0))
            tag_d = c.query_advice(a_0, R(0))
            word = c.query_advice(a_5, R(0))
            dec = (a + b * (1 << 3) + cc * (1 << 7) + d * (1 << 18)
                   + word * (-1))
            return [("decompose_check", q * dec),
                    ("range_check_tag_c",
                     q * range_check_expr(tag_c, 0, 2)),
                    ("range_check_tag_d",
                     q * range_check_expr(tag_d, 0, 4))]

        meta.create_gate("s_decompose_1", s_dec1)

        def s_dec2(c):
            q = c.query_selector(self.s_decompose_2)
            a = c.query_advice(a_3, R(-1))
            b = c.query_advice(a_1, R(1))
            cc = c.query_advice(a_4, R(-1))
            d = c.query_advice(a_1, R(0))
            tag_d = c.query_advice(a_0, R(0))
            e = c.query_advice(a_3, R(1))
            f = c.query_advice(a_4, R(1))
            g = c.query_advice(a_1, R(-1))
            tag_g = c.query_advice(a_0, R(-1))
            word = c.query_advice(a_5, R(0))
            dec = (a + b * (1 << 3) + cc * (1 << 7) + d * (1 << 10)
                   + e * (1 << 17) + f * (1 << 18) + g * (1 << 19)
                   + word * (-1))
            return [("decompose_check", q * dec),
                    ("range_check_tag_g",
                     q * range_check_expr(tag_g, 0, 3)),
                    ("range_check_tag_d",
                     q * range_check_expr(tag_d, 0, 0))]

        meta.create_gate("s_decompose_2", s_dec2)

        def s_dec3(c):
            q = c.query_selector(self.s_decompose_3)
            a = c.query_advice(a_1, R(1))
            tag_a = c.query_advice(a_0, R(1))
            b = c.query_advice(a_4, R(1))
            cc = c.query_advice(a_3, R(1))
            d = c.query_advice(a_1, R(0))
            tag_d = c.query_advice(a_0, R(0))
            word = c.query_advice(a_5, R(0))
            dec = (a + b * (1 << 10) + cc * (1 << 17) + d * (1 << 19)
                   + word * (-1))
            return [("decompose_check", q * dec),
                    ("range_check_tag_a",
                     q * range_check_expr(tag_a, 0, 1)),
                    ("range_check_tag_d",
                     q * range_check_expr(tag_d, 0, 3))]

        meta.create_gate("s_decompose_3", s_dec3)

        def sigma0_v1(c):
            q = c.query_selector(self.s_lower_sigma_0)
            sr0e = c.query_advice(a_2, R(-1))
            sr0o = c.query_advice(a_2, R(0))
            sr1e = c.query_advice(a_2, R(1))
            sr1o = c.query_advice(a_3, R(0))
            a = c.query_advice(a_5, R(1))
            sa = c.query_advice(a_6, R(1))
            b = c.query_advice(a_6, R(0))
            b_lo = c.query_advice(a_3, R(-1))
            sb_lo = c.query_advice(a_4, R(-1))
            b_hi = c.query_advice(a_5, R(-1))
            sb_hi = c.query_advice(a_6, R(-1))
            sc = c.query_advice(a_4, R(0))
            sd = c.query_advice(a_5, R(0))
            out = []
            out += two_bit_spread_and_range(b_lo, sb_lo)
            out += two_bit_spread_and_range(b_hi, sb_hi)
            out += three_bit_spread_and_range(a, sa)
            out.append(("check_b", b_lo + b_hi * (1 << 2) - b))
            witness = sr0e + sr0o * 2 + (sr1e + sr1o * 2) * (1 << 32)
            xor_0 = (sb_lo + sb_hi * (1 << 4) + sc * (1 << 8)
                     + sd * (1 << 30))
            xor_1 = (sc + sd * (1 << 22) + sa * (1 << 50)
                     + sb_lo * (1 << 56) + sb_hi * (1 << 60))
            xor_2 = (sd + sa * (1 << 28) + sb_lo * (1 << 34)
                     + sb_hi * (1 << 38) + sc * (1 << 42))
            out.append(("lower_sigma_0",
                        witness - (xor_0 + xor_1 + xor_2)))
            return [(n, q * p) for n, p in out]

        meta.create_gate("sigma_0 v1", sigma0_v1)

        def _sigma_v2(c, sel, which):
            q = c.query_selector(sel)
            sr0e = c.query_advice(a_2, R(-1))
            sr0o = c.query_advice(a_2, R(0))
            sr1e = c.query_advice(a_2, R(1))
            sr1o = c.query_advice(a_3, R(0))
            a = c.query_advice(a_3, R(1))
            sa = c.query_advice(a_4, R(1))
            b = c.query_advice(a_6, R(0))
            b_lo = c.query_advice(a_3, R(-1))
            sb_lo = c.query_advice(a_4, R(-1))
            b_hi = c.query_advice(a_5, R(-1))
            sb_hi = c.query_advice(a_6, R(-1))
            cc = c.query_advice(a_5, R(1))
            sc = c.query_advice(a_6, R(1))
            sd = c.query_advice(a_4, R(0))
            se = c.query_advice(a_7, R(0))
            sf = c.query_advice(a_7, R(1))
            sg = c.query_advice(a_5, R(0))
            out = []
            out += two_bit_spread_and_range(b_lo, sb_lo)
            out += two_bit_spread_and_range(b_hi, sb_hi)
            out += three_bit_spread_and_range(a, sa)
            out += three_bit_spread_and_range(cc, sc)
            out.append(("check_b", b_lo + b_hi * (1 << 2) - b))
            witness = sr0e + sr0o * 2 + (sr1e + sr1o * 2) * (1 << 32)
            if which == 0:
                xor_0 = (sb_lo + sb_hi * (1 << 4) + sc * (1 << 8)
                         + sd * (1 << 14) + se * (1 << 28)
                         + sf * (1 << 30) + sg * (1 << 32))
                xor_1 = (sc + sd * (1 << 6) + se * (1 << 20)
                         + sf * (1 << 22) + sg * (1 << 24)
                         + sa * (1 << 50) + sb_lo * (1 << 56)
                         + sb_hi * (1 << 60))
                xor_2 = (sf + sg * (1 << 2) + sa * (1 << 28)
                         + sb_lo * (1 << 34) + sb_hi * (1 << 38)
                         + sc * (1 << 42) + sd * (1 << 48)
                         + se * (1 << 62))
                name = "lower_sigma_0_v2"
            else:
                xor_0 = (sd + se * (1 << 14) + sf * (1 << 16)
                         + sg * (1 << 18))
                xor_1 = (se + sf * (1 << 2) + sg * (1 << 4)
                         + sa * (1 << 30) + sb_lo * (1 << 36)
                         + sb_hi * (1 << 40) + sc * (1 << 44)
                         + sd * (1 << 50))
                xor_2 = (sg + sa * (1 << 26) + sb_lo * (1 << 32)
                         + sb_hi * (1 << 36) + sc * (1 << 40)
                         + sd * (1 << 46) + se * (1 << 60)
                         + sf * (1 << 62))
                name = "lower_sigma_1_v2"
            out.append((name, witness - (xor_0 + xor_1 + xor_2)))
            return [(n, q * p) for n, p in out]

        meta.create_gate(
            "sigma_0 v2",
            lambda c: _sigma_v2(c, self.s_lower_sigma_0_v2, 0))
        meta.create_gate(
            "sigma_1 v2",
            lambda c: _sigma_v2(c, self.s_lower_sigma_1_v2, 1))

        def sigma1_v1(c):
            q = c.query_selector(self.s_lower_sigma_1)
            sr0e = c.query_advice(a_2, R(-1))
            sr0o = c.query_advice(a_2, R(0))
            sr1e = c.query_advice(a_2, R(1))
            sr1o = c.query_advice(a_3, R(0))
            sa = c.query_advice(a_4, R(0))
            b = c.query_advice(a_6, R(0))
            b_lo = c.query_advice(a_3, R(-1))
            sb_lo = c.query_advice(a_4, R(-1))
            b_mid = c.query_advice(a_5, R(-1))
            sb_mid = c.query_advice(a_6, R(-1))
            b_hi = c.query_advice(a_5, R(1))
            sb_hi = c.query_advice(a_6, R(1))
            cc = c.query_advice(a_3, R(1))
            sc = c.query_advice(a_4, R(1))
            sd = c.query_advice(a_5, R(0))
            out = []
            out += two_bit_spread_and_range(b_lo, sb_lo)
            out += two_bit_spread_and_range(b_mid, sb_mid)
            out += two_bit_spread_and_range(cc, sc)
            out += three_bit_spread_and_range(b_hi, sb_hi)
            out.append(("check_b1", b_lo + b_mid * (1 << 2)
                        + b_hi * (1 << 4) - b))
            witness = sr0e + sr0o * 2 + (sr1e + sr1o * 2) * (1 << 32)
            xor_0 = (sb_lo + sb_mid * (1 << 4) + sb_hi * (1 << 8)
                     + sc * (1 << 14) + sd * (1 << 18))
            xor_1 = (sc + sd * (1 << 4) + sa * (1 << 30)
                     + sb_lo * (1 << 50) + sb_mid * (1 << 54)
                     + sb_hi * (1 << 58))
            xor_2 = (sd + sa * (1 << 26) + sb_lo * (1 << 46)
                     + sb_mid * (1 << 50) + sb_hi * (1 << 54)
                     + sc * (1 << 60))
            out.append(("lower_sigma_1",
                        witness - (xor_0 + xor_1 + xor_2)))
            return [(n, q * p) for n, p in out]

        meta.create_gate("sigma_1 v1", sigma1_v1)

    # ---- assignment helpers ----
    def assign_word_and_halves(self, region, word: Value, word_idx: int):
        """schedule_util.rs:147-180."""
        a_3, a_4 = self.extras[0], self.extras[1]
        row = get_word_row(word_idx)
        w_lo = region.assign_advice(
            f"W_{word_idx}_lo", a_3, row,
            lambda: word.map(lambda w: w & 0xFFFF))
        w_hi = region.assign_advice(
            f"W_{word_idx}_hi", a_4, row,
            lambda: word.map(lambda w: (w >> 16) & 0xFFFF))
        w = region.assign_advice(f"W_{word_idx}", self.message_schedule,
                                 row, lambda: word)
        return w, (w_lo, w_hi)

    # ---- subregion 1 ----
    def _decompose_subregion1_word(self, region, word: Value, index):
        """(3, 4, 11, 14) chunks (subregion1.rs:105-152)."""
        row = get_word_row(index)
        a_3, a_4 = self.extras[0], self.extras[1]
        a = region.assign_advice(
            "word_a", a_3, row + 1,
            lambda: word.map(lambda w: _bits(w, 0, 3)))
        b = region.assign_advice(
            "word_b", a_4, row + 1,
            lambda: word.map(lambda w: _bits(w, 3, 7)))
        spread_c = SpreadVar.with_lookup(
            region, self.lookup, row + 1,
            word.map(lambda w: _bits(w, 7, 18)), 11)
        spread_d = SpreadVar.with_lookup(
            region, self.lookup, row,
            word.map(lambda w: _bits(w, 18, 32)), 14)
        return (index, a, b, spread_c, spread_d)

    def _lower_sigma_0(self, region, sub1_word):
        """subregion1.rs:156-218."""
        index, a, b, spread_c, spread_d = sub1_word
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5, a_6 = self.message_schedule, self.extras[2]
        row = get_word_row(index) + 3

        a.copy_advice("a", region, a_5, row + 1)
        region.assign_advice(
            "spread_a", a_6, row + 1,
            lambda: a.value.map(lambda v: spread_int(v, 3)))
        b_lo = b.value.map(lambda v: v & 3)
        region.assign_advice("b_lo", a_3, row - 1, lambda: b_lo)
        region.assign_advice(
            "spread_b_lo", a_4, row - 1,
            lambda: b_lo.map(lambda v: spread_int(v, 2)))
        b_hi = b.value.map(lambda v: (v >> 2) & 3)
        region.assign_advice("b_hi", a_5, row - 1, lambda: b_hi)
        region.assign_advice(
            "spread_b_hi", a_6, row - 1,
            lambda: b_hi.map(lambda v: spread_int(v, 2)))
        b.copy_advice("b", region, a_6, row)
        spread_c.spread.copy_advice("spread_c", region, a_4, row)
        spread_d.spread.copy_advice("spread_d", region, a_5, row)

        def xor(vals):
            av, bv, cv, dv = vals
            sa, sb = spread_int(av, 3), spread_int(bv, 4)
            sc, sd = spread_int(cv, 11), spread_int(dv, 14)
            # sigma_0 = (b||c||d) + (c||d||a||b) + (d||a||b||c)
            # in spread form, little-endian concat => shifts in bits*2
            xor_0 = sb | (sc << 8) | (sd << 30)
            xor_1 = sc | (sd << 22) | (sa << 50) | (sb << 56)
            xor_2 = sd | (sa << 28) | (sb << 34) | (sc << 42)
            return xor_0 + xor_1 + xor_2

        r = (a.value.zip(b.value)
             .zip(spread_c.dense.value.zip(spread_d.dense.value))
             .map(lambda t: xor((t[0][0], t[0][1], t[1][0], t[1][1]))))
        r0e, r0o, r1e, r1o = _split_even_odd(r)
        return _assign_sigma_outputs(region, self.lookup, a_3, row,
                                     r0e, r0o, r1e, r1o)

    def assign_subregion1(self, region, input_words):
        out = []
        for idx, word in enumerate(input_words):
            sub = self._decompose_subregion1_word(region, word.value,
                                                  idx + 1)
            out.append(self._lower_sigma_0(region, sub))
        return out

    # ---- subregion 2 ----
    def _decompose_word2(self, region, word: Value, index):
        """(3, 4, 3, 7, 1, 1, 13) chunks (subregion2.rs:283-341)."""
        row = get_word_row(index)
        a_3, a_4 = self.extras[0], self.extras[1]
        a = region.assign_advice(
            "a", a_3, row - 1, lambda: word.map(lambda w: _bits(w, 0, 3)))
        spread_b = SpreadVar.with_lookup(
            region, self.lookup, row + 1,
            word.map(lambda w: _bits(w, 3, 7)), 4)
        c = region.assign_advice(
            "c", a_4, row - 1,
            lambda: word.map(lambda w: _bits(w, 7, 10)))
        spread_d = SpreadVar.with_lookup(
            region, self.lookup, row,
            word.map(lambda w: _bits(w, 10, 17)), 7)
        e = region.assign_advice(
            "e", a_3, row + 1,
            lambda: word.map(lambda w: _bits(w, 17, 18)))
        f = region.assign_advice(
            "f", a_4, row + 1,
            lambda: word.map(lambda w: _bits(w, 18, 19)))
        spread_g = SpreadVar.with_lookup(
            region, self.lookup, row - 1,
            word.map(lambda w: _bits(w, 19, 32)), 13)
        return (index, a, spread_b.dense, c, spread_d, e, f, spread_g)

    def _assign_lower_sigma_v2_pieces(self, region, row, word2):
        """subregion2.rs:345-407."""
        (_idx, a, b, c, spread_d, e, f, spread_g) = word2
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5, a_6, a_7 = (self.message_schedule, self.extras[2],
                         self.extras[3])
        a.copy_advice("a", region, a_3, row + 1)
        region.assign_advice(
            "spread_a", a_4, row + 1,
            lambda: a.value.map(lambda v: spread_int(v, 3)))
        b_lo = b.value.map(lambda v: v & 3)
        region.assign_advice("b_lo", a_3, row - 1, lambda: b_lo)
        region.assign_advice(
            "spread_b_lo", a_4, row - 1,
            lambda: b_lo.map(lambda v: spread_int(v, 2)))
        b_hi = b.value.map(lambda v: (v >> 2) & 3)
        region.assign_advice("b_hi", a_5, row - 1, lambda: b_hi)
        region.assign_advice(
            "spread_b_hi", a_6, row - 1,
            lambda: b_hi.map(lambda v: spread_int(v, 2)))
        b.copy_advice("b", region, a_6, row)
        c.copy_advice("c", region, a_5, row + 1)
        region.assign_advice(
            "spread_c", a_6, row + 1,
            lambda: c.value.map(lambda v: spread_int(v, 3)))
        spread_d.spread.copy_advice("spread_d", region, a_4, row)
        e.copy_advice("e", region, a_7, row)
        f.copy_advice("f", region, a_7, row + 1)
        spread_g.spread.copy_advice("spread_g", region, a_5, row)

    @staticmethod
    def _xor2(vals, which):
        av, bv, cv, dv, ev, fv, gv = vals
        sa, sb, sc = (spread_int(av, 3), spread_int(bv, 4),
                      spread_int(cv, 3))
        sd, se, sf, sg = (spread_int(dv, 7), spread_int(ev, 1),
                          spread_int(fv, 1), spread_int(gv, 13))
        if which == 0:
            xor_0 = (sb | (sc << 8) | (sd << 14) | (se << 28)
                     | (sf << 30) | (sg << 32))
            xor_1 = (sc | (sd << 6) | (se << 20) | (sf << 22)
                     | (sg << 24) | (sa << 50) | (sb << 56))
            xor_2 = (sf | (sg << 2) | (sa << 28) | (sb << 34)
                     | (sc << 42) | (sd << 48) | (se << 62))
        else:
            xor_0 = sd | (se << 14) | (sf << 16) | (sg << 18)
            xor_1 = (se | (sf << 2) | (sg << 4) | (sa << 30)
                     | (sb << 36) | (sc << 44) | (sd << 50))
            xor_2 = (sg | (sa << 26) | (sb << 32) | (sc << 40)
                     | (sd << 46) | (se << 60) | (sf << 62))
        return xor_0 + xor_1 + xor_2

    def _word2_vals(self, word2):
        (_idx, a, b, c, spread_d, e, f, spread_g) = word2
        return (a.value.zip(b.value).zip(c.value)
                .zip(spread_d.dense.value).zip(e.value).zip(f.value)
                .zip(spread_g.dense.value)
                .map(lambda t: (t[0][0][0][0][0][0], t[0][0][0][0][0][1],
                                t[0][0][0][0][1], t[0][0][0][1],
                                t[0][0][1], t[0][1], t[1])))

    def _lower_sigma_v2(self, region, word2, which):
        a_3 = self.extras[0]
        index = word2[0]
        row = get_word_row(index) + 3
        if which == 1:
            row += SIGMA_0_V2_ROWS
        self._assign_lower_sigma_v2_pieces(region, row, word2)
        r = self._word2_vals(word2).map(
            lambda v: self._xor2(v, which))
        r0e, r0o, r1e, r1o = _split_even_odd(r)
        return _assign_sigma_outputs(region, self.lookup, a_3, row,
                                     r0e, r0o, r1e, r1o)

    def assign_subregion2(self, region, lower_sigma_0_output, w,
                          w_halves):
        """subregion2.rs:153-280."""
        a_5, a_6 = self.message_schedule, self.extras[2]
        a_7, a_8, a_9 = self.extras[3], self.extras[4], self.extras[5]
        sigma_0_v2_results = []
        sigma_1_v2_results = []

        def new_word(idx, sigma_0_output):
            word2 = self._decompose_word2(region, w[idx].value, idx)
            sigma_0_v2_results.append(
                self._lower_sigma_v2(region, word2, 0))
            sigma_1_v2_results.append(
                self._lower_sigma_v2(region, word2, 1))
            nwi = idx + 2
            base = get_word_row(nwi - 16)
            sigma_0_output[0].copy_advice(
                f"sigma_0(W_{nwi-15})_lo", region, a_6, base)
            sigma_0_output[1].copy_advice(
                f"sigma_0(W_{nwi-15})_hi", region, a_6, base + 1)
            s1 = sigma_1_v2_results[nwi - 16]
            s1[0].copy_advice(f"sigma_1(W_{nwi-2})_lo", region, a_7,
                              base)
            s1[1].copy_advice(f"sigma_1(W_{nwi-2})_hi", region, a_7,
                              base + 1)
            w_halves[nwi - 7][0].copy_advice(
                f"W_{nwi-7}_lo", region, a_8, base)
            w_halves[nwi - 7][1].copy_advice(
                f"W_{nwi-7}_hi", region, a_8, base + 1)
            word, carry = sum_with_carry([
                (s1[0].value, s1[1].value),
                (w_halves[nwi - 7][0].value, w_halves[nwi - 7][1].value),
                (sigma_0_output[0].value, sigma_0_output[1].value),
                (w_halves[nwi - 16][0].value,
                 w_halves[nwi - 16][1].value)])
            region.assign_advice(f"W_{nwi}", a_5, base + 1,
                                 lambda: word)
            region.assign_advice(f"carry_{nwi}", a_9, base + 1,
                                 lambda: carry)
            new_w, halves = self.assign_word_and_halves(region, word,
                                                        nwi)
            w.append(new_w)
            w_halves.append(halves)

        for i in range(14, 27):
            new_word(i, lower_sigma_0_output[i - 14])
        for i in range(27, 49):
            new_word(i, sigma_0_v2_results[i + 2 - 15 - 14])
        return sigma_0_v2_results[36 - 14:]

    # ---- subregion 3 ----
    def _decompose_subregion3_word(self, region, word: Value, index):
        """(10, 7, 2, 13) chunks (subregion3.rs:196-245)."""
        row = get_word_row(index)
        a_3, a_4 = self.extras[0], self.extras[1]
        spread_a = SpreadVar.with_lookup(
            region, self.lookup, row + 1,
            word.map(lambda w: _bits(w, 0, 10)), 10)
        b = region.assign_advice(
            "b", a_4, row + 1,
            lambda: word.map(lambda w: _bits(w, 10, 17)))
        c = region.assign_advice(
            "c", a_3, row + 1,
            lambda: word.map(lambda w: _bits(w, 17, 19)))
        spread_d = SpreadVar.with_lookup(
            region, self.lookup, row,
            word.map(lambda w: _bits(w, 19, 32)), 13)
        return (index, spread_a, b, c, spread_d)

    def _lower_sigma_1(self, region, word3):
        """subregion3.rs:247-320."""
        index, spread_a, b, c, spread_d = word3
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5, a_6 = self.message_schedule, self.extras[2]
        row = get_word_row(index) + 3

        spread_a.spread.copy_advice("spread_a", region, a_4, row)
        b_lo = b.value.map(lambda v: v & 3)
        SpreadVar.without_lookup(region, a_3, row - 1, a_4, row - 1,
                                 b_lo, 2)
        b_mid = b.value.map(lambda v: (v >> 2) & 3)
        SpreadVar.without_lookup(region, a_5, row - 1, a_6, row - 1,
                                 b_mid, 2)
        b_hi = b.value.map(lambda v: (v >> 4) & 7)
        SpreadVar.without_lookup(region, a_5, row + 1, a_6, row + 1,
                                 b_hi, 3)
        b.copy_advice("b", region, a_6, row)
        c.copy_advice("c", region, a_3, row + 1)
        region.assign_advice(
            "spread_c", a_4, row + 1,
            lambda: c.value.map(lambda v: spread_int(v, 2)))
        spread_d.spread.copy_advice("spread_d", region, a_5, row)

        def xor(vals):
            av, bv, cv, dv = vals
            sa, sb = spread_int(av, 10), spread_int(bv, 7)
            sc, sd = spread_int(cv, 2), spread_int(dv, 13)
            xor_0 = sb | (sc << 14) | (sd << 18)
            xor_1 = sc | (sd << 4) | (sa << 30) | (sb << 50)
            xor_2 = sd | (sa << 26) | (sb << 46) | (sc << 60)
            return xor_0 + xor_1 + xor_2

        r = (spread_a.dense.value.zip(b.value)
             .zip(c.value.zip(spread_d.dense.value))
             .map(lambda t: xor((t[0][0], t[0][1], t[1][0], t[1][1]))))
        r0e, r0o, r1e, r1o = _split_even_odd(r)
        return _assign_sigma_outputs(region, self.lookup, a_3, row,
                                     r0e, r0o, r1e, r1o)

    def assign_subregion3(self, region, lower_sigma_0_v2_output, w,
                          w_halves):
        """subregion3.rs:81-194."""
        a_5, a_6 = self.message_schedule, self.extras[2]
        a_7, a_8, a_9 = self.extras[3], self.extras[4], self.extras[5]

        def new_word(idx):
            word3 = self._decompose_subregion3_word(region,
                                                    w[idx].value, idx)
            r_0_even, r_1_even = self._lower_sigma_1(region, word3)
            nwi = idx + 2
            base = get_word_row(nwi - 16)
            s0 = lower_sigma_0_v2_output[idx - 49]
            s0[0].copy_advice(f"sigma_0(W_{nwi-15})_lo", region, a_6,
                              base)
            s0[1].copy_advice(f"sigma_0(W_{nwi-15})_hi", region, a_6,
                              base + 1)
            r_0_even.copy_advice(f"sigma_1(W_{nwi-2})_lo", region, a_7,
                                 base)
            r_1_even.copy_advice(f"sigma_1(W_{nwi-2})_hi", region, a_7,
                                 base + 1)
            w_halves[nwi - 7][0].copy_advice(
                f"W_{nwi-7}_lo", region, a_8, base)
            w_halves[nwi - 7][1].copy_advice(
                f"W_{nwi-7}_hi", region, a_8, base + 1)
            word, carry = sum_with_carry([
                (r_0_even.value, r_1_even.value),
                (w_halves[nwi - 7][0].value, w_halves[nwi - 7][1].value),
                (s0[0].value, s0[1].value),
                (w_halves[nwi - 16][0].value,
                 w_halves[nwi - 16][1].value)])
            region.assign_advice(f"W_{nwi}", a_5, base + 1,
                                 lambda: word)
            region.assign_advice(f"carry_{nwi}", a_9, base + 1,
                                 lambda: carry)
            new_w, halves = self.assign_word_and_halves(region, word,
                                                        nwi)
            w.append(new_w)
            w_halves.append(halves)

        for i in range(49, 62):
            new_word(i)

    # ---- top-level process ----
    def process(self, layouter, input_words):
        """message_schedule.rs:305-392."""
        result = {}

        def region_fn(region):
            w = []
            w_halves = []
            for index in range(1, 14):
                row = get_word_row(index)
                region.enable_selector("s_dec1", self.s_decompose_1, row)
                region.enable_selector("s_ls0", self.s_lower_sigma_0,
                                       row + 3)
            for index in range(14, 49):
                row = get_word_row(index)
                region.enable_selector("s_dec2", self.s_decompose_2, row)
                region.enable_selector("s_ls0v2",
                                       self.s_lower_sigma_0_v2, row + 3)
                region.enable_selector(
                    "s_ls1v2", self.s_lower_sigma_1_v2,
                    row + SIGMA_0_V2_ROWS + 3)
                nwi = index + 2
                region.enable_selector("s_word", self.s_word,
                                       get_word_row(nwi - 16) + 1)
            for index in range(49, 62):
                row = get_word_row(index)
                region.enable_selector("s_dec3", self.s_decompose_3, row)
                region.enable_selector("s_ls1", self.s_lower_sigma_1,
                                       row + 3)
                nwi = index + 2
                region.enable_selector("s_word", self.s_word,
                                       get_word_row(nwi - 16) + 1)
            for index in range(64):
                region.enable_selector("s_dec0", self.s_decompose_0,
                                       get_word_row(index))

            for i, word in enumerate(input_words):
                new_w, halves = self.assign_word_and_halves(
                    region, word.value, i)
                w.append(new_w)
                w_halves.append(halves)

            sigma0_out = self.assign_subregion1(
                region, input_words[1:14])
            sigma0_v2_out = self.assign_subregion2(
                region, sigma0_out, w, w_halves)
            self.assign_subregion3(region, sigma0_v2_out, w, w_halves)
            result["w"] = w
            result["w_halves"] = w_halves

        layouter.assign_region("process message block", region_fn)
        return result["w"], result["w_halves"]


# ------------------------------------------------------- compression
# Row accounting (compression_util.rs:28-40)
SIGMA_0_ROWS = 4
SIGMA_1_ROWS = 4
CH_ROWS = 8
MAJ_ROWS = 4
DECOMPOSE_ABCD = 2
DECOMPOSE_EFGH = 2
SUBREGION_MAIN_WORD = (DECOMPOSE_ABCD + SIGMA_0_ROWS + DECOMPOSE_EFGH
                       + SIGMA_1_ROWS + CH_ROWS + MAJ_ROWS)
SUBREGION_MAIN_ROWS = 64 * SUBREGION_MAIN_WORD

INIT = "init"


def get_round_row(round_idx):
    if round_idx == INIT:
        return 0
    assert round_idx < 64
    return round_idx * SUBREGION_MAIN_WORD


def get_decompose_e_row(round_idx):
    return get_round_row(round_idx)


def get_decompose_f_row():
    return get_decompose_e_row(INIT) + DECOMPOSE_EFGH


def get_decompose_g_row():
    return get_decompose_f_row() + DECOMPOSE_EFGH


def get_upper_sigma_1_row(round_idx):
    return get_decompose_e_row(round_idx) + DECOMPOSE_EFGH + 1


def get_ch_row(round_idx):
    return (get_decompose_e_row(round_idx) + DECOMPOSE_EFGH
            + SIGMA_1_ROWS + 1)


def get_ch_neg_row(round_idx):
    return get_ch_row(round_idx) + CH_ROWS // 2


def get_h_row(round_idx):
    if round_idx == INIT:
        return get_decompose_g_row() + DECOMPOSE_EFGH
    return get_ch_row(round_idx) - 1


def get_decompose_a_row(round_idx):
    if round_idx == INIT:
        return get_h_row(INIT) + DECOMPOSE_EFGH
    return get_ch_neg_row(round_idx) - 1 + CH_ROWS // 2


def get_upper_sigma_0_row(round_idx):
    return get_decompose_a_row(round_idx) + DECOMPOSE_ABCD + 1


def get_decompose_b_row():
    return get_decompose_a_row(INIT) + DECOMPOSE_ABCD


def get_decompose_c_row():
    return get_decompose_b_row() + DECOMPOSE_ABCD


def get_maj_row(round_idx):
    return get_upper_sigma_0_row(round_idx) + SIGMA_0_ROWS


def get_h_prime_row(round_idx):
    return get_ch_row(round_idx)


def get_d_row(round_idx):
    if round_idx == INIT:
        return get_decompose_c_row() + DECOMPOSE_ABCD
    return get_ch_row(round_idx) + 2


def get_e_new_row(round_idx):
    return get_d_row(round_idx)


def get_a_new_row(round_idx):
    return get_maj_row(round_idx)


def get_digest_abcd_row():
    return SUBREGION_MAIN_ROWS


def get_digest_efgh_row():
    return get_digest_abcd_row() + 2


class RoundWordDense:
    def __init__(self, lo: AssignedCell, hi: AssignedCell):
        self.lo, self.hi = lo, hi

    def value(self) -> Value:
        return self.lo.value.zip(self.hi.value).map(
            lambda t: t[0] + (t[1] << 16))


class RoundWordSpread:
    def __init__(self, lo: AssignedCell, hi: AssignedCell):
        self.lo, self.hi = lo, hi

    def value(self) -> Value:
        return self.lo.value.zip(self.hi.value).map(
            lambda t: t[0] + (t[1] << 32))


class RoundWordA:
    def __init__(self, pieces, dense_halves, spread_halves):
        self.pieces = pieces                    # AbcdVar dict or None
        self.dense_halves = dense_halves
        self.spread_halves = spread_halves


class RoundWordE:
    def __init__(self, pieces, dense_halves, spread_halves):
        self.pieces = pieces                    # EfghVar dict or None
        self.dense_halves = dense_halves
        self.spread_halves = spread_halves


class RoundWord:
    def __init__(self, dense_halves, spread_halves):
        self.dense_halves = dense_halves
        self.spread_halves = spread_halves


class State:
    def __init__(self, a, b, c, d, e, f, g, h):
        self.a, self.b, self.c, self.d = a, b, c, d
        self.e, self.f, self.g, self.h = e, f, g, h


class CompressionConfig:
    """compression.rs + compression/ subregions."""

    def __init__(self, meta, lookup: SpreadInputs, message_schedule,
                 extras):
        self.lookup = lookup
        self.message_schedule = message_schedule
        self.extras = list(extras)

        self.s_ch = meta.selector()
        self.s_ch_neg = meta.selector()
        self.s_maj = meta.selector()
        self.s_h_prime = meta.selector()
        self.s_a_new = meta.selector()
        self.s_e_new = meta.selector()
        self.s_upper_sigma_0 = meta.selector()
        self.s_upper_sigma_1 = meta.selector()
        self.s_decompose_abcd = meta.selector()
        self.s_decompose_efgh = meta.selector()
        self.s_digest = meta.selector()

        a_0, a_1, a_2 = lookup.tag, lookup.dense, lookup.spread
        a_3, a_4 = extras[0], extras[1]
        a_5 = message_schedule
        a_6, a_7, a_8, a_9 = extras[2], extras[3], extras[4], extras[5]
        R = Rotation

        def dec_abcd(c):
            q = c.query_selector(self.s_decompose_abcd)
            a = c.query_advice(a_3, R(1))
            sa = c.query_advice(a_4, R(1))
            b = c.query_advice(a_1, R(0))
            sb = c.query_advice(a_2, R(0))
            tag_b = c.query_advice(a_0, R(0))
            c_lo = c.query_advice(a_3, R(0))
            sc_lo = c.query_advice(a_4, R(0))
            c_mid = c.query_advice(a_5, R(0))
            sc_mid = c.query_advice(a_6, R(0))
            c_hi = c.query_advice(a_5, R(1))
            sc_hi = c.query_advice(a_6, R(1))
            d = c.query_advice(a_1, R(1))
            sd = c.query_advice(a_2, R(1))
            tag_d = c.query_advice(a_0, R(1))
            word_lo = c.query_advice(a_7, R(0))
            sword_lo = c.query_advice(a_8, R(0))
            word_hi = c.query_advice(a_7, R(1))
            sword_hi = c.query_advice(a_8, R(1))
            out = []
            out += three_bit_spread_and_range(c_lo, sc_lo)
            out += three_bit_spread_and_range(c_mid, sc_mid)
            out += three_bit_spread_and_range(c_hi, sc_hi)
            out += two_bit_spread_and_range(a, sa)
            out.append(("range_check_tag_b",
                        range_check_expr(tag_b, 0, 2)))
            out.append(("range_check_tag_d",
                        range_check_expr(tag_d, 0, 1)))
            dense = (a + b * (1 << 2) + c_lo * (1 << 13)
                     + c_mid * (1 << 16) + c_hi * (1 << 19)
                     + d * (1 << 22) + word_lo * (-1)
                     + word_hi * (1 << 16) * (-1))
            spread = (sa + sb * (1 << 4) + sc_lo * (1 << 26)
                      + sc_mid * (1 << 32) + sc_hi * (1 << 38)
                      + sd * (1 << 44) + sword_lo * (-1)
                      + sword_hi * (1 << 32) * (-1))
            out.append(("dense_check", dense))
            out.append(("spread_check", spread))
            return [(n, q * p) for n, p in out]

        meta.create_gate("decompose ABCD", dec_abcd)

        def dec_efgh(c):
            q = c.query_selector(self.s_decompose_efgh)
            a_lo = c.query_advice(a_3, R(1))
            sa_lo = c.query_advice(a_4, R(1))
            a_hi = c.query_advice(a_5, R(1))
            sa_hi = c.query_advice(a_6, R(1))
            b_lo = c.query_advice(a_3, R(0))
            sb_lo = c.query_advice(a_4, R(0))
            b_hi = c.query_advice(a_5, R(0))
            sb_hi = c.query_advice(a_6, R(0))
            cc = c.query_advice(a_1, R(1))
            sc = c.query_advice(a_2, R(1))
            tag_c = c.query_advice(a_0, R(1))
            d = c.query_advice(a_1, R(0))
            sd = c.query_advice(a_2, R(0))
            tag_d = c.query_advice(a_0, R(0))
            word_lo = c.query_advice(a_7, R(0))
            sword_lo = c.query_advice(a_8, R(0))
            word_hi = c.query_advice(a_7, R(1))
            sword_hi = c.query_advice(a_8, R(1))
            out = []
            out += three_bit_spread_and_range(a_lo, sa_lo)
            out += three_bit_spread_and_range(a_hi, sa_hi)
            out += three_bit_spread_and_range(b_hi, sb_hi)
            out += two_bit_spread_and_range(b_lo, sb_lo)
            out.append(("range_check_tag_c",
                        range_check_expr(tag_c, 0, 4)))
            out.append(("range_check_tag_d",
                        range_check_expr(tag_d, 0, 0)))
            dense = (a_lo + a_hi * (1 << 3) + b_lo * (1 << 6)
                     + b_hi * (1 << 8) + cc * (1 << 11) + d * (1 << 25)
                     + word_lo * (-1) + word_hi * (1 << 16) * (-1))
            spread = (sa_lo + sa_hi * (1 << 6) + sb_lo * (1 << 12)
                      + sb_hi * (1 << 16) + sc * (1 << 22)
                      + sd * (1 << 50) + sword_lo * (-1)
                      + sword_hi * (1 << 32) * (-1))
            out.append(("dense_check", dense))
            out.append(("spread_check", spread))
            return [(n, q * p) for n, p in out]

        meta.create_gate("Decompose EFGH", dec_efgh)

        def us0(c):
            q = c.query_selector(self.s_upper_sigma_0)
            sr0e = c.query_advice(a_2, R(-1))
            sr0o = c.query_advice(a_2, R(0))
            sr1e = c.query_advice(a_2, R(1))
            sr1o = c.query_advice(a_3, R(0))
            sa = c.query_advice(a_3, R(1))
            sb = c.query_advice(a_5, R(0))
            sc_lo = c.query_advice(a_3, R(-1))
            sc_mid = c.query_advice(a_4, R(-1))
            sc_hi = c.query_advice(a_4, R(1))
            sd = c.query_advice(a_4, R(0))
            witness = sr0e + sr0o * 2 + (sr1e + sr1o * 2) * (1 << 32)
            xor_0 = (sb + sc_lo * (1 << 22) + sc_mid * (1 << 28)
                     + sc_hi * (1 << 34) + sd * (1 << 40)
                     + sa * (1 << 60))
            xor_1 = (sc_lo + sc_mid * (1 << 6) + sc_hi * (1 << 12)
                     + sd * (1 << 18) + sa * (1 << 38)
                     + sb * (1 << 42))
            xor_2 = (sd + sa * (1 << 20) + sb * (1 << 24)
                     + sc_lo * (1 << 46) + sc_mid * (1 << 52)
                     + sc_hi * (1 << 58))
            return [("s_upper_sigma_0",
                     q * (witness + (xor_0 + xor_1 + xor_2) * (-1)))]

        meta.create_gate("s_upper_sigma_0", us0)

        def us1(c):
            q = c.query_selector(self.s_upper_sigma_1)
            sr0e = c.query_advice(a_2, R(-1))
            sr0o = c.query_advice(a_2, R(0))
            sr1e = c.query_advice(a_2, R(1))
            sr1o = c.query_advice(a_3, R(0))
            sa_lo = c.query_advice(a_3, R(1))
            sa_hi = c.query_advice(a_4, R(1))
            sb_lo = c.query_advice(a_3, R(-1))
            sb_hi = c.query_advice(a_4, R(-1))
            sc = c.query_advice(a_5, R(0))
            sd = c.query_advice(a_4, R(0))
            witness = sr0e + sr0o * 2 + (sr1e + sr1o * 2) * (1 << 32)
            xor_0 = (sb_lo + sb_hi * (1 << 4) + sc * (1 << 10)
                     + sd * (1 << 38) + sa_lo * (1 << 52)
                     + sa_hi * (1 << 58))
            xor_1 = (sc + sd * (1 << 28) + sa_lo * (1 << 42)
                     + sa_hi * (1 << 48) + sb_lo * (1 << 54)
                     + sb_hi * (1 << 58))
            xor_2 = (sd + sa_lo * (1 << 14) + sa_hi * (1 << 20)
                     + sb_lo * (1 << 26) + sb_hi * (1 << 30)
                     + sc * (1 << 36))
            return [("s_upper_sigma_1",
                     q * (witness + (xor_0 + xor_1 + xor_2) * (-1)))]

        meta.create_gate("s_upper_sigma_1", us1)

        def ch(c):
            q = c.query_selector(self.s_ch)
            sp0e = c.query_advice(a_2, R(-1))
            sp0o = c.query_advice(a_2, R(0))
            sp1e = c.query_advice(a_2, R(1))
            sp1o = c.query_advice(a_3, R(0))
            se_lo = c.query_advice(a_3, R(-1))
            se_hi = c.query_advice(a_4, R(-1))
            sf_lo = c.query_advice(a_3, R(1))
            sf_hi = c.query_advice(a_4, R(1))
            lhs = (se_lo + sf_lo) + (se_hi + sf_hi) * (1 << 32)
            rhs = (sp0e + sp1e * (1 << 32)
                   + (sp0o + sp1o * (1 << 32)) * 2)
            return [("s_ch", q * (lhs + rhs * (-1)))]

        meta.create_gate("s_ch", ch)

        def ch_neg(c):
            q = c.query_selector(self.s_ch_neg)
            sq0e = c.query_advice(a_2, R(-1))
            sq0o = c.query_advice(a_2, R(0))
            sq1e = c.query_advice(a_2, R(1))
            sq1o = c.query_advice(a_3, R(0))
            se_lo = c.query_advice(a_5, R(-1))
            se_hi = c.query_advice(a_5, R(0))
            sen_lo = c.query_advice(a_3, R(-1))
            sen_hi = c.query_advice(a_4, R(-1))
            sg_lo = c.query_advice(a_3, R(1))
            sg_hi = c.query_advice(a_4, R(1))
            evens = ones() * MASK_EVEN_32
            lo_check = sen_lo + se_lo + evens * (-1)
            hi_check = sen_hi + se_hi + evens * (-1)
            lhs = (sen_lo + sg_lo) + (sen_hi + sg_hi) * (1 << 32)
            rhs = (sq0e + sq1e * (1 << 32)
                   + (sq0o + sq1o * (1 << 32)) * 2)
            return [("lo_check", q * lo_check),
                    ("hi_check", q * hi_check),
                    ("s_ch_neg", q * (lhs - rhs))]

        meta.create_gate("s_ch_neg", ch_neg)

        def maj(c):
            q = c.query_selector(self.s_maj)
            sm0e = c.query_advice(a_2, R(-1))
            sm0o = c.query_advice(a_2, R(0))
            sm1e = c.query_advice(a_2, R(1))
            sm1o = c.query_advice(a_3, R(0))
            sa_lo = c.query_advice(a_4, R(-1))
            sa_hi = c.query_advice(a_5, R(-1))
            sb_lo = c.query_advice(a_4, R(0))
            sb_hi = c.query_advice(a_5, R(0))
            sc_lo = c.query_advice(a_4, R(1))
            sc_hi = c.query_advice(a_5, R(1))
            m = (sm0e + sm1e * (1 << 32)
                 + (sm0o + sm1o * (1 << 32)) * 2)
            s = ((sa_lo + sa_hi * (1 << 32))
                 + (sb_lo + sb_hi * (1 << 32))
                 + (sc_lo + sc_hi * (1 << 32)))
            return [("maj", q * (s - m))]

        meta.create_gate("s_maj", maj)

        def h_prime(c):
            q = c.query_selector(self.s_h_prime)
            hp_lo = c.query_advice(a_7, R(1))
            hp_hi = c.query_advice(a_8, R(1))
            hp_carry = c.query_advice(a_9, R(1))
            se_lo = c.query_advice(a_4, R(0))
            se_hi = c.query_advice(a_5, R(0))
            ch_lo = c.query_advice(a_1, R(0))
            ch_hi = c.query_advice(a_6, R(1))
            chn_lo = c.query_advice(a_5, R(-1))
            chn_hi = c.query_advice(a_5, R(1))
            h_lo = c.query_advice(a_7, R(-1))
            h_hi = c.query_advice(a_7, R(0))
            k_lo = c.query_advice(a_6, R(-1))
            k_hi = c.query_advice(a_6, R(0))
            w_lo = c.query_advice(a_8, R(-1))
            w_hi = c.query_advice(a_8, R(0))
            lo = h_lo + ch_lo + chn_lo + se_lo + k_lo + w_lo
            hi = h_hi + ch_hi + chn_hi + se_hi + k_hi + w_hi
            s = lo + hi * (1 << 16)
            hp = hp_lo + hp_hi * (1 << 16)
            return [("s_h_prime",
                     q * (s - hp_carry * (1 << 32) - hp))]

        meta.create_gate("s_h_prime", h_prime)

        def a_new(c):
            q = c.query_selector(self.s_a_new)
            an_lo = c.query_advice(a_8, R(0))
            an_hi = c.query_advice(a_8, R(1))
            an_carry = c.query_advice(a_9, R(0))
            sa_lo = c.query_advice(a_6, R(0))
            sa_hi = c.query_advice(a_6, R(1))
            maj_lo = c.query_advice(a_1, R(0))
            maj_hi = c.query_advice(a_3, R(-1))
            hp_lo = c.query_advice(a_7, R(-1))
            hp_hi = c.query_advice(a_8, R(-1))
            lo = sa_lo + maj_lo + hp_lo
            hi = sa_hi + maj_hi + hp_hi
            s = lo + hi * (1 << 16)
            an = an_lo + an_hi * (1 << 16)
            return [("s_a_new", q * (s - an_carry * (1 << 32) - an))]

        meta.create_gate("s_a_new", a_new)

        def e_new(c):
            q = c.query_selector(self.s_e_new)
            en_lo = c.query_advice(a_8, R(0))
            en_hi = c.query_advice(a_8, R(1))
            en_carry = c.query_advice(a_9, R(1))
            d_lo = c.query_advice(a_7, R(0))
            d_hi = c.query_advice(a_7, R(1))
            hp_lo = c.query_advice(a_7, R(-1))
            hp_hi = c.query_advice(a_8, R(-1))
            s = (hp_lo + d_lo) + (hp_hi + d_hi) * (1 << 16)
            en = en_lo + en_hi * (1 << 16)
            return [("s_e_new", q * (s - en_carry * (1 << 32) - en))]

        meta.create_gate("s_e_new", e_new)

        def digest(c):
            q = c.query_selector(self.s_digest)
            out = []
            cols = [(a_3, a_4, a_5), (a_6, a_7, a_8)]
            for j, (lo_c, hi_c, w_c) in enumerate(cols):
                lo0 = c.query_advice(lo_c, R(0))
                hi0 = c.query_advice(hi_c, R(0))
                w0 = c.query_advice(w_c, R(0))
                out.append((f"check_lo_hi_{2*j}",
                            q * (lo0 + hi0 * (1 << 16) - w0)))
                lo1 = c.query_advice(lo_c, R(1))
                hi1 = c.query_advice(hi_c, R(1))
                w1 = c.query_advice(w_c, R(1))
                out.append((f"check_lo_hi_{2*j+1}",
                            q * (lo1 + hi1 * (1 << 16) - w1)))
            return out

        meta.create_gate("s_digest", digest)

    # ---- assignment helpers (compression_util.rs) ----
    def assign_word_halves_dense(self, region, lo_row, lo_col, hi_row,
                                 hi_col, word: Value) -> RoundWordDense:
        lo = region.assign_advice(
            "lo", lo_col, lo_row, lambda: word.map(lambda w: w & 0xFFFF))
        hi = region.assign_advice(
            "hi", hi_col, hi_row,
            lambda: word.map(lambda w: (w >> 16) & 0xFFFF))
        return RoundWordDense(lo, hi)

    def assign_word_halves(self, region, row, word: Value):
        a_7, a_8 = self.extras[3], self.extras[4]
        lo = word.map(lambda w: w & 0xFFFF)
        hi = word.map(lambda w: (w >> 16) & 0xFFFF)
        w_lo = SpreadVar.without_lookup(region, a_7, row, a_8, row,
                                        lo, 16)
        w_hi = SpreadVar.without_lookup(region, a_7, row + 1, a_8,
                                        row + 1, hi, 16)
        return (RoundWordDense(w_lo.dense, w_hi.dense),
                RoundWordSpread(w_lo.spread, w_hi.spread))

    def decompose_abcd(self, region, row, val: Value):
        """(2, 11, 9=3+3+3, 10) chunks (compression_util.rs:203-272)."""
        region.enable_selector("s_dec_abcd", self.s_decompose_abcd, row)
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5, a_6 = self.message_schedule, self.extras[2]
        a = SpreadVar.without_lookup(
            region, a_3, row + 1, a_4, row + 1,
            val.map(lambda v: _bits(v, 0, 2)), 2)
        b = SpreadVar.with_lookup(
            region, self.lookup, row,
            val.map(lambda v: _bits(v, 2, 13)), 11)
        c_lo = SpreadVar.without_lookup(
            region, a_3, row, a_4, row,
            val.map(lambda v: _bits(v, 13, 16)), 3)
        c_mid = SpreadVar.without_lookup(
            region, a_5, row, a_6, row,
            val.map(lambda v: _bits(v, 16, 19)), 3)
        c_hi = SpreadVar.without_lookup(
            region, a_5, row + 1, a_6, row + 1,
            val.map(lambda v: _bits(v, 19, 22)), 3)
        d = SpreadVar.with_lookup(
            region, self.lookup, row + 1,
            val.map(lambda v: _bits(v, 22, 32)), 10)
        return {"a": a, "b": b, "c_lo": c_lo, "c_mid": c_mid,
                "c_hi": c_hi, "d": d}

    def decompose_efgh(self, region, row, val: Value):
        """(6=3+3, 5=2+3, 14, 7) chunks (compression_util.rs:274-342)."""
        region.enable_selector("s_dec_efgh", self.s_decompose_efgh, row)
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5, a_6 = self.message_schedule, self.extras[2]
        a_lo = SpreadVar.without_lookup(
            region, a_3, row + 1, a_4, row + 1,
            val.map(lambda v: _bits(v, 0, 3)), 3)
        a_hi = SpreadVar.without_lookup(
            region, a_5, row + 1, a_6, row + 1,
            val.map(lambda v: _bits(v, 3, 6)), 3)
        b_lo = SpreadVar.without_lookup(
            region, a_3, row, a_4, row,
            val.map(lambda v: _bits(v, 6, 8)), 2)
        b_hi = SpreadVar.without_lookup(
            region, a_5, row, a_6, row,
            val.map(lambda v: _bits(v, 8, 11)), 3)
        c = SpreadVar.with_lookup(
            region, self.lookup, row + 1,
            val.map(lambda v: _bits(v, 11, 25)), 14)
        d = SpreadVar.with_lookup(
            region, self.lookup, row,
            val.map(lambda v: _bits(v, 25, 32)), 7)
        return {"a_lo": a_lo, "a_hi": a_hi, "b_lo": b_lo, "b_hi": b_hi,
                "c": c, "d": d}

    def decompose_a(self, region, round_idx, a_val: Value) -> RoundWordA:
        row = get_decompose_a_row(round_idx)
        dense, spread = self.assign_word_halves(region, row, a_val)
        pieces = self.decompose_abcd(region, row, a_val)
        return RoundWordA(pieces, dense, spread)

    def decompose_e(self, region, round_idx, e_val: Value) -> RoundWordE:
        row = get_decompose_e_row(round_idx)
        dense, spread = self.assign_word_halves(region, row, e_val)
        pieces = self.decompose_efgh(region, row, e_val)
        return RoundWordE(pieces, dense, spread)

    @staticmethod
    def _abcd_xor_sigma(vals):
        """Sigma_0: spread (a,b,c,d) with rotations b||c||d||a etc."""
        av, bv, c_lo, c_mid, c_hi, dv = vals
        sa, sb = spread_int(av, 2), spread_int(bv, 11)
        sc = (spread_int(c_lo, 3) | (spread_int(c_mid, 3) << 6)
              | (spread_int(c_hi, 3) << 12))
        sd = spread_int(dv, 10)
        xor_0 = sb | (sc << 22) | (sd << 40) | (sa << 60)
        xor_1 = sc | (sd << 18) | (sa << 38) | (sb << 42)
        xor_2 = sd | (sa << 20) | (sb << 24) | (sc << 46)
        return xor_0 + xor_1 + xor_2

    @staticmethod
    def _efgh_xor_sigma(vals):
        """Sigma_1: spread (a=6,b=5,c=14,d=7) rotations."""
        a_lo, a_hi, b_lo, b_hi, cv, dv = vals
        sa = spread_int(a_lo, 3) | (spread_int(a_hi, 3) << 6)
        sb = spread_int(b_lo, 2) | (spread_int(b_hi, 3) << 4)
        sc, sd = spread_int(cv, 14), spread_int(dv, 7)
        xor_0 = sb | (sc << 10) | (sd << 38) | (sa << 52)
        xor_1 = sc | (sd << 28) | (sa << 42) | (sb << 54)
        xor_2 = sd | (sa << 14) | (sb << 26) | (sc << 36)
        return xor_0 + xor_1 + xor_2

    def assign_upper_sigma_0(self, region, round_idx, pieces):
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5 = self.message_schedule
        row = get_upper_sigma_0_row(round_idx)
        region.enable_selector("s_us0", self.s_upper_sigma_0, row)
        pieces["a"].spread.copy_advice("spread_a", region, a_3, row + 1)
        pieces["b"].spread.copy_advice("spread_b", region, a_5, row)
        pieces["c_lo"].spread.copy_advice("spread_c_lo", region, a_3,
                                          row - 1)
        pieces["c_mid"].spread.copy_advice("spread_c_mid", region, a_4,
                                           row - 1)
        pieces["c_hi"].spread.copy_advice("spread_c_hi", region, a_4,
                                          row + 1)
        pieces["d"].spread.copy_advice("spread_d", region, a_4, row)
        r = (pieces["a"].dense.value.zip(pieces["b"].dense.value)
             .zip(pieces["c_lo"].dense.value)
             .zip(pieces["c_mid"].dense.value)
             .zip(pieces["c_hi"].dense.value)
             .zip(pieces["d"].dense.value)
             .map(lambda t: self._abcd_xor_sigma(
                 (t[0][0][0][0][0], t[0][0][0][0][1], t[0][0][0][1],
                  t[0][0][1], t[0][1], t[1]))))
        r0e, r0o, r1e, r1o = _split_even_odd(r)
        return _assign_sigma_outputs(region, self.lookup, a_3, row,
                                     r0e, r0o, r1e, r1o)

    def assign_upper_sigma_1(self, region, round_idx, pieces):
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5 = self.message_schedule
        row = get_upper_sigma_1_row(round_idx)
        region.enable_selector("s_us1", self.s_upper_sigma_1, row)
        pieces["a_lo"].spread.copy_advice("spread_a_lo", region, a_3,
                                          row + 1)
        pieces["a_hi"].spread.copy_advice("spread_a_hi", region, a_4,
                                          row + 1)
        pieces["b_lo"].spread.copy_advice("spread_b_lo", region, a_3,
                                          row - 1)
        pieces["b_hi"].spread.copy_advice("spread_b_hi", region, a_4,
                                          row - 1)
        pieces["c"].spread.copy_advice("spread_c", region, a_5, row)
        pieces["d"].spread.copy_advice("spread_d", region, a_4, row)
        r = (pieces["a_lo"].dense.value.zip(pieces["a_hi"].dense.value)
             .zip(pieces["b_lo"].dense.value)
             .zip(pieces["b_hi"].dense.value)
             .zip(pieces["c"].dense.value)
             .zip(pieces["d"].dense.value)
             .map(lambda t: self._efgh_xor_sigma(
                 (t[0][0][0][0][0], t[0][0][0][0][1], t[0][0][0][1],
                  t[0][0][1], t[0][1], t[1]))))
        r0e, r0o, r1e, r1o = _split_even_odd(r)
        return _assign_sigma_outputs(region, self.lookup, a_3, row,
                                     r0e, r0o, r1e, r1o)

    def _assign_ch_outputs(self, region, row, p0e, p0o, p1e, p1o):
        a_3 = self.extras[0]
        _even, odd = _assign_spread_outputs(
            region, self.lookup, a_3, row, p0e, p0o, p1e, p1o)
        return odd

    def assign_ch(self, region, round_idx, spread_e: RoundWordSpread,
                  spread_f: RoundWordSpread):
        a_3, a_4 = self.extras[0], self.extras[1]
        row = get_ch_row(round_idx)
        region.enable_selector("s_ch", self.s_ch, row)
        spread_e.lo.copy_advice("spread_e_lo", region, a_3, row - 1)
        spread_e.hi.copy_advice("spread_e_hi", region, a_4, row - 1)
        spread_f.lo.copy_advice("spread_f_lo", region, a_3, row + 1)
        spread_f.hi.copy_advice("spread_f_hi", region, a_4, row + 1)
        p = spread_e.value().zip(spread_f.value()).map(
            lambda t: t[0] + t[1])
        p0 = p.map(lambda v: v & 0xFFFFFFFF)
        p1 = p.map(lambda v: (v >> 32) & 0xFFFFFFFF)
        return self._assign_ch_outputs(
            region, row,
            p0.map(lambda v: even_bits_int(v, 16)),
            p0.map(lambda v: odd_bits_int(v, 16)),
            p1.map(lambda v: even_bits_int(v, 16)),
            p1.map(lambda v: odd_bits_int(v, 16)))

    def assign_ch_neg(self, region, round_idx,
                      spread_e: RoundWordSpread,
                      spread_g: RoundWordSpread):
        row = get_ch_neg_row(round_idx)
        region.enable_selector("s_ch_neg", self.s_ch_neg, row)
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5 = self.message_schedule
        spread_e.lo.copy_advice("spread_e_lo", region, a_5, row - 1)
        spread_e.hi.copy_advice("spread_e_hi", region, a_5, row)
        spread_g.lo.copy_advice("spread_g_lo", region, a_3, row + 1)
        spread_g.hi.copy_advice("spread_g_hi", region, a_4, row + 1)
        neg_lo = spread_e.lo.value.map(
            lambda v: negate_spread_int(v, 32))
        region.assign_advice("spread_neg_e_lo", a_3, row - 1,
                             lambda: neg_lo)
        neg_hi = spread_e.hi.value.map(
            lambda v: negate_spread_int(v, 32))
        region.assign_advice("spread_neg_e_hi", a_4, row - 1,
                             lambda: neg_hi)
        p = (neg_lo.zip(neg_hi).zip(spread_g.value())
             .map(lambda t: t[0][0] + (t[0][1] << 32) + t[1]))
        p0 = p.map(lambda v: v & 0xFFFFFFFF)
        p1 = p.map(lambda v: (v >> 32) & 0xFFFFFFFF)
        return self._assign_ch_outputs(
            region, row,
            p0.map(lambda v: even_bits_int(v, 16)),
            p0.map(lambda v: odd_bits_int(v, 16)),
            p1.map(lambda v: even_bits_int(v, 16)),
            p1.map(lambda v: odd_bits_int(v, 16)))

    def assign_maj(self, region, round_idx, spread_a, spread_b,
                   spread_c):
        a_4, a_5 = self.extras[1], self.message_schedule
        row = get_maj_row(round_idx)
        region.enable_selector("s_maj", self.s_maj, row)
        spread_a.lo.copy_advice("spread_a_lo", region, a_4, row - 1)
        spread_a.hi.copy_advice("spread_a_hi", region, a_5, row - 1)
        spread_b.lo.copy_advice("spread_b_lo", region, a_4, row)
        spread_b.hi.copy_advice("spread_b_hi", region, a_5, row)
        spread_c.lo.copy_advice("spread_c_lo", region, a_4, row + 1)
        spread_c.hi.copy_advice("spread_c_hi", region, a_5, row + 1)
        m = (spread_a.value().zip(spread_b.value())
             .zip(spread_c.value()).map(lambda t: t[0][0] + t[0][1]
                                        + t[1]))
        m0 = m.map(lambda v: v & 0xFFFFFFFF)
        m1 = m.map(lambda v: (v >> 32) & 0xFFFFFFFF)
        a_3 = self.extras[0]
        _even, odd = _assign_spread_outputs(
            region, self.lookup, a_3, row,
            m0.map(lambda v: even_bits_int(v, 16)),
            m0.map(lambda v: odd_bits_int(v, 16)),
            m1.map(lambda v: even_bits_int(v, 16)),
            m1.map(lambda v: odd_bits_int(v, 16)))
        return odd

    def assign_h_prime(self, region, round_idx, h: RoundWordDense, ch,
                       ch_neg, sigma_1, k: int, w):
        row = get_h_prime_row(round_idx)
        region.enable_selector("s_h_prime", self.s_h_prime, row)
        a_4, a_5 = self.extras[1], self.message_schedule
        a_6, a_7 = self.extras[2], self.extras[3]
        a_8, a_9 = self.extras[4], self.extras[5]
        h.lo.copy_advice("h_lo", region, a_7, row - 1)
        h.hi.copy_advice("h_hi", region, a_7, row)
        sigma_1[0].copy_advice("sigma_1_lo", region, a_4, row)
        sigma_1[1].copy_advice("sigma_1_hi", region, a_5, row)
        k_lo, k_hi = k & 0xFFFF, (k >> 16) & 0xFFFF
        region.assign_advice("k_lo", a_6, row - 1,
                             lambda: Value.known(k_lo))
        region.assign_advice("k_hi", a_6, row,
                             lambda: Value.known(k_hi))
        w[0].copy_advice("w_lo", region, a_8, row - 1)
        w[1].copy_advice("w_hi", region, a_8, row)
        ch[1].copy_advice("ch_hi", region, a_6, row + 1)
        ch_neg[0].copy_advice("ch_neg_lo", region, a_5, row - 1)
        ch_neg[1].copy_advice("ch_neg_hi", region, a_5, row + 1)
        h_prime, carry = sum_with_carry([
            (h.lo.value, h.hi.value),
            (ch[0].value, ch[1].value),
            (ch_neg[0].value, ch_neg[1].value),
            (sigma_1[0].value, sigma_1[1].value),
            (Value.known(k_lo), Value.known(k_hi)),
            (w[0].value, w[1].value)])
        region.assign_advice("h_prime_carry", a_9, row + 1,
                             lambda: carry)
        hp_lo = region.assign_advice(
            "h_prime_lo", a_7, row + 1,
            lambda: h_prime.map(lambda v: v & 0xFFFF))
        hp_hi = region.assign_advice(
            "h_prime_hi", a_8, row + 1,
            lambda: h_prime.map(lambda v: (v >> 16) & 0xFFFF))
        return RoundWordDense(hp_lo, hp_hi)

    def assign_e_new(self, region, round_idx, d: RoundWordDense,
                     h_prime: RoundWordDense) -> RoundWordDense:
        row = get_e_new_row(round_idx)
        region.enable_selector("s_e_new", self.s_e_new, row)
        a_7, a_8, a_9 = self.extras[3], self.extras[4], self.extras[5]
        d.lo.copy_advice("d_lo", region, a_7, row)
        d.hi.copy_advice("d_hi", region, a_7, row + 1)
        e_new, carry = sum_with_carry([
            (h_prime.lo.value, h_prime.hi.value),
            (d.lo.value, d.hi.value)])
        dense = self.assign_word_halves_dense(region, row, a_8,
                                              row + 1, a_8, e_new)
        region.assign_advice("e_new_carry", a_9, row + 1,
                             lambda: carry)
        return dense

    def assign_a_new(self, region, round_idx, maj, sigma_0,
                     h_prime: RoundWordDense) -> RoundWordDense:
        row = get_a_new_row(round_idx)
        region.enable_selector("s_a_new", self.s_a_new, row)
        a_3, a_6 = self.extras[0], self.extras[2]
        a_7, a_8, a_9 = self.extras[3], self.extras[4], self.extras[5]
        maj[1].copy_advice("maj_1_hi", region, a_3, row - 1)
        sigma_0[0].copy_advice("sigma_0_lo", region, a_6, row)
        sigma_0[1].copy_advice("sigma_0_hi", region, a_6, row + 1)
        h_prime.lo.copy_advice("h_prime_lo", region, a_7, row - 1)
        h_prime.hi.copy_advice("h_prime_hi", region, a_8, row - 1)
        a_new, carry = sum_with_carry([
            (h_prime.lo.value, h_prime.hi.value),
            (sigma_0[0].value, sigma_0[1].value),
            (maj[0].value, maj[1].value)])
        dense = self.assign_word_halves_dense(region, row, a_8,
                                              row + 1, a_8, a_new)
        region.assign_advice("a_new_carry", a_9, row,
                             lambda: carry)
        return dense

    # ---- subregion: initial ----
    def _initialize(self, region, vals):
        """subregion_initial.rs initialize_{iv,state} common body;
        vals: dict of Value[u32] per state letter."""
        a_7 = self.extras[3]
        e = self.decompose_e(region, INIT, vals["e"])
        f_row = get_decompose_f_row()
        f_dense, f_spread = self.assign_word_halves(region, f_row,
                                                    vals["f"])
        self.decompose_efgh(region, f_row, vals["f"])
        f = RoundWord(f_dense, f_spread)
        g_row = get_decompose_g_row()
        g_dense, g_spread = self.assign_word_halves(region, g_row,
                                                    vals["g"])
        self.decompose_efgh(region, g_row, vals["g"])
        g = RoundWord(g_dense, g_spread)
        h_row = get_h_row(INIT)
        h = self.assign_word_halves_dense(region, h_row, a_7,
                                          h_row + 1, a_7, vals["h"])
        a = self.decompose_a(region, INIT, vals["a"])
        b_row = get_decompose_b_row()
        b_dense, b_spread = self.assign_word_halves(region, b_row,
                                                    vals["b"])
        self.decompose_abcd(region, b_row, vals["b"])
        b = RoundWord(b_dense, b_spread)
        c_row = get_decompose_c_row()
        c_dense, c_spread = self.assign_word_halves(region, c_row,
                                                    vals["c"])
        self.decompose_abcd(region, c_row, vals["c"])
        c = RoundWord(c_dense, c_spread)
        d_row = get_d_row(INIT)
        d = self.assign_word_halves_dense(region, d_row, a_7,
                                          d_row + 1, a_7, vals["d"])
        return State(a, b, c, d, e, f, g, h)

    def initialize_with_iv(self, layouter, iv):
        out = {}

        def region_fn(region):
            out["s"] = self._initialize(
                region, {k: Value.known(v) for k, v in
                         zip("abcdefgh", iv)})

        layouter.assign_region("initialize_with_iv", region_fn)
        return out["s"]

    def initialize_with_state(self, layouter, state: State):
        out = {}
        vals = {"a": state.a.dense_halves.value(),
                "b": state.b.dense_halves.value(),
                "c": state.c.dense_halves.value(),
                "d": state.d.value(),
                "e": state.e.dense_halves.value(),
                "f": state.f.dense_halves.value(),
                "g": state.g.dense_halves.value(),
                "h": state.h.value()}

        def region_fn(region):
            out["s"] = self._initialize(region, vals)

        layouter.assign_region("initialize_with_state", region_fn)
        return out["s"]

    # ---- subregion: main rounds ----
    def assign_round(self, region, round_idx, state: State,
                     schedule_word) -> State:
        """subregion_main.rs."""
        a_3, a_4, a_7 = (self.extras[0], self.extras[1],
                         self.extras[3])
        a, b, c, d = state.a, state.b, state.c, state.d
        e, f, g, h = state.e, state.f, state.g, state.h

        sigma_1 = self.assign_upper_sigma_1(region, round_idx, e.pieces)
        ch = self.assign_ch(region, round_idx, e.spread_halves,
                            f.spread_halves)
        ch_neg = self.assign_ch_neg(region, round_idx, e.spread_halves,
                                    g.spread_halves)
        sigma_0 = self.assign_upper_sigma_0(region, round_idx, a.pieces)
        maj = self.assign_maj(region, round_idx, a.spread_halves,
                              b.spread_halves, c.spread_halves)
        h_prime = self.assign_h_prime(region, round_idx, h, ch, ch_neg,
                                      sigma_1,
                                      ROUND_CONSTANTS[round_idx],
                                      schedule_word)
        e_new_dense = self.assign_e_new(region, round_idx, d, h_prime)
        a_new_dense = self.assign_a_new(region, round_idx, maj, sigma_0,
                                        h_prime)

        if round_idx < 63:
            a_new_row = get_decompose_a_row(round_idx + 1)
            a_new_dense.lo.copy_advice("a_new_lo", region, a_7,
                                       a_new_row)
            a_new_dense.hi.copy_advice("a_new_hi", region, a_7,
                                       a_new_row + 1)
            e_new_row = get_decompose_e_row(round_idx + 1)
            e_new_dense.lo.copy_advice("e_new_lo", region, a_7,
                                       e_new_row)
            e_new_dense.hi.copy_advice("e_new_hi", region, a_7,
                                       e_new_row + 1)
            a_new = self.decompose_a(region, round_idx + 1,
                                     a_new_dense.value())
            e_new = self.decompose_e(region, round_idx + 1,
                                     e_new_dense.value())
            return State(
                a_new,
                RoundWord(a.dense_halves, a.spread_halves),
                b, c.dense_halves,
                e_new,
                RoundWord(e.dense_halves, e.spread_halves),
                f, g.dense_halves)
        abcd_row = get_digest_abcd_row()
        efgh_row = get_digest_efgh_row()
        a_final = self.assign_word_halves_dense(
            region, abcd_row, a_3, abcd_row, a_4, a_new_dense.value())
        e_final = self.assign_word_halves_dense(
            region, efgh_row, a_3, efgh_row, a_4, e_new_dense.value())
        return State(
            RoundWordA(None, a_final, None),
            RoundWord(a.dense_halves, a.spread_halves),
            b, c.dense_halves,
            RoundWordE(None, e_final, None),
            RoundWord(e.dense_halves, e.spread_halves),
            f, g.dense_halves)

    def compress(self, layouter, initialized_state: State, w_halves):
        out = {}

        def region_fn(region):
            state = initialized_state
            for idx, wh in enumerate(w_halves):
                state = self.assign_round(region, idx, state,
                                          (wh[0], wh[1]))
            out["s"] = state

        layouter.assign_region("compress", region_fn)
        return out["s"]

    # ---- subregion: digest ----
    def _assign_digest_word(self, region, row, lo_col, hi_col,
                            word_col, dense: RoundWordDense) -> Value:
        dense.lo.copy_advice("lo", region, lo_col, row)
        dense.hi.copy_advice("hi", region, hi_col, row)
        val = dense.value()
        region.assign_advice("word", word_col, row, lambda: val)
        return val

    def digest(self, layouter, state: State):
        out = {}
        a_3, a_4 = self.extras[0], self.extras[1]
        a_5, a_6 = self.message_schedule, self.extras[2]
        a_7, a_8 = self.extras[3], self.extras[4]

        def region_fn(region):
            a, b, c, d = state.a, state.b, state.c, state.d
            e, f, g, h = state.e, state.f, state.g, state.h
            abcd_row = 0
            region.enable_selector("s_digest", self.s_digest, abcd_row)
            efgh_row = abcd_row + 2
            region.enable_selector("s_digest", self.s_digest, efgh_row)
            a.dense_halves.lo.copy_advice("a_lo", region, a_3, abcd_row)
            a.dense_halves.hi.copy_advice("a_hi", region, a_4, abcd_row)
            a_val = a.dense_halves.value()
            region.assign_advice("a", a_5, abcd_row, lambda: a_val)
            b_val = self._assign_digest_word(region, abcd_row, a_6, a_7,
                                             a_8, b.dense_halves)
            c_val = self._assign_digest_word(region, abcd_row + 1, a_3,
                                             a_4, a_5, c.dense_halves)
            d_val = self._assign_digest_word(region, abcd_row + 1, a_6,
                                             a_7, a_8, d)
            e.dense_halves.lo.copy_advice("e_lo", region, a_3, efgh_row)
            e.dense_halves.hi.copy_advice("e_hi", region, a_4, efgh_row)
            e_val = e.dense_halves.value()
            region.assign_advice("e", a_5, efgh_row, lambda: e_val)
            f_val = self._assign_digest_word(region, efgh_row, a_6, a_7,
                                             a_8, f.dense_halves)
            g_val = self._assign_digest_word(region, efgh_row + 1, a_3,
                                             a_4, a_5, g.dense_halves)
            h_val = self._assign_digest_word(region, efgh_row + 1, a_6,
                                             a_7, a_8, h)
            out["digest"] = [BlockWord(v) for v in
                             (a_val, b_val, c_val, d_val, e_val, f_val,
                              g_val, h_val)]

        layouter.assign_region("digest", region_fn)
        return out["digest"]


# ------------------------------------------------------ Table16 chip
@dataclass
class Table16Config:
    lookup: SpreadTableConfig
    message_schedule: MessageScheduleConfig
    compression: CompressionConfig


class Table16Chip(Chip, Sha256Instructions):
    """table16.rs:240-380."""

    def __init__(self, config: Table16Config):
        self._config = config

    def config(self):
        return self._config

    @staticmethod
    def configure(meta) -> Table16Config:
        message_schedule = meta.advice_column()
        extras = [meta.advice_column() for _ in range(6)]
        input_tag = meta.advice_column()
        input_dense = meta.advice_column()
        input_spread = meta.advice_column()

        lookup = SpreadTableChip.configure(meta, input_tag, input_dense,
                                           input_spread)
        lookup_inputs = lookup.input

        a_1, a_2 = lookup_inputs.dense, lookup_inputs.spread
        a_3, a_4 = extras[0], extras[1]
        a_5 = message_schedule
        a_6, a_7, a_8 = extras[2], extras[3], extras[4]
        for column in (a_1, a_2, a_3, a_4, a_5, a_6, a_7, a_8):
            meta.enable_equality(column)

        compression = CompressionConfig(meta, lookup_inputs,
                                        message_schedule, extras)
        msg_schedule = MessageScheduleConfig(meta, lookup_inputs,
                                             message_schedule, extras)
        return Table16Config(lookup=lookup,
                             message_schedule=msg_schedule,
                             compression=compression)

    @staticmethod
    def load(config: Table16Config, layouter):
        SpreadTableChip.load(config.lookup, layouter)

    # ---- Sha256Instructions ----
    def initialization_vector(self, layouter):
        return self._config.compression.initialize_with_iv(layouter, IV)

    def initialization(self, layouter, init_state):
        return self._config.compression.initialize_with_state(
            layouter, init_state)

    def compress(self, layouter, initialized_state, input_words):
        assert len(input_words) == BLOCK_SIZE
        _, w_halves = self._config.message_schedule.process(
            layouter, input_words)
        return self._config.compression.compress(
            layouter, initialized_state, w_halves)

    def digest(self, layouter, state):
        return self._config.compression.digest(layouter, state)
