"""SHA-256 chip: bit-decomposition design.

Implements `Sha256Instructions` with a direct boolean-decomposition
constraint system:

  - every 32-bit word is a field cell linked to 32 boolean bit cells by a
    recomposition gate (word = Σ 2^i b_i, bits boolean-checked);
  - rotations/shifts are free (copy constraints re-wire bit cells);
  - Ch / Maj / Σ / σ are per-bit algebraic gates over aligned bit columns:
      xor3(a,b,c) = a+b+c − 2(ab+bc+ca) + 4abc
      maj(a,b,c)  = ab+bc+ca − 2abc
      ch(e,f,g)   = e·f + (1−e)·g
  - additions mod 2^32 recompose through a carry cell with its own small
    decomposition.

The reference's Table16 chip (halo2_gadgets/src/sha256/table16/, spread
16-bit lookup tables, fused message-schedule/compression regions) is a
row-count optimization of the same function; it is tracked in PARITY.md.
This chip is sound, complete, and verified against the FIPS 180-4 host
primitive.

Copied from halo2_tpu/gadgets/sha256/chip.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...fields.host import FieldSpec, FQ
from ...poly.polynomial import Rotation
from ...plonk.circuit import Constant
from ...circuit.value import Value
from ...circuit.layouter import Chip, AssignedCell
from . import (Sha256Instructions, BlockWord, IV, ROUND_CONSTANTS,
               compress_host, _rotr)

NBITS = 32
BIT_COLS = 8          # bit cells per row -> 4 rows per word
BIT_ROWS = NBITS // BIT_COLS


@dataclass
class Word:
    """A 32-bit word: the field cell + its 32 bit cells (LSB first)."""
    cell: AssignedCell
    bits: list[AssignedCell]

    def value_u32(self) -> Value:
        return self.cell.value


@dataclass
class Sha256Config:
    word: object            # advice: word value / sums / carries
    bit_cols: list          # BIT_COLS advice columns of bit cells
    out_cols: list          # BIT_COLS advice columns for bitwise outputs
    aux_cols: list          # BIT_COLS advice (third operand)
    q_decompose: object     # word = sum 2^i bits (over BIT_ROWS rows)
    q_xor3: object
    q_maj: object
    q_ch: object
    q_add: object           # sum-with-carry gate
    n_add: int              # max addends supported by q_add
    field: FieldSpec


class Sha256Chip(Chip, Sha256Instructions):
    def __init__(self, config: Sha256Config):
        self._config = config

    def config(self):
        return self._config

    @staticmethod
    def configure(meta, field: FieldSpec = FQ) -> Sha256Config:
        word = meta.advice_column()
        bit_cols = [meta.advice_column() for _ in range(BIT_COLS)]
        out_cols = [meta.advice_column() for _ in range(BIT_COLS)]
        aux_cols = [meta.advice_column() for _ in range(BIT_COLS)]
        for c in [word] + bit_cols + out_cols + aux_cols:
            meta.enable_equality(c)

        q_decompose = meta.selector()
        q_xor3 = meta.selector()
        q_maj = meta.selector()
        q_ch = meta.selector()
        q_add = meta.selector()

        def decompose_gate(cells):
            """Row r of BIT_ROWS rows holds bits [r*8, r*8+8); the word
            cell sits on row 0 of the `word` column; bits boolean."""
            q = cells.query_selector(q_decompose)
            w = cells.query_advice(word, Rotation(0))
            acc = None
            constraints = []
            for r in range(BIT_ROWS):
                for c in range(BIT_COLS):
                    b = cells.query_advice(bit_cols[c], Rotation(r))
                    i = r * BIT_COLS + c
                    term = b * (1 << i)
                    acc = term if acc is None else acc + term
                    constraints.append(
                        (f"bool_{i}", q * (b * (Constant(1) - b))))
            constraints.append(("recompose", q * (acc - w)))
            return constraints

        meta.create_gate("sha256 word decompose", decompose_gate)

        def bitwise(qsel, fn, name):
            def gate(cells):
                q = cells.query_selector(qsel)
                constraints = []
                for c in range(BIT_COLS):
                    a = cells.query_advice(bit_cols[c], Rotation(0))
                    b = cells.query_advice(aux_cols[c], Rotation(0))
                    d = cells.query_advice(out_cols[c], Rotation(0))
                    # third operand rides on bit_cols at Rotation(1)
                    e = cells.query_advice(bit_cols[c], Rotation(1))
                    constraints.append((f"{name}_{c}",
                                        q * (fn(a, e, b) - d)))
                return constraints
            return gate

        def xor3(a, b, c):
            ab, bc, ca = a * b, b * c, c * a
            return a + b + c - 2 * (ab + bc + ca) + 4 * (a * (b * c))

        def maj(a, b, c):
            return a * b + b * c + c * a - 2 * (a * (b * c))

        def ch(e, f, g):
            return e * f + (Constant(1) - e) * g

        meta.create_gate("sha256 xor3", bitwise(q_xor3, xor3, "xor3"))
        meta.create_gate("sha256 maj", bitwise(q_maj, maj, "maj"))
        meta.create_gate("sha256 ch", bitwise(q_ch, ch, "ch"))

        # q_add: word[0..n_add rows] are addends; word[n_add] = out word;
        # word[n_add+1] = carry; sum = out + carry * 2^32
        n_add = 7
        def add_gate(cells):
            q = cells.query_selector(q_add)
            s = None
            for i in range(n_add):
                t = cells.query_advice(word, Rotation(i))
                s = t if s is None else s + t
            out = cells.query_advice(word, Rotation(n_add))
            carry = cells.query_advice(word, Rotation(n_add + 1))
            cons = [("sum", q * (s - out - carry * (1 << 32)))]
            # carry < 8 (at most 7 addends): 3-bit range product check
            rc = carry
            for v in range(1, 8):
                rc = rc * (Constant(v) - carry)
            cons.append(("carry_range", q * rc))
            return cons

        meta.create_gate("sha256 add", add_gate)

        return Sha256Config(
            word=word, bit_cols=bit_cols, out_cols=out_cols,
            aux_cols=aux_cols, q_decompose=q_decompose, q_xor3=q_xor3,
            q_maj=q_maj, q_ch=q_ch, q_add=q_add, n_add=n_add, field=field)

    # ---------------- building blocks ----------------
    def witness_word(self, layouter, value: Value, annotation="word"
                     ) -> Word:
        """Witness a word cell + bit cells, linked by the decompose gate."""
        cfg = self._config

        def region_fn(region):
            region.enable_selector("q_dec", cfg.q_decompose, 0)
            w = region.assign_advice(annotation, cfg.word, 0,
                                     lambda: value)
            bits = []
            for i in range(NBITS):
                r, c = divmod(i, BIT_COLS)
                bits.append(region.assign_advice(
                    f"bit{i}", cfg.bit_cols[c], r,
                    lambda i=i: value.map(lambda v: (v >> i) & 1)))
            return Word(cell=w, bits=bits)

        return layouter.assign_region(annotation, region_fn)

    def copy_word_from_cell(self, layouter, cell: AssignedCell) -> Word:
        """Decompose an existing word cell into bits (copy + decompose)."""
        cfg = self._config

        def region_fn(region):
            region.enable_selector("q_dec", cfg.q_decompose, 0)
            w = cell.copy_advice("word", region, cfg.word, 0)
            bits = []
            for i in range(NBITS):
                r, c = divmod(i, BIT_COLS)
                bits.append(region.assign_advice(
                    f"bit{i}", cfg.bit_cols[c], r,
                    lambda i=i: cell.value.map(lambda v: (v >> i) & 1)))
            return Word(cell=w, bits=bits)

        return layouter.assign_region("decompose", region_fn)

    def _bitwise(self, layouter, selector, fn_host, a_bits, b_bits, c_bits,
                 name) -> list[AssignedCell]:
        """Apply a per-bit ternary gate; operands are lists of 32 bit
        cells (already constrained boolean). Returns 32 output bit cells.
        Row layout per chunk c of 8 bits: bit_cols row0 = a, bit_cols
        row1 = b, aux row0 = c, out row0 = result."""
        cfg = self._config

        def region_fn(region):
            out = []
            for r in range(BIT_ROWS):
                region.enable_selector(f"q_{name}_{r}", selector, 2 * r)
                for c in range(BIT_COLS):
                    i = r * BIT_COLS + c
                    a = a_bits[i].copy_advice(f"a{i}", region,
                                              cfg.bit_cols[c], 2 * r)
                    b = b_bits[i].copy_advice(f"b{i}", region,
                                              cfg.bit_cols[c], 2 * r + 1)
                    cc = c_bits[i].copy_advice(f"c{i}", region,
                                               cfg.aux_cols[c], 2 * r)
                    val = a.value.zip(b.value.zip(cc.value)).map(
                        lambda t: fn_host(t[0], t[1][0], t[1][1]))
                    out.append(region.assign_advice(
                        f"out{i}", cfg.out_cols[c], 2 * r,
                        lambda v=val: v))
            return out

        return layouter.assign_region(name, region_fn)

    def xor3_words(self, layouter, a_bits, b_bits, c_bits):
        return self._bitwise(layouter, self._config.q_xor3,
                             lambda a, b, c: a ^ b ^ c,
                             a_bits, b_bits, c_bits, "xor3")

    def maj_words(self, layouter, a_bits, b_bits, c_bits):
        return self._bitwise(layouter, self._config.q_maj,
                             lambda a, b, c: (a & b) ^ (b & c) ^ (c & a),
                             a_bits, b_bits, c_bits, "maj")

    def ch_words(self, layouter, e_bits, f_bits, g_bits):
        # gate computes fn(a, e_rot1, aux) = ch(a, aux?) — wiring: the
        # gate fn is fn(a, b_row1, c_aux); we pass (e, f, g) as
        # (a=e, b=f, c=g) consistent with _bitwise's ordering.
        return self._bitwise(layouter, self._config.q_ch,
                             lambda e, f, g: (e & f) ^ ((~e & 0x1) & g),
                             e_bits, f_bits, g_bits, "ch")

    @staticmethod
    def rotr_bits(bits: list[AssignedCell], n: int) -> list[AssignedCell]:
        """Free rotation: out bit i = in bit (i + n) mod 32."""
        return [bits[(i + n) % NBITS] for i in range(NBITS)]

    def shr_bits(self, layouter, bits: list[AssignedCell], n: int,
                 zero_cell: AssignedCell) -> list[AssignedCell]:
        """Logical shift right: top n bits become the constant-0 cell."""
        return [bits[i + n] if i + n < NBITS else zero_cell
                for i in range(NBITS)]

    def recompose(self, layouter, bits: list[AssignedCell]) -> Word:
        """Bits -> word cell (copy bits into a decompose region)."""
        cfg = self._config

        def region_fn(region):
            region.enable_selector("q_dec", cfg.q_decompose, 0)
            val = bits[0].value
            acc = Value.known(0)
            vals = [b.value for b in bits]
            def compute():
                out = 0
                for i, v in enumerate(vals):
                    if not v.is_known():
                        return Value.unknown()
                    out |= (v.inner() & 1) << i
                return Value.known(out)
            wval = compute()
            w = region.assign_advice("word", cfg.word, 0, lambda: wval)
            new_bits = []
            for i in range(NBITS):
                r, c = divmod(i, BIT_COLS)
                nb = bits[i].copy_advice(f"bit{i}", region,
                                         cfg.bit_cols[c], r)
                new_bits.append(nb)
            return Word(cell=w, bits=new_bits)

        return layouter.assign_region("recompose", region_fn)

    def add_words(self, layouter, word_cells: list[AssignedCell]) -> Word:
        """Sum up to n_add words mod 2^32; output decomposed."""
        cfg = self._config
        f = cfg.field
        assert len(word_cells) <= cfg.n_add

        def region_fn(region):
            region.enable_selector("q_add", cfg.q_add, 0)
            vals = []
            for i in range(cfg.n_add):
                if i < len(word_cells):
                    cell = word_cells[i].copy_advice(
                        f"addend{i}", region, cfg.word, i)
                    vals.append(cell.value)
                else:
                    region.assign_advice(f"zero{i}", cfg.word, i,
                                         lambda: Value.known(0))
                    vals.append(Value.known(0))

            def compute():
                total = 0
                for v in vals:
                    if not v.is_known():
                        return Value.unknown(), Value.unknown()
                    total += v.inner()
                return (Value.known(total & 0xFFFFFFFF),
                        Value.known(total >> 32))

            out_v, carry_v = compute()
            out = region.assign_advice("out", cfg.word, cfg.n_add,
                                       lambda: out_v)
            region.assign_advice("carry", cfg.word, cfg.n_add + 1,
                                 lambda: carry_v)
            return out

        out_cell = layouter.assign_region("add", region_fn)
        return self.copy_word_from_cell(layouter, out_cell)

    def constant_word(self, layouter, value: int) -> Word:
        cfg = self._config

        def region_fn(region):
            region.enable_selector("q_dec", cfg.q_decompose, 0)
            w = region.assign_advice_from_constant("const word", cfg.word,
                                                   0, value & 0xFFFFFFFF)
            bits = []
            for i in range(NBITS):
                r, c = divmod(i, BIT_COLS)
                bits.append(region.assign_advice(
                    f"bit{i}", cfg.bit_cols[c], r,
                    lambda i=i: Value.known((value >> i) & 1)))
            return Word(cell=w, bits=bits)

        return layouter.assign_region("const word", region_fn)

    def zero_bit(self, layouter) -> AssignedCell:
        cfg = self._config

        def region_fn(region):
            return region.assign_advice_from_constant(
                "zero bit", cfg.bit_cols[0], 0, 0)

        return layouter.assign_region("zero bit", region_fn)

    # ---------------- Sha256Instructions ----------------
    def initialization_vector(self, layouter) -> list[Word]:
        return [self.constant_word(layouter, v) for v in IV]

    def initialization(self, layouter, state: list[Word]) -> list[Word]:
        return state

    def _sigma(self, layouter, w: Word, r1, r2, shift_or_r3,
               use_shift: bool, zero) -> list[AssignedCell]:
        a = self.rotr_bits(w.bits, r1)
        b = self.rotr_bits(w.bits, r2)
        if use_shift:
            c = self.shr_bits(layouter, w.bits, shift_or_r3, zero)
        else:
            c = self.rotr_bits(w.bits, shift_or_r3)
        return self.xor3_words(layouter, a, b, c)

    def compress(self, layouter, state: list[Word],
                 input_words: list[BlockWord]) -> list[Word]:
        """One SHA-256 compression round function over 16 input words."""
        cfg = self._config
        zero = self.zero_bit(layouter)

        w = [self.witness_word(layouter, bw.value, f"w{i}")
             for i, bw in enumerate(input_words)]
        for i in range(16, 64):
            s0_bits = self._sigma(layouter, w[i - 15], 7, 18, 3, True,
                                  zero)
            s0 = self.recompose(layouter, s0_bits)
            s1_bits = self._sigma(layouter, w[i - 2], 17, 19, 10, True,
                                  zero)
            s1 = self.recompose(layouter, s1_bits)
            w.append(self.add_words(
                layouter, [w[i - 16].cell, s0.cell, w[i - 7].cell,
                           s1.cell]))

        a, b, c, d, e, f, g, h = state
        for i in range(64):
            S1_bits = self._sigma(layouter, e, 6, 11, 25, False, zero)
            S1 = self.recompose(layouter, S1_bits)
            ch_bits = self.ch_words(layouter, e.bits, f.bits, g.bits)
            ch = self.recompose(layouter, ch_bits)
            k = self.constant_word(layouter, ROUND_CONSTANTS[i])
            t1 = self.add_words(layouter, [h.cell, S1.cell, ch.cell,
                                           k.cell, w[i].cell])
            S0_bits = self._sigma(layouter, a, 2, 13, 22, False, zero)
            S0 = self.recompose(layouter, S0_bits)
            maj_bits = self.maj_words(layouter, a.bits, b.bits, c.bits)
            mj = self.recompose(layouter, maj_bits)
            t2 = self.add_words(layouter, [S0.cell, mj.cell])
            h, g, f = g, f, e
            e = self.add_words(layouter, [d.cell, t1.cell])
            d, c, b = c, b, a
            a = self.add_words(layouter, [t1.cell, t2.cell])

        return [self.add_words(layouter, [x.cell, y.cell])
                for x, y in zip(state, [a, b, c, d, e, f, g, h])]

    def digest(self, layouter, state: list[Word]) -> list[Word]:
        return state
