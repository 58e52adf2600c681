"""Pow5 chip: in-circuit Poseidon permutation with an x^5 S-box.

Reference: halo2_gadgets/src/poseidon/pow5.rs — WIDTH state advice
columns + one partial_sbox helper column + two WIDTH-wide round-constant
fixed column sets (rc_a / rc_b), selectors s_full / s_partial /
s_pad_and_add (pow5.rs:21-95); one full round per row, TWO partial rounds
fused per row (pow5.rs:116-161); sponge padding loaded through rc_b as
scratch (pow5.rs:77-80, 343-372).

Copied from halo2_tpu/gadgets/poseidon/pow5.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...fields.host import FieldSpec
from ...circuit.value import Value
from ...circuit.layouter import Chip, AssignedCell
from ...poly.polynomial import Rotation
from .primitive import Spec, ConstantLength, generate_constants


@dataclass
class Pow5Config:
    state: list          # WIDTH advice columns
    partial_sbox: object
    rc_a: list           # WIDTH fixed columns
    rc_b: list
    s_full: object
    s_partial: object
    s_pad_and_add: object
    half_full_rounds: int
    half_partial_rounds: int
    round_constants: list
    m_reg: list
    width: int
    rate: int
    field: FieldSpec


class Pow5Chip(Chip):
    def __init__(self, config: Pow5Config):
        self._config = config

    def config(self):
        return self._config

    @staticmethod
    def configure(meta, spec: Spec, field: FieldSpec, state, partial_sbox,
                  rc_a, rc_b) -> Pow5Config:
        width = spec.t
        rate = spec.rate
        assert rate == width - 1
        assert spec.full_rounds() % 2 == 0
        assert spec.partial_rounds() % 2 == 0
        round_constants, m_reg, m_inv = generate_constants(field, spec)

        for column in list(state) + list(rc_b):
            meta.enable_equality(column)

        s_full = meta.selector()
        s_partial = meta.selector()
        s_pad_and_add = meta.selector()

        def pow_5(v):
            v2 = v * v
            return v2 * v2 * v

        def full_round(cells):
            s = cells.query_selector(s_full)
            constraints = []
            cur = [cells.query_advice(state[i], Rotation(0))
                   for i in range(width)]
            rca = [cells.query_fixed(rc_a[i]) for i in range(width)]
            for next_idx in range(width):
                nxt = cells.query_advice(state[next_idx], Rotation(1))
                expr = None
                for idx in range(width):
                    term = pow_5(cur[idx] + rca[idx]) * m_reg[next_idx][idx]
                    expr = term if expr is None else expr + term
                constraints.append(("full", s * (expr - nxt)))
            return constraints

        meta.create_gate("full round", full_round)

        def partial_rounds(cells):
            s = cells.query_selector(s_partial)
            cur = [cells.query_advice(state[i], Rotation(0))
                   for i in range(width)]
            mid_0 = cells.query_advice(partial_sbox, Rotation(0))
            rca = [cells.query_fixed(rc_a[i]) for i in range(width)]
            rcb = [cells.query_fixed(rc_b[i]) for i in range(width)]
            nxt = [cells.query_advice(state[i], Rotation(1))
                   for i in range(width)]

            def mid(idx):
                acc = mid_0 * m_reg[idx][0]
                for cur_idx in range(1, width):
                    acc = acc + (cur[cur_idx] + rca[cur_idx]) \
                        * m_reg[idx][cur_idx]
                return acc

            def nxt_comb(idx):
                acc = None
                for next_idx in range(width):
                    term = nxt[next_idx] * m_inv[idx][next_idx]
                    acc = term if acc is None else acc + term
                return acc

            constraints = [("sbox-a", s * (pow_5(cur[0] + rca[0]) - mid_0)),
                           ("sbox-b", s * (pow_5(mid(0) + rcb[0])
                                           - nxt_comb(0)))]
            for idx in range(1, width):
                constraints.append(
                    (f"lin-{idx}",
                     s * (mid(idx) + rcb[idx] - nxt_comb(idx))))
            return constraints

        meta.create_gate("partial rounds", partial_rounds)

        def pad_and_add(cells):
            s = cells.query_selector(s_pad_and_add)
            constraints = []
            for idx in range(rate):
                initial = cells.query_advice(state[idx], Rotation(-1))
                inp = cells.query_advice(state[idx], Rotation(0))
                output = cells.query_advice(state[idx], Rotation(1))
                constraints.append(
                    (f"pad-{idx}", s * (initial + inp - output)))
            init_rate = cells.query_advice(state[rate], Rotation(-1))
            out_rate = cells.query_advice(state[rate], Rotation(1))
            constraints.append(("cap", s * (init_rate - out_rate)))
            return constraints

        meta.create_gate("pad-and-add", pad_and_add)

        return Pow5Config(
            state=list(state), partial_sbox=partial_sbox, rc_a=list(rc_a),
            rc_b=list(rc_b), s_full=s_full, s_partial=s_partial,
            s_pad_and_add=s_pad_and_add,
            half_full_rounds=spec.full_rounds() // 2,
            half_partial_rounds=spec.partial_rounds() // 2,
            round_constants=round_constants, m_reg=m_reg,
            width=width, rate=rate, field=field)

    # ------------- PoseidonInstructions -------------
    def permute(self, layouter, initial_state: list[AssignedCell]
                ) -> list[AssignedCell]:
        cfg = self._config
        f = cfg.field
        width = cfg.width

        def region_fn(region):
            # load initial state (copy into row 0)
            state = [initial_state[i].copy_advice(
                f"load state_{i}", region, cfg.state[i], 0)
                for i in range(width)]

            offset = 0
            rnd = 0
            # first half full rounds
            for _ in range(cfg.half_full_rounds):
                state = self._full_round(region, state, rnd, offset)
                rnd += 1
                offset += 1
            for _ in range(cfg.half_partial_rounds):
                state = self._partial_round(region, state, rnd, offset)
                rnd += 2
                offset += 1
            for _ in range(cfg.half_full_rounds):
                state = self._full_round(region, state, rnd, offset)
                rnd += 1
                offset += 1
            return state

        return layouter.assign_region("permute state", region_fn)

    def _load_rc(self, region, columns, rcs, offset):
        for i, (col, rc) in enumerate(zip(columns, rcs)):
            region.assign_fixed(f"rc_{i}", col, offset,
                                lambda rc=rc: Value.known(rc))

    def _full_round(self, region, state, rnd, offset):
        cfg = self._config
        f = cfg.field
        p = f.modulus
        region.enable_selector("s_full", cfg.s_full, offset)
        self._load_rc(region, cfg.rc_a, cfg.round_constants[rnd], offset)

        vals = [w.value for w in state]
        if all(v.is_known() for v in vals):
            r = [pow((v.inner() + rc) % p, 5, p)
                 for v, rc in zip(vals, cfg.round_constants[rnd])]
            new = [sum(cfg.m_reg[i][j] * r[j] for j in range(cfg.width)) % p
                   for i in range(cfg.width)]
            new_vals = [Value.known(v) for v in new]
        else:
            new_vals = [Value.unknown()] * cfg.width
        return [region.assign_advice(f"state_{i}", cfg.state[i], offset + 1,
                                     lambda v=new_vals[i]: v)
                for i in range(cfg.width)]

    def _partial_round(self, region, state, rnd, offset):
        cfg = self._config
        f = cfg.field
        p = f.modulus
        width = cfg.width
        region.enable_selector("s_partial", cfg.s_partial, offset)
        self._load_rc(region, cfg.rc_a, cfg.round_constants[rnd], offset)
        self._load_rc(region, cfg.rc_b, cfg.round_constants[rnd + 1], offset)

        vals = [w.value for w in state]
        if all(v.is_known() for v in vals):
            pvals = [v.inner() for v in vals]
            r = [pow((pvals[0] + cfg.round_constants[rnd][0]) % p, 5, p)]
            r += [(pvals[i] + cfg.round_constants[rnd][i]) % p
                  for i in range(1, width)]
            region.assign_advice("partial_sbox", cfg.partial_sbox, offset,
                                 lambda: Value.known(r[0]))
            p_mid = [sum(cfg.m_reg[i][j] * r[j] for j in range(width)) % p
                     for i in range(width)]
            r_mid = [pow((p_mid[0] + cfg.round_constants[rnd + 1][0]) % p,
                         5, p)]
            r_mid += [(p_mid[i] + cfg.round_constants[rnd + 1][i]) % p
                      for i in range(1, width)]
            new = [sum(cfg.m_reg[i][j] * r_mid[j] for j in range(width)) % p
                   for i in range(width)]
            new_vals = [Value.known(v) for v in new]
        else:
            region.assign_advice("partial_sbox", cfg.partial_sbox, offset,
                                 lambda: Value.unknown())
            new_vals = [Value.unknown()] * width
        return [region.assign_advice(f"state_{i}", cfg.state[i], offset + 1,
                                     lambda v=new_vals[i]: v)
                for i in range(width)]

    # ------------- PoseidonSpongeInstructions -------------
    def initial_state(self, layouter, domain: ConstantLength
                      ) -> list[AssignedCell]:
        cfg = self._config

        def region_fn(region):
            state = []
            for i in range(cfg.rate):
                state.append(region.assign_advice_from_constant(
                    f"state_{i}", cfg.state[i], 0, 0))
            state.append(region.assign_advice_from_constant(
                f"state_{cfg.rate}", cfg.state[cfg.rate], 0,
                domain.initial_capacity_element() % cfg.field.modulus))
            return state

        return layouter.assign_region(
            f"initial state for domain ConstantLength<{domain.length}>",
            region_fn)

    def add_input(self, layouter, initial_state: list[AssignedCell],
                  input_words) -> list[AssignedCell]:
        """input_words: list of RATE entries, each either an AssignedCell
        ("message") or an int ("padding")."""
        cfg = self._config
        f = cfg.field
        width, rate = cfg.width, cfg.rate

        def region_fn(region):
            region.enable_selector("s_pad", cfg.s_pad_and_add, 1)
            init = [initial_state[i].copy_advice(
                f"load state_{i}", region, cfg.state[i], 0)
                for i in range(width)]

            inputs = []
            for i, word in enumerate(input_words):
                if isinstance(word, AssignedCell):
                    var = region.assign_advice(
                        f"load input_{i}", cfg.state[i], 1,
                        lambda w=word: w.value)
                    region.constrain_equal(word.cell, var.cell)
                else:
                    pad_cell = region.assign_fixed(
                        f"load pad_{i}", cfg.rc_b[i], 1,
                        lambda w=word: Value.known(w))
                    var = region.assign_advice(
                        f"load input_{i}", cfg.state[i], 1,
                        lambda w=word: Value.known(w))
                    region.constrain_equal(pad_cell, var.cell)
                inputs.append(var)

            out = []
            for i in range(width):
                if i < rate:
                    val = init[i].value.add(inputs[i].value, f)
                else:
                    val = init[i].value
                out.append(region.assign_advice(
                    f"load output_{i}", cfg.state[i], 2, lambda v=val: v))
            return out

        return layouter.assign_region("add input", region_fn)


def poseidon_hash_gadget(chip: Pow5Chip, layouter, message: list[AssignedCell]
                         ) -> AssignedCell:
    """Hash<ConstantLength<L>> gadget (halo2_gadgets/src/poseidon.rs
    Sponge/Hash): absorb message (+ zero padding) rate-wise, permute,
    squeeze state[0]."""
    cfg = chip.config()
    domain = ConstantLength(len(message))
    padding = domain.padding(cfg.rate)
    words: list = list(message) + list(padding)
    state = chip.initial_state(layouter, domain)
    for chunk_start in range(0, len(words), cfg.rate):
        chunk = words[chunk_start:chunk_start + cfg.rate]
        state = chip.add_input(layouter, state, chunk)
        state = chip.permute(layouter, state)
    return state[0]
