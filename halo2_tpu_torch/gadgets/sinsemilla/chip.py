"""Sinsemilla chip: 10-bit lookup-based hash-to-point, 5 advice columns.

Reference: halo2_gadgets/src/sinsemilla/chip.rs (config + gates:
"Initial y_Q" with q_sinsemilla4, "Sinsemilla gate" with the synthetic
selector q_s3 = q_s2·(q_s2 − 1)), chip/generator_table.rs (3-way
(idx, x, y) lookup with default-to-S[0] when q_s1 off), and
chip/hash_to_point.rs (row layout: public-Q init writes fixed y_Q and a
constant x_Q; each word row carries x_a, x_p, z_i, λ1, λ2; q_s2 = 1 on
all but the last row of a piece, 0 between pieces, 2 on the final row;
the final row holds y_a_final in the λ1 column).

Copied from halo2_tpu/gadgets/sinsemilla/chip.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...fields.host import FP
from ...curves.host import PALLAS
from ...poly.polynomial import Rotation
from ...plonk.circuit import Constant
from ...circuit.value import Value
from ...circuit.layouter import Chip, AssignedCell
from ..ecc.chip import EccPoint
from .primitive import K, sinsemilla_s, lebs2ip


@dataclass
class SinsemillaConfig:
    q_sinsemilla1: object
    q_sinsemilla2: object    # fixed column with values {0, 1, 2}
    q_sinsemilla4: object
    fixed_y_q: object
    x_a: object
    x_p: object
    bits: object
    lambda_1: object
    lambda_2: object
    witness_pieces: object
    table_idx: object
    table_x: object
    table_y: object
    field: object
    lookup_config: object = None
    allow_init_from_private_point: bool = False


@dataclass
class MessagePiece:
    cell: AssignedCell
    num_words: int


class SinsemillaChip(Chip):
    def __init__(self, config: SinsemillaConfig):
        self._config = config

    def config(self):
        return self._config

    @staticmethod
    def configure(meta, advices, witness_pieces, fixed_y_q,
                  lookup_columns, field=FP, range_check=None,
                  allow_init_from_private_point: bool = False
                  ) -> SinsemillaConfig:
        """advices: 5 advice columns; lookup_columns: 3 TableColumns;
        range_check: a LookupRangeCheckConfig over lookup_columns[0]
        (chip.rs:170-178 takes it as a parameter and stores it)."""
        # Only the 5 advice columns are equality-enabled here; callers
        # enable witness_pieces themselves (chip.rs:179-182).
        for col in advices:
            meta.enable_equality(col)
        x_a, x_p, bits, lambda_1, lambda_2 = advices
        q_s1 = meta.complex_selector()
        q_s2 = meta.fixed_column()
        q_s4 = meta.selector()
        table_idx, table_x, table_y = lookup_columns

        # DoubleAndAdd helpers — query order and AST shapes mirror
        # ecc/chip/mul/incomplete.rs:30-56 exactly (vk Debug parity).
        def x_r(cells, rot):
            xa = cells.query_advice(x_a, rot)
            xp = cells.query_advice(x_p, rot)
            l1 = cells.query_advice(lambda_1, rot)
            return l1 * l1 - xa - xp

        def Y_A(cells, rot):
            xa = cells.query_advice(x_a, rot)
            l1 = cells.query_advice(lambda_1, rot)
            l2 = cells.query_advice(lambda_2, rot)
            return (l1 + l2) * (xa - x_r(cells, rot))

        def q_s3(cells):
            s2 = cells.query_fixed(q_s2, Rotation(0))
            return s2 * (s2 - Constant(1))

        # 3-way generator-table lookup (generator_table.rs:18-80)
        two_inv = pow(2, field.modulus - 2, field.modulus)
        s0_x, s0_y = sinsemilla_s(0)

        def lookup_fn(cells):
            # generator_table.rs:46-84, with the reference's exact AST:
            # int multiplications are Scaled nodes (Mul<F>).
            qs1 = cells.query_selector(q_s1)
            s2 = cells.query_fixed(q_s2, Rotation(0))
            qs3 = s2 * (s2 - Constant(1))
            q_run = s2 - qs3
            z_cur = cells.query_advice(bits, Rotation(0))
            z_next = cells.query_advice(bits, Rotation(1))
            word = z_cur - q_run * z_next * (1 << K)
            xp = cells.query_advice(x_p, Rotation(0))
            l1 = cells.query_advice(lambda_1, Rotation(0))
            xa = cells.query_advice(x_a, Rotation(0))
            y_p = Y_A(cells, Rotation(0)) * two_inv - (l1 * (xa - xp))
            not_q_s1 = Constant(1) - qs1
            m = qs1 * word
            xp_l = qs1 * xp + not_q_s1 * s0_x
            yp_l = qs1 * y_p + not_q_s1 * s0_y
            return [(m, table_idx), (xp_l, table_x), (yp_l, table_y)]

        meta.lookup("generator table", lookup_fn)

        def init_y_q(cells):
            q4 = cells.query_selector(q_s4)
            if allow_init_from_private_point:
                # y_Q rides in the x_p column on the previous row
                # (chip.rs:225-236)
                y_q = cells.query_advice(x_p, Rotation(-1))
            else:
                y_q = cells.query_fixed(fixed_y_q, Rotation(0))
            return [("init_y_q_check",
                     q4 * (y_q * 2 - Y_A(cells, Rotation(0))))]

        meta.create_gate("Initial y_Q", init_y_q)

        def main_gate(cells):
            qs1 = cells.query_selector(q_s1)
            qs3_e = q_s3(cells)
            l1_next = cells.query_advice(lambda_1, Rotation(1))
            l2_cur = cells.query_advice(lambda_2, Rotation(0))
            xa_cur = cells.query_advice(x_a, Rotation(0))
            xa_next = cells.query_advice(x_a, Rotation(1))
            xr = x_r(cells, Rotation(0))
            ya_cur = Y_A(cells, Rotation(0))
            ya_next = Y_A(cells, Rotation(1))
            secant = l2_cur * l2_cur - (xa_next + xr + xa_cur)
            lhs = l2_cur * 4 * (xa_cur - xa_next)
            rhs = ya_cur * 2 + (Constant(2) - qs3_e) * ya_next \
                + qs3_e * 2 * l1_next
            return [("Secant line", qs1 * secant),
                    ("y check", qs1 * (lhs - rhs))]

        meta.create_gate("Sinsemilla gate", main_gate)

        return SinsemillaConfig(
            q_sinsemilla1=q_s1, q_sinsemilla2=q_s2, q_sinsemilla4=q_s4,
            fixed_y_q=fixed_y_q, x_a=x_a, x_p=x_p, bits=bits,
            lambda_1=lambda_1, lambda_2=lambda_2,
            witness_pieces=witness_pieces, table_idx=table_idx,
            table_x=table_x, table_y=table_y, field=field,
            lookup_config=range_check,
            allow_init_from_private_point=allow_init_from_private_point)

    def load_table(self, layouter) -> None:
        """(idx, x, y) of S[0..2^K) (generator_table.rs load).  With a
        4_5B range-check config, the tag column is loaded too and the
        S[index] rows are duplicated for the tag-4 and tag-5 blocks
        (lookup_range_check.rs:687-780)."""
        cfg = self._config
        from ..utilities.lookup_range_check import LookupRangeCheck45BConfig
        tagged = isinstance(cfg.lookup_config, LookupRangeCheck45BConfig)

        def table_fn(table):
            def row(r, i, x, y, tag):
                table.assign_cell("idx", cfg.table_idx, r,
                                  lambda i=i: Value.known(i))
                table.assign_cell("x", cfg.table_x, r,
                                  lambda x=x: Value.known(x))
                table.assign_cell("y", cfg.table_y, r,
                                  lambda y=y: Value.known(y))
                if tagged:
                    table.assign_cell(
                        "tag", cfg.lookup_config.table_range_check_tag, r,
                        lambda t=tag: Value.known(t))

            for i in range(1 << K):
                x, y = sinsemilla_s(i)
                row(i, i, x, y, 0)
                if tagged and i < (1 << 4):
                    row(i + (1 << K), i, x, y, 4)
                if tagged and i < (1 << 5):
                    row(i + (1 << K) + (1 << 4), i, x, y, 5)

        layouter.assign_table("generator_table", table_fn)

    def witness_message_piece(self, layouter, field_elem: Value,
                              num_words: int) -> MessagePiece:
        cfg = self._config

        def region_fn(region):
            return region.assign_advice("witness message piece",
                                        cfg.witness_pieces, 0,
                                        lambda: field_elem)

        cell = layouter.assign_region("witness message piece", region_fn)
        return MessagePiece(cell=cell, num_words=num_words)

    def _hash_piece(self, region, offset, piece, x_a_val, y_a_val,
                    final_piece):
        """One message piece's word rows (hash_to_point.rs hash_piece)."""
        cfg = self._config
        p = cfg.field.modulus
        n_words = piece.num_words
        for row in range(n_words):
            region.enable_selector("q_s1", cfg.q_sinsemilla1, offset + row)
        for row in range(n_words - 1):
            region.assign_fixed("q_s2=1", cfg.q_sinsemilla2, offset + row,
                                lambda: Value.known(1))
        region.assign_fixed(
            "q_s2 last", cfg.q_sinsemilla2, offset + n_words - 1,
            lambda fp=final_piece: Value.known(2 if fp else 0))

        words = piece.cell.value.map(
            lambda v: [(v >> (K * i)) & ((1 << K) - 1)
                       for i in range(n_words)])

        zs = [piece.cell.copy_advice("z_0", region, cfg.bits, offset)]
        inv2k = pow(1 << K, p - 2, p)
        z_val = piece.cell.value
        for i in range(n_words - 1):
            z_val = z_val.zip(words).map(
                lambda t, i=i: (t[0] - t[1][i]) * inv2k % p)
            zs.append(region.assign_advice(
                f"z_{i+1}", cfg.bits, offset + i + 1, lambda v=z_val: v))

        x_a_cell = None
        for row in range(n_words):
            gen = words.map(lambda w, row=row: sinsemilla_s(w[row]))
            region.assign_advice("x_p", cfg.x_p, offset + row,
                                 lambda g=gen: g.map(lambda t: t[0]))
            lam1 = y_a_val.zip(gen).zip(x_a_val).map(
                lambda t: (t[0][0] - t[0][1][1])
                * pow((t[1] - t[0][1][0]) % p, p - 2, p) % p)
            region.assign_advice("lambda_1", cfg.lambda_1, offset + row,
                                 lambda v=lam1: v)
            x_r_val = lam1.zip(x_a_val.zip(gen)).map(
                lambda t: (t[0] * t[0] - t[1][0] - t[1][1][0]) % p)
            lam2 = y_a_val.zip(x_a_val.zip(x_r_val)).zip(lam1).map(
                lambda t: (2 * t[0][0]
                           * pow((t[0][1][0] - t[0][1][1]) % p,
                                 p - 2, p) - t[1]) % p)
            region.assign_advice("lambda_2", cfg.lambda_2, offset + row,
                                 lambda v=lam2: v)
            x_a_new = lam2.zip(x_a_val.zip(x_r_val)).map(
                lambda t: (t[0] * t[0] - t[1][0] - t[1][1]) % p)
            y_a_new = lam2.zip(x_a_val.zip(x_a_new)).zip(y_a_val).map(
                lambda t: (t[0][0] * (t[0][1][0] - t[0][1][1])
                           - t[1]) % p)
            x_a_cell = region.assign_advice(
                "x_a", cfg.x_a, offset + row + 1, lambda v=x_a_new: v)
            x_a_val = x_a_new
            y_a_val = y_a_new
        return offset + n_words, x_a_val, y_a_val, x_a_cell, zs

    def hash_to_point_with_private_init(self, layouter, Q_point,
                                        pieces: list[MessagePiece]):
        """Private-point initialization (hash_to_point.rs:176-215):
        Q is a witnessed NonIdentity EccPoint; raises
        IllegalHashFromPrivatePoint unless the chip was configured with
        allow_init_from_private_point (error.rs:44)."""
        from ...plonk.error import IllegalHashFromPrivatePoint
        cfg = self._config
        if not cfg.allow_init_from_private_point:
            raise IllegalHashFromPrivatePoint()
        f = cfg.field
        p = f.modulus

        def region_fn(region):
            # | offset | x_A | x_P | q_s4 |
            # |   0    |     | y_Q |      |
            # |   1    | x_Q |     |  1   |
            region.enable_selector("q_s4", cfg.q_sinsemilla4, 1)
            Q_point.y.copy_advice("y_q", region, cfg.x_p, 0)
            Q_point.x.copy_advice("x_q", region, cfg.x_a, 1)
            offset = 1
            x_a_val = Q_point.x.value
            y_a_val = Q_point.y.value
            zs_all = []
            x_a_cell = None
            for piece_idx, piece in enumerate(pieces):
                (offset, x_a_val, y_a_val, x_a_cell, zs) = \
                    self._hash_piece(region, offset, piece,
                                     x_a_val, y_a_val,
                                     piece_idx == len(pieces) - 1)
                zs_all.append(zs)
            y_a_cell = region.assign_advice("y_a final", cfg.lambda_1,
                                            offset, lambda: y_a_val)
            region.assign_advice("dummy l2", cfg.lambda_2, offset,
                                 lambda: Value.known(0))
            region.assign_advice("dummy x_p", cfg.x_p, offset,
                                 lambda: Value.known(0))
            return EccPoint(x_a_cell, y_a_cell), zs_all

        return layouter.assign_region("hash_to_point (private init)",
                                      region_fn)

    def hash_to_point(self, layouter, Q, pieces: list[MessagePiece]):
        """Public-Q initialization; returns (EccPoint, zs per piece)."""
        cfg = self._config
        f = cfg.field
        p = f.modulus
        x_q, y_q = Q

        def region_fn(region):
            offset = 0
            # init rows (hash_to_point.rs:113-173); with private-init
            # support enabled, the public path also writes y_Q into the
            # x_p/prev slot the gate queries (one extra row)
            if cfg.allow_init_from_private_point:
                # y_Q rides in x_p@0 as a CONSTANT; fixed_y_q is unused
                # in this mode (hash_to_point.rs:136-147)
                region.enable_selector("q_s4", cfg.q_sinsemilla4, 1)
                region.assign_advice_from_constant("y_q (public)",
                                                   cfg.x_p, 0, y_q)
                offset = 1
                region.assign_advice_from_constant("x_q", cfg.x_a, offset,
                                                   x_q)
            else:
                region.enable_selector("q_s4", cfg.q_sinsemilla4, offset)
                region.assign_fixed("fixed y_q", cfg.fixed_y_q, offset,
                                    lambda: Value.known(y_q))
                region.assign_advice_from_constant("x_q", cfg.x_a, offset,
                                                   x_q)

            x_a_val = Value.known(x_q)
            y_a_val = Value.known(y_q)
            zs_all = []

            x_a_cell = None
            for piece_idx, piece in enumerate(pieces):
                (offset, x_a_val, y_a_val, x_a_cell, zs) = \
                    self._hash_piece(region, offset, piece, x_a_val,
                                     y_a_val,
                                     piece_idx == len(pieces) - 1)
                zs_all.append(zs)

            # final row: y_a in lambda_1 column + dummy λ2/x_p
            y_a_cell = region.assign_advice("y_a final", cfg.lambda_1,
                                            offset, lambda: y_a_val)
            region.assign_advice("dummy l2", cfg.lambda_2, offset,
                                 lambda: Value.known(0))
            region.assign_advice("dummy x_p", cfg.x_p, offset,
                                 lambda: Value.known(0))
            return EccPoint(x_a_cell, y_a_cell), zs_all

        return layouter.assign_region("hash_to_point", region_fn)
