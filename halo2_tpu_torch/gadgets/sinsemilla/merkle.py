"""Merkle path gadget over the Sinsemilla layer hash (Orchard MerkleCRH).

Reference: halo2_gadgets/src/sinsemilla/merkle.rs (MerklePath:
calculate_root distributes layers over PAR chips) and merkle/chip.rs
(MerkleConfig = CondSwap over the Sinsemilla advice columns +
q_decompose with the four decomposition constraints; hash_layer packs
l || left || right into pieces a = l || left[0..240] (250 bits),
b = left[240..250] || left[250..255] || right[0..5] (20 bits),
c = right[5..255] (250 bits), with b_1/b_2 short-range-checked, and the
"Check piece decomposition" region layout of merkle/chip.rs:340-400).

Byte parity: gate ASTs and query order mirror merkle/chip.rs:136-205
exactly (int multiplications are Scaled nodes); the golden
vk_merkle_chip.rdata is checked in tests/test_merkle_parity.py.

Copied from halo2_tpu/gadgets/sinsemilla/merkle.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

from dataclasses import dataclass

from ...poly.polynomial import Rotation
from ...circuit.value import Value
from ..utilities import i2lebsp, bitrange_subset
from ..utilities.cond_swap import CondSwapChip, CondSwapConfig
from .chip import SinsemillaChip, SinsemillaConfig, MessagePiece
from .primitive import HashDomain, K


@dataclass
class MerkleConfig:
    advices: list              # the sinsemilla chip's 5 advice columns
    q_decompose: object
    cond_swap_config: CondSwapConfig
    sinsemilla_config: SinsemillaConfig


class MerkleChip:
    def __init__(self, config: MerkleConfig):
        self.config = config

    @staticmethod
    def configure(meta, sinsemilla_config: SinsemillaConfig
                  ) -> MerkleConfig:
        """merkle/chip.rs:108-211."""
        cfg = sinsemilla_config
        # SinsemillaConfig::advices() order (chip.rs:82-90)
        advices = [cfg.x_a, cfg.x_p, cfg.bits, cfg.lambda_1, cfg.lambda_2]
        cond_swap_config = CondSwapChip.configure(meta, cfg.field, advices)
        q_decompose = meta.selector()

        two_pow_5 = 1 << 5
        two_pow_10 = 1 << 10
        two_pow_240 = 1 << 240

        def decomposition(cells):
            q = cells.query_selector(q_decompose)
            l_whole = cells.query_advice(advices[4], Rotation(1))

            a_whole = cells.query_advice(advices[0], Rotation(0))
            b_whole = cells.query_advice(advices[1], Rotation(0))
            c_whole = cells.query_advice(advices[2], Rotation(0))
            left_node = cells.query_advice(advices[3], Rotation(0))
            right_node = cells.query_advice(advices[4], Rotation(0))

            z1_a = cells.query_advice(advices[0], Rotation(1))
            a_1 = z1_a
            a_0 = a_whole - a_1 * two_pow_10

            z1_b = cells.query_advice(advices[1], Rotation(1))
            b_1 = cells.query_advice(advices[2], Rotation(1))
            b_2 = cells.query_advice(advices[3], Rotation(1))
            b1_b2_check = z1_b - (b_1 + b_2 * two_pow_5)
            b_0 = b_whole - (z1_b * two_pow_10)

            left_check = (a_1 + (b_0 + b_1 * two_pow_10) * two_pow_240) \
                - left_node
            right_check = b_2 + c_whole * two_pow_5 - right_node

            return [("l_check", q * (a_0 - l_whole)),
                    ("left_check", q * left_check),
                    ("right_check", q * right_check),
                    ("b1_b2_check", q * b1_b2_check)]

        meta.create_gate("Decomposition check", decomposition)
        return MerkleConfig(advices=advices, q_decompose=q_decompose,
                            cond_swap_config=cond_swap_config,
                            sinsemilla_config=cfg)

    # ---- CondSwapInstructions delegation (merkle/chip.rs:436-460) ----
    def swap(self, layouter, pair, swap_value: Value):
        return CondSwapChip(self.config.cond_swap_config).swap(
            layouter, pair, swap_value)

    def load_private(self, layouter, column, value: Value):
        def region_fn(region):
            return region.assign_advice("load private", column, 0,
                                        lambda: value)
        return layouter.assign_region("load private", region_fn)

    # ---- MerkleInstructions (merkle/chip.rs:228-432) ----
    def hash_layer(self, layouter, Q, l: int, left, right):
        """MerkleCRH of one layer; returns the parent AssignedCell."""
        cfg = self.config
        sin = SinsemillaChip(cfg.sinsemilla_config)
        f = cfg.sinsemilla_config.field
        p = f.modulus
        lookup = cfg.sinsemilla_config.lookup_config

        def shift_sum(parts):
            """from_subpieces value: sum of (value, num_bits) shifted."""
            acc = Value.known(0)
            bits = 0
            for val, nbits in parts:
                acc = acc.zip(val).map(
                    lambda t, b=bits: (t[0] + (t[1] << b)) % p)
                bits += nbits
            assert bits % K == 0
            return acc, bits // K

        # a = a_0 || a_1 = l (10 bits) || left[0..240]
        a_val, a_words = shift_sum([
            (Value.known(l), 10),
            (left.value.map(lambda v: bitrange_subset(p, v, 0, 240)), 240),
        ])
        a = sin.witness_message_piece(layouter, a_val, a_words)

        # b_1 = left[250..255], b_2 = right[0..5], short-range-checked
        b_1 = lookup.witness_short_check(
            layouter, left.value.map(lambda v: bitrange_subset(p, v, 250,
                                                               255)), 5)
        b_2 = lookup.witness_short_check(
            layouter, right.value.map(lambda v: bitrange_subset(p, v, 0,
                                                                5)), 5)
        # b = b_0 || b_1 || b_2 (20 bits)
        b_val, b_words = shift_sum([
            (left.value.map(lambda v: bitrange_subset(p, v, 240, 250)), 10),
            (b_1.value, 5),
            (b_2.value, 5),
        ])
        b = sin.witness_message_piece(layouter, b_val, b_words)

        # c = right[5..255] (250 bits)
        c_val, c_words = shift_sum([
            (right.value.map(lambda v: bitrange_subset(p, v, 5, 255)), 250),
        ])
        c = sin.witness_message_piece(layouter, c_val, c_words)

        point, zs = sin.hash_to_point(layouter, Q, [a, b, c])
        hash_cell = point.x

        z1_a = zs[0][1]
        z1_b = zs[1][1]

        # |  A_0  |  A_1  |  A_2  |  A_3  |  A_4  | q_decompose |
        # |   a   |   b   |   c   |  left | right |      1      |
        # |  z1_a |  z1_b |  b_1  |  b_2  |   l   |      0      |
        def decompose_region(region):
            region.enable_selector("q_decompose", cfg.q_decompose, 0)
            region.assign_advice_from_constant(f"l {l}", cfg.advices[4], 1,
                                               l)
            a.cell.copy_advice("copy a", region, cfg.advices[0], 0)
            b.cell.copy_advice("copy b", region, cfg.advices[1], 0)
            c.cell.copy_advice("copy c", region, cfg.advices[2], 0)
            left.copy_advice("left", region, cfg.advices[3], 0)
            right.copy_advice("right", region, cfg.advices[4], 0)
            z1_a.copy_advice("z1_a", region, cfg.advices[0], 1)
            z1_b.copy_advice("z1_b", region, cfg.advices[1], 1)
            b_1.copy_advice("b_1", region, cfg.advices[2], 1)
            b_2.copy_advice("b_2", region, cfg.advices[3], 1)

        layouter.assign_region("Check piece decomposition",
                               decompose_region)
        return hash_cell


@dataclass
class MerklePath:
    """merkle.rs:44-170: distributes PATH_LENGTH layers over the chips."""
    chips: list
    domain: HashDomain
    leaf_pos: Value
    path: list    # list[Value] ordered from leaves to root

    def calculate_root(self, layouter, leaf):
        path_length = len(self.path)
        layers_per_chip = -(-path_length // len(self.chips))
        pos_bits = [self.leaf_pos.map(lambda v, i=i: (v >> i) & 1 == 1)
                    for i in range(path_length)]
        Q = self.domain.Q
        node = leaf
        for l, (sibling, pos) in enumerate(zip(self.path, pos_bits)):
            chip = self.chips[l // layers_per_chip]
            pair = chip.swap(layouter, (node, sibling), pos)
            node = chip.hash_layer(layouter, Q, l, pair[0], pair[1])
        return node


def merkle_crh_host(domain: HashDomain, l: int, left: int,
                    right: int) -> int:
    """Host MerkleCRH: hash(Q, l(10) || left(255) || right(255)),
    mapping bottom to 0 (merkle.rs:351-383)."""
    bits = i2lebsp(l, 10) + i2lebsp(left, 255) + i2lebsp(right, 255)
    return domain.hash(bits)
