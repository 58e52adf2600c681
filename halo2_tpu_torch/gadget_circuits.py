"""The golden gadget circuits: zcash/halo2's own test circuits at K = 11.

halo2_gadgets keeps a pinned verifying key (`vk_*.rdata`, the `{:#?}`
text) and a proof (`proof_*.bin`, over Params<EqAffine>, K = 11, no
public inputs) for fifteen circuits; tests/golden/ holds those bytes.
This module builds each circuit against the classes of one package, so
the port and the JAX package prove the same circuit:

  short_range_check_case{0,1,2}, short_range_check_4_5b_case{0..3}
      MyShortRangeCheckCircuit (utilities/lookup_range_check.rs:1004-1058)
  lookup_range_check, lookup_range_check_4_5b
      MyLookupCircuit (lookup_range_check.rs:881-976)
  ecc_chip, ecc_chip_4_5b
      MyEccCircuit (ecc.rs:623-1010)
  sinsemilla_chip, sinsemilla_with_private_init_chip_4_5b
      MySinsemillaCircuit and its private-init variant (sinsemilla.rs)
  merkle_chip, merkle_with_private_init_chip_4_5b
      MyMerkleCircuit and its private-init variant (merkle.rs:175-575)

`namespace(import_module)` gathers what the circuits use from one
package: `import_module("gadgets.ecc")` must return that package's
module. `port_namespace()` is the port's; a caller that holds another
package passes its own importer. `golden_circuit(ns, name)` is the
circuit whose key is `vk_{name}.rdata`, with its witness (`PROVED` lists
the names chip_smoke.py proves).
"""
from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

K = 11                # every golden circuit's size
LOOKUP_K = 10         # the range-check table's bits
MERKLE_DEPTH = 32
MERKLE_SEED = 42      # the Merkle witness (random.Random seed)

# name -> (element, num_bits)  (lookup_range_check.rs:1077-1135, 1225-1232)
SHORT_CASES = {
    "case0": (0, 0),
    "case1": ((1 << LOOKUP_K) - 1, LOOKUP_K),
    "case2": ((1 << 6) - 1, 6),
}
SHORT_CASES_45B = dict(SHORT_CASES, case3=((1 << 4) - 1, 4))

GOLDEN = (
    [f"short_range_check_{c}" for c in sorted(SHORT_CASES)]
    + [f"short_range_check_4_5b_{c}" for c in sorted(SHORT_CASES_45B)]
    + ["lookup_range_check", "lookup_range_check_4_5b",
       "ecc_chip", "ecc_chip_4_5b",
       "sinsemilla_chip", "sinsemilla_with_private_init_chip_4_5b",
       "merkle_chip", "merkle_with_private_init_chip_4_5b"])
PROVED = ("ecc_chip", "sinsemilla_chip", "merkle_chip", "lookup_range_check")

# (attribute, module under the package, name in that module)
_NAMES = (
    ("Circuit", "circuit", "Circuit"),
    ("Value", "circuit", "Value"),
    ("FP", "fields.host", "FP"),
    ("PALLAS", "curves.host", "PALLAS"),
    ("EccChip", "gadgets.ecc", "EccChip"),
    ("FixedPointBase", "gadgets.ecc", "FixedPointBase"),
    ("NUM_WINDOWS", "gadgets.ecc.constants", "NUM_WINDOWS"),
    ("NUM_WINDOWS_SHORT", "gadgets.ecc.constants", "NUM_WINDOWS_SHORT"),
    ("LookupRangeCheckConfig", "gadgets.utilities.lookup_range_check",
     "LookupRangeCheckConfig"),
    ("LookupRangeCheck45BConfig", "gadgets.utilities.lookup_range_check",
     "LookupRangeCheck45BConfig"),
    ("SinsemillaChip", "gadgets.sinsemilla.chip", "SinsemillaChip"),
    ("HashDomainGadget", "gadgets.sinsemilla.gadget", "HashDomainGadget"),
    ("CommitDomainGadget", "gadgets.sinsemilla.gadget",
     "CommitDomainGadget"),
    ("CommitDomain", "gadgets.sinsemilla.primitive", "CommitDomain"),
    ("MerkleChip", "gadgets.sinsemilla.merkle", "MerkleChip"),
    ("MerklePath", "gadgets.sinsemilla.merkle", "MerklePath"),
)


def namespace(import_module) -> SimpleNamespace:
    """The classes the circuits use, from the package whose modules
    `import_module(relative_name)` returns."""
    ns = SimpleNamespace(**{attr: getattr(import_module(mod), name)
                            for attr, mod, name in _NAMES})
    # the "MerkleCRH" commit domain: Q of its hash domain for Merkle and
    # the Sinsemilla hash, R for the Sinsemilla commit (sinsemilla.rs tests)
    ns.COMMIT_DOMAIN = ns.CommitDomain("MerkleCRH")
    ns.classes = _classes(ns)
    return ns


def port_namespace() -> SimpleNamespace:
    return namespace(
        lambda mod: importlib.import_module(f"{__package__}.{mod}"))


def golden_circuit(ns, name: str):
    """The circuit of `vk_{name}.rdata`, with the witness it is proved
    with: keygen takes its without_witnesses() form, and the ECC and
    Sinsemilla mirrors draw their witness inside synthesize from a fixed
    seed."""
    c = ns.classes
    for prefix, cls, cases in (
            ("short_range_check_4_5b_", c.ShortRangeCheck45B,
             SHORT_CASES_45B),
            ("short_range_check_", c.ShortRangeCheck, SHORT_CASES)):
        if name.startswith(prefix):
            return cls(*cases[name[len(prefix):]])
    if name in ("merkle_chip", "merkle_with_private_init_chip_4_5b"):
        return _merkle_witness(ns.FP, c.Merkle if name == "merkle_chip"
                               else c.MerklePrivateInit45B)
    cls, args = {
        "lookup_range_check": (c.LookupCheck, (6,)),
        "lookup_range_check_4_5b": (c.LookupCheck45B, (6,)),
        "ecc_chip": (c.EccMirror, ()),
        "ecc_chip_4_5b": (c.EccMirror45B, ()),
        "sinsemilla_chip": (c.SinsemillaMirror, ()),
        "sinsemilla_with_private_init_chip_4_5b":
            (c.SinsemillaPrivateInit45B, ()),
    }[name]
    return cls(*args)


def _merkle_witness(fp, cls):
    rng = random.Random(MERKLE_SEED)
    leaf = rng.randrange(fp.modulus)
    pos = rng.getrandbits(32)
    path = [rng.randrange(fp.modulus) for _ in range(MERKLE_DEPTH)]
    return cls(leaf, pos, path)


# The full-width scalar whose window sequence doubles on the last step
# (ecc.rs full_width tests, octal digits)
LAST_DOUBLING_OCT = ("1333333333333333333333333333333333333333333333333"
                     "333333333333333333333333333333333334")


def _oct_fold(s, modulus):
    acc = 0
    for ch in s:
        acc = (acc * 8 + int(ch, 8)) % modulus
    return acc


def _bits_to_int(bits):
    acc = 0
    for i, b in enumerate(bits):
        acc |= int(b) << i
    return acc


def _classes(ns) -> SimpleNamespace:
    Circuit, Value, FP, PALLAS = ns.Circuit, ns.Value, ns.FP, ns.PALLAS
    EccChip, FixedPointBase = ns.EccChip, ns.FixedPointBase
    SinsemillaChip, MerkleChip = ns.SinsemillaChip, ns.MerkleChip
    COMMIT_DOMAIN = ns.COMMIT_DOMAIN

    class ShortRangeCheckCircuit(Circuit):
        lookup_cls = ns.LookupRangeCheckConfig

        def __init__(self, element=None, num_bits=0):
            self.element = element
            self.num_bits = num_bits

        def without_witnesses(self):
            return type(self)(None, self.num_bits)

        @classmethod
        def configure(cls, meta):
            running_sum = meta.advice_column()
            table_idx = meta.lookup_table_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return cls.lookup_cls.configure(meta, FP, running_sum, table_idx,
                                            LOOKUP_K)

        def synthesize(self, config, layouter):
            config.load_table(layouter)
            config.witness_short_check(
                layouter,
                Value.known(self.element) if self.element is not None
                else Value.unknown(),
                self.num_bits)

    class ShortRangeCheck45BCircuit(ShortRangeCheckCircuit):
        lookup_cls = ns.LookupRangeCheck45BConfig

    class LookupCheckCircuit(Circuit):
        """Two running-sum decompositions of num_words words: one strict
        (element = 2^60 - 1), one not (element = 2^60)."""
        lookup_cls = ns.LookupRangeCheckConfig

        def __init__(self, num_words=6):
            self.num_words = num_words

        def without_witnesses(self):
            return type(self)(self.num_words)

        @classmethod
        def configure(cls, meta):
            running_sum = meta.advice_column()
            table_idx = meta.lookup_table_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return cls.lookup_cls.configure(meta, FP, running_sum, table_idx,
                                            LOOKUP_K)

        def synthesize(self, config, layouter):
            config.load_table(layouter)
            n = self.num_words * LOOKUP_K
            for element, strict in (((1 << n) - 1, True), (1 << n, False)):
                config.witness_check(layouter, Value.known(element),
                                     self.num_words, strict)

    class LookupCheck45BCircuit(LookupCheckCircuit):
        lookup_cls = ns.LookupRangeCheck45BConfig

    base_full = FixedPointBase(PALLAS.generator, ns.NUM_WINDOWS)
    base_short = FixedPointBase(PALLAS.generator, ns.NUM_WINDOWS_SHORT)

    class EccMirrorCircuit(Circuit):
        """Like the reference MyEccCircuit, the witness values are drawn
        inside synthesize and are always known, even during keygen
        (ecc.rs:796-800, 848+). Witnessing the identity as a
        NonIdentityPoint then errors in the measurement pass, so those two
        regions are never placed and take no rows."""

        LOOKUP_CONFIG = ns.LookupRangeCheckConfig

        def without_witnesses(self):
            return type(self)()

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(10)]
            lookup_table = meta.lookup_table_column()
            lagrange = [meta.fixed_column() for _ in range(8)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            range_check = cls.LOOKUP_CONFIG.configure(
                meta, FP, advices[9], lookup_table)
            return EccChip.configure(meta, advices, lagrange, range_check,
                                     FP)

        def synthesize(self, config, layouter):
            chip = EccChip(config)
            rc = config.lookup_config
            rng = random.Random(20260817)
            V = VP = Value.known

            rc.load_table(layouter)      # load_range_check_table (:845)

            p_val = PALLAS.mul(PALLAS.generator, rng.randrange(1, 1 << 128))
            q_val = PALLAS.mul(PALLAS.generator, rng.randrange(1, 1 << 128))
            p_neg_val = PALLAS.neg(p_val)

            p = chip.witness_point_non_id(layouter, VP(p_val))
            p_neg = chip.witness_point_non_id(layouter, VP(p_neg_val))
            q = chip.witness_point_non_id(layouter, VP(q_val))

            # the identity as a Point, and twice as a NonIdentityPoint,
            # which errors only when values are known (ecc.rs:873-888,
            # witness_point::tests::test_witness_non_id)
            chip.witness_point(layouter, VP((0, 0)))
            for _ in range(2):
                try:
                    chip.witness_point_non_id(layouter, VP((0, 0)))
                except ValueError:
                    pass

            def witness_non_id(val):
                return chip.witness_point_non_id(layouter, VP(val))

            # add::tests::test_add (add.rs:382-500)
            zero = chip.add(layouter, p, p_neg)
            r = chip.add(layouter, zero, zero)
            chip.constrain_equal(layouter, r, zero)
            r = chip.add(layouter, p, q)
            chip.constrain_equal(layouter, r,
                                 witness_non_id(PALLAS.add(p_val, q_val)))
            r = chip.add(layouter, p, p)
            chip.constrain_equal(layouter, r,
                                 witness_non_id(PALLAS.double(p_val)))
            r = chip.add(layouter, p, zero)
            chip.constrain_equal(layouter, r, p)
            r = chip.add(layouter, zero, p)
            chip.constrain_equal(layouter, r, p)
            pm = FP.modulus

            def endo(pt):
                return (pt[0] * FP.zeta % pm, pt[1])
            for val in (endo(p_val), endo(p_neg_val), endo(endo(p_val)),
                        endo(endo(p_neg_val))):
                chip.add(layouter, p, witness_non_id(val))

            # add_incomplete::tests (test_errors = false)
            r = chip.add_incomplete(layouter, p, q)
            chip.constrain_equal(layouter, r,
                                 witness_non_id(PALLAS.add(p_val, q_val)))

            # mul::tests::test_mul (3 scalars)
            q_scalar = PALLAS.scalar.modulus
            for scalar_val in (rng.randrange(pm), 0, pm - 1):
                cell = chip.load_private(layouter, config.advices[0],
                                         V(scalar_val))
                result, _ = chip.mul(layouter, cell, p)
                if scalar_val != 0:
                    w = witness_non_id(PALLAS.mul(p_val,
                                                  scalar_val % q_scalar))
                    chip.constrain_equal(layouter, result, w)

            # mul_fixed::short::tests::test_mul_sign
            sp_val = PALLAS.mul(PALLAS.generator, rng.randrange(1, 1 << 128))
            sp = chip.witness_point(layouter, VP(sp_val))
            sp_neg = chip.witness_point(layouter, VP(PALLAS.neg(sp_val)))
            identity = chip.witness_point(layouter, VP((0, 0)))
            pos_sign = chip.load_private(layouter, config.advices[0], V(1))
            neg_sign = chip.load_private(layouter, config.advices[1],
                                         V(pm - 1))
            for sign, pt, want in ((pos_sign, sp, sp), (neg_sign, sp, sp_neg),
                                   (pos_sign, identity, identity),
                                   (neg_sign, identity, identity)):
                r = chip.mul_sign(layouter, sign, pt)
                chip.constrain_equal(layouter, r, want)

            # mul_fixed::full_width::tests (4 scalars)
            gen = PALLAS.generator
            for scalar in (rng.randrange(q_scalar),
                           _oct_fold(LAST_DOUBLING_OCT, q_scalar),
                           0, q_scalar - 1):
                result = chip.mul_fixed(layouter, V(scalar), base_full)
                if scalar != 0:
                    w = witness_non_id(PALLAS.mul(gen, scalar))
                    chip.constrain_equal(layouter, result, w)

            # mul_fixed::short::tests::test_mul_fixed_short
            magnitude_signs = [
                (rng.getrandbits(64), 1 if rng.getrandbits(1) else pm - 1),
                (0xFFFF_FFFF_FFFF_FFFF, 1),
                (0xFFFF_FFFF_FFFF_FFFF, pm - 1),
                (0xB6DB_6DB6_DB6D_B6DC, 1),
                (0xB6DB_6DB6_DB6D_B6DC, pm - 1),
            ]
            for magnitude, sign in magnitude_signs:
                m_cell = chip.load_private(layouter, config.advices[0],
                                           V(magnitude))
                s_cell = chip.load_private(layouter, config.advices[0],
                                           V(sign))
                result = chip.mul_fixed_short(layouter, (m_cell, s_cell),
                                              base_short)
                scalar = magnitude if sign == 1 else (q_scalar - magnitude)
                w = witness_non_id(PALLAS.mul(gen, scalar % q_scalar))
                chip.constrain_equal(layouter, result, w)

            # "mul by +zero" / "mul by -zero": two more short muls,
            # identity-asserted only (short.rs tests)
            for magnitude, sign in ((0, 1), (0, pm - 1)):
                m_cell = chip.load_private(layouter, config.advices[0],
                                           V(magnitude))
                s_cell = chip.load_private(layouter, config.advices[0],
                                           V(sign))
                chip.mul_fixed_short(layouter, (m_cell, s_cell), base_short)

            # mul_fixed::base_field_elem::tests (4 scalars)
            for scalar in (rng.randrange(pm), _oct_fold(LAST_DOUBLING_OCT, pm),
                           0, pm - 1):
                cell = chip.load_private(layouter, config.advices[0],
                                         V(scalar))
                result = chip.mul_fixed_base_field(layouter, cell, base_full)
                if scalar != 0:
                    w = witness_non_id(PALLAS.mul(gen, scalar % q_scalar))
                    chip.constrain_equal(layouter, result, w)

    class EccMirror45BCircuit(EccMirrorCircuit):
        """MyEccCircuit::<PallasLookupRangeCheck4_5BConfig>
        (ecc.rs:999-1010)."""
        LOOKUP_CONFIG = ns.LookupRangeCheck45BConfig

    class SinsemillaMirrorCircuit(Circuit):
        """EccChip and two SinsemillaChips sharing one generator table:
        a MerkleCRH parent (l + left + right, 510 bits) hashed with chip
        1, a 500-bit message committed with chip 2 ([r]R full-width
        fixed-base mul and a complete add)."""
        LOOKUP_CONFIG = ns.LookupRangeCheckConfig
        ALLOW_PRIVATE_INIT = False

        def without_witnesses(self):
            return type(self)()

        @classmethod
        def configure(cls, meta):
            # column allocation order mirrors sinsemilla.rs tests configure
            advices = [meta.advice_column() for _ in range(10)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            table_idx = meta.lookup_table_column()
            lagrange = [meta.fixed_column() for _ in range(8)]
            lookup = (table_idx, meta.lookup_table_column(),
                      meta.lookup_table_column())
            range_check = cls.LOOKUP_CONFIG.configure(
                meta, FP, advices[9], table_idx)
            ecc_config = EccChip.configure(meta, advices, lagrange,
                                           range_check, FP)
            config1 = SinsemillaChip.configure(
                meta, advices[0:5], advices[2], lagrange[0], lookup, FP,
                range_check,
                allow_init_from_private_point=cls.ALLOW_PRIVATE_INIT)
            config2 = SinsemillaChip.configure(
                meta, advices[5:10], advices[7], lagrange[1], lookup, FP,
                range_check,
                allow_init_from_private_point=cls.ALLOW_PRIVATE_INIT)
            return (ecc_config, config1, config2)

        def synthesize(self, config, layouter):
            rng = random.Random(20260818)
            ecc_chip = EccChip(config[0])
            chip1 = SinsemillaChip(config[1])
            chip1.load_table(layouter)

            # MerkleCRH parent with chip 1
            merkle_crh = ns.HashDomainGadget(chip=chip1,
                                             domain=COMMIT_DOMAIN.M)
            l_bits = [False] * LOOKUP_K
            left_bits = [bool(rng.getrandbits(1)) for _ in range(250)]
            right_bits = [bool(rng.getrandbits(1)) for _ in range(250)]
            pieces = [chip1.witness_message_piece(
                layouter, Value.known(_bits_to_int(bits)), n)
                for bits, n in ((l_bits, 1), (left_bits, 25),
                                (right_bits, 25))]
            expected_parent = ecc_chip.witness_point_non_id(
                layouter, Value.known(COMMIT_DOMAIN.M.hash_to_point(
                    l_bits + left_bits + right_bits)))
            parent, _zs = merkle_crh.hash_to_point(layouter, pieces)
            ecc_chip.constrain_equal(layouter, parent, expected_parent)

            # 500-bit commit with chip 2
            chip2 = SinsemillaChip(config[2])
            test_commit = ns.CommitDomainGadget(
                sinsemilla_chip=chip2, ecc_chip=ecc_chip,
                M=ns.HashDomainGadget(chip=chip2, domain=COMMIT_DOMAIN.M),
                R=FixedPointBase(COMMIT_DOMAIN.R, ns.NUM_WINDOWS))
            r_val = rng.randrange(PALLAS.scalar.modulus)
            msg_bits = [bool(rng.getrandbits(1)) for _ in range(500)]
            pieces = [chip2.witness_message_piece(
                layouter, Value.known(_bits_to_int(bits)), 25)
                for bits in (msg_bits[:250], msg_bits[250:])]
            result = test_commit.commit(layouter, pieces, Value.known(r_val))
            expected_result = ecc_chip.witness_point_non_id(
                layouter, Value.known(COMMIT_DOMAIN.commit(msg_bits, r_val)))
            ecc_chip.constrain_equal(layouter, result, expected_result)

    class SinsemillaPrivateInit45BCircuit(SinsemillaMirrorCircuit):
        """MySinsemillaCircuitWithHashFromPrivatePoint::<4_5B>: the same
        synthesize, with private-init hashing allowed and the tagged
        4/5-bit range check."""
        LOOKUP_CONFIG = ns.LookupRangeCheck45BConfig
        ALLOW_PRIVATE_INIT = True

    class MerkleCircuit(Circuit):
        """Two MerkleChips side by side, sharing one generator table and
        range check, hashing a 32-deep path."""
        lookup_cls = ns.LookupRangeCheckConfig
        allow_private_init = False

        def __init__(self, leaf=None, leaf_pos=None, path=None):
            self.leaf = leaf
            self.leaf_pos = leaf_pos
            self.path = path

        def without_witnesses(self):
            # Value::default() == known(0): the reference's #[derive(Default)]
            return type(self)(0, 0, [0] * MERKLE_DEPTH)

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(10)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            fixed_y_q_1 = meta.fixed_column()
            fixed_y_q_2 = meta.fixed_column()
            lookup = (meta.lookup_table_column(), meta.lookup_table_column(),
                      meta.lookup_table_column())
            range_check = cls.lookup_cls.configure(
                meta, FP, advices[9], lookup[0])
            sin1 = SinsemillaChip.configure(
                meta, advices[5:10], advices[7], fixed_y_q_1, lookup, FP,
                range_check,
                allow_init_from_private_point=cls.allow_private_init)
            config1 = MerkleChip.configure(meta, sin1)
            sin2 = SinsemillaChip.configure(
                meta, advices[0:5], advices[2], fixed_y_q_2, lookup, FP,
                range_check,
                allow_init_from_private_point=cls.allow_private_init)
            config2 = MerkleChip.configure(meta, sin2)
            return (config1, config2)

        def synthesize(self, config, layouter):
            SinsemillaChip(config[0].sinsemilla_config).load_table(layouter)
            chip_1 = MerkleChip(config[0])
            chip_2 = MerkleChip(config[1])

            def known(v):
                return Value.known(v) if v is not None else Value.unknown()

            leaf = chip_1.load_private(
                layouter, config[0].cond_swap_config.a, known(self.leaf))
            path = ns.MerklePath(
                chips=[chip_1, chip_2], domain=COMMIT_DOMAIN.M,
                leaf_pos=known(self.leaf_pos),
                path=[known(v) for v in
                      (self.path or [None] * MERKLE_DEPTH)])
            path.calculate_root(layouter, leaf)

    class MerklePrivateInit45BCircuit(MerkleCircuit):
        """MyMerkleCircuitWithHashFromPrivatePoint (merkle.rs:450-575)."""
        lookup_cls = ns.LookupRangeCheck45BConfig
        allow_private_init = True

    return SimpleNamespace(
        ShortRangeCheck=ShortRangeCheckCircuit,
        ShortRangeCheck45B=ShortRangeCheck45BCircuit,
        LookupCheck=LookupCheckCircuit, LookupCheck45B=LookupCheck45BCircuit,
        EccMirror=EccMirrorCircuit, EccMirror45B=EccMirror45BCircuit,
        SinsemillaMirror=SinsemillaMirrorCircuit,
        SinsemillaPrivateInit45B=SinsemillaPrivateInit45BCircuit,
        Merkle=MerkleCircuit, MerklePrivateInit45B=MerklePrivateInit45BCircuit)
