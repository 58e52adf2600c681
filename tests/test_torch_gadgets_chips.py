"""The port's gadgets (halo2_tpu_torch/gadgets) against the JAX reference,
on the CPU, exactly.

Off-circuit: the Poseidon permutation, constants and constant-length hash
over Fp and Fq, the Poseidon transcript's challenges and a whole proof
with it (K = 4 MulCircuit, tests/test_poseidon_transcript.py's round
trip, byte-equal to the JAX package's), Sinsemilla's S
table, hash_to_point and commit, and ECC's fixed-base window tables,
Lagrange coefficients, z/u values and window counts, on numpy-seeded
inputs. In-circuit: the JAX package's chip tests (tests/test_ecc_chip.py,
test_pow5_chip.py, test_utilities_gadgets.py, test_sinsemilla.py) built
against each package's classes and run through each package's
MockProver; the failures of verify() and of verify_vectorized(device=
"cpu") are compared by class name and dataclasses.astuple, field by
field, as tests/test_torch_mock_prover.py does."""
import dataclasses
import functools
import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.transcript import (PoseidonTranscriptWrite as RPoseidonWrite,
                                  PoseidonTranscriptRead as RPoseidonRead)
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.ops import field_kernels as fk
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                            VerificationError)
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import (PoseidonTranscriptWrite,
                                        PoseidonTranscriptRead)

from tests.test_torch_prover import mul_circuit_class


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def package(root: str) -> SimpleNamespace:
    """What the tests use of one package: `halo2_tpu` (the JAX reference)
    or `halo2_tpu_torch` (the port)."""
    def imp(mod):
        return importlib.import_module(f"{root}.{mod}")
    circuit = imp("circuit")
    return SimpleNamespace(
        root=root, Circuit=circuit.Circuit, Value=circuit.Value,
        MockProver=imp("dev").MockProver,
        FP=imp("fields.host").FP, FQ=imp("fields.host").FQ,
        PALLAS=imp("curves.host").PALLAS, VESTA=imp("curves.host").VESTA,
        ConstraintSystem=imp("plonk.circuit").ConstraintSystem,
        error=imp("plonk.error"), transcript=imp("transcript"),
        ecc=imp("gadgets.ecc"), ecc_constants=imp("gadgets.ecc.constants"),
        poseidon=imp("gadgets.poseidon"),
        poseidon_gadget=imp("gadgets.poseidon.gadget"),
        utilities=imp("gadgets.utilities"),
        lrc=imp("gadgets.utilities.lookup_range_check"),
        sinsemilla=imp("gadgets.sinsemilla"),
        sinsemilla_chip=imp("gadgets.sinsemilla.chip"),
        sinsemilla_primitive=imp("gadgets.sinsemilla.primitive"))


REF, PORT = "halo2_tpu", "halo2_tpu_torch"


def both(fn):
    """fn(package) for the reference and the port."""
    return fn(package(REF)), fn(package(PORT))


def rand_ints(seed, n, bound):
    """n integers in [0, bound) from a numpy generator (48 bytes each, so
    the reduction's bias is below 2^-128)."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % bound
            for _ in range(n)]


# ---------------------------------------------------------------------------
# off-circuit primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["FP", "FQ"])
def test_poseidon_permutation_and_hash_match_reference(field):
    def run(m):
        fs = getattr(m, field)
        spec = m.poseidon.P128Pow5T3()
        rc, mds, mds_inv = spec.constants(fs)
        states = [rand_ints(10 + i, 3, fs.modulus) for i in range(4)]
        perms = [m.poseidon.permute(fs, spec, s, mds, rc) for s in states]
        msgs = [rand_ints(20 + n, n, fs.modulus) for n in range(1, 6)]
        hashes = [m.poseidon.poseidon_hash(fs, spec, msg) for msg in msgs]
        return rc, mds, mds_inv, perms, hashes
    ref, port = both(run)
    assert port == ref
    assert len(port[0]) == 8 + 56       # full and partial rounds


@pytest.mark.parametrize("curve", ["PALLAS", "VESTA"])
def test_poseidon_transcript_challenges_match_reference(curve):
    """The same points and scalars absorbed give the same challenges."""
    def run(m):
        c = getattr(m, curve)
        tw = m.transcript.PoseidonTranscriptWrite(c)
        out = [tw.squeeze_challenge()]
        for i, s in enumerate(rand_ints(30, 5, c.scalar.modulus)):
            tw.write_scalar(s)
            tw.write_point(c.mul(c.generator, s + 1))
            if i % 2:
                out.append(tw.squeeze_challenge())
        out.append(tw.squeeze_challenge())
        proof = tw.finalize()
        tr = m.transcript.PoseidonTranscriptRead(c, proof)
        replay = [tr.squeeze_challenge()]
        for i in range(5):
            tr.read_scalar()
            tr.read_point()
            if i % 2:
                replay.append(tr.squeeze_challenge())
        replay.append(tr.squeeze_challenge())
        tr.assert_consumed()
        assert replay == out
        return out, proof
    ref, port = both(run)
    assert port == ref
    assert len(set(port[0])) == len(port[0])


def test_poseidon_transcript_proof_matches_reference():
    """tests/test_poseidon_transcript.py's round trip (K = 4 MulCircuit)
    proved by both packages with the Poseidon transcript and the same
    seeded RNG: the same bytes, accepted by both verifiers; a wrong
    instance rejected by the port's."""
    k, a, b, seed = 4, 7, 191, 42
    rparams = RParams.new(R_PALLAS, k, use_cache=False)
    port_params = params_from_reference("pallas", k, rparams.g,
                                        rparams.g_lagrange, rparams.w,
                                        rparams.u, "cpu")
    out = R_PALLAS.scalar.mul(a, b)
    rcircuit = mul_circuit_class(RCircuit, RValue, RRotation,
                                 R_PALLAS.scalar)(a, b)
    circuit = mul_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)(a, b)
    rvk = rplonk.keygen_vk(rparams, rcircuit)
    rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
    tw = RPoseidonWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                        random.Random(seed), tw)
    rproof = tw.finalize()

    vk = keygen_vk(port_params, circuit)
    pk = keygen_pk(port_params, vk, circuit)
    tw = PoseidonTranscriptWrite(PALLAS)
    create_proof(port_params, pk, [circuit], [[[out]]], random.Random(seed),
                 tw)
    proof = tw.finalize()
    assert proof == rproof

    verify_proof(port_params, vk, SingleVerifier(port_params), [[[out]]],
                 PoseidonTranscriptRead(PALLAS, proof))
    rplonk.verify_proof(rparams, rvk, rplonk.SingleVerifier(rparams),
                        [[[out]]], RPoseidonRead(R_PALLAS, proof))
    with pytest.raises(VerificationError):
        verify_proof(port_params, vk, SingleVerifier(port_params),
                     [[[out + 1]]], PoseidonTranscriptRead(PALLAS, proof))


def test_sinsemilla_s_table_matches_reference():
    ref, port = both(lambda m: [m.sinsemilla.sinsemilla_s(j)
                                for j in range(1 << m.sinsemilla.K)])
    assert len(port) == 1024
    assert port == ref


def test_sinsemilla_hash_and_commit_match_reference():
    def run(m):
        p = m.sinsemilla_primitive
        out = []
        for i, nbits in enumerate((10, 30, 255, 510)):
            rng = np.random.default_rng(40 + i)
            bits = [bool(b) for b in rng.integers(0, 2, nbits)]
            r = rand_ints(50 + i, 1, m.PALLAS.scalar.modulus)[0]
            domain = p.CommitDomain("z.cash:test-Sinsemilla")
            out.append((p.hash_to_point("z.cash:test-Sinsemilla", bits),
                        p.HashDomain("MerkleCRH").hash(bits),
                        domain.commit(bits, r), domain.short_commit(bits, r),
                        domain.M.Q, domain.R))
        return out
    ref, port = both(run)
    assert port == ref


@pytest.mark.parametrize("windows", ["NUM_WINDOWS", "NUM_WINDOWS_SHORT"])
def test_ecc_window_tables_and_lagrange_coeffs_match_reference(windows):
    def run(m):
        c = m.ecc_constants
        nw = getattr(c, windows)
        base = m.PALLAS.mul(m.PALLAS.generator,
                            rand_ints(60, 1, m.PALLAS.scalar.modulus)[0])
        return ((c.FIXED_BASE_WINDOW_SIZE, c.H, c.NUM_WINDOWS,
                 c.L_SCALAR_SHORT, c.NUM_WINDOWS_SHORT),
                c.compute_window_table(m.PALLAS, base, nw),
                c.compute_lagrange_coeffs(m.PALLAS, base, nw))
    ref, port = both(run)
    assert port[0] == (3, 8, 85, 64, 22)
    assert port == ref


def test_ecc_zs_and_us_match_reference():
    """z and u of the three fixed bases the golden circuits use (the
    generator at full and short width, MerkleCRH's R); the search takes
    minutes a base, so both packages read the repository's cache. The
    values are checked against their definition: u^2 = z + y, and z - y
    is not a square, for each window's eight y."""
    def run(m):
        c = m.ecc_constants
        bases = [(m.PALLAS.generator, c.NUM_WINDOWS),
                 (m.PALLAS.generator, c.NUM_WINDOWS_SHORT),
                 (m.sinsemilla_primitive.CommitDomain("MerkleCRH").R,
                  c.NUM_WINDOWS)]
        return [(c.fixed_base_constants(b, nw),
                 c.compute_window_table(m.PALLAS, b, nw)) for b, nw in bases]
    ref, port = both(run)
    assert [t for t, _ in port] == [t for t, _ in ref]
    fp = package(PORT).FP
    p = fp.modulus
    for (_, zs_us), table in port:
        assert len(zs_us) == len(table)
        for (z, us), window in zip(zs_us, table):
            for u, (_, y) in zip(us, window):
                assert u * u % p == (z + y) % p
                assert not fp.is_square((z - y) % p)


# ---------------------------------------------------------------------------
# the JAX package's chip tests, mirrored through both MockProvers
# ---------------------------------------------------------------------------

def known(m, v):
    return m.Value.known(v) if v is not None else m.Value.unknown()


@functools.lru_cache(maxsize=None)
def circuits(root: str) -> SimpleNamespace:
    """The chip tests' circuits against one package's classes."""
    m = package(root)
    FP, FQ, Circuit, Value = m.FP, m.FQ, m.Circuit, m.Value
    EccChip = m.ecc.EccChip
    LRC = m.lrc.LookupRangeCheckConfig
    SinsemillaChip = m.sinsemilla_chip.SinsemillaChip

    class EccCircuit(Circuit):
        """tests/test_ecc_chip.py: witness P and Q, P + Q (complete or
        incomplete) copied to the instance."""

        def __init__(self, p=None, q=None, mode="add"):
            self.p, self.q, self.mode = p, q, mode

        def without_witnesses(self):
            return EccCircuit(mode=self.mode)

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(10)]
            lookup_table = meta.lookup_table_column()
            lagrange = [meta.fixed_column() for _ in range(8)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            instance = meta.instance_column()
            meta.enable_equality(instance)
            range_check = LRC.configure(meta, FP, advices[9], lookup_table)
            cfg = EccChip.configure(meta, advices, lagrange, range_check, FP)
            return {"ecc": cfg, "instance": instance}

        def synthesize(self, config, layouter):
            chip = EccChip(config["ecc"])
            p = chip.witness_point(
                layouter, Value.known((0, 0) if self.p is None else self.p))
            if self.mode == "add":
                q = chip.witness_point(
                    layouter,
                    Value.known((0, 0) if self.q is None else self.q))
                r = chip.add(layouter, p, q)
            else:
                q = chip.witness_point_non_id(layouter, Value.known(self.q))
                r = chip.add_incomplete(layouter, p, q)
            layouter.constrain_instance(r.x.cell, config["instance"], 0)
            layouter.constrain_instance(r.y.cell, config["instance"], 1)

    spec = m.poseidon.P128Pow5T3()
    Pow5Chip = m.poseidon.Pow5Chip

    class HashCircuit(Circuit):
        """tests/test_pow5_chip.py: a two-element Poseidon hash over Fq,
        through poseidon_hash_gadget or the Hash class."""
        use_class = False

        def __init__(self, message=None):
            self.message = message

        def without_witnesses(self):
            return type(self)()

        @classmethod
        def configure(cls, meta):
            width = spec.t
            state = [meta.advice_column() for _ in range(width)]
            partial_sbox = meta.advice_column()
            rc_a = [meta.fixed_column() for _ in range(width)]
            rc_b = [meta.fixed_column() for _ in range(width)]
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            instance = meta.instance_column()
            meta.enable_equality(instance)
            message_col = meta.advice_column()
            meta.enable_equality(message_col)
            pow5 = Pow5Chip.configure(meta, spec, FQ, state, partial_sbox,
                                      rc_a, rc_b)
            return {"pow5": pow5, "instance": instance,
                    "message": message_col}

        def synthesize(self, config, layouter):
            chip = Pow5Chip(config["pow5"])

            def load_message(region):
                return [region.assign_advice(
                    f"m{i}", config["message"], i,
                    lambda v=v: known(m, v))
                    for i, v in enumerate(self.message or [None, None])]

            message = layouter.assign_region("load message", load_message)
            if self.use_class:
                out = m.poseidon_gadget.Hash(chip, layouter, 2).hash(message)
            else:
                out = m.poseidon.poseidon_hash_gadget(chip, layouter, message)
            layouter.constrain_instance(out.cell, config["instance"], 0)

    class HashClassCircuit(HashCircuit):
        use_class = True

    class RangeCheckCircuit(Circuit):
        """tests/test_utilities_gadgets.py: a 4-bit table, a running-sum
        check of num_words words or a short check of short_bits bits."""

        def __init__(self, value=None, num_words=2, strict=True,
                     short_bits=None):
            self.value, self.num_words = value, num_words
            self.strict, self.short_bits = strict, short_bits

        def without_witnesses(self):
            return RangeCheckCircuit(num_words=self.num_words,
                                     strict=self.strict,
                                     short_bits=self.short_bits)

        @classmethod
        def configure(cls, meta):
            running_sum = meta.advice_column()
            table = meta.lookup_table_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return LRC.configure(meta, FQ, running_sum, table, k=4)

        def synthesize(self, cfg, layouter):
            cfg.load_table(layouter)
            if self.short_bits is not None:
                cfg.witness_short_check(layouter, known(m, self.value),
                                        self.short_bits)
            else:
                cfg.witness_check(layouter, known(m, self.value),
                                  self.num_words, self.strict)

    class RunningSumCircuit(Circuit):
        def __init__(self, value=None, windows=4, strict=True):
            self.value, self.windows, self.strict = value, windows, strict

        def without_witnesses(self):
            return RunningSumCircuit(windows=self.windows, strict=self.strict)

        @classmethod
        def configure(cls, meta):
            z = meta.advice_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return m.utilities.RunningSumConfig.configure(meta, FQ, z, 3)

        def synthesize(self, cfg, layouter):
            cfg.witness_decompose(layouter, known(m, self.value),
                                  self.windows, self.strict)

    class SwapCircuit(Circuit):
        def __init__(self, a=None, b=None, swap=None):
            self.a, self.b, self.swap = a, b, swap

        def without_witnesses(self):
            return SwapCircuit()

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(5)]
            witness = meta.advice_column()
            meta.enable_equality(witness)
            cfg = m.utilities.CondSwapChip.configure(meta, FQ, advices)
            return {"swap": cfg, "witness": witness}

        def synthesize(self, config, layouter):
            chip = m.utilities.CondSwapChip(config["swap"])

            def wit(region):
                return region.assign_advice(
                    "a", config["witness"], 0, lambda: Value.known(self.a))

            a_cell = layouter.assign_region("witness a", wit)
            chip.swap(layouter, (a_cell, Value.known(self.b)),
                      Value.known(self.swap))

    class Tagged45Circuit(Circuit):
        def __init__(self, value=None, bits=4):
            self.value, self.bits = value, bits

        def without_witnesses(self):
            return Tagged45Circuit(bits=self.bits)

        @classmethod
        def configure(cls, meta):
            running_sum = meta.advice_column()
            table = meta.lookup_table_column()
            tag = meta.lookup_table_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            return m.lrc.LookupRangeCheck45BConfig.configure_with_tag(
                meta, FQ, running_sum, table, tag, k=5)

        def synthesize(self, cfg, layouter):
            cfg.load_table(layouter)
            cfg.witness_short_check_tagged(layouter, known(m, self.value),
                                           self.bits)

    domain = "z.cash:test-Sinsemilla"

    class SinsemillaCircuit(Circuit):
        """tests/test_sinsemilla.py: a 30-bit message (pieces of 2 + 1
        words) hashed; the output's x copied to the instance."""

        def __init__(self, piece1=None, piece2=None):
            self.piece1, self.piece2 = piece1, piece2

        def without_witnesses(self):
            return SinsemillaCircuit()

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(5)]
            witness_pieces = meta.advice_column()
            meta.enable_equality(witness_pieces)
            fixed_y_q = meta.fixed_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            lookup = (meta.lookup_table_column(), meta.lookup_table_column(),
                      meta.lookup_table_column())
            instance = meta.instance_column()
            meta.enable_equality(instance)
            cfg = SinsemillaChip.configure(meta, advices, witness_pieces,
                                           fixed_y_q, lookup, FP)
            return {"sinsemilla": cfg, "instance": instance}

        def synthesize(self, config, layouter):
            chip = SinsemillaChip(config["sinsemilla"])
            chip.load_table(layouter)
            d = m.sinsemilla.HashDomain(domain)
            p1 = chip.witness_message_piece(layouter, known(m, self.piece1),
                                            2)
            p2 = chip.witness_message_piece(layouter, known(m, self.piece2),
                                            1)
            point, _zs = chip.hash_to_point(layouter, d.Q, [p1, p2])
            layouter.constrain_instance(point.x.cell, config["instance"], 0)

    class PrivateInitCircuit(Circuit):
        """hash_to_point from a witnessed (private) Q."""

        def __init__(self, q=None, piece=None):
            self.q, self.piece = q, piece

        def without_witnesses(self):
            return PrivateInitCircuit()

        @classmethod
        def configure(cls, meta):
            advices = [meta.advice_column() for _ in range(5)]
            witness_pieces = meta.advice_column()
            meta.enable_equality(witness_pieces)
            fixed_y_q = meta.fixed_column()
            constants = meta.fixed_column()
            meta.enable_constant(constants)
            lookup = (meta.lookup_table_column(), meta.lookup_table_column(),
                      meta.lookup_table_column())
            instance = meta.instance_column()
            meta.enable_equality(instance)
            ecc_advices = [meta.advice_column() for _ in range(10)]
            ecc_lagrange = [meta.fixed_column() for _ in range(8)]
            ecc_range = LRC.configure(meta, FP, ecc_advices[9], lookup[0])
            ecc = EccChip.configure(meta, ecc_advices, ecc_lagrange,
                                    ecc_range, FP)
            cfg = SinsemillaChip.configure(
                meta, advices, witness_pieces, fixed_y_q, lookup, FP,
                allow_init_from_private_point=True)
            return {"sin": cfg, "ecc": ecc, "instance": instance}

        def synthesize(self, config, layouter):
            chip = SinsemillaChip(config["sin"])
            chip.load_table(layouter)
            ecc = EccChip(config["ecc"])
            q_pt = ecc.witness_point_non_id(layouter, known(m, self.q))
            p1 = chip.witness_message_piece(layouter, known(m, self.piece), 2)
            point, _ = chip.hash_to_point_with_private_init(layouter, q_pt,
                                                            [p1])
            layouter.constrain_instance(point.x.cell, config["instance"], 0)

    return SimpleNamespace(
        Ecc=EccCircuit, Hash=HashCircuit, HashClass=HashClassCircuit,
        RangeCheck=RangeCheckCircuit, RunningSum=RunningSumCircuit,
        Swap=SwapCircuit, Tagged45=Tagged45Circuit,
        Sinsemilla=SinsemillaCircuit, PrivateInit=PrivateInitCircuit)


def _points(m):
    pts = [m.PALLAS.mul(m.PALLAS.generator, s)
           for s in rand_ints(70, 2, 1 << 100)]
    return pts[0], pts[1]


def _ecc_args(m, kind):
    """(constructor args, instance) of an ECC case."""
    P = m.PALLAS
    p, q = _points(m)
    r = P.add(p, q)
    p_bad = (p[0], (p[1] + 1) % m.FP.modulus)

    def inst(pt):
        return [[0, 0]] if pt is None else [[pt[0], pt[1]]]
    return {
        "add": ((p, q, "add"), inst(r)),
        "add_p_neg_p": ((p, P.neg(p), "add"), inst(None)),
        "add_p_identity": ((p, None, "add"), inst(p)),
        "add_identities": ((None, None, "add"), inst(None)),
        "add_p_p": ((p, p, "add"), inst(P.double(p))),
        "add_wrong_result_fails": (
            (p, q, "add"), inst((r[0], (r[1] + 1) % m.FP.modulus))),
        "add_incomplete": ((p, q, "add_incomplete"), inst(r)),
        "point_not_on_curve_fails": ((p_bad, p_bad, "add"), inst(None)),
    }[kind]


ECC_KINDS = ("add", "add_p_neg_p", "add_p_identity", "add_identities",
             "add_p_p", "add_wrong_result_fails", "add_incomplete",
             "point_not_on_curve_fails")


def _sinsemilla_expected(m, piece1, piece2):
    bits = (m.utilities.i2lebsp(piece1, 20)
            + m.utilities.i2lebsp(piece2, 10))
    return m.sinsemilla.hash_to_point("z.cash:test-Sinsemilla", bits)[0]


def _private_init_expected(m, q, piece):
    p = m.sinsemilla_primitive
    acc = q
    for i in range(2):
        word = (piece >> (p.K * i)) & ((1 << p.K) - 1)
        acc = p._incomplete_add(p._incomplete_add(acc, p.sinsemilla_s(word)),
                                acc)
    return acc[0]


def _poseidon_expected(m, msg, delta=0):
    fq = m.FQ
    out = m.poseidon.poseidon_hash(fq, m.poseidon.P128Pow5T3(), msg)
    return (out + delta) % fq.modulus


Q_SCALAR = 987654321
PIECE = 0b0110011010_1010010110

# name -> (k, field, circuits attribute, constructor args(m), instance(m));
# the names ending in _fails are the chip tests' wrong-witness cases
CASES = {
    **{f"ecc_{kind}": (8, "FP", "Ecc",
                       lambda m, kind=kind: _ecc_args(m, kind)[0],
                       lambda m, kind=kind: _ecc_args(m, kind)[1])
       for kind in ECC_KINDS},
    "pow5_hash": (7, "FQ", "Hash", lambda m: ([123456789, 987654321],),
                  lambda m: [[_poseidon_expected(m, [123456789, 987654321])]]),
    "pow5_wrong_output_fails": (7, "FQ", "Hash", lambda m: ([5, 6],),
                                lambda m: [[_poseidon_expected(m, [5, 6], 1)]]),
    "pow5_hash_class": (7, "FQ", "HashClass", lambda m: ([17, 23],),
                        lambda m: [[_poseidon_expected(m, [17, 23])]]),
    "range_check": (7, "FQ", "RangeCheck", lambda m: (0xA7, 2), lambda m: []),
    "range_check_too_big_fails": (7, "FQ", "RangeCheck",
                                  lambda m: (0x1A7, 2), lambda m: []),
    "short_range_check": (7, "FQ", "RangeCheck",
                          lambda m: (5, 2, True, 3), lambda m: []),
    "short_range_check_fails": (7, "FQ", "RangeCheck",
                                lambda m: (9, 2, True, 3), lambda m: []),
    "running_sum": (6, "FQ", "RunningSum", lambda m: (0xABC,), lambda m: []),
    "running_sum_fails": (6, "FQ", "RunningSum", lambda m: (0x1ABC,),
                          lambda m: []),
    "cond_swap_0": (5, "FQ", "Swap", lambda m: (10, 20, 0), lambda m: []),
    "cond_swap_1": (5, "FQ", "Swap", lambda m: (10, 20, 1), lambda m: []),
    "cond_swap_nonbool_fails": (5, "FQ", "Swap", lambda m: (10, 20, 2),
                                lambda m: []),
    "tagged_4b": (7, "FQ", "Tagged45", lambda m: (13, 4), lambda m: []),
    "tagged_5b": (7, "FQ", "Tagged45", lambda m: (29, 5), lambda m: []),
    "tagged_4b_fails": (7, "FQ", "Tagged45", lambda m: (17, 4), lambda m: []),
    "tagged_5b_fails": (7, "FQ", "Tagged45", lambda m: (33, 5), lambda m: []),
    "sinsemilla": (11, "FP", "Sinsemilla",
                   lambda m: (0b01101_11010_01100_10111, 0b10101_01010),
                   lambda m: [[_sinsemilla_expected(
                       m, 0b01101_11010_01100_10111, 0b10101_01010)]]),
    "sinsemilla_wrong_output_fails": (
        11, "FP", "Sinsemilla", lambda m: (12345, 678),
        lambda m: [[(_sinsemilla_expected(m, 12345, 678) + 1)
                    % m.FP.modulus]]),
    "sinsemilla_private_init": (
        11, "FP", "PrivateInit",
        lambda m: (m.PALLAS.mul(m.PALLAS.generator, Q_SCALAR), PIECE),
        lambda m: [[_private_init_expected(
            m, m.PALLAS.mul(m.PALLAS.generator, Q_SCALAR), PIECE)]]),
}


@functools.lru_cache(maxsize=None)
def _prover(name: str, root: str):
    k, field, cls, args, instance = CASES[name]
    m = package(root)
    circuit = getattr(circuits(root), cls)(*args(m))
    return m.MockProver.run(k, circuit, instance(m), fs=getattr(m, field))


def _norm(errors):
    return [(type(e).__name__, dataclasses.astuple(e)) for e in errors]


@pytest.mark.parametrize("name", list(CASES))
def test_chip_verify_matches_reference(name):
    port, ref = _prover(name, PORT), _prover(name, REF)
    assert ([(r.index, r.name, r.rows) for r in port.regions]
            == [(r.index, r.name, r.rows) for r in ref.regions])
    errors = port.verify()
    assert _norm(errors) == _norm(ref.verify())
    assert bool(errors) == name.endswith("_fails")


@pytest.mark.parametrize("name", list(CASES))
def test_chip_verify_vectorized_matches_reference(name):
    """The gate check on the CPU (the plain versions of B1 and the
    add/subtract) equals the reference's and the host checker's gate
    stream."""
    port, ref = _prover(name, PORT), _prover(name, REF)
    before = dict(fk.LAUNCHES)
    errors = port.verify_vectorized(device="cpu")
    assert fk.LAUNCHES == before        # the CPU runs no kernel
    assert _norm(errors) == _norm(ref.verify_vectorized())
    assert _norm(errors) == _norm(port.verify(streams=("gates",)))


def test_witness_non_id_rejects_the_identity_as_the_reference_does():
    def run(m):
        circuit = circuits(m.root).Ecc(_points(m)[0], None, "add_incomplete")
        with pytest.raises(Exception) as info:
            m.MockProver.run(8, circuit, [[0, 0]], fs=m.FP)
        return type(info.value).__name__, str(info.value)
    ref, port = both(run)
    assert port == ref


def test_private_init_needs_the_flag_as_the_reference_does():
    def run(m):
        meta = m.ConstraintSystem()
        cfg = circuits(m.root).Sinsemilla.configure(meta)["sinsemilla"]
        chip = m.sinsemilla_chip.SinsemillaChip(cfg)
        with pytest.raises(m.error.IllegalHashFromPrivatePoint):
            chip.hash_to_point_with_private_init(None, None, [])
    both(run)
