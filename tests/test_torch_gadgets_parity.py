"""zcash/halo2's fifteen golden gadget circuits (tests/golden/vk_*.rdata,
proof_*.bin; K = 11 over Vesta, no public inputs) through the port, on
the CPU, exactly:

- each circuit's pinned constraint system, compressed-selector fixed
  columns and permutation mapping equal the JAX package's (host only);
- the port's keygen_vk reproduces each `vk_*.rdata` byte for byte, each
  golden proof verifies under the port's SingleVerifier, and a corrupted
  one is rejected;
- a golden circuit's proof (short_range_check_case1 at K = 11) is
  byte-equal to the JAX package's for the same seed, and verifies;
- a second proof with one proving key equals the first where a region
  of the circuit raised (the ECC mirror's case; the layout is then not
  replayed).

The commitments: one K = 11 commit through the plain Pippenger takes
about half a minute on a CPU, and a gadget key needs 10-25 of them. The
`params` fixture below therefore gives the port's Params a commit_many
that computes the same group elements with the native host MSM
(`curve.msm` over g_lagrange or g, then [blind]W added, as
Params.commit_many adds it). Everything else runs the port's own code;
the card builds the keys with its own commits (chip_smoke.py
`[gadgets]`)."""
import importlib
import os
import random
import re
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from halo2_tpu.curves import PALLAS as R_PALLAS, VESTA as R_VESTA
from halo2_tpu.circuit import (Circuit as RCircuit, Value as RValue,
                               synthesize_circuit as r_synthesize_circuit)
from halo2_tpu.plonk import keygen as rkeygen
from halo2_tpu.plonk.assigned import (batch_evaluate_assigned as
                                      r_batch_evaluate_assigned)
from halo2_tpu.plonk.circuit import ConstraintSystem as RConstraintSystem
from halo2_tpu.plonk.compress_selectors import (compress_selectors as
                                                r_compress_selectors)
from halo2_tpu.plonk.pinned import (pinned_cs_node as r_pinned_cs_node,
                                    render_alternate as r_render_alternate)
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.transcript import (TranscriptWrite as RTranscriptWrite,
                                  TranscriptRead as RTranscriptRead)
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch import gadget_circuits as gc
from halo2_tpu_torch.circuit import Circuit, Value, synthesize_circuit
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.plonk.circuit import ConstraintSystem
from halo2_tpu_torch.plonk.keygen import (Assembly, _fixed_ints, keygen_vk,
                                          keygen_pk)
from halo2_tpu_torch.plonk.keys import VerifyingKey
from halo2_tpu_torch.plonk.pinned import pinned_cs_node, render_alternate
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                            VerificationError)
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import (TranscriptRead, TranscriptWrite,
                                        TranscriptError)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
K = gc.K
SEED = 2
PORT_NS = gc.port_namespace()
REF_NS = gc.namespace(
    lambda mod: importlib.import_module(f"halo2_tpu.{mod}"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _host_commit_many(self, polys_mont, blinds, lagrange):
    """Params.commit_many's group elements by the native host MSM."""
    bases = self.g_lagrange if lagrange else self.g
    fs = self.curve.scalar
    out = []
    for poly, blind in zip(polys_mont, blinds):
        pt = self.curve.msm(list(self.scalar_df.from_mont_np(poly)), bases)
        blind %= fs.modulus
        if blind:
            pt = self.curve.add(pt, self.curve.mul(self.w, blind))
        out.append(pt)
    return out


@pytest.fixture(scope="module")
def params():
    """The port's K = 11 Vesta Params on the CPU, committing by the native
    host MSM (this object only)."""
    p = Params.new(VESTA, K, device="cpu", use_cache=False)
    p.commit_many = types.MethodType(_host_commit_many, p)
    return p


def _golden_text(name):
    with open(os.path.join(GOLDEN, f"vk_{name}.rdata")) as fh:
        return fh.read()


def _golden_proof(name):
    with open(os.path.join(GOLDEN, f"proof_{name}.bin"), "rb") as fh:
        return fh.read()


def _golden_commitments(text):
    def points(block):
        return [(int(x, 16), int(y, 16)) for x, y in re.findall(
            r"\(0x([0-9a-f]+), 0x([0-9a-f]+)\)", block)]
    fixed = re.search(r"fixed_commitments: \[(.*?)\n    \]", text, re.S)
    perm = re.search(r"permutation: VerifyingKey \{\s*commitments: "
                     r"\[(.*?)\n        \]", text, re.S)
    return points(fixed.group(1)), points(perm.group(1))


def _assemble(ns, cs_cls, assembly_cls, synthesize, fs, name):
    """keygen's synthesis of one package: its constraint system and its
    Assembly (fixed cells, selectors, copies)."""
    cs = cs_cls()
    circuit = gc.golden_circuit(ns, name)
    config = type(circuit).configure(cs)
    assembly = assembly_cls(cs, SimpleNamespace(n=1 << K, k=K), fs)
    synthesize(assembly, circuit.without_witnesses(), config, cs.constants)
    return cs, assembly


@pytest.mark.parametrize("name", gc.GOLDEN)
def test_constraint_system_fixed_columns_and_permutation_match_reference(
        name):
    """Host only: the pinned constraint system (gates, lookups, selector
    compression), every fixed column after compression and the
    permutation mapping equal the JAX package's; rebuilt around the
    golden commitments, the pinned vk is the golden text."""
    cs, asm = _assemble(PORT_NS, ConstraintSystem, Assembly,
                        synthesize_circuit, VESTA.scalar, name)
    cs2, fixed = _fixed_ints(VESTA.scalar, cs, asm)
    rcs, rasm = _assemble(REF_NS, RConstraintSystem, rkeygen.Assembly,
                          r_synthesize_circuit, R_VESTA.scalar, name)
    rcs2, rsel = r_compress_selectors(rcs, rasm.selectors)
    rfixed = [r_batch_evaluate_assigned(R_VESTA.scalar, col)
              for col in rasm.fixed]
    rfixed.extend([v % R_VESTA.scalar.modulus for v in poly] for poly in rsel)

    assert (render_alternate(pinned_cs_node(cs2))
            == r_render_alternate(r_pinned_cs_node(rcs2)))
    assert fixed == rfixed
    for attr in ("map_col", "map_row"):
        assert np.array_equal(getattr(asm.permutation, attr),
                              getattr(rasm.permutation, attr)), attr

    text = _golden_text(name)
    gold_fixed, gold_perm = _golden_commitments(text)
    assert len(gold_fixed) == len(fixed)
    n = 1 << K
    extended_k = K
    while (1 << extended_k) < n * (cs2.degree() - 1):
        extended_k += 1
    fs = VESTA.scalar
    omega = pow(fs.root_of_unity, 1 << (fs.s - K), fs.modulus)
    domain = SimpleNamespace(pinned=lambda: {
        "k": K, "extended_k": extended_k, "omega": omega})
    vk = VerifyingKey(VESTA, domain, gold_fixed, gold_perm, cs2,
                      cs2.degree())
    assert vk.pinned_text() + "\n" == text


_KEYS: dict = {}


def _vk(params, name):
    if name not in _KEYS:
        _KEYS[name] = keygen_vk(params, gc.golden_circuit(PORT_NS, name))
    return _KEYS[name]


@pytest.mark.parametrize("name", gc.GOLDEN)
def test_pinned_vk_equals_golden_and_golden_proof_verifies(params, name):
    vk = _vk(params, name)
    assert vk.pinned_text() + "\n" == _golden_text(name)
    verify_proof(params, vk, SingleVerifier(params), [[]],
                 TranscriptRead(VESTA, _golden_proof(name)))


@pytest.mark.parametrize("where", ["point", "scalar"])
def test_corrupted_golden_proof_rejected(params, where):
    """One byte of ecc_chip's proof changed: in the first advice
    commitment, or in the last scalar of the IPA."""
    proof = bytearray(_golden_proof("ecc_chip"))
    proof[0 if where == "point" else len(proof) - 20] ^= 0x01
    with pytest.raises((VerificationError, TranscriptError)):
        verify_proof(params, _vk(params, "ecc_chip"), SingleVerifier(params),
                     [[]], TranscriptRead(VESTA, bytes(proof)))


def test_golden_circuit_proof_matches_reference(params):
    """short_range_check_case1 (the cheapest golden circuit with a
    lookup) proved at K = 11 by both packages with the same seed: the
    same bytes; the proof verifies under the port's verifier."""
    name = "short_range_check_case1"
    rparams = RParams.new(R_VESTA, K, use_cache=False)
    rcircuit = gc.golden_circuit(REF_NS, name)
    rvk = rplonk.keygen_vk(rparams, rcircuit)
    rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
    tw = RTranscriptWrite(R_VESTA)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[]], random.Random(SEED),
                        tw)
    rproof = tw.finalize()

    circuit = gc.golden_circuit(PORT_NS, name)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(VESTA)
    create_proof(params, pk, [circuit], [[]], random.Random(SEED), tw)
    proof = tw.finalize()
    assert proof == rproof
    verify_proof(params, vk, SingleVerifier(params), [[]],
                 TranscriptRead(VESTA, proof))
    rplonk.verify_proof(rparams, rvk, rplonk.SingleVerifier(rparams), [[]],
                        RTranscriptRead(R_VESTA, proof))


def raising_region_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    """MulCircuit with, between its two regions, a region that assigns a
    cell and then raises, which synthesize catches: the ECC mirror's
    identity witnessed as a non-identity point, at K = 4."""
    class RaisingRegionCircuit(circuit_base):
        def __init__(self, a=None, b=None):
            self.a, self.b = a, b

        def without_witnesses(self):
            return RaisingRegionCircuit()

        @classmethod
        def configure(cls, meta):
            a, b = meta.advice_column(), meta.advice_column()
            instance = meta.instance_column()
            s = meta.selector()
            meta.enable_equality(a)
            meta.enable_equality(instance)
            meta.create_gate("mul", lambda c: [(
                "mul", c.query_selector(s)
                * (c.query_advice(a, rotation_cls(0))
                   * c.query_advice(b, rotation_cls(0))
                   - c.query_advice(a, rotation_cls(1))))])
            return {"a": a, "b": b, "instance": instance, "s": s}

        def synthesize(self, config, layouter):
            def known(v):
                return (value_cls.known(v) if self.a is not None
                        else value_cls.unknown())

            def raising(region):
                region.assign_advice("junk", config["a"], 0,
                                     lambda: value_cls.known(99))
                raise ValueError("the region refuses its witness")

            def mul(region):
                region.enable_selector("s", config["s"], 0)
                region.assign_advice("a", config["a"], 0,
                                     lambda: known(self.a))
                region.assign_advice("b", config["b"], 0,
                                     lambda: known(self.b))
                return region.assign_advice(
                    "out", config["a"], 1,
                    lambda: known(fs.mul(self.a or 0, self.b or 0)))

            layouter.assign_region("first", mul)
            try:
                layouter.assign_region("raising", raising)
            except ValueError:
                pass
            out = layouter.assign_region("second", mul)
            layouter.constrain_instance(out.cell, config["instance"], 0)

    return RaisingRegionCircuit


def test_repeat_proof_with_a_raising_region_matches_reference():
    """The prover caches a circuit's simple-planner layout in the pk and
    replays it on the next proof. A region whose closure raises takes no
    rows; the port does not replay such a layout, so the second proof
    with one pk equals the first and the JAX package's (whose own second
    proof would replay it)."""
    k, a, b = 4, 7, 191
    out = R_PALLAS.scalar.mul(a, b)
    rparams = RParams.new(R_PALLAS, k, use_cache=False)
    port_params = params_from_reference("pallas", k, rparams.g,
                                        rparams.g_lagrange, rparams.w,
                                        rparams.u, "cpu")
    rcircuit = raising_region_circuit_class(RCircuit, RValue, RRotation,
                                            R_PALLAS.scalar)(a, b)
    circuit = raising_region_circuit_class(Circuit, Value, Rotation,
                                           PALLAS.scalar)(a, b)
    rvk = rplonk.keygen_vk(rparams, rcircuit)
    rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
    tw = RTranscriptWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                        random.Random(SEED), tw)
    rproof = tw.finalize()

    vk = keygen_vk(port_params, circuit)
    pk = keygen_pk(port_params, vk, circuit)
    proofs = []
    for _ in range(2):
        tw = TranscriptWrite(PALLAS)
        create_proof(port_params, pk, [circuit], [[[out]]],
                     random.Random(SEED), tw)
        proofs.append(tw.finalize())
    assert proofs[0] == proofs[1] == rproof
    verify_proof(port_params, vk, SingleVerifier(port_params), [[[out]]],
                 TranscriptRead(PALLAS, proofs[1]))
