"""The port's keygen -> create_proof -> verify_proof against the JAX
reference, on the CPU.

Both provers get the same Params (carried by halo2_tpu_torch.convert), the
same circuit and the same seeded random.Random; the vk hash, the proving
key arrays and the proof bytes must be equal, and proofs must verify
across the two verifiers."""
import os
import random
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.transcript import (TranscriptWrite as RTranscriptWrite,
                                  TranscriptRead as RTranscriptRead)
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.bench_circuit import bench_circuit_class, expected_output
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import (params_from_reference,
                                     proving_key_arrays_from_numpy,
                                     load_proving_key_arrays, PK_ARRAYS)
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                            VerificationError)
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2024


def mul_circuit_class(circuit_base, value_cls, rotation_cls, fs):
    """tests/test_plonk_e2e.py's MulCircuit against either circuit API:
    out = a * b, copied to the instance column."""
    class MulCircuit(circuit_base):
        def __init__(self, a=None, b=None):
            self.a = a
            self.b = b

        def without_witnesses(self):
            return MulCircuit()

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
                out = cells.query_advice(col_a, rotation_cls(1))
                s = cells.query_selector(s_mul)
                return [("mul", s * (a * b - out))]

            meta.create_gate("mul", gate)
            return {"a": col_a, "b": col_b, "instance": instance,
                    "s_mul": s_mul}

        def synthesize(self, config, layouter):
            def region_fn(region):
                region.enable_selector("s", config["s_mul"], 0)
                region.assign_advice("a", config["a"], 0,
                                     lambda: value_cls.known(self.a))
                region.assign_advice("b", config["b"], 0,
                                     lambda: value_cls.known(self.b))
                return region.assign_advice(
                    "out", config["a"], 1,
                    lambda: value_cls.known(fs.mul(self.a, self.b)))

            out = layouter.assign_region("mul", region_fn)
            layouter.constrain_instance(out.cell, config["instance"], 0)

    return MulCircuit


# name -> (k, circuit args, public output)
CASES = {
    "mul": (4, (7, 191), R_PALLAS.scalar.mul(7, 191)),
    "bench": (5, (5, 6), expected_output(R_PALLAS.scalar, 5, 6)),
}
_BUILT: dict = {}


def _classes(name):
    factory = mul_circuit_class if name == "mul" else bench_circuit_class
    return (factory(RCircuit, RValue, RRotation, R_PALLAS.scalar),
            factory(Circuit, Value, Rotation, PALLAS.scalar))


def _prove_ref(rparams, rpk, rcircuit, out):
    tw = RTranscriptWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                        random.Random(SEED), tw)
    return tw.finalize()


def _prove_port(params, pk, circuit, out):
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [circuit], [[[out]]], random.Random(SEED), tw)
    return tw.finalize()


def _verify_port(params, vk, proof, out):
    verify_proof(params, vk, SingleVerifier(params), [[[out]]],
                 TranscriptRead(PALLAS, proof))


def _verify_ref(rparams, rvk, proof, out):
    rplonk.verify_proof(rparams, rvk, rplonk.SingleVerifier(rparams),
                        [[[out]]], RTranscriptRead(R_PALLAS, proof))


def built(name):
    """Keys and one proof from each prover for CASES[name] (made once per
    test process)."""
    if name not in _BUILT:
        k, args, out = CASES[name]
        rcls, cls = _classes(name)
        rparams = RParams.new(R_PALLAS, k, use_cache=False)
        params = params_from_reference("pallas", k, rparams.g,
                                       rparams.g_lagrange, rparams.w,
                                       rparams.u, "cpu")
        rcircuit, circuit = rcls(*args), cls(*args)
        rvk = rplonk.keygen_vk(rparams, rcircuit)
        rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
        vk = keygen_vk(params, circuit)
        pk = keygen_pk(params, vk, circuit)
        _BUILT[name] = dict(
            out=out, rparams=rparams, params=params, rcircuit=rcircuit,
            circuit=circuit, rvk=rvk, rpk=rpk, vk=vk, pk=pk,
            rproof=_prove_ref(rparams, rpk, rcircuit, out),
            proof=_prove_port(params, pk, circuit, out))
    return _BUILT[name]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_pk_arrays(rpk) -> dict:
    return {
        "fixed_values": [np.asarray(a) for a in rpk.fixed_values],
        "fixed_polys": [np.asarray(a) for a in rpk.fixed_polys],
        "fixed_cosets": [np.asarray(a) for a in rpk.fixed_cosets],
        "l0": np.asarray(rpk.l0),
        "l_blind": np.asarray(rpk.l_blind),
        "l_last": np.asarray(rpk.l_last),
        "permutation_permutations": [np.asarray(a) for a in
                                     rpk.permutation.permutations],
        "permutation_polys": [np.asarray(a) for a in rpk.permutation.polys],
        "permutation_cosets": [np.asarray(a)
                               for a in rpk.permutation.cosets],
    }


@pytest.mark.parametrize("name", list(CASES))
def test_vk_matches_reference(name):
    b = built(name)
    assert b["vk"].transcript_repr() == b["rvk"].transcript_repr()
    assert b["vk"].pinned_text() == b["rvk"].pinned_text()
    assert b["vk"].fixed_commitments == b["rvk"].fixed_commitments
    assert (b["vk"].permutation_commitments
            == b["rvk"].permutation_commitments)


@pytest.mark.parametrize("name", list(CASES))
def test_proving_key_arrays_match_reference(name):
    """convert.proving_key_arrays_from_numpy carries the reference's pk
    arrays; the port's own keygen computed the same tensors."""
    b = built(name)
    ref = proving_key_arrays_from_numpy(_reference_pk_arrays(b["rpk"]),
                                        "cpu")
    pk = b["pk"]
    mine = {
        "fixed_values": pk.fixed_values, "fixed_polys": pk.fixed_polys,
        "fixed_cosets": pk.fixed_cosets, "l0": pk.l0,
        "l_blind": pk.l_blind, "l_last": pk.l_last,
        "permutation_permutations": pk.permutation.permutations,
        "permutation_polys": pk.permutation.polys,
        "permutation_cosets": pk.permutation.cosets,
    }
    assert set(ref) == set(PK_ARRAYS)
    for key in PK_ARRAYS:
        want, got = ref[key], mine[key]
        if isinstance(want, list):
            assert len(got) == len(want), key
            for g, w in zip(got, want):
                assert torch.equal(g, w), key
        else:
            assert torch.equal(got, want), key


@pytest.mark.parametrize("name", list(CASES))
def test_proof_bytes_match_reference(name):
    b = built(name)
    assert b["proof"] == b["rproof"]


def test_proof_from_carried_proving_key():
    """A port pk whose arrays were all carried over from the reference
    proves the same bytes."""
    b = built("bench")
    pk = keygen_pk(b["params"], b["vk"], b["circuit"])
    load_proving_key_arrays(pk, proving_key_arrays_from_numpy(
        _reference_pk_arrays(b["rpk"]), "cpu"))
    assert _prove_port(b["params"], pk, b["circuit"], b["out"]) == \
        b["rproof"]


@pytest.mark.parametrize("name", list(CASES))
def test_port_proof_verifies_under_both_verifiers(name):
    b = built(name)
    _verify_port(b["params"], b["vk"], b["proof"], b["out"])
    _verify_ref(b["rparams"], b["rvk"], b["proof"], b["out"])


@pytest.mark.parametrize("name", list(CASES))
def test_reference_proof_verifies_under_port(name):
    b = built(name)
    _verify_port(b["params"], b["vk"], b["rproof"], b["out"])


@pytest.mark.parametrize("name", list(CASES))
def test_wrong_instance_rejected(name):
    b = built(name)
    with pytest.raises(VerificationError):
        _verify_port(b["params"], b["vk"], b["proof"], b["out"] + 1)
    with pytest.raises(rplonk.VerificationError):
        _verify_ref(b["rparams"], b["rvk"], b["proof"], b["out"] + 1)


def test_circuit_with_lookup_proves_and_verifies():
    """Lookups were once refused by keygen; a circuit with one (an advice
    column looked up in an unassigned table) now keygens, proves and
    verifies."""
    class LookupCircuit(Circuit):
        def without_witnesses(self):
            return LookupCircuit()

        @classmethod
        def configure(cls, meta):
            a = meta.advice_column()
            t = meta.lookup_table_column()
            meta.lookup("t", lambda cells: [
                (cells.query_advice(a, Rotation(0)), t)])

        def synthesize(self, config, layouter):
            pass

    params = built("mul")["params"]
    vk = keygen_vk(params, LookupCircuit())
    pk = keygen_pk(params, vk, LookupCircuit())
    assert len(vk.cs.lookups) == 1
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [LookupCircuit()], [[]], random.Random(SEED), tw)
    verify_proof(params, vk, SingleVerifier(params), [[]],
                 TranscriptRead(PALLAS, tw.finalize()))


def test_entry_points_require_a_gpu_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Params.new(PALLAS, 2)


_ISOLATED = textwrap.dedent("""
    import importlib, pkgutil, random, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "halo2_tpu"):
                raise ImportError("blocked: " + name)

    for name in list(sys.modules):
        if name.split(".")[0] in ("jax", "jaxlib", "halo2_tpu"):
            del sys.modules[name]
    sys.meta_path.insert(0, Block())

    import halo2_tpu_torch
    for m in pkgutil.walk_packages(halo2_tpu_torch.__path__,
                                   "halo2_tpu_torch."):
        importlib.import_module(m.name)

    from halo2_tpu_torch.bench_circuit import BenchCircuit, expected_output
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.plonk.prover import create_proof
    from halo2_tpu_torch.plonk.verifier import verify_proof, SingleVerifier
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

    params = Params.new(PALLAS, 4, device="cpu")
    circuit = BenchCircuit(5, 3)
    out = expected_output(PALLAS.scalar, 5, 3)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [circuit], [[[out]]], random.Random(1), tw)
    verify_proof(params, vk, SingleVerifier(params), [[[out]]],
                 TranscriptRead(PALLAS, tw.finalize()))

    # the multi-device layer: the same proof under a mesh of one gloo rank
    from halo2_tpu_torch.parallel import ProverMesh, make_mesh
    from halo2_tpu_torch.parallel.launch import world_of_one
    with world_of_one("gloo", 60):
        mesh_tw = TranscriptWrite(PALLAS)
        with ProverMesh(make_mesh(device="cpu")):
            create_proof(params, pk, [circuit], [[[out]]], random.Random(1),
                         mesh_tw)
    assert mesh_tw.finalize() == tw.finalize()

    # the gadgets: a golden circuit satisfied under the mock prover, and a
    # Poseidon transcript
    import halo2_tpu_torch.gadgets
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.host import FP
    from halo2_tpu_torch.gadget_circuits import port_namespace, golden_circuit
    from halo2_tpu_torch.transcript import PoseidonTranscriptWrite
    ns = port_namespace()
    MockProver.run(11, golden_circuit(ns, "short_range_check_case1"), [],
                   fs=FP).assert_satisfied()
    PoseidonTranscriptWrite(PALLAS).squeeze_challenge()

    # SHA-256: the bit-decomposition chip's compression of "abc" copied
    # to its instance (sha256_circuits.py)
    from halo2_tpu_torch import sha256_circuits as sc
    from halo2_tpu_torch.gadgets.sha256 import IV, compress_host
    ns = sc.port_namespace()
    want = compress_host(list(IV), sc.ABC_BLOCK)
    assert MockProver.run(sc.K_COMPRESS, ns.classes.Compress(sc.ABC_BLOCK),
                          [want], fs=ns.FQ).verify(
        streams=("permutation",)) == []

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "halo2_tpu")]
    assert not bad, bad
    print("isolated ok")
""")


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port imports, a K = 4 proof is made and
    verified on the CPU, and made again under a mesh of one rank
    (parallel/), a golden gadget circuit (gadget_circuits.py)
    passes the mock prover and the SHA-256 chip's compression is copied
    to its instance, with jax and halo2_tpu unimportable."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "isolated ok" in res.stdout
