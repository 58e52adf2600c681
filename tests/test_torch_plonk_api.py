"""halo2's plonk_api circuit (a lookup, a permutation in more than one
chunk, an instance column) through the port, on the CPU, against the two
golden proofs of tests/test_plonk_api_parity.py:

  tests/golden/plonk_api_proof.bin      zcash/halo2's own proof bytes
                                        (two instances, K = 5, VESTA)
  tests/golden/plonk_api_tpu_proof.bin  the JAX package's proof with
                                        random.Random(1234)

Neither check needs JAX; both also run on the card (chip_smoke.py)."""
import hashlib
import os
import random

import pytest
import torch

from halo2_tpu_torch.bench_circuit import (plonk_api_circuit_class,
                                           plonk_api_inputs, PLONK_API_K,
                                           PLONK_API_SEED)
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.curves.host import VESTA
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                            VerificationError)
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FS = VESTA.scalar
PlonkApiCircuit = plonk_api_circuit_class(Circuit, Value, Rotation, FS)
A, INSTANCE, TABLE = plonk_api_inputs(FS)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain point ops of 26 K = 5 commitments dominate this file;
    two threads keep it near the other port files' time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    params = Params.new(VESTA, PLONK_API_K, device="cpu")
    vk = keygen_vk(params, PlonkApiCircuit(None, TABLE))
    return params, vk


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as fh:
        return fh.read()


def _verify(params, vk, proof, instance):
    verify_proof(params, vk, SingleVerifier(params),
                 [[[INSTANCE]], [[instance]]], TranscriptRead(VESTA, proof))


def test_plonk_api_vk_matches_pinned_golden(keys):
    _, vk = keys
    assert vk.pinned_text() == _golden("pinned_vk_plonk_api.txt").decode()
    cs = vk.cs
    assert len(cs.lookups) == 1
    assert -(-len(cs.permutation.columns) // (cs.degree() - 2)) > 1


def test_zcash_halo2_proof_verifies_under_port(keys):
    params, vk = keys
    proof = _golden("plonk_api_proof.bin")
    _verify(params, vk, proof, INSTANCE)
    with pytest.raises(VerificationError):
        _verify(params, vk, proof, INSTANCE + 1)


def test_port_proof_equals_the_jax_golden(keys):
    """Two instances in one proof, random.Random(1234): the bytes of
    tests/golden/plonk_api_tpu_proof.bin; the proof verifies."""
    params, vk = keys
    circuit = PlonkApiCircuit(A, TABLE)
    pk = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(VESTA)
    create_proof(params, pk, [circuit, circuit], [[[INSTANCE]], [[INSTANCE]]],
                 random.Random(PLONK_API_SEED), tw)
    proof = tw.finalize()
    assert hashlib.sha256(proof).hexdigest() == hashlib.sha256(
        _golden("plonk_api_tpu_proof.bin")).hexdigest()
    _verify(params, vk, proof, INSTANCE)
