"""The port's AccumulatorStrategy, BatchVerifier, Guard.compute_g and the
device branch of MSMAccumulator.eval against the JAX package and the
host MSM, on the CPU, for MulCircuit at K = 4 (as
tests/test_plonk_e2e.py:131 runs the reference's).

The port proves twice; both verifiers read the same proof bytes over the
same SRS (carried by halo2_tpu_torch.convert). Points and verdicts are
compared exactly."""
import random

import pytest
import torch

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.transcript import TranscriptRead as RTranscriptRead
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves import native
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.ops import msm as msm_ops
from halo2_tpu_torch.plonk import AccumulatorStrategy, BatchVerifier
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof, VerificationError
from halo2_tpu_torch.poly import commitment
from halo2_tpu_torch.poly.commitment import Accumulator, compute_s
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

from test_torch_prover import mul_circuit_class, SEED

K = 4
WITNESSES = ((7, 191), (2, 13))
FS = PALLAS.scalar


@pytest.fixture(scope="module")
def built():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rparams = RParams.new(R_PALLAS, K, use_cache=False)
    params = params_from_reference("pallas", K, rparams.g,
                                   rparams.g_lagrange, rparams.w, rparams.u,
                                   "cpu")
    cls = mul_circuit_class(Circuit, Value, Rotation, FS)
    rcls = mul_circuit_class(RCircuit, RValue, RRotation, R_PALLAS.scalar)
    vk = keygen_vk(params, cls(*WITNESSES[0]))
    pk = keygen_pk(params, vk, cls(*WITNESSES[0]))
    proofs, outs = [], []
    for i, (a, b) in enumerate(WITNESSES):
        outs.append(FS.mul(a, b))
        tw = TranscriptWrite(PALLAS)
        create_proof(params, pk, [cls(a, b)], [[[outs[-1]]]],
                     random.Random(SEED + i), tw)
        proofs.append(tw.finalize())
    yield dict(params=params, vk=vk, rparams=rparams,
               rvk=rplonk.keygen_vk(rparams, rcls(*WITNESSES[0])),
               proofs=proofs, outs=outs)
    torch.set_num_threads(n)


class _Keep:
    """A strategy that keeps the opening's Guard."""

    def __init__(self, params):
        self.params = params

    def process(self, f):
        self.guard = f(self.params.empty_msm())


def _guard(b, i, out=None):
    keep = _Keep(b["params"])
    verify_proof(b["params"], b["vk"], keep,
                 [[[b["outs"][i] if out is None else out]]],
                 TranscriptRead(PALLAS, b["proofs"][i]))
    return keep.guard


@pytest.mark.parametrize("i", [0, 1])
def test_accumulator_strategy_matches_reference(built, i):
    b = built
    acc = verify_proof(b["params"], b["vk"], AccumulatorStrategy(b["params"]),
                       [[[b["outs"][i]]]],
                       TranscriptRead(PALLAS, b["proofs"][i]))
    racc = rplonk.verify_proof(b["rparams"], b["rvk"],
                               rplonk.AccumulatorStrategy(b["rparams"]),
                               [[[b["outs"][i]]]],
                               RTranscriptRead(R_PALLAS, b["proofs"][i]))
    assert isinstance(acc, Accumulator)
    assert acc.g is not None and len(acc.u_packed) == K
    assert acc.g == racc.g
    assert acc.u_packed == racc.u_packed
    with pytest.raises(VerificationError):
        verify_proof(b["params"], b["vk"], AccumulatorStrategy(b["params"]),
                     [[[b["outs"][i] + 1]]],
                     TranscriptRead(PALLAS, b["proofs"][i]))


def _batch(b, proofs, outs, reference):
    if reference:
        batch = rplonk.BatchVerifier(b["rparams"])
    else:
        batch = BatchVerifier(b["params"])
    for proof, out in zip(proofs, outs):
        batch.add_proof([[[out]]], proof)
    return batch.finalize(b["rvk"] if reference else b["vk"])


def _corrupt(proof):
    """The last scalar of the proof (the IPA's f) changed by one: still a
    canonical scalar, so both verifiers read it and reject the opening."""
    bad = bytearray(proof)
    bad[-32] ^= 1
    return bytes(bad)


@pytest.mark.parametrize("case", ["valid", "corrupted", "wrong_instance"])
def test_batch_verifier_verdicts_match_reference(built, case):
    b = built
    proofs, outs = list(b["proofs"]), list(b["outs"])
    if case == "corrupted":
        proofs[1] = _corrupt(proofs[1])
    elif case == "wrong_instance":
        outs[1] += 1
    want = case == "valid"
    assert _batch(b, proofs, outs, reference=False) is want
    assert _batch(b, proofs, outs, reference=True) is want


def test_batch_verifier_rejects_a_malformed_proof(built):
    """A proof cut short fails the batch instead of raising."""
    b = built
    proofs = [b["proofs"][0], b["proofs"][1][:-1]]
    assert _batch(b, proofs, b["outs"], reference=False) is False


def test_compute_g_matches_host_msm(built, monkeypatch):
    """G = <s, g> on the host branch (n = 16 is under the threshold) and
    on the device Pippenger with the packed SRS bases (threshold 0)."""
    b = built
    guard = _guard(b, 0)
    want = PALLAS.msm(compute_s(FS, guard.u, 1), b["params"].g)
    assert guard.compute_g() == want
    calls = []
    real = msm_ops.msm_many
    monkeypatch.setattr(msm_ops, "msm_many",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(msm_ops, "HOST_MSM_THRESHOLD", 0)
    assert guard.compute_g() == want
    assert len(calls) == 1 and calls[0]["packed"] is not None


@pytest.mark.parametrize("valid", [True, False])
def test_eval_device_branch_matches_host(built, valid, monkeypatch):
    """MSMAccumulator.eval without the native library and above the term
    limit (both patched, and the MSM threshold at 0) runs one device
    MSM; its verdict equals the host branch's, on a valid proof and on a
    wrong instance."""
    b = built
    msm = _guard(b, 0, None if valid else b["outs"][0] + 1).use_challenges()
    assert msm.clone().eval() is valid
    calls = []
    real = msm_ops.msm_many
    monkeypatch.setattr(msm_ops, "msm_many",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(commitment, "DEVICE_EVAL_THRESHOLD", 0)
    monkeypatch.setattr(msm_ops, "HOST_MSM_THRESHOLD", 0)
    assert msm.clone().eval() is valid
    assert len(calls) == 1
