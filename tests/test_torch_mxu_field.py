"""The port's four-step NTT on shared-constant products
(halo2_tpu_torch/ops/mxu_field.py, kernel K1's plain version) against
the JAX package's halo2_tpu/ops/mxu_field.py, bit for bit: the band
tables, the grouped constant product (edge constants and values in both
fields), ntt_mxu and ntt_mxu_b forward and inverse, the domain's route
by size, and a K = 4 proof with every transform through the four-step.
"""
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.fields.device import (FP_DEV as R_FP_DEV, FQ_DEV as R_FQ_DEV,
                                     fmul as r_fmul)
from halo2_tpu.ops import mxu_field as rmxu
from halo2_tpu.ops.ntt import make_plan as r_make_plan, ntt as r_ntt
from halo2_tpu.poly import Params as RParams
from halo2_tpu.transcript import TranscriptWrite as RTranscriptWrite
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV
from halo2_tpu_torch.ops import mxu_field as mxu
from halo2_tpu_torch.ops.field_kernels import fmul
from halo2_tpu_torch.ops.ntt import make_plan, ntt_many
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.poly import domain as port_domain
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite

from test_torch_prover import mul_circuit_class, SEED

FIELDS = [(FP_DEV, R_FP_DEV), (FQ_DEV, R_FQ_DEV)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


@pytest.mark.parametrize("fields", FIELDS, ids=["fp", "fq"])
def test_band_matrices_match_reference(fields):
    df, rdf = fields
    p = df.spec.modulus
    consts = [0, 1, p - 1, p - 2] + _values(p, 5, 1)
    got = mxu.band_matrices(df, consts)
    assert got.dtype == np.float32
    assert np.array_equal(got, rmxu.band_matrices(rdf, consts))
    assert np.array_equal(mxu.band_matrix(consts[5]),
                          rmxu.band_matrix(consts[5]))


@pytest.mark.parametrize("fields", FIELDS, ids=["fp", "fq"])
def test_mul_const_grouped_matches_reference_and_fmul(fields):
    """G = 6 groups of nb = 9 lanes: the constants and the values include
    0, 1, p - 1 and p - 2 (p - 1 times p - 1 is the column sums' worst
    case)."""
    df, rdf = fields
    p = df.spec.modulus
    G, nb = 6, 9
    consts = [0, 1, p - 1, p - 2] + _values(p, G - 4, 2)
    vals = [[0, 1, p - 1, p - 2] + _values(p, nb - 4, 3 + g)
            for g in range(G)]
    x = df.to_mont_np(vals)                                   # [G, nb, 16]
    c = df.to_mont_np(consts)                                 # [G, 16]
    got = mxu.mul_const_grouped(df, torch.from_numpy(x), torch.from_numpy(c))
    want = np.asarray(rmxu.mul_const_grouped(
        rdf, jnp.asarray(x.astype(np.uint32)),
        jnp.asarray(rmxu.band_matrices(rdf, consts))))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert torch.equal(got, fmul(df, torch.from_numpy(x),
                                 torch.from_numpy(c)[:, None]))
    for g in range(G):
        ref = np.asarray(r_fmul(rdf, jnp.asarray(x[g].astype(np.uint32)),
                                jnp.asarray(c[g].astype(np.uint32))))
        assert np.array_equal(got[g].numpy(), ref.astype(np.int32))


def _plans(df, rdf, k):
    p = df.spec.modulus
    omega = pow(df.spec.root_of_unity, 1 << (df.spec.s - k), p)
    omega_inv = pow(omega, p - 2, p)
    return [(make_plan(df, 1 << k, w), r_make_plan(rdf, 1 << k, w))
            for w in (omega, omega_inv)]


@pytest.mark.parametrize("k", [4, 7, 10])
def test_ntt_mxu_matches_reference(k):
    """ntt_mxu forward and inverse against the JAX ntt_mxu and the port's
    B7 plain version (held to the JAX ntt by tests/test_torch_ntt.py; the
    JAX ntt itself in the batched test below), in Fp (Fq below)."""
    df, rdf = FP_DEV, R_FP_DEV
    n = 1 << k
    x = df.to_mont_np(_values(df.spec.modulus, n, 10 + k))
    xj = jnp.asarray(x.astype(np.uint32))
    for plan, rplan in _plans(df, rdf, k):
        got = mxu.ntt_mxu(df, torch.from_numpy(x), plan).numpy()
        assert np.array_equal(
            got, np.asarray(rmxu.ntt_mxu(rdf, xj, rplan)).astype(np.int32))
        assert np.array_equal(
            got, ntt_many(df, torch.from_numpy(x)[None], plan)[0].numpy())


def test_ntt_mxu_b_matches_reference():
    """m = 3 columns at k = 8, forward and inverse, against the JAX
    ntt_mxu_b and ntt column by column, in Fq."""
    df, rdf = FQ_DEV, R_FQ_DEV
    k, m = 8, 3
    n = 1 << k
    x = df.to_mont_np([_values(df.spec.modulus, n, 20 + j)
                       for j in range(m)])
    xj = jnp.asarray(x.astype(np.uint32))
    for plan, rplan in _plans(df, rdf, k):
        got = mxu.ntt_mxu_b(df, torch.from_numpy(x), plan).numpy()
        assert np.array_equal(
            got, np.asarray(rmxu.ntt_mxu_b(rdf, xj, rplan)).astype(np.int32))
        for j in range(m):
            assert np.array_equal(
                got[j], np.asarray(r_ntt(rdf, xj[j], rplan)).astype(np.int32))


def test_route_by_size():
    """The four-step only on CUDA, from MXU_NTT_MIN (2^16) up; never on the
    CPU, at any size."""
    assert port_domain.MXU_NTT_MIN == 1 << 16
    for n in (1, 1 << 10, 1 << 16, 1 << 20, 1 << 24):
        assert not port_domain._use_mxu(n, "cpu")
        assert port_domain._use_mxu(n, "cuda") == (n >= 1 << 16)
        assert port_domain._use_mxu(n, torch.device("cuda", 0)) == (
            n >= 1 << 16)


def k4_proofs(**port_kw):
    """MulCircuit (tests/test_torch_prover.py) at K = 4 proved by the JAX
    package and by the port (with create_proof keywords port_kw) from the
    same Params and RNG seed: (reference proof, port proof)."""
    k, a, b = 4, 7, 191
    out = R_PALLAS.scalar.mul(a, b)
    rparams = RParams.new(R_PALLAS, k, use_cache=False)
    params = params_from_reference("pallas", k, rparams.g,
                                   rparams.g_lagrange, rparams.w, rparams.u,
                                   "cpu")
    rcircuit = mul_circuit_class(RCircuit, RValue, RRotation,
                                 R_PALLAS.scalar)(a, b)
    circuit = mul_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)(a, b)
    rvk = rplonk.keygen_vk(rparams, rcircuit)
    rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
    rtw = RTranscriptWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                        random.Random(SEED), rtw)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [circuit], [[[out]]], random.Random(SEED), tw,
                 **port_kw)
    return rtw.finalize(), tw.finalize()


def test_k4_proof_through_the_four_step(monkeypatch):
    """The route taken from n = 16 (a test hook on _use_mxu, not a knob):
    every keygen and prover transform goes through ntt_mxu_b, and the
    proof equals the JAX package's bytes."""
    calls = []
    orig = mxu.ntt_mxu_b

    def counted(df, x, plan):
        calls.append(tuple(x.shape[:2]))
        return orig(df, x, plan)

    monkeypatch.setattr(port_domain, "_use_mxu",
                        lambda n, device: n >= 16)
    monkeypatch.setattr(port_domain, "ntt_mxu_b", counted)
    monkeypatch.setattr(port_domain, "ntt_many", None)   # B7 never taken
    rproof, proof = k4_proofs()
    assert calls
    assert proof == rproof
