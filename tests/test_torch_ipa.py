"""The port's device IPA rounds (halo2_tpu_torch.ops.ipa_device and the
hybrid loop of poly/commitment.py::ipa_create_proof) against the JAX
reference, on the CPU: the GLV split, one fold round's p', b and G'
bit for bit against the reference's ipa_device_fold_lr (its jnp
fallback), the L/R points and values, the batch normalize and the inner
product, and K = 5 proofs with every IPA round on the device and with a
mid-stream hand-off to the native session, byte-equal to the reference's
proof. Inputs are numpy-seeded."""
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.ops import ipa_device as ripd
from halo2_tpu.ops.msm import _jpoint_to_proj
from halo2_tpu.poly import Params as RParams
from halo2_tpu.poly.utils import inner_product as r_inner_product
from halo2_tpu.transcript import TranscriptWrite as RTranscriptWrite
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.bench_circuit import bench_circuit_class, expected_output
from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.device import normalize
from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.ops import ipa_device as ipd
from halo2_tpu_torch.ops import point_kernels as pk
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof, SingleVerifier
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.poly.utils import inner_product
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

K = 5
SEED = 2024
_BUILT: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(x: torch.Tensor):
    return jnp.asarray(x.numpy().astype(np.uint32))


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int32)


def built():
    """The reference's Params at K, the port's Params on the same SRS, and
    a BenchCircuit proof of the reference with its keys (once per test
    process)."""
    if not _BUILT:
        from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
        from halo2_tpu.poly.polynomial import Rotation as RRotation
        rparams = RParams.new(R_PALLAS, K, use_cache=False)
        params = params_from_reference("pallas", K, rparams.g,
                                       rparams.g_lagrange, rparams.w,
                                       rparams.u, "cpu")
        args = (5, 6)
        out = expected_output(R_PALLAS.scalar, *args)
        rcircuit = bench_circuit_class(RCircuit, RValue, RRotation,
                                       R_PALLAS.scalar)(*args)
        rvk = rplonk.keygen_vk(rparams, rcircuit)
        rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
        tw = RTranscriptWrite(R_PALLAS)
        rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                            random.Random(SEED), tw)
        _BUILT.update(rparams=rparams, params=params, out=out, args=args,
                      rproof=tw.finalize())
    return _BUILT


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_glv_split_matches_reference(curve):
    fs = curve.scalar
    assert ipd._find_lambda(curve.name, fs.modulus, fs.zeta) == \
        ripd._find_lambda(curve.name, fs.modulus, fs.zeta)
    rng = np.random.default_rng(20)
    for _ in range(20):
        u = int.from_bytes(rng.bytes(32), "little") % fs.modulus
        assert ipd.glv_split(fs, curve.name, u) == \
            ripd.glv_split(fs, curve.name, u)
    assert np.array_equal(ipd._bits_msb(u, ipd.GLV_BITS),
                          ripd._bits_msb(u, ripd.GLV_BITS))


def test_fold_rounds_match_reference():
    """Two fold rounds from n = 32: from the SRS (Z = 1), then from the
    folded G' (Z != 1). p', b and G' are bit-equal to the reference's
    width-n padded state on its first h lanes; the next round's L/R are
    equal as affine points, and their values equal."""
    b_ = built()
    rparams, params = b_["rparams"], b_["params"]
    df = params.scalar_df
    q = params.curve.scalar.modulus
    n = params.n
    rng = np.random.default_rng(21)
    rand = lambda: [int.from_bytes(rng.bytes(32), "little") % q
                    for _ in range(n)]
    p = df.upload_values(rand(), "cpu")
    b = df.upload_values(rand(), "cpu")
    g = params.g_dev
    rg = _jpoint_to_proj(rparams.dev, rparams.g_dev)
    np.testing.assert_array_equal(_np(rg), g.numpy())
    rp, rb = _ref(p), _ref(b)
    half = n // 2
    for _ in range(2):
        u = int.from_bytes(rng.bytes(32), "little") % q
        u_inv = pow(u, -1, q)
        p, b, g, *lr = ipd.ipa_device_fold_lr(params, p, b, g, half, u,
                                              u_inv)
        rp, rb, rg, *rlr = ripd.ipa_device_fold_lr(
            rparams, rp, rb, rg, half, u, u_inv)
        assert p.shape == (half, 16) and g.shape == (48, half)
        np.testing.assert_array_equal(_np(rp)[:half], p.numpy())
        np.testing.assert_array_equal(_np(rb)[:half], b.numpy())
        np.testing.assert_array_equal(_np(rg)[:, :half], g.numpy())
        assert lr == rlr
        assert all(pt is not None for pt in lr[:2])
        half //= 2


def test_fold_only_round_and_round_zero_lr():
    """with_lr=False returns no L/R; the round-0 L/R equals the host's
    <p'_hi, G_lo>, <p'_lo, G_hi> and the inner products."""
    params = built()["params"]
    df = params.scalar_df
    q = params.curve.scalar.modulus
    n, h = params.n, params.n // 2
    rng = np.random.default_rng(22)
    pv = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    bv = [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
    p, b = df.upload_values(pv, "cpu"), df.upload_values(bv, "cpu")
    l_pt, r_pt, vl, vr = ipd.ipa_device_lr(params, p, b, params.g_dev)
    assert l_pt == PALLAS.msm(pv[h:], params.g[:h])
    assert r_pt == PALLAS.msm(pv[:h], params.g[h:])
    assert vl == sum(x * y for x, y in zip(pv[h:], bv[:h])) % q
    assert vr == sum(x * y for x, y in zip(pv[:h], bv[h:])) % q
    out = ipd.ipa_device_fold_lr(params, p, b, params.g_dev, h, 3,
                                 pow(3, -1, q), with_lr=False)
    assert out[3:] == (None, None, None, None)
    assert pk.points_from_proj(params.base_df, out[2]) == [
        PALLAS.add(x, PALLAS.mul(y, 3))
        for x, y in zip(params.g[:h], params.g[h:])]


def test_normalize_and_inner_product():
    params = built()["params"]
    dfb, df = params.base_df, params.scalar_df
    g = pk.padd_plain(dfb, params.g_dev[:, :16], params.g_dev[:, 16:])
    g[:, 5] = pk.ident_col(dfb, "cpu")
    pts = pk.points_from_proj(dfb, g)
    x, y, inf = normalize(dfb, g)
    assert inf.tolist() == [pt is None for pt in pts]
    xs, ys = dfb.from_mont_np(x), dfb.from_mont_np(y)
    assert [None if i else (int(a), int(c)) for a, c, i in
            zip(xs, ys, inf.tolist())] == pts
    assert (int(xs[5]), int(ys[5])) == (0, 1)
    rng = np.random.default_rng(23)
    a = df.upload_values([int(v) for v in rng.integers(0, 1 << 62, 24)],
                         "cpu")
    b = df.upload_values([int(v) for v in rng.integers(0, 1 << 62, 24)],
                         "cpu")
    rdf = built()["rparams"].scalar_df
    want = r_inner_product(rdf, _ref(a), _ref(b))
    assert inner_product(df, a, b) == int(rdf.from_mont_np(np.asarray(want)))


@pytest.mark.parametrize("threshold", [0, 4], ids=["all-device", "hand-off"])
def test_proof_matches_reference(threshold):
    """BenchCircuit at K = 5: every IPA round on the device (threshold 0),
    or rounds with half > 4 on the device and the rest in the native
    session after a hand-off of the folded G'; the bytes equal the
    reference's proof and verify."""
    b_ = built()
    params = b_["params"]
    circuit = bench_circuit_class(Circuit, Value, Rotation,
                                  PALLAS.scalar)(*b_["args"])
    vk = keygen_vk(params, circuit)
    pk_ = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk_, [circuit], [[[b_["out"]]]],
                 random.Random(SEED), tw, native_ipa_threshold=threshold)
    proof = tw.finalize()
    assert proof == b_["rproof"]
    verify_proof(params, vk, SingleVerifier(params), [[[b_["out"]]]],
                 TranscriptRead(PALLAS, proof))
