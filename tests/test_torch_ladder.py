"""The GLV ladder of the device IPA fold on the CPU:
halo2_tpu_torch.ops.point_kernels.glv_ladder_flat (one launch of the
fused ladder kernel on CUDA, its plain version here) against the
step-by-step composition of the doubling (B5) and masked complete add
(B3) wrappers that it replaces, over bit patterns and bit counts, and
against the host group law; and ipa_device._glv_mul_add, which runs it,
against the G' of the reference's fold round
(halo2_tpu/ops/ipa_device.py::ipa_device_fold_lr, Pallas in interpret
mode). Inputs are numpy-seeded; results must be bit-equal."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.ops import ipa_device as ripd
from halo2_tpu.ops.msm import _jpoint_to_proj
from halo2_tpu.poly import Params as RParams

from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.curves.native import native_srs_g
from halo2_tpu_torch.fields.device import DeviceField
from halo2_tpu_torch.ops import ipa_device as ipd
from halo2_tpu_torch.ops import point_kernels as pk

LANES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(pattern: str, nbits: int, rng):
    i = np.arange(nbits)
    if pattern == "zeros":
        return np.zeros(nbits, np.uint32), np.zeros(nbits, np.uint32)
    if pattern == "all-sel3":
        return np.ones(nbits, np.uint32), np.ones(nbits, np.uint32)
    if pattern == "alternating":           # sel = 0, 1, 2, 3, 0, ...
        return (i & 1).astype(np.uint32), ((i >> 1) & 1).astype(np.uint32)
    return (rng.integers(0, 2, nbits).astype(np.uint32),
            rng.integers(0, 2, nbits).astype(np.uint32))


def _table(curve, seed, neg1, neg2):
    """The ladder's table over LANES projective points with Z != 1 (sums
    of two SRS points) and one identity lane; the host points too."""
    df = DeviceField(curve.base)
    pts = native_srs_g(curve, f"torch-ladder-test-{seed}", 2 * LANES)
    g = pk.padd_plain(df, pk.points_to_proj(df, pts[:LANES], "cpu"),
                      pk.points_to_proj(df, pts[LANES:], "cpu"))
    g[:, 3] = pk.ident_col(df, "cpu")
    return df, ipd.glv_table(df, g, neg1, neg2)


def _stepwise(df, t1, t2, t12, bits1, bits2):
    """The loop glv_ladder replaces: one B5 and one masked B3 a step."""
    acc = pk.ident_col(df, "cpu")[:, None].expand(48, LANES).contiguous()
    table = (t1, t1, t2, t12)
    on = torch.ones(LANES, dtype=torch.int32)
    off = torch.zeros(LANES, dtype=torch.int32)
    for b1, b2 in zip(bits1, bits2):
        sel = int(b1) + 2 * int(b2)
        acc = pk.pdouble_flat(df, acc)
        acc = pk.padd_masked_flat(df, acc, table[sel], on if sel else off)
    return acc


CASES = [("pallas", "zeros", 130), ("pallas", "all-sel3", 130),
         ("pallas", "alternating", 130), ("pallas", "random", 130),
         ("vesta", "random", 130), ("pallas", "random", 1),
         ("pallas", "random", 33), ("vesta", "alternating", 64)]


@pytest.mark.parametrize("curve_name,pattern,nbits", CASES,
                         ids=[f"{c}-{p}-{n}" for c, p, n in CASES])
def test_ladder_equals_stepwise_b5_b3(curve_name, pattern, nbits):
    """The plain ladder equals the B5/B3 loop bit for bit; its points are
    [s1] t1 + [s2] t2 on the host, s1 and s2 read MSB first."""
    curve = PALLAS if curve_name == "pallas" else VESTA
    rng = np.random.default_rng(nbits)
    bits1, bits2 = _bits(pattern, nbits, rng)
    df, (t1, t2, t12) = _table(curve, nbits, 1, 0)
    before = dict(pk.LAUNCHES)
    got = pk.glv_ladder_flat(df, t1, t2, t12, bits1, bits2)
    assert pk.LAUNCHES == before            # the plain version on the CPU
    assert got.shape == (48, LANES) and got.dtype == torch.int32
    assert torch.equal(got, _stepwise(df, t1, t2, t12, bits1, bits2))
    s1 = int("".join(map(str, bits1)), 2)
    s2 = int("".join(map(str, bits2)), 2)
    q1 = pk.points_from_proj(df, t1)
    q2 = pk.points_from_proj(df, t2)
    assert pk.points_from_proj(df, got) == [
        curve.add(curve.mul(a, s1), curve.mul(b, s2))
        for a, b in zip(q1, q2)]


def test_ladder_rejects_bad_input():
    df, (t1, t2, t12) = _table(PALLAS, 0, 0, 0)
    with pytest.raises(TypeError):
        pk.glv_ladder_flat(df, t1, t2[:, :4], t12, [1], [0])
    with pytest.raises(TypeError):
        pk.glv_ladder_flat(df, t1, t2, t12, [1, 0], [0])
    with pytest.raises(TypeError):
        pk.glv_ladder_flat(df, t1, t2, t12, [0] * 161, [0] * 161)
    meta = t1.to("meta")
    with pytest.raises(ValueError):
        pk.glv_ladder_flat(df, meta, meta, meta, [1], [1])


def test_glv_mul_add_matches_reference_round():
    """_glv_mul_add (B4 table, the ladder, B4 add) gives the G' of the
    reference's fold round bit for bit: from the SRS (Z = 1), then from
    that folded G' (Z != 1)."""
    k = 4
    rparams = RParams.new(R_PALLAS, k, use_cache=False)
    params = params_from_reference("pallas", k, rparams.g,
                                   rparams.g_lagrange, rparams.w, rparams.u,
                                   "cpu")
    df = params.scalar_df
    q = params.curve.scalar.modulus
    n = params.n
    rng = np.random.default_rng(31)
    p = df.upload_values([int(v) for v in rng.integers(0, 1 << 62, n)],
                         "cpu")
    b = df.upload_values([int(v) for v in rng.integers(0, 1 << 62, n)],
                         "cpu")
    g = params.g_dev
    rg = _jpoint_to_proj(rparams.dev, rparams.g_dev)
    rp = jnp.asarray(p.numpy().astype(np.uint32))
    rb = jnp.asarray(b.numpy().astype(np.uint32))
    half = n // 2
    for _ in range(2):
        u = int.from_bytes(rng.bytes(32), "little") % q
        u_inv = pow(u, -1, q)
        rp, rb, rg, *_ = ripd.ipa_device_fold_lr(rparams, rp, rb, rg, half,
                                                 u, u_inv, with_lr=False)
        g = ipd._glv_mul_add(params, g[:, :half], g[:, half:], u)
        np.testing.assert_array_equal(
            np.asarray(rg)[:, :half].astype(np.int32), g.numpy())
        half //= 2
