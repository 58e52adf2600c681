"""The plain versions of kernels B2-B6 (masked mixed add, masked and
unmasked complete add, doubling, masked doubling) against the JAX
reference's pmixed_masked_flat / padd_masked_flat / padd_flat /
pdouble_flat / pdouble_masked_flat (interpret=True, its CPU path) and
against the exact host group law, on both Pasta curves; B3's forms that
read the second operand at a lane offset or an index (with a per-lane
sign) against the reference's padd_masked_flat on the operand built with
jnp.roll and jnp.take. Inputs are numpy-seeded; results must be
bit-equal."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.fields import device as rfd
from halo2_tpu.ops import pallas_point as rpp

from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.curves.native import native_srs_g
from halo2_tpu_torch.fields.device import DeviceField
from halo2_tpu_torch.ops import point_kernels as pk

L = 96
CURVES = {"pallas": (PALLAS, rfd.FP_DEV), "vesta": (VESTA, rfd.FQ_DEV)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(curve, seed):
    """Host points and [48, L] batches: A projective with Z != 1 (sums
    of two points) and identity lanes, B affine-coded (Z = mont 1) with
    identity lanes and one lane equal to A (the doubling case)."""
    rng = np.random.default_rng(seed)
    df = DeviceField(curve.base)
    pts = native_srs_g(curve, "torch-point-test", 3 * L)
    p_pts, q_pts, b_pts = pts[:L], pts[L:2 * L], pts[2 * L:]
    ones = torch.ones(L, dtype=torch.int32)
    a = pk.padd_masked_plain(df, pk.points_to_proj(df, p_pts, "cpu"),
                             pk.points_to_proj(df, q_pts, "cpu"), ones)
    a_host = [curve.add(x, y) for x, y in zip(p_pts, q_pts)]
    ident = pk.ident_col(df, "cpu")
    for i in rng.choice(L, 8, replace=False):
        a[:, i] = ident
        a_host[i] = None
    b_host = list(b_pts)
    for i in rng.choice(L, 8, replace=False):
        b_host[i] = None
    b_host[5] = a_host[5] if a_host[5] is not None else a_host[6]
    b = pk.points_to_proj(df, b_host, "cpu")
    mask = torch.from_numpy((rng.random(L) < 0.75).astype(np.int32))
    signs = torch.from_numpy((rng.random(L) < 0.5).astype(np.int32))
    mask[5] = 1
    return df, a, a_host, b, b_host, mask, signs


def _host(curve, df, batch):
    return pk.points_from_proj(df, batch)


@pytest.mark.parametrize("name", list(CURVES))
def test_padd_masked_matches_reference_and_host(name):
    curve, rdf = CURVES[name]
    df, a, a_host, b, b_host, mask, _ = _batches(curve, 1)
    got = pk.padd_masked_flat(df, a, b, mask)
    want = rpp.padd_masked_flat(rdf, jnp.asarray(a.numpy().astype(np.uint32)),
                                jnp.asarray(b.numpy().astype(np.uint32)),
                                jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    expect = [curve.add(x, y) if m else x
              for x, y, m in zip(a_host, b_host, mask.tolist())]
    assert _host(curve, df, got) == expect
    assert torch.equal(pk.padd_masked_plain(df, a, b, mask), got)


@pytest.mark.parametrize("name", list(CURVES))
def test_pmixed_masked_matches_reference_and_host(name):
    """Identity-coded (0, mont 1) bases pass the accumulator through; the
    sign negates the base."""
    curve, rdf = CURVES[name]
    df, a, a_host, b, b_host, mask, signs = _batches(curve, 2)
    aff = b[:32].contiguous()
    got = pk.pmixed_masked_flat(df, a, aff, mask, signs)
    want = rpp.pmixed_masked_flat(
        rdf, jnp.asarray(a.numpy().astype(np.uint32)),
        jnp.asarray(aff.numpy().astype(np.uint32)),
        jnp.asarray(mask.numpy()), jnp.asarray(signs.numpy()),
        interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    expect = []
    for x, y, m, s in zip(a_host, b_host, mask.tolist(), signs.tolist()):
        if not m or y is None:
            expect.append(x)
        else:
            expect.append(curve.add(x, curve.neg(y) if s else y))
    assert _host(curve, df, got) == expect
    # without signs every base is added as it is
    got = pk.pmixed_masked_flat(df, a, aff, mask)
    assert _host(curve, df, got) == [
        curve.add(x, y) if m and y is not None else x
        for x, y, m in zip(a_host, b_host, mask.tolist())]


def _ref(x):
    return jnp.asarray(x.numpy().astype(np.uint32))


# (curve, form, width or source lanes, shift): rolls within rows of
# `width` lanes as the MSM's suffix, tree and scan rounds read them, and
# gathers from a wider batch as its projective bucket rounds do
SRC_CASES = [("pallas", "roll", L, -1), ("pallas", "roll", 24, -5),
             ("vesta", "roll", 32, 3), ("pallas", "roll-self", 8, -4),
             ("pallas", "index", 2 * L, 0), ("pallas", "index-sign", 2 * L, 0),
             ("vesta", "index-sign", 3 * L, 0)]


@pytest.mark.parametrize("name,form,width,shift", SRC_CASES,
                         ids=[f"{c}-{f}-{w}-{s}" for c, f, w, s in SRC_CASES])
def test_padd_masked_operand_forms_match_reference(name, form, width,
                                                   shift):
    curve, rdf = CURVES[name]
    df, a, _, b, _, mask, signs = _batches(curve, 5)
    rng = np.random.default_rng(width)
    if form.startswith("roll"):
        src = a if form == "roll-self" else b
        got = pk.padd_masked_flat(df, a, src, mask, width=width, shift=shift)
        operand = jnp.roll(_ref(src).reshape(48, -1, width), shift,
                           axis=2).reshape(48, L)
    else:
        src = pk.padd_plain(df, torch.cat([a] * (width // L), dim=1),
                            torch.cat([b] * (width // L), dim=1).flip(1))
        idx = torch.from_numpy(rng.integers(0, width, L).astype(np.int32))
        sign = signs if form == "index-sign" else None
        got = pk.padd_masked_flat(df, a, src, mask, idx=idx, sign=sign)
        operand = jnp.take(_ref(src), jnp.asarray(idx.numpy()), axis=1)
        if sign is not None:
            Y = operand[16:32]
            negY = rfd.fneg(rdf, Y.T).T
            Y = jnp.where(jnp.asarray(sign.numpy() != 0)[None, :], negY, Y)
            operand = jnp.concatenate([operand[:16], Y, operand[32:]])
    want = rpp.padd_masked_flat(rdf, _ref(a), operand,
                                jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("name", list(CURVES))
def test_padd_matches_reference_and_host(name):
    """B4 on projective operands with identity lanes and a == b lanes."""
    curve, rdf = CURVES[name]
    df, a, a_host, b, b_host, _, _ = _batches(curve, 3)
    b[:, 9], b_host[9] = a[:, 9], a_host[9]     # the same representative
    got = pk.padd_flat(df, a, b)
    want = rpp.padd_flat(rdf, _ref(a), _ref(b), interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert _host(curve, df, got) == [curve.add(x, y)
                                     for x, y in zip(a_host, b_host)]
    assert torch.equal(pk.padd_plain(df, a, b), got)


@pytest.mark.parametrize("name", list(CURVES))
def test_pdouble_matches_reference_and_host(name):
    """B5 and B6 (RCB Alg 9) on projective points with identity lanes;
    B6 with a random mask; then at the ragged widths of 1, 2 and 5 lanes
    (the card's group form ends part way through a warp there)."""
    curve, rdf = CURVES[name]
    df, a, a_host, _, _, mask, _ = _batches(curve, 4)
    got = pk.pdouble_flat(df, a)
    want = rpp.pdouble_flat(rdf, _ref(a), interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    assert _host(curve, df, got) == [curve.add(x, x) for x in a_host]
    got_m = pk.pdouble_masked_flat(df, a, mask)
    want_m = rpp.pdouble_masked_flat(rdf, _ref(a), _ref(mask),
                                     interpret=True)
    np.testing.assert_array_equal(got_m.numpy(),
                                  np.asarray(want_m).astype(np.int32))
    assert torch.equal(got_m, torch.where(mask.bool()[None], got, a))
    for w in (1, 2, 5):
        x, m = a[:, -w:].clone(), mask[-w:]
        if w == 5:
            x[:, 2] = pk.ident_col(df, "cpu")
        want = rpp.pdouble_flat(rdf, _ref(x), interpret=True)
        np.testing.assert_array_equal(pk.pdouble_flat(df, x).numpy(),
                                      np.asarray(want).astype(np.int32))
        want_m = rpp.pdouble_masked_flat(rdf, _ref(x), _ref(m),
                                         interpret=True)
        np.testing.assert_array_equal(
            pk.pdouble_masked_flat(df, x, m).numpy(),
            np.asarray(want_m).astype(np.int32))


def test_identity_coding_round_trip():
    df = DeviceField(PALLAS.base)
    pts = native_srs_g(PALLAS, "torch-point-test", 6)
    pts[2] = None
    batch = pk.points_to_proj(df, pts, "cpu")
    assert batch.shape == (48, 6) and batch.dtype == torch.int32
    assert torch.equal(batch[:, 2], pk.ident_col(df, "cpu"))
    assert torch.equal(batch[32:, 0], pk.mont_one(df, "cpu"))
    assert pk.points_from_proj(df, batch) == pts
    assert pk.points_from_proj(df, batch.numpy()) == pts


def test_wrappers_reject_bad_input():
    df = DeviceField(PALLAS.base)
    a = torch.zeros(48, 4, dtype=torch.int32)
    mask = torch.ones(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        pk.padd_masked_flat(df, a, a[:, :3], mask)
    with pytest.raises(TypeError):
        pk.padd_masked_flat(df, a.long(), a.long(), mask)
    with pytest.raises(TypeError):
        pk.padd_masked_flat(df, a, a, mask, width=3)       # 3 does not divide 4
    with pytest.raises(TypeError):
        pk.padd_masked_flat(df, a, a, mask, sign=mask)     # sign needs idx
    with pytest.raises(TypeError):
        pk.padd_masked_flat(df, a, a, mask, idx=mask[:3])
    with pytest.raises(TypeError):
        pk.padd_masked_flat(df, a, a, mask, idx=mask, width=2)
    with pytest.raises(TypeError):
        pk.pmixed_masked_flat(df, a, a, mask)
    with pytest.raises(TypeError):
        pk.padd_flat(df, a, a[:32])
    with pytest.raises(TypeError):
        pk.pdouble_flat(df, a[:, None])
    with pytest.raises(TypeError):
        pk.pdouble_masked_flat(df, a.long(), mask)
    meta = torch.zeros(48, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pk.padd_masked_flat(df, meta, meta, mask.to("meta"))
    with pytest.raises(ValueError):
        pk.pdouble_flat(df, meta)


def test_pdouble_form_needs_the_card():
    """pdouble_form launches the form it is asked for, so it has no CPU
    version: a CPU batch raises, as do a bad batch and a bad mask."""
    df = DeviceField(PALLAS.base)
    a = torch.zeros(48, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.pdouble_form(df, a, 1)
    with pytest.raises(TypeError):
        pk.pdouble_form(df, a[:32], 4)
    meta = torch.zeros(48, 4, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        pk.pdouble_form(df, meta, 4, torch.ones(3, dtype=torch.int32))


def test_glv_and_bucket_forms_need_the_card():
    """glv_ladder_form and pmixed_bucket_runs_form launch the form they
    are asked for, so they have no CPU version: CPU operands raise, as do
    bad tables, bit lists and members."""
    df = DeviceField(PALLAS.base)
    t = torch.zeros(48, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.glv_ladder_form(df, t, t, t, [1, 0], [0, 1], 4)
    with pytest.raises(TypeError):
        pk.glv_ladder_form(df, t, t[:32], t, [1], [0], 4)
    with pytest.raises(TypeError):
        pk.glv_ladder_form(df, t, t, t, [1, 0], [0], 1)
    bases = torch.zeros(8, 16, dtype=torch.int32)
    members = torch.zeros(2, 8, dtype=torch.int32)
    runs = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.pmixed_bucket_runs_form(df, bases, members, runs, runs, 2, 4)
    with pytest.raises(TypeError):
        pk.pmixed_bucket_runs_form(df, bases, members[:, :4], runs, runs,
                                   2, 4)
