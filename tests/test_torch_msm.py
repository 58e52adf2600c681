"""The port's Pippenger (halo2_tpu_torch.ops.msm_pippenger) on the CPU:
window digits against the JAX reference's, and MSMs against the exact host
MSM -- random, all-zero, q-1 and all-equal scalar columns, identity bases,
affine and projective (Z != 1) bases, signed and unsigned digits, the
serial and the segmented-scan branch, and Params' chunked commits -- the
device window combine against the host one, and the bucket-run kernel's
plain version against the B2 round loop it replaced. Inputs are numpy-seeded;
points must be equal."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.ops import msm_pallas as rmp

from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.curves.native import native_srs_g
from halo2_tpu_torch.fields.device import DeviceField, ints_to_digits
from halo2_tpu_torch.ops import msm_pippenger as mp
from halo2_tpu_torch.ops import point_kernels as pk
from halo2_tpu_torch.ops.point_kernels import (ident_col, padd_masked_plain,
                                               points_from_proj,
                                               points_to_proj)
from halo2_tpu_torch.poly import commitment

N = 128
Q = PALLAS.scalar.modulus


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_scalars(rng, n, q):
    return [int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]


@pytest.mark.parametrize("c", [4, 7, 10, 13, 16])
def test_window_digits_match_reference(c):
    rng = np.random.default_rng(c)
    vals = _rand_scalars(rng, 125, Q) + [0, 1, Q - 1]
    d16 = ints_to_digits(vals)
    got = mp.window_digits(torch.from_numpy(d16), c).numpy()
    want = np.asarray(rmp.window_digits(jnp.asarray(d16.astype(np.uint32)),
                                        c))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    g_abs, g_sg = mp.window_digits_signed(torch.from_numpy(d16), c)
    w_abs, w_sg = rmp.window_digits_signed(
        jnp.asarray(d16.astype(np.uint32)), c)
    np.testing.assert_array_equal(g_abs.numpy(),
                                  np.asarray(w_abs).astype(np.int64))
    np.testing.assert_array_equal(g_sg.numpy(),
                                  np.asarray(w_sg).astype(np.int64))
    # the signed digits recompose every value
    for j in range(len(vals)):
        total = sum((-1 if s else 1) * int(a) << (c * w) for w, (a, s) in
                    enumerate(zip(g_abs[:, j].tolist(),
                                  g_sg[:, j].tolist())))
        assert total == vals[j]


@pytest.mark.parametrize("signed", [True, False])
def test_pick_c_in_range(signed):
    for k in range(1, 21):
        assert 4 <= mp.pick_c(1 << k, signed) <= 16


def _columns(rng, bases):
    """Scalar columns: random, with 0 and q-1 on identity bases and on
    finite ones; all zeros; q-1 on every fourth base."""
    n = len(bases)
    rand = _rand_scalars(rng, n, Q)
    ident = [i for i, pt in enumerate(bases) if pt is None]
    rand[ident[0]] = 0
    rand[ident[1]] = Q - 1
    rand[7], rand[8] = 0, Q - 1
    sparse = [Q - 1 if i % 4 == 0 else 0 for i in range(n)]
    return [rand, [0] * n, sparse]


@pytest.fixture(scope="module")
def bases():
    pts = native_srs_g(PALLAS, "torch-msm-test", N)
    for i in (3, 10, 17, 29, 70, 100):
        pts[i] = None
    return pts


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("c", [4, 5])
def test_msm_matches_host(bases, signed, c):
    pts = bases[:32]
    df = DeviceField(PALLAS.base)
    proj = points_to_proj(df, pts, "cpu")
    cols = _columns(np.random.default_rng(11), pts)
    digits = torch.from_numpy(np.stack([ints_to_digits(c) for c in cols]))
    got = mp.msm_many(PALLAS, df, digits, proj, c=c, signed=signed)
    assert got == [PALLAS.msm(col, pts) for col in cols]
    assert got[1] is None


@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
def test_msm_on_projective_bases_matches_host(bases, signed):
    """The bucket loop over projective bases (affine=False, the reference's
    aff=None): bases with Z != 1 (sums of two points) and identity lanes
    (Z = 0), B3 adds with y negated per lane for signed digits."""
    df = DeviceField(PALLAS.base)
    half = points_to_proj(df, bases[:32], "cpu")
    proj = padd_masked_plain(df, half, points_to_proj(df, bases[32:64],
                                                      "cpu"),
                             torch.ones(32, dtype=torch.int32))
    proj[:, [3, 20]] = ident_col(df, "cpu")[:, None]
    pts = points_from_proj(df, proj)
    assert not torch.equal(proj[32:], half[32:])     # Z != 1
    cols = _columns(np.random.default_rng(12), pts)
    digits = torch.from_numpy(np.stack([ints_to_digits(c) for c in cols]))
    got = mp.msm_many(PALLAS, df, digits, proj, c=4, signed=signed,
                      affine=False)
    assert got == [PALLAS.msm(col, pts) for col in cols]


def test_device_horner_combine_matches_host(bases):
    """c doublings (B5) and one complete add (B4) per window, MSB first,
    on a batch of two window-sum rows."""
    df = DeviceField(PALLAS.base)
    c, W = 3, 5
    rows = [bases[:W], bases[W:2 * W]]
    wsums = torch.stack([points_to_proj(df, r, "cpu") for r in rows], dim=1)
    got = mp.device_horner_combine(df, wsums, c)
    assert got.shape == (48, 2)
    assert points_from_proj(df, got) == [
        mp.host_horner_combine(PALLAS, r, c) for r in rows]


def test_skewed_column_takes_the_scan_branch(bases, monkeypatch):
    """An all-equal column (here all q-1) puts every point in one bucket
    per window: the run is long enough for the segmented scan
    (msm_pallas.py:489-491)."""
    pts = bases[:128]
    calls = []
    scan = mp._segmented_scan

    def counting(*args):
        calls.append(1)
        return scan(*args)

    monkeypatch.setattr(mp, "_segmented_scan", counting)
    df = DeviceField(PALLAS.base)
    proj = points_to_proj(df, pts, "cpu")
    col = [Q - 1] * len(pts)
    for signed in (True, False):
        got = mp.msm_many(PALLAS, df, torch.from_numpy(
            ints_to_digits(col))[None], proj, c=8, signed=signed)
        assert got == [PALLAS.msm(col, pts)]
    assert len(calls) == 2


def test_msm_on_vesta():
    rng = np.random.default_rng(3)
    pts = native_srs_g(VESTA, "torch-msm-test", 32)
    q = VESTA.scalar.modulus
    cols = [_rand_scalars(rng, 32, q), [q - 1] * 32]
    df = DeviceField(VESTA.base)
    proj = points_to_proj(df, pts, "cpu")
    digits = torch.from_numpy(np.stack([ints_to_digits(c) for c in cols]))
    assert mp.msm_many(VESTA, df, digits, proj) == \
        [VESTA.msm(c, pts) for c in cols]


def test_host_horner_combine_matches_reference():
    rng = np.random.default_rng(9)
    pts = native_srs_g(PALLAS, "torch-msm-test", 12)
    pts[4] = None
    for c in (3, 9):
        assert mp.host_horner_combine(PALLAS, pts, c) == \
            rmp.host_horner_combine(PALLAS, pts, c)
    s = [int(x) for x in rng.integers(0, 1 << 40, 12)]
    want = PALLAS.msm(s, [p for p in pts])
    # windows of one base each: sum_w 2^(cw) s_w P_w is the host MSM
    c = 41
    win = [PALLAS.mul(p, x) if p is not None else None
           for p, x in zip(pts, s)]
    scaled = [PALLAS.mul(w, pow(2, -c * i, Q)) if w is not None else None
              for i, w in enumerate(win)]
    assert mp.host_horner_combine(PALLAS, scaled, c) == want


def test_params_commit_many_chunks(monkeypatch):
    """Params.commit_many over several column chunks equals the host MSM
    plus [blind] W."""
    params = commitment.Params.new(PALLAS, 5, device="cpu")
    monkeypatch.setattr(commitment, "COMMIT_GN_BUDGET", params.n * 52)
    rng = np.random.default_rng(4)
    cols = [_rand_scalars(rng, params.n, Q) for _ in range(3)]
    cols.append([0] * params.n)
    blinds = [1, 0, 12345, Q - 1]
    df = params.scalar_df
    polys = [df.upload_values(c, "cpu") for c in cols]
    for lagrange, g in ((False, params.g), (True, params.g_lagrange)):
        got = params.commit_many(polys, blinds, lagrange=lagrange)
        want = [PALLAS.add(PALLAS.msm(c, g), PALLAS.mul(params.w, b))
                for c, b in zip(cols, blinds)]
        assert got == want
    assert params.commit(polys[2], 12345) == PALLAS.add(
        PALLAS.msm(cols[2], params.g), PALLAS.mul(params.w, 12345))


def _b2_round_loop(df, aff, runs, n):
    """The affine bucket loop before the bucket-run kernel: round r
    gathers every lane's r-th member, aff[:, gidx], and adds it with B2's
    plain version, lanes past their run masked off."""
    G, BL = runs.starts_e.shape
    g_off = (torch.arange(G) * n)[:, None]
    acc = ident_col(df, "cpu")[:, None].expand(48, G * BL).clone()
    for r in range(int(runs.counts_e.max())):
        idx = torch.clamp(runs.starts_e + r, max=n - 1)
        gidx = runs.order.reshape(-1)[(idx + g_off).reshape(-1)]
        valid = (r < runs.counts_e).reshape(-1).to(torch.int32)
        sig = (runs.sg.reshape(-1)[(gidx.view(G, BL) + g_off).reshape(-1)]
               if runs.sg is not None else torch.zeros_like(gidx))
        acc = pk.pmixed_masked_plain(df, acc, aff[:, gidx], valid,
                                     sig.to(torch.int32))
    return acc


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
@pytest.mark.parametrize("c,signed,slotted", [(4, True, False),
                                              (5, False, True)])
def test_bucket_runs_plain_equals_b2_round_loop(curve, c, signed, slotted):
    """pmixed_bucket_runs over packed bases and packed members equals the
    B2 round loop over the gathered operands, projective digits and all,
    with the top-window slotting on (c = 5) and off (c = 4), for signed
    and unsigned digits."""
    n = 64
    pts = native_srs_g(curve, "torch-msm-test", n)
    pts[5] = pts[40] = None
    df = DeviceField(curve.base)
    aff = points_to_proj(df, pts, "cpu")[:32]
    packed = pk.pack_affine(aff)
    assert packed.shape == (n, 16)
    assert torch.equal(pk.unpack_affine(packed), aff)
    q = curve.scalar.modulus
    rng = np.random.default_rng(c)
    col = _rand_scalars(rng, n, q)
    col[:3] = [0, 1, q - 1]
    digits = torch.from_numpy(ints_to_digits(col))[None]
    runs = mp.bucket_runs(curve, digits, c, signed)
    assert (runs.S > 1) == slotted
    members = pk.bucket_members(runs.order, runs.sg)
    assert torch.equal(members.long() & 0x7FFFFFFF, runs.order)
    if signed:
        assert torch.equal((members < 0).long(),
                           torch.gather(runs.sg, 1, runs.order))
    got = pk.pmixed_bucket_runs(df, packed, members,
                                runs.starts_e.reshape(-1),
                                runs.counts_e.reshape(-1), runs.BL)
    assert torch.equal(got, _b2_round_loop(df, aff, runs, n))


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_msm_through_bucket_runs_matches_host(curve):
    """An MSM of 2^6 affine bases with an identity base, from a packed
    copy given once for two columns, equals the host MSM."""
    n = 64
    pts = native_srs_g(curve, "torch-msm-test", n)
    pts[9] = None
    df = DeviceField(curve.base)
    proj = points_to_proj(df, pts, "cpu")
    q = curve.scalar.modulus
    rng = np.random.default_rng(21)
    cols = [_rand_scalars(rng, n, q), [0] * n]
    cols[0][:3] = [0, 1, q - 1]
    digits = torch.from_numpy(np.stack([ints_to_digits(v) for v in cols]))
    got = mp.msm_many(curve, df, digits, proj, c=5,
                      packed=pk.pack_affine(proj[:32]))
    assert got == [curve.msm(v, pts) for v in cols]
