"""The port's point-batch API (halo2_tpu_torch/curves/device.py) against
the JAX package's (halo2_tpu/curves/device.py), on the CPU.

The port keeps [48, L] homogeneous projective batches, the reference
Jacobian JPoints, so the two are compared as affine points after each
side's normalize, lane by lane, identity lanes included. The group law is
exact: every comparison is exact equality. Inputs are made from a seed
with numpy's generator and handed to both as host points."""
import jax
import numpy as np
import pytest
import torch

from halo2_tpu.curves import device as rdev
from halo2_tpu.curves.device import PALLAS_DEV as R_PALLAS_DEV

from halo2_tpu_torch.curves import device as cdev
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.fields.device import FP_DEV, ints_to_digits
from halo2_tpu_torch.ops import point_kernels as pk

DF = FP_DEV                      # PALLAS base field
Q = PALLAS.scalar.modulus


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_points(L, seed, identity_lanes=()):
    rng = np.random.default_rng(seed)
    pts = [PALLAS.mul(PALLAS.generator, int(rng.integers(1, 1 << 62)))
           for _ in range(L)]
    for i in identity_lanes:
        pts[i] = None
    return pts


def _pair(L, seed, identity_lanes=()):
    """The same L points on both sides: for the port a [48, L] batch with
    Z != 1 where finite (each point the sum of two host points, added by
    B4's plain version), for the reference the JPoint of those points,
    padded with identity lanes to WIDTH."""
    a = _host_points(L, seed, identity_lanes)
    b = _host_points(L, seed + 1, identity_lanes)
    mine = cdev.padd(DF, pk.points_to_proj(DF, a, "cpu"),
                     pk.points_to_proj(DF, b, "cpu"))
    pts = [PALLAS.add(x, y) for x, y in zip(a, b)]
    ref = R_PALLAS_DEV.points_to_device(pts + [None] * (WIDTH - L))
    return mine, ref


# the reference runs jitted at one width, so each of its functions
# compiles once (eager, each call of its padd takes seconds); lanes past
# L are identity padding and are not compared
WIDTH = 8
_JIT: dict = {}


def _ref(name, *args, **kw):
    key = (name, tuple(sorted(kw.items())))
    fn = _JIT.get(key)
    if fn is None:
        f = getattr(rdev, name)
        fn = _JIT[key] = jax.jit(lambda *a: f(R_PALLAS_DEV, *a, **kw))
    return fn(*args)


def _affine(batch):
    """[48, L] batch -> host points, through the port's normalize."""
    x, y, inf = cdev.normalize(DF, batch)
    xs, ys = DF.from_mont_np(x), DF.from_mont_np(y)
    return [None if f else (int(a), int(b))
            for a, b, f in zip(xs, ys, inf.tolist())]


def _ref_affine(jp, L=WIDTH):
    return R_PALLAS_DEV.points_from_device(_ref("normalize", jp))[:L]


IDENTITY_LANES = {1: (), 5: (0, 3), 8: (2, 5, 7)}


@pytest.mark.parametrize("L", [1, 5, 8])
def test_add_double_neg_select_match_reference(L):
    ident = IDENTITY_LANES[L]
    a, ra = _pair(L, 10 * L, ident)
    b, rb = _pair(L, 10 * L + 5, ident[:1])
    lanes = np.arange(WIDTH)
    # a lane with b == a (the doubling case) and one with b == -a
    if L > 1:
        b[:, L - 1] = a[:, L - 1]
        rb = rdev.pselect(lanes == L - 1, ra, rb)
    if L > 4:
        b[:, 4] = cdev.pneg(DF, a)[:, 4]
        rb = rdev.pselect(lanes == 4, _ref("pneg", ra), rb)
    assert _affine(a) == _ref_affine(ra, L)
    assert _affine(b) == _ref_affine(rb, L)
    assert _affine(cdev.padd(DF, a, b)) == _ref_affine(
        _ref("padd", ra, rb), L)
    assert _affine(cdev.pdouble(DF, a)) == _ref_affine(
        _ref("pdouble", ra), L)
    assert _affine(cdev.pneg(DF, a)) == _ref_affine(_ref("pneg", ra), L)
    cond = lanes % 2 == 0
    assert _affine(cdev.pselect(torch.from_numpy(cond[:L]), a, b)) == \
        _ref_affine(rdev.pselect(cond, ra, rb), L)
    assert _affine(cdev.identity(DF, L, "cpu")) == [None] * L


@pytest.mark.parametrize("L", [1, 5, 8])
def test_tree_sum_matches_reference(L):
    """Odd widths take the port's identity pad; the reference sums the
    same points padded with identity lanes to WIDTH."""
    a, ra = _pair(L, 7 * L, IDENTITY_LANES[L])
    got = cdev.tree_sum(DF, a)
    assert got.shape == (48, 1)
    tot = _ref("tree_sum", ra)
    want = R_PALLAS_DEV.points_from_device(rdev.normalize(
        R_PALLAS_DEV, rdev.JPoint(tot.x[None], tot.y[None], tot.z[None])))
    assert _affine(got) == want
    host = None
    for pt in _affine(a):
        host = PALLAS.add(host, pt)
    assert _affine(got) == [host]


def _scalars(nbits, seed):
    """8 scalars: 0, 1, q - 1, 2^256 - 1 (its low nbits bits count) and
    random ones below 2^nbits."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % (1 << nbits)
            for _ in range(4)]
    return [0, 1, Q - 1, (1 << 256) - 1] + rand


@pytest.mark.parametrize("nbits", [255, 256])
def test_batch_scalar_mul_matches_reference(nbits):
    """The scalar-multiplication ladder's plain version (the CPU path of
    batch_scalar_mul) against the reference's fori_loop at 8 lanes, with
    identity lanes, and against host scalar multiplication."""
    a, ra = _pair(8, 30 + nbits, (1, 6))
    scalars = _scalars(nbits, nbits)
    digits = ints_to_digits(scalars)
    before = pk.LAUNCHES["scalar_mul_ladder"]
    got = _affine(cdev.batch_scalar_mul(DF, a, torch.from_numpy(digits),
                                        nbits))
    assert pk.LAUNCHES["scalar_mul_ladder"] == before   # no kernel on CPU
    want = _ref_affine(_ref("batch_scalar_mul", ra,
                            digits.astype(np.uint32), nbits=nbits))
    assert got == want
    mask = (1 << nbits) - 1
    assert got == [PALLAS.mul(pt, s & mask)
                   for pt, s in zip(_affine(a), scalars)]


def test_ladder_table_form_matches_full_form():
    """Lane l reading row l % T of a [T, 16] table equals the full [L, 16]
    form with those rows written out, bit for bit, with and without the
    fused butterfly (lo + t, lo - t)."""
    a, _ = _pair(8, 77, (3,))
    lo, _ = _pair(8, 79, (0,))
    table = torch.from_numpy(ints_to_digits([Q - 1, 1, 5, 2 ** 200 + 3]))
    full = table[torch.arange(8) % 4]
    t_tab = pk.scalar_mul_ladder_flat(DF, a, table, 255)
    assert torch.equal(t_tab, pk.scalar_mul_ladder_flat(DF, a, full, 255))
    top, bot = pk.scalar_mul_ladder_flat(DF, a, table, 255, lo=lo)
    assert torch.equal(top, pk.padd_plain(DF, lo, t_tab))
    assert torch.equal(bot, pk.padd_plain(DF, lo, pk.pneg_flat(DF, t_tab)))
    want = [PALLAS.mul(pt, s) for pt, s in
            zip(_affine(a), [Q - 1, 1, 5, 2 ** 200 + 3] * 2)]
    assert _affine(t_tab) == want
    assert _affine(bot) == [PALLAS.add(x, PALLAS.neg(y))
                            for x, y in zip(_affine(lo), want)]
