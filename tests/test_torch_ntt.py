"""The port's NTT (halo2_tpu_torch.ops.ntt), EvaluationDomain transforms
and polynomial utilities against the JAX reference at k = 4 to 6, on the
CPU. Inputs are numpy-seeded; results must be bit-equal."""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.fields import device as rfd
from halo2_tpu.ops.pallas_field import (ntt_pallas, to_limbs_first,
                                        from_limbs_first)
from halo2_tpu.poly import utils as rutils
from halo2_tpu.poly.domain import EvaluationDomain as RDomain

from halo2_tpu_torch.fields import device as pfd
from halo2_tpu_torch.ops import ntt as pntt
from halo2_tpu_torch.poly import utils as putils
from halo2_tpu_torch.poly.domain import EvaluationDomain

# halo2_tpu.ops re-exports the function ntt under the module's name
rntt = importlib.import_module("halo2_tpu.ops.ntt")
FIELDS = {"fp": (rfd.FP_DEV, pfd.FP_DEV), "fq": (rfd.FQ_DEV, pfd.FQ_DEV)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mont(rdf, shape, seed):
    """Random Montgomery digits: the reference's uint32 array and the
    port's int32 tensor."""
    rng = np.random.default_rng(seed)
    p = rdf.spec.modulus
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % p
            for _ in range(count)]
    arr = np.asarray(rdf.to_mont_np(vals)).reshape(tuple(shape) + (16,))
    return arr, torch.from_numpy(arr.astype(np.int32))


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("fname", list(FIELDS))
@pytest.mark.parametrize("k", [4, 5, 6])
def test_ntt_matches_reference(fname, k):
    rdf, pdf = FIELDS[fname]
    fs = rdf.spec
    n = 1 << k
    omega = pow(fs.root_of_unity, 1 << (fs.s - k), fs.modulus)
    rplan, plan = rntt.make_plan(rdf, n, omega), pntt.make_plan(pdf, n, omega)
    arr, t = _mont(rdf, (3, n), 10 * k)
    _eq(pntt.ntt(pdf, t[0], plan), rntt.ntt(rdf, jnp.asarray(arr[0]), rplan))
    _eq(pntt.ntt_many(pdf, t, plan),
        rntt.ntt_many(rdf, jnp.asarray(arr), rplan))
    rinv, rn_inv = rntt.make_inv_plan(rdf, rplan)
    inv, n_inv = pntt.make_inv_plan(pdf, plan)
    back = pntt.intt(pdf, pntt.ntt(pdf, t[1], plan), inv, n_inv)
    assert torch.equal(back, t[1])
    _eq(pntt.intt(pdf, t[2], inv, n_inv),
        rntt.intt(rdf, jnp.asarray(arr[2]), rinv, rn_inv))


@pytest.mark.parametrize("k", [6, 8])
def test_ntt_matches_pallas_interpret(k):
    """The port's NTT (kernel B7's plain version on the CPU) equals the TPU
    routine ntt_pallas, run in interpret mode, forward and inverse."""
    rdf, pdf = FIELDS["fq"]
    fs = rdf.spec
    n = 1 << k
    arr, t = _mont(rdf, (2, n), 50 + k)
    for omega in (pow(fs.root_of_unity, 1 << (fs.s - k), fs.modulus),
                  pow(fs.root_of_unity, (1 << fs.s) - (1 << (fs.s - k)),
                      fs.modulus)):
        rplan, plan = (rntt.make_plan(rdf, n, omega),
                       pntt.make_plan(pdf, n, omega))
        want = from_limbs_first(ntt_pallas(
            rdf, to_limbs_first(jnp.asarray(arr[0])), rplan, interpret=True))
        got = pntt.ntt_many(pdf, t, plan)
        _eq(got[0], want)
        assert torch.equal(got[1], pntt.ntt_many_plain(pdf, t[1:], plan)[0])


def test_ntt_wrapper_rejects_bad_input():
    _, pdf = FIELDS["fp"]
    plan = pntt.make_plan(pdf, 8, pow(pdf.spec.root_of_unity,
                                      1 << (pdf.spec.s - 3),
                                      pdf.spec.modulus))
    with pytest.raises(TypeError):
        pntt.ntt_many(pdf, torch.zeros(1, 8, 16, dtype=torch.int64), plan)
    with pytest.raises(TypeError):
        pntt.ntt_many(pdf, torch.zeros(8, 16, dtype=torch.int32), plan)
    with pytest.raises(ValueError):
        pntt.ntt_many(pdf, torch.zeros(1, 4, 16, dtype=torch.int32), plan)
    with pytest.raises(ValueError):
        pntt.ntt_many(pdf, torch.zeros(1, 8, 16, dtype=torch.int32,
                                       device="meta"), plan)


@pytest.mark.parametrize("k,j", [(4, 3), (5, 4), (6, 5)])
def test_domain_transforms_match_reference(k, j):
    rdf, pdf = FIELDS["fq"]
    rdom = RDomain(rdf, j, k)
    dom = EvaluationDomain(pdf, j, k, "cpu")
    assert (dom.extended_k, dom.omega, dom.extended_omega) == \
        (rdom.extended_k, rdom.omega, rdom.extended_omega)
    assert dom.pinned() == rdom.pinned()
    n, ext_n = dom.n, dom.extended_n
    arr, t = _mont(rdf, (2, n), k)
    polys, cosets = dom.lagrange_to_coeff_extended_many([t[0], t[1]])
    rpolys, rcosets = rdom.lagrange_to_coeff_extended_many(
        [jnp.asarray(arr[0]), jnp.asarray(arr[1])])
    for a, b in zip(polys + cosets, list(rpolys) + list(rcosets)):
        _eq(a, b)
    _eq(dom.lagrange_to_coeff(t[0]), rdom.lagrange_to_coeff(
        jnp.asarray(arr[0])))
    _eq(dom.coeff_to_lagrange(t[1]),
        rdom.coeff_to_lagrange(jnp.asarray(arr[1])))
    _eq(dom.coeff_to_extended(t[1]),
        rdom.coeff_to_extended(jnp.asarray(arr[1])))
    earr, et = _mont(rdf, (ext_n,), 100 + k)
    _eq(dom.extended_to_coeff(et), rdom.extended_to_coeff(jnp.asarray(earr)))
    _eq(dom.divide_by_vanishing_poly(et),
        rdom.divide_by_vanishing_poly(jnp.asarray(earr)))
    _eq(dom.rotate_extended(et, -1),
        rdom.rotate_extended(jnp.asarray(earr), -1))
    # the round trip through the extended coset
    back = dom.extended_to_coeff(dom.coeff_to_extended(t[1]))
    assert torch.equal(back[:n], t[1])
    assert not back[n:].any()
    x = 0x1234567890ABCDEF
    xn = pow(x, n, rdf.spec.modulus)
    for rot in (-3, 0, 1, 5):
        assert dom.rotate_omega(x, rot) == rdom.rotate_omega(x, rot)
    assert dom.l_i_range(x, xn, range(-2, 3)) == \
        rdom.l_i_range(x, xn, range(-2, 3))


def test_poly_utils_match_reference():
    rdf, pdf = FIELDS["fq"]
    p = rdf.spec.modulus
    n = 32
    arr, t = _mont(rdf, (3, n), 7)
    x = 0xC0FFEE
    _eq(putils.powers(pdf, x, n, "cpu"),
        rutils.powers(rdf, rdf.scalar(x), n))
    want = int(rdf.from_mont_np(np.asarray(
        rutils.eval_poly(rdf, jnp.asarray(arr[0]), rdf.scalar(x)))))
    assert putils.eval_poly(pdf, t[0], x) == want
    pairs = [(t[0], x), (t[1], x), (t[2], x + 1), (t[1][:9], 5)]
    assert putils.batch_eval_polys(pdf, pairs) == rutils.batch_eval_polys(
        rdf, [(jnp.asarray(arr[0]), x), (jnp.asarray(arr[1]), x),
              (jnp.asarray(arr[2]), x + 1), (jnp.asarray(arr[1][:9]), 5)])
    memo = putils.MemoEval(pdf)
    memo.collect(t[1], x)
    memo.compute()
    assert memo.ev(t[1], x) == putils.batch_eval_polys(pdf, pairs)[1]
    # a pair that was not collected is evaluated on its own
    assert memo.ev(t[2], 9) == putils.eval_poly(pdf, t[2], 9)
    _eq(putils.kate_division(pdf, t[0], x),
        rutils.kate_division(rdf, jnp.asarray(arr[0]), rdf.scalar(x)))
    # (p(X) - p(b)) = q(X) (X - b), checked at a second point
    q = putils.kate_division(pdf, t[0], x)
    y = 77
    assert (putils.eval_poly(pdf, t[0], y) - putils.eval_poly(pdf, t[0], x)
            ) % p == putils.eval_poly(pdf, q, y) * (y - x) % p
    _eq(putils.distribute_powers(pdf, [t[0], t[1], t[2]], x),
        rutils.distribute_powers(rdf, [jnp.asarray(a) for a in arr],
                                 rdf.scalar(x)))


def _pass_map(log_n, a, cnt, r_log):
    """[blocks, E] global element of each block's local element u, as
    ntt_pass_kernel computes it (GIDX)."""
    E = 1 << (r_log + cnt)
    blocks = np.arange(1 << (log_n - r_log - cnt))
    g = blocks % (1 << (a - r_log))
    h = blocks >> (a - r_log)
    u = np.arange(E)
    base = (g << r_log) + (h << (a + cnt))
    return base[:, None] + (u & ((1 << r_log) - 1))[None] + \
        ((u >> r_log) << a)[None]


def _brev(i, log_n):
    """__brev(i) >> (32 - log_n) on uint32 values."""
    out = np.zeros_like(i)
    for b in range(32):
        out |= ((i >> b) & 1) << (31 - b)
    return out >> (32 - log_n)


def _emulate_b7(x, log_n, tw, p):
    """ntt_pass_kernel's schedule over host ints: for each pass of
    ntt_passes, each block loads its tile (through the bit reversal in the
    first pass), runs one radix-2 stage when its stage count is odd, then
    radix-4 units of two stages, reading twiddle rows of the table `tw`
    as the kernel does, and stores the tile back."""
    x = list(x)
    for a, cnt, r_log in pntt.ntt_passes(log_n):
        gmap = _pass_map(log_n, a, cnt, r_log)
        src = list(x)
        for blk in gmap:
            loc = [src[int(_brev(np.int64(i), log_n))] if a == 0 else src[i]
                   for i in blk]

            def bf(lo, hi, row):
                t = loc[hi] * tw[row] % p
                loc[lo], loc[hi] = (loc[lo] + t) % p, (loc[lo] - t) % p

            E = len(blk)
            sp = 1
            if cnt & 1:
                half, ls = 1 << a, 1 << r_log
                for q in range(E // 2):
                    u0 = (q & (ls - 1)) | ((q >> r_log) << (r_log + 1))
                    bf(u0, u0 + ls, half - 1 + (int(blk[u0]) & (half - 1)))
                sp = 2
            while sp < cnt:
                LS = r_log + sp - 1
                ls, half = 1 << LS, 1 << (a + sp - 1)
                for q in range(E // 4):
                    u0 = (q & (ls - 1)) | ((q >> LS) << (LS + 2))
                    jj = int(blk[u0]) & (half - 1)
                    bf(u0, u0 + ls, half - 1 + jj)
                    bf(u0 + 2 * ls, u0 + 3 * ls, half - 1 + jj)
                    bf(u0, u0 + 2 * ls, 2 * half - 1 + jj)
                    bf(u0 + ls, u0 + 3 * ls, 2 * half - 1 + jj + half)
                sp += 2
            for i, v in zip(blk, loc):
                x[int(i)] = v
    return x


@pytest.mark.parametrize("log_n", [1, 4, 11, 12])
def test_b7_pass_schedule_equals_plain(log_n):
    """B7's two-pass schedule (the pass plan of ntt_passes and the
    kernel's index arithmetic: tiles, residues, radix-4 units, twiddle
    rows of make_plan's table, the bit reversal by __brev), emulated on
    host ints, equals ntt_many_plain."""
    rdf, pdf = FIELDS["fq"]
    fs = rdf.spec
    p = fs.modulus
    n = 1 << log_n
    omega = pow(fs.root_of_unity, 1 << (fs.s - log_n), p)
    plan = pntt.make_plan(pdf, n, omega)
    _, table, _, packed = plan.on("cpu")
    rinv = pow(1 << 256, -1, p)
    tw = [v * rinv % p for v in pfd.digits_to_ints(table.numpy())]
    words = packed.numpy().view(np.uint32).astype(object)
    assert [sum(int(w) << (32 * i) for i, w in enumerate(row)) * rinv % p
            for row in words] == tw
    arr, t = _mont(rdf, (1, n), 70 + log_n)
    vals = [v * rinv % p for v in pfd.digits_to_ints(arr[0])]
    want = pntt.ntt_many_plain(pdf, t, plan)[0]
    assert _emulate_b7(vals, log_n, tw, p) == \
        [v * rinv % p for v in pfd.digits_to_ints(want.numpy())]


@pytest.mark.parametrize("log_n", [2, 10, 11, 14, 16, 17, 20, 21])
def test_b7_pass_plan(log_n):
    """ntt_passes covers stages 1..log n in order with at most 10 stages
    a pass: two launches for 2^10 < n <= 2^20, one below; every pass's
    tiles cover each element once; the first pass's __brev gather is
    bit_reverse_perm; 2^16 splits 8 + 8 stages (2^8 tiles a pass)."""
    passes = pntt.ntt_passes(log_n)
    assert len(passes) == -(-log_n // pntt.PASS_LOG)
    if log_n <= 20:
        assert len(passes) == (1 if log_n <= 10 else 2)
    a_next = 0
    for a, cnt, r_log in passes:
        assert a == a_next and 1 <= cnt <= pntt.PASS_LOG
        assert r_log <= a and r_log + cnt <= pntt.PASS_LOG
        a_next = a + cnt
        gmap = _pass_map(log_n, a, cnt, r_log)
        assert np.array_equal(np.sort(gmap.reshape(-1)),
                              np.arange(1 << log_n))
    assert a_next == log_n
    if log_n == 16:
        assert passes == ((0, 8, 0), (8, 8, 0))
    i = np.arange(1 << log_n, dtype=np.int64)
    assert np.array_equal(_brev(i, log_n), pntt.bit_reverse_perm(1 << log_n))
