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
