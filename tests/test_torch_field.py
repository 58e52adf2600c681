"""The port's field layer (halo2_tpu_torch.fields.device and the plain
versions of kernel B1 and the add/sub kernel) against the JAX reference
(halo2_tpu.fields.device, and the Pallas multiply in interpret mode) and
the exact host ints. Inputs are numpy-seeded; results must be equal."""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.fields import device as ref
from halo2_tpu.ops.pallas_field import (fmul_pallas, to_limbs_first,
                                        from_limbs_first)
from halo2_tpu_torch.fields import device as port
from halo2_tpu_torch.ops import cuda_build, field_kernels as fk

FIELDS = [(ref.FP_DEV, port.FP_DEV), (ref.FQ_DEV, port.FQ_DEV)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(rdf, n, seed):
    """n random Montgomery operands (+ 0, 1, p-1 at the end) as the
    reference's uint32 array and the port's int32 tensor."""
    p = rdf.spec.modulus
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p
            for _ in range(n - 3)] + [0, 1, p - 1]
    arr = np.asarray(rdf.to_mont_np(vals))
    return vals, arr, torch.from_numpy(arr.astype(np.int32))


@pytest.mark.parametrize("fi", [0, 1])
def test_ops_match_reference_and_host(fi):
    rdf, pdf = FIELDS[fi]
    p = rdf.spec.modulus
    n = 1 << 10
    va, ra, ta = _operands(rdf, n, 1 + fi)
    vb, rb, tb = _operands(rdf, n, 7 + fi)
    rb[-3:] = ra[-1]
    tb[-3:] = ta[-1]
    vb[-3:] = [p - 1] * 3
    cases = [
        (port.fmul, ref.fmul, lambda x, y: x * y),
        (fk.fadd, ref.fadd, lambda x, y: x + y),
        (fk.fsub, ref.fsub, lambda x, y: x - y),
    ]
    for pf, rf, host in cases:
        got = pf(pdf, ta, tb).numpy()
        want = np.asarray(rf(rdf, jnp.asarray(ra), jnp.asarray(rb)))
        np.testing.assert_array_equal(got, want.astype(np.int32))
        ints = pdf.from_mont_np(torch.from_numpy(got))
        assert [int(v) for v in ints] == [host(x, y) % p
                                         for x, y in zip(va, vb)]
    np.testing.assert_array_equal(
        port.fneg(pdf, ta).numpy(),
        np.asarray(ref.fneg(rdf, jnp.asarray(ra))).astype(np.int32))


def test_fmul_matches_pallas_interpret():
    rdf, pdf = FIELDS[0]
    _, ra, ta = _operands(rdf, 512, 3)
    _, rb, tb = _operands(rdf, 512, 4)
    want = from_limbs_first(fmul_pallas(
        rdf, to_limbs_first(jnp.asarray(ra)), to_limbs_first(jnp.asarray(rb)),
        interpret=True))
    np.testing.assert_array_equal(port.fmul(pdf, ta, tb).numpy(),
                                  np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("fi", [0, 1])
def test_limbs_first_fmul_matches_pallas_interpret(fi):
    """Kernel B8's plain version on limbs-first [16, 512] operands equals
    the Pallas multiply in interpret mode."""
    rdf, pdf = FIELDS[fi]
    _, ra, ta = _operands(rdf, 512, 31 + fi)
    _, rb, tb = _operands(rdf, 512, 41 + fi)
    want = fmul_pallas(rdf, to_limbs_first(jnp.asarray(ra)),
                       to_limbs_first(jnp.asarray(rb)), interpret=True)
    got = fk.fmul_limbs_first(pdf, ta.T.contiguous(), tb.T.contiguous())
    assert got.shape == (16, 512)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int32))
    with pytest.raises(TypeError):
        fk.fmul_limbs_first(pdf, ta, tb)          # element-major [512, 16]


@pytest.mark.parametrize("fi", [0, 1])
def test_mont_conversions_and_broadcast(fi):
    rdf, pdf = FIELDS[fi]
    p = rdf.spec.modulus
    vals, ra, ta = _operands(rdf, 256, 11 + fi)
    canon = port.from_mont(pdf, ta)
    np.testing.assert_array_equal(
        canon.numpy(), np.asarray(ref.from_mont(rdf, jnp.asarray(ra)))
        .astype(np.int32))
    np.testing.assert_array_equal(port.to_mont(pdf, canon).numpy(),
                                  ta.numpy())
    assert [int(v) for v in pdf.from_mont_np(ta)] == vals
    up = pdf.upload_values(vals, "cpu")
    np.testing.assert_array_equal(up.numpy(), ta.numpy())
    # a scalar and a trailing-row operand broadcast against [4, 64, 16]
    s = pdf.scalar(12345, "cpu")
    got = port.fmul(pdf, ta.view(4, 64, 16), s)
    assert [int(v) for v in pdf.from_mont_np(got.reshape(-1, 16))] == \
        [v * 12345 % p for v in vals]
    row = ta[:64]
    got = fk.fadd(pdf, ta.view(4, 64, 16), row).reshape(-1, 16)
    assert [int(v) for v in pdf.from_mont_np(got)] == \
        [(v + vals[i % 64]) % p for i, v in enumerate(vals)]


@pytest.mark.parametrize("fi", [0, 1])
def test_scans_and_batch_inv(fi):
    rdf, pdf = FIELDS[fi]
    p = rdf.spec.modulus
    vals, ra, ta = _operands(rdf, 200, 21 + fi)
    ta[5] = 0
    ra[5] = 0
    vals[5] = 0
    np.testing.assert_array_equal(
        port.batch_inv(pdf, ta).numpy(),
        np.asarray(ref.batch_inv(rdf, jnp.asarray(ra))).astype(np.int32))
    assert [int(v) for v in pdf.from_mont_np(port.batch_inv(pdf, ta))] == \
        [pow(v, -1, p) if v else 0 for v in vals]
    for rev in (False, True):
        np.testing.assert_array_equal(
            port.running_product(pdf, ta, reverse=rev).numpy(),
            np.asarray(ref.running_product(rdf, jnp.asarray(ra),
                                           reverse=rev)).astype(np.int32))
        np.testing.assert_array_equal(
            port.running_sum(pdf, ta, reverse=rev).numpy(),
            np.asarray(ref.running_sum(rdf, jnp.asarray(ra),
                                       reverse=rev)).astype(np.int32))
    two_d = ta[:192].view(3, 64, 16)
    np.testing.assert_array_equal(
        port.running_product(pdf, two_d, axis=1).numpy(),
        np.asarray(ref.running_product(rdf, jnp.asarray(ra[:192]).reshape(
            3, 64, 16), axis=1)).astype(np.int32))
    got = port.fpow(pdf, ta[:8], 65537)
    assert [int(v) for v in pdf.from_mont_np(got)] == \
        [pow(v, 65537, p) for v in vals[:8]]


def test_cuda_header_constants():
    """csrc/field.cuh's limbs of p, R mod p and n0 match the FieldSpecs."""
    import os
    src = open(os.path.join(cuda_build.CSRC, "field.cuh")).read()
    for fid, (_, pdf) in enumerate(FIELDS):
        p = pdf.spec.modulus
        body = src[src.index(f"template <> struct Field<{fid}>"):]
        body = body[:body.index("};")]
        p_fn, one_fn = body.split("one(int i)")

        def limbs(text):
            out = {int(i): int(v, 16) for i, v in re.findall(
                r"case (\d): return 0x([0-9a-f]+)u", text)}
            dflt = re.search(r"default: return 0x([0-9a-f]+)u|"
                             r"default: return (0)u", text)
            d = int(dflt.group(1) or dflt.group(2), 16)
            return sum(out.get(i, d) << (32 * i) for i in range(8))
        assert limbs(p_fn) == p
        assert limbs(one_fn) == (1 << 256) % p
        assert (-pow(p, -1, 1 << 32)) % (1 << 32) == 0xFFFFFFFF


def test_kernel_wrappers_reject_bad_input():
    _, pdf = FIELDS[0]
    with pytest.raises(TypeError):
        fk.fmul(pdf, torch.zeros(4, 16, dtype=torch.int64),
                torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(TypeError):
        fk.fadd(pdf, torch.zeros(4, 15, dtype=torch.int32),
                torch.zeros(4, 15, dtype=torch.int32))
    with pytest.raises(ValueError):
        fk.fmul(pdf, torch.zeros(4, 16, dtype=torch.int32, device="meta"),
                torch.zeros(4, 16, dtype=torch.int32, device="meta"))
