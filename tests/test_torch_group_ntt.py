"""The port's group NTT, device g_lagrange route and MSM dispatch against
the JAX package, on the CPU.

Points are compared as affine host points (the port keeps projective,
the reference Jacobian coordinates); the group law is exact, so every
comparison is exact equality. Inputs are made from a seed with numpy's
generator."""
import importlib

import numpy as np
import pytest
import torch

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.curves.device import (PALLAS_DEV as R_PALLAS_DEV, JPoint,
                                     normalize as r_normalize)
from halo2_tpu.fields.device import FQ_DEV as R_FQ_DEV
from halo2_tpu.ops.ntt import group_ntt as r_group_ntt, make_plan as r_plan
from halo2_tpu.poly import Params as RParams

from halo2_tpu_torch.curves import native
from halo2_tpu_torch.curves.device import normalize
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV, ints_to_digits
from halo2_tpu_torch.ops import msm as msm_ops
from halo2_tpu_torch.ops import point_kernels as pk
from halo2_tpu_torch.ops.ntt import group_ntt, make_plan
from halo2_tpu_torch.poly.commitment import _device_group_intt

FS = PALLAS.scalar
# the reference's MSM module (halo2_tpu.ops re-exports its msm function
# under the same name)
r_msm = importlib.import_module("halo2_tpu.ops.msm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_points(n, seed, identity_lanes=()):
    rng = np.random.default_rng(seed)
    pts = [PALLAS.mul(PALLAS.generator, int(rng.integers(1, 1 << 62)))
           for _ in range(n)]
    for i in identity_lanes:
        pts[i] = None
    return pts


def _affine(batch):
    x, y, inf = normalize(FP_DEV, batch)
    xs, ys = FP_DEV.from_mont_np(x), FP_DEV.from_mont_np(y)
    return [None if f else (int(a), int(b))
            for a, b, f in zip(xs, ys, inf.tolist())]


def _omega(k):
    return pow(FS.root_of_unity, 1 << (FS.s - k), FS.modulus)


def test_group_ntt_matches_reference_and_host_formula():
    """n = 8, with an identity point: the port's group_ntt (the scalar
    ladder's plain version with its fused butterfly) against the
    reference's group_ntt and the defining sum (tests/test_ops.py:62)."""
    k, n = 3, 8
    omega = _omega(k)
    pts = _host_points(n, 3, identity_lanes=(5,))
    got = _affine(group_ntt(FP_DEV, pk.points_to_proj(FP_DEV, pts, "cpu"),
                            make_plan(FQ_DEV, n, omega)))
    want = R_PALLAS_DEV.points_from_device(r_normalize(
        R_PALLAS_DEV, r_group_ntt(R_PALLAS_DEV,
                                  R_PALLAS_DEV.points_to_device(pts),
                                  r_plan(R_FQ_DEV, n, omega))))
    assert got == want
    host = []
    for i in range(n):
        acc = None
        for j, pt in enumerate(pts):
            acc = PALLAS.add(acc, PALLAS.mul(pt, pow(omega, i * j,
                                                     FS.modulus)))
        host.append(acc)
    assert got == host


@pytest.mark.parametrize("k", [3, 4])
def test_device_group_intt_matches_native_and_reference(k):
    """The route Params.new takes on CUDA, run here on the plain versions:
    its host points equal the native library's group iNTT and the
    reference's g_lagrange, and its device batch equals points_to_proj of
    them bit for bit (the bucket-run kernel reads rows 0-31 as coded
    affine)."""
    n = 1 << k
    g = native.native_srs_g(PALLAS, "Halo2-Parameters", n)
    omega_inv = pow(_omega(k), FS.modulus - 2, FS.modulus)
    minv = pow(n, FS.modulus - 2, FS.modulus)
    host, dev = _device_group_intt(PALLAS, pk.points_to_proj(FP_DEV, g, "cpu"),
                                   omega_inv, minv)
    assert host == native.native_group_ntt(PALLAS, g, omega_inv, minv)
    assert host == RParams.new(R_PALLAS, k, use_cache=False).g_lagrange
    assert torch.equal(dev, pk.points_to_proj(FP_DEV, host, "cpu"))


def _msm_inputs(n, seed):
    rng = np.random.default_rng(seed)
    pts = _host_points(n, seed, identity_lanes=(2,))
    scalars = [int.from_bytes(rng.bytes(32), "little") % FS.modulus
               for _ in range(n)]
    scalars[3] = 0
    scalars[4] = FS.modulus - 1
    return scalars, pts


@pytest.fixture(scope="module")
def msm_case():
    """n = 16 inputs with an identity base and the scalars 0 and q - 1,
    and the reference's msm of them (computed once for every case)."""
    scalars, pts = _msm_inputs(16, 41)
    digits = ints_to_digits(scalars).astype(np.uint32)
    res = r_msm.msm(R_PALLAS_DEV, digits, R_PALLAS_DEV.points_to_device(pts))
    res = JPoint(res.x[None], res.y[None], res.z[None])
    want = R_PALLAS_DEV.points_from_device(r_normalize(R_PALLAS_DEV, res))[0]
    assert want == PALLAS.msm(scalars, pts)
    return (scalars, pts, torch.from_numpy(ints_to_digits(scalars)),
            pk.points_to_proj(FP_DEV, pts, "cpu"), want)


@pytest.mark.parametrize("host_threshold", [512, 0],
                         ids=["host", "pippenger"])
def test_msm_dispatch_matches_reference(msm_case, host_threshold,
                                        monkeypatch):
    """msm at n = 16 on each branch (forced by the threshold, as
    tests/test_ops.py:91 forces the reference's) against the reference's
    msm; the Pippenger also with affine bases (packed) and a width it
    pads."""
    monkeypatch.setattr(msm_ops, "HOST_MSM_THRESHOLD", host_threshold)
    scalars, pts, digits, proj, want = msm_case
    assert msm_ops.msm(PALLAS, digits, proj) == want
    if host_threshold == 0:
        packed = pk.pack_affine(proj[:32])
        assert msm_ops.msm(PALLAS, digits, proj, packed=packed) == want
        # 13 scalars: padded to 16 with zero scalars and identity points
        assert msm_ops.msm(PALLAS, digits[:13], proj[:, :13]) == \
            PALLAS.msm(scalars[:13], pts[:13])
    mont = torch.from_numpy(FQ_DEV.to_mont_np(scalars))
    assert msm_ops.msm_mont(PALLAS, mont, proj) == want


def test_msm_small_matches_reference(msm_case):
    """msm_small (the scalar ladder at 256 bits, then tree_sum) against
    the reference's msm."""
    _, _, digits, proj, want = msm_case
    got = msm_ops.msm_small(FP_DEV, digits, proj)
    assert got.shape == (48, 1)
    assert _affine(got) == [want]
