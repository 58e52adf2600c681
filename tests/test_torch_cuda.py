"""The port's CUDA kernels against their plain PyTorch versions, and a
small proof on the card against the same proof on the CPU. These tests
need an NVIDIA GPU and skip elsewhere. The machine with the card has no
JAX, so this file imports none and runs without tests/conftest.py:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import os
import random

import numpy as np
import pytest
import torch

from halo2_tpu_torch.bench_circuit import (BenchCircuit, DevLookupCircuit,
                                           expected_output)
from halo2_tpu_torch.curves.host import PALLAS, VESTA
from halo2_tpu_torch.curves.native import native_srs_g
from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV, ints_to_digits
from halo2_tpu_torch.ops import field_kernels as fk
from halo2_tpu_torch.ops import ipa_device as ipd
from halo2_tpu_torch.ops import msm_pippenger as mp
from halo2_tpu_torch.ops import ntt as ntt_ops
from halo2_tpu_torch.ops import point_kernels as pk
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.plonk.verifier import verify_proof, SingleVerifier
from halo2_tpu_torch.poly.commitment import Params
from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda")


def _field_operands(df, n, seed):
    rng = np.random.default_rng(seed)
    p = df.spec.modulus
    vals = [int.from_bytes(rng.bytes(32), "little") % p
            for _ in range(n - 3)] + [0, 1, p - 1]
    return torch.from_numpy(df.to_mont_np(vals))


@pytest.mark.parametrize("df", [FP_DEV, FQ_DEV], ids=["fp", "fq"])
def test_field_kernels_match_plain(cuda, df):
    a = _field_operands(df, 4099, 1)
    b = _field_operands(df, 4099, 2)
    b[-3:] = a[-1]
    for kern, plain in ((fk.fmul, fk.fmul_plain), (fk.fadd, fk.fadd_plain),
                        (fk.fsub, fk.fsub_plain)):
        before = dict(fk.LAUNCHES)
        got = kern(df, a.to(cuda), b.to(cuda)).cpu()
        assert fk.LAUNCHES != before
        assert torch.equal(got, plain(df, a, b))
        # a broadcast row and a scalar operand
        rows = a[:4096].view(16, 256, 16)
        assert torch.equal(kern(df, rows.to(cuda), b[:256].to(cuda)).cpu(),
                           plain(df, rows, b[:256]))
        assert torch.equal(kern(df, a.to(cuda), b[5].to(cuda)).cpu(),
                           plain(df, a, b[5]))


@pytest.mark.parametrize("df", [FP_DEV, FQ_DEV], ids=["fp", "fq"])
@pytest.mark.parametrize("log_n", [10, 14, 17])
def test_ntt_kernel_matches_plain(cuda, df, log_n):
    """B7 on 3 columns, forward and inverse, in one launch per pass of
    ntt_passes (one at 2^10; 7 + 7 stages at 2^14, 9 + 8 at 2^17)."""
    n = 1 << log_n
    spec = df.spec
    x = _field_operands(df, 3 * n, 6).view(3, n, 16)
    omega = pow(spec.root_of_unity, 1 << (spec.s - log_n), spec.modulus)
    for omega in (omega, pow(omega, spec.modulus - 2, spec.modulus)):
        plan = ntt_ops.make_plan(df, n, omega)
        want = ntt_ops.ntt_many_plain(df, x, plan)
        before = ntt_ops.LAUNCHES["ntt"]
        got = ntt_ops.ntt_many(df, x.to(cuda), plan).cpu()
        assert ntt_ops.LAUNCHES["ntt"] == before + (1 if log_n <= 10 else 2)
        assert torch.equal(got, want)


@pytest.mark.parametrize("df", [FP_DEV, FQ_DEV], ids=["fp", "fq"])
def test_limbs_first_kernel_matches_b1(cuda, df):
    """B8 on limbs-first [16, N] equals B1 on the same elements and its
    plain version."""
    a = _field_operands(df, 4099, 7)
    b = _field_operands(df, 4099, 8)
    before = fk.LAUNCHES["fmul_limbs_first"]
    got = fk.fmul_limbs_first(df, a.T.contiguous().to(cuda),
                              b.T.contiguous().to(cuda))
    assert fk.LAUNCHES["fmul_limbs_first"] == before + 1
    assert torch.equal(got.T.cpu(), fk.fmul(df, a.to(cuda), b.to(cuda)).cpu())
    assert torch.equal(got.cpu(), fk.fmul_limbs_first_plain(
        df, a.T.contiguous(), b.T.contiguous()))


def test_point_kernels_match_plain(cuda):
    df = FP_DEV
    rng = np.random.default_rng(3)
    L = 1000
    pts = native_srs_g(PALLAS, "torch-cuda-test", 3 * L)
    ones = torch.ones(L, dtype=torch.int32)
    a = pk.padd_masked_plain(df, pk.points_to_proj(df, pts[:L], "cpu"),
                             pk.points_to_proj(df, pts[L:2 * L], "cpu"),
                             ones)
    a[:, :7] = pk.ident_col(df, "cpu")[:, None]
    b_pts = pts[2 * L:]
    b_pts[10:17] = [None] * 7
    b = pk.points_to_proj(df, b_pts, "cpu")
    b[:, 20] = a[:, 20]
    mask = torch.from_numpy((rng.random(L) < 0.8).astype(np.int32))
    signs = torch.from_numpy((rng.random(L) < 0.5).astype(np.int32))
    got = pk.padd_masked_flat(df, a.to(cuda), b.to(cuda), mask.to(cuda))
    assert torch.equal(got.cpu(), pk.padd_masked_plain(df, a, b, mask))
    aff = b[:32].contiguous()
    got = pk.pmixed_masked_flat(df, a.to(cuda), aff.to(cuda),
                                mask.to(cuda), signs.to(cuda))
    assert torch.equal(got.cpu(),
                       pk.pmixed_masked_plain(df, a, aff, mask, signs))


def test_add_and_double_kernels_match_plain(cuda):
    """B4, B5 and B6 on both fields: projective operands with identity
    lanes, B4 lanes with a == b, a random B6 mask."""
    rng = np.random.default_rng(5)
    L = 1000
    for curve, df in ((PALLAS, FP_DEV), (VESTA, FQ_DEV)):
        pts = native_srs_g(curve, "torch-cuda-test", 2 * L)
        a = pk.padd_plain(df, pk.points_to_proj(df, pts[:L], "cpu"),
                          pk.points_to_proj(df, pts[L:], "cpu"))
        a[:, :7] = pk.ident_col(df, "cpu")[:, None]
        b = a.flip(1).contiguous()
        b[:, 30:40] = a[:, 30:40]
        mask = torch.from_numpy((rng.random(L) < 0.5).astype(np.int32))
        before = dict(pk.LAUNCHES)
        got = pk.padd_flat(df, a.to(cuda), b.to(cuda)).cpu()
        assert torch.equal(got, pk.padd_plain(df, a, b))
        got = pk.pdouble_flat(df, a.to(cuda)).cpu()
        assert torch.equal(got, pk.pdouble_plain(df, a))
        got = pk.pdouble_masked_flat(df, a.to(cuda), mask.to(cuda)).cpu()
        assert torch.equal(got, pk.pdouble_masked_plain(df, a, mask))
        assert all(pk.LAUNCHES[k] == before[k] + 1
                   for k in ("padd", "pdouble", "pdouble_masked"))


def _card_points(curve, df, L, rng, cuda):
    """[48, L] projective points with Z != 1 on the card: B4 sums of two
    random picks from 1,024 SRS points, one identity lane."""
    pts = pk.points_to_proj(df, native_srs_g(curve, "torch-cuda-test", 1024),
                            cuda)
    pick = lambda: torch.from_numpy(rng.integers(0, 1024, L)).to(cuda)
    g = pk.padd_flat(df, pts[:, pick()], pts[:, pick()])
    g[:, 3] = pk.ident_col(df, cuda)
    return g


def _unfused_ladder(df, t1, t2, t12, bits1, bits2):
    """The loop the ladder kernel replaced: B5, then a masked B3, a step."""
    L = t1.shape[1]
    acc = pk.ident_col(df, t1.device)[:, None].expand(48, L).contiguous()
    table = (t1, t1, t2, t12)
    on = torch.ones(L, dtype=torch.int32, device=t1.device)
    off = torch.zeros_like(on)
    for b1, b2 in zip(bits1, bits2):
        sel = int(b1) + 2 * int(b2)
        acc = pk.pdouble_flat(df, acc)
        acc = pk.padd_masked_flat(df, acc, table[sel], on if sel else off)
    return acc


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_glv_ladder_matches_unfused_loop_and_plain(cuda, curve):
    """The fused ladder equals the B5/B3 kernel loop at 2^13 and 2^17
    lanes (130 random bit pairs) and its plain version at 256 lanes, in
    one launch per call."""
    df = FP_DEV if curve is PALLAS else FQ_DEV
    rng = np.random.default_rng(11)
    bits1 = rng.integers(0, 2, ipd.GLV_BITS)
    bits2 = rng.integers(0, 2, ipd.GLV_BITS)
    for L in (1 << 13, 1 << 17, 256):
        table = ipd.glv_table(df, _card_points(curve, df, L, rng, cuda),
                              1, 0)
        before = pk.LAUNCHES["glv_ladder"]
        got = pk.glv_ladder_flat(df, *table, bits1, bits2)
        assert pk.LAUNCHES["glv_ladder"] == before + 1
        if L == 256:
            want = pk.glv_ladder_plain(df, *table, bits1, bits2)
        else:
            want = _unfused_ladder(df, *table, bits1, bits2)
        assert torch.equal(got, want), L


def test_padd_masked_operand_forms_match_plain(cuda):
    """B3 reading its operand at a lane offset (rows of 512 lanes, as the
    k = 14 commits' suffix and tree rounds; the whole batch, as the scan)
    and by index with and without signs, at 26,624 lanes."""
    df = FP_DEV
    rng = np.random.default_rng(12)
    L = 26624
    a = _card_points(PALLAS, df, L, rng, cuda)
    src = _card_points(PALLAS, df, 1 << 14, rng, cuda)
    mask = torch.from_numpy((rng.random(L) < 0.8).astype(np.int32)).to(cuda)
    signs = torch.from_numpy((rng.random(L) < 0.5).astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, 1 << 14, L)).to(cuda)
    forms = [dict(width=512, shift=-1), dict(width=512, shift=-256),
             dict(width=L, shift=3)]
    for kw in forms:
        got = pk.padd_masked_flat(df, a, a, mask, **kw)
        assert torch.equal(got, pk.padd_masked_plain(df, a, a, mask, **kw))
    for sign in (None, signs):
        got = pk.padd_masked_flat(df, a, src, mask, idx=idx, sign=sign)
        want = pk.padd_masked_plain(df, a, src, mask, idx=idx, sign=sign)
        assert torch.equal(got, want)


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_bucket_runs_kernel_matches_plain_and_b2_loop(cuda, curve):
    """The bucket-run kernel at a k = 14 advice commit's 26,624 lanes (two
    columns of 2^14 random scalars, c = 10, with identity bases): equal to
    its plain version and to the
    one-step B2 kernel run round by round, in one launch."""
    df = FP_DEV if curve is PALLAS else FQ_DEV
    n = 1 << 14
    pts = native_srs_g(curve, "torch-cuda-test", n)
    pts[7] = pts[1000] = None
    aff = pk.points_to_proj(df, pts, cuda)[:32].contiguous()
    packed = pk.pack_affine(aff)
    rng = np.random.default_rng(13)
    q = curve.scalar.modulus
    cols = [[int.from_bytes(rng.bytes(32), "little") % q for _ in range(n)]
            for _ in range(2)]
    digits = torch.from_numpy(np.stack([ints_to_digits(c) for c in cols]))
    runs = mp.bucket_runs(curve, digits.to(cuda), 10)
    starts = runs.starts_e.reshape(-1).to(torch.int32)
    counts = runs.counts_e.reshape(-1).to(torch.int32)
    assert starts.shape[0] == 26624
    members = pk.bucket_members(runs.order, runs.sg)
    want = pk.pmixed_bucket_runs_plain(df, packed, members, starts, counts,
                                       runs.BL)
    # the one-step B2 kernel, round by round, on the gathered bases
    flat = members.reshape(-1).long()
    row_off = torch.arange(starts.shape[0], device=cuda) // runs.BL * n
    loop = pk.ident_col(df, cuda)[:, None].expand(48, 26624).contiguous()
    for r in range(int(counts.max())):
        valid = r < counts
        m = flat[row_off + torch.where(valid, starts.long() + r, 0)]
        loop = pk.pmixed_masked_flat(df, loop, aff[:, m & 0x7FFFFFFF],
                                     valid.to(torch.int32),
                                     (m < 0).to(torch.int32))
    assert torch.equal(loop, want)
    # from int32 run bounds and from the int64 ones the MSM passes
    # (converted in the wrapper)
    for st, ct in ((starts, counts),
                   (runs.starts_e.reshape(-1), runs.counts_e.reshape(-1))):
        before = pk.LAUNCHES["pmixed_bucket_runs"]
        got = pk.pmixed_bucket_runs(df, packed, members, st, ct, runs.BL)
        assert pk.LAUNCHES["pmixed_bucket_runs"] == before + 1
        assert torch.equal(got, want), st.dtype


def _scalar_digits(curve, L, rng, cuda):
    """[L, 16] random 256-bit scalars, the first four 0, 1, q - 1 and
    2^256 - 1."""
    q = curve.scalar.modulus
    vals = [0, 1, q - 1, (1 << 256) - 1] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(L - 4)]
    return torch.from_numpy(ints_to_digits(vals)).to(cuda)


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_scalar_mul_ladder_matches_loop_and_plain(cuda, curve):
    """The scalar-multiplication ladder, one launch a call: at 2^13 lanes
    equal to the B5/B4/select loop (256 bits, one scalar a lane; 255 bits
    from a table of 2^12 rows read by lane % T, with the fused
    butterfly); at 256 lanes equal to its plain version."""
    df = FP_DEV if curve is PALLAS else FQ_DEV
    rng = np.random.default_rng(15)
    for L in (1 << 13, 256):
        pts = _card_points(curve, df, L, rng, cuda)
        lo = _card_points(curve, df, L, rng, cuda)
        digits = _scalar_digits(curve, L, rng, cuda)
        table = digits[:L // 2]
        before = pk.LAUNCHES["scalar_mul_ladder"]
        got = pk.scalar_mul_ladder_flat(df, pts, digits, 256)
        top, bot = pk.scalar_mul_ladder_flat(df, pts, table, 255, lo=lo)
        assert pk.LAUNCHES["scalar_mul_ladder"] == before + 2
        if L == 256:
            assert torch.equal(got, pk.scalar_mul_ladder_plain(
                df, pts, digits, 256))
            want = pk.scalar_mul_ladder_plain(df, pts, table, 255, lo=lo)
            assert torch.equal(top, want[0]) and torch.equal(bot, want[1])
        else:
            assert torch.equal(got, pk.scalar_mul_ladder_loop(df, pts, digits,
                                                              256))
            full = table[torch.arange(L, device=cuda) % (L // 2)]
            t = pk.scalar_mul_ladder_loop(df, pts, full, 255)
            assert torch.equal(top, pk.padd_flat(df, lo, t))
            assert torch.equal(bot, pk.padd_flat(df, lo,
                                                 pk.pneg_flat(df, t)))


GROUP_EDGES = (1, 31, 33, 8191, 8192)


def _edge_points(curve, df, L, rng, cuda):
    """[48, L] points with Z != 1 and an identity lane (lane L // 3)."""
    pts = pk.points_to_proj(df, native_srs_g(curve, "torch-cuda-test", 1024),
                            cuda)
    pick = lambda: torch.from_numpy(rng.integers(0, 1024, L)).to(cuda)
    g = pk.padd_flat(df, pts[:, pick()], pts[:, pick()])
    g[:, L // 3] = pk.ident_col(df, cuda)
    return g


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_padd_kernel_at_group_and_block_edges(cuda, curve):
    """B4 (one lane a group of four threads) equals padd_plain at lane
    counts that end part way through a warp or a block: 1, 31, 33, 8,191
    and 8,192 lanes, with identity lanes and a == b lanes, one launch a
    call."""
    df = FP_DEV if curve is PALLAS else FQ_DEV
    rng = np.random.default_rng(21)
    for L in GROUP_EDGES:
        a = _edge_points(curve, df, L, rng, cuda)
        b = _edge_points(curve, df, L, rng, cuda)
        b[:, L // 2:L // 2 + 5] = a[:, L // 2:L // 2 + 5]
        b[:, -1] = pk.ident_col(df, cuda)
        before = pk.LAUNCHES["padd"]
        got = pk.padd_flat(df, a, b)
        assert pk.LAUNCHES["padd"] == before + 1
        assert torch.equal(got.cpu(), pk.padd_plain(df, a.cpu(), b.cpu())), L


@pytest.mark.parametrize("curve", [PALLAS, VESTA], ids=["pallas", "vesta"])
def test_scalar_mul_ladder_at_group_and_block_edges(cuda, curve):
    """The scalar ladder (one lane a group of four threads) at 1, 31, 33,
    8,191 and 8,192 lanes, with the scalars 0, 1, q - 1 and 2^256 - 1 and
    identity lanes, without and with the fused butterfly (a table of half
    the lanes): equal to its plain version up to 33 lanes (at one lane,
    each edge scalar in turn) and to the B5/B4/select loop above."""
    df = FP_DEV if curve is PALLAS else FQ_DEV
    rng = np.random.default_rng(22)
    for L in GROUP_EDGES:
        pts = _edge_points(curve, df, L, rng, cuda)
        lo = _edge_points(curve, df, L, rng, cuda)
        digits = _scalar_digits(curve, max(L, 4), rng, cuda)
        for d in (digits[i:i + 1] for i in range(4)) if L == 1 else (digits,):
            table = d[:max(L // 2, 1)]
            before = pk.LAUNCHES["scalar_mul_ladder"]
            got = pk.scalar_mul_ladder_flat(df, pts, d, 256)
            top, bot = pk.scalar_mul_ladder_flat(df, pts, table, 255, lo=lo)
            assert pk.LAUNCHES["scalar_mul_ladder"] == before + 2
            if L <= 33:
                assert torch.equal(got, pk.scalar_mul_ladder_plain(
                    df, pts, d, 256)), L
                want = pk.scalar_mul_ladder_plain(df, pts, table, 255, lo=lo)
            else:
                assert torch.equal(got, pk.scalar_mul_ladder_loop(
                    df, pts, d, 256)), L
                full = table[torch.arange(L, device=cuda) % table.shape[0]]
                t = pk.scalar_mul_ladder_loop(df, pts, full, 255)
                want = (pk.padd_flat(df, lo, t),
                        pk.padd_flat(df, lo, pk.pneg_flat(df, t)))
            assert torch.equal(top, want[0]) and torch.equal(bot, want[1]), L


def test_params_new_on_the_card_matches_native(cuda):
    """Params.new on CUDA builds g_lagrange by the device group iNTT (one
    ladder launch a stage and one for the 1/n scale): the same bytes as
    the CPU's, whose g_lagrange comes from the native library, and its
    device batches of g and g_lagrange equal to points_to_proj of their
    points."""
    k = 10
    before = pk.LAUNCHES["scalar_mul_ladder"]
    params = Params.new(PALLAS, k, device=cuda, use_cache=False)
    assert pk.LAUNCHES["scalar_mul_ladder"] == before + k + 1
    assert params.write() == Params.new(PALLAS, k, device="cpu",
                                        use_cache=False).write()
    assert torch.equal(params.g_lagrange_dev, pk.points_to_proj(
        FP_DEV, params.g_lagrange, cuda))
    assert torch.equal(params.g_dev, pk.points_to_proj(FP_DEV, params.g,
                                                       cuda))


def test_msm_on_the_card_matches_host(cuda):
    n = 1024
    pts = native_srs_g(PALLAS, "torch-cuda-test", n)
    pts[3] = None
    q = PALLAS.scalar.modulus
    rng = np.random.default_rng(4)
    cols = [[int.from_bytes(rng.bytes(32), "little") % q
             for _ in range(n)], [0] * n, [q - 1] * n]
    proj = pk.points_to_proj(FP_DEV, pts, cuda)
    digits = torch.from_numpy(np.stack([ints_to_digits(c) for c in cols]))
    got = mp.msm_many(PALLAS, FP_DEV, digits.to(cuda), proj)
    assert got == [PALLAS.msm(c, pts) for c in cols]


@pytest.mark.parametrize("threshold", [None, 0],
                         ids=["default", "all-device-ipa"])
def test_proof_on_the_card_equals_the_cpu_proof(cuda, threshold):
    """The default IPA schedule (all rounds native at k = 5) and every IPA
    round on the device give the CPU's proof."""
    kw = {} if threshold is None else {"native_ipa_threshold": threshold}
    k, regions = 5, 10
    out = expected_output(PALLAS.scalar, 5, regions)
    proofs = []
    for dev in ("cpu", cuda):
        params = Params.new(PALLAS, k, device=dev)
        circuit = BenchCircuit(5, regions)
        vk = keygen_vk(params, circuit)
        pk_ = keygen_pk(params, vk, circuit)
        tw = TranscriptWrite(PALLAS)
        create_proof(params, pk_, [circuit], [[[out]]], random.Random(9), tw,
                     **kw)
        proofs.append(tw.finalize())
        verify_proof(params, vk, SingleVerifier(params), [[[out]]],
                     TranscriptRead(PALLAS, proofs[-1]))
    assert proofs[0] == proofs[1]


def test_lookup_proof_on_the_card_equals_the_cpu_proof(cuda):
    """The scaled-down dev_lookup circuit (a 2^3 table, 16 looked-up rows)
    at K = 5: the card's proof equals the CPU's and verifies."""
    proofs = []
    for dev in ("cpu", cuda):
        params = Params.new(PALLAS, 5, device=dev)
        circuit = DevLookupCircuit(3, 16)
        vk = keygen_vk(params, circuit)
        pk_ = keygen_pk(params, vk, circuit)
        tw = TranscriptWrite(PALLAS)
        create_proof(params, pk_, [circuit], [[]], random.Random(9), tw)
        proofs.append(tw.finalize())
        verify_proof(params, vk, SingleVerifier(params), [[]],
                     TranscriptRead(PALLAS, proofs[-1]))
    assert proofs[0] == proofs[1]


@pytest.mark.parametrize("tamper", [False, True], ids=["satisfied",
                                                      "tampered"])
def test_mock_prover_gate_check_on_the_card(cuda, tamper):
    """MockProver.verify_vectorized on the card at 2^12 rows gives the
    host checker's gate failures, and per-row flags equal to the plain
    versions' on the CPU."""
    from halo2_tpu_torch.bench_circuit import regions_for_k
    from halo2_tpu_torch.dev import MockProver

    k = 12
    regions = regions_for_k(k)
    prover = MockProver.run(k, BenchCircuit(5, regions),
                            [[expected_output(PALLAS.scalar, 5, regions)]])
    if tamper:
        col = prover.advice[0]
        for row in (1, 2048, 4089):
            col[row] = (col[row] + 1) % PALLAS.scalar.modulus
    before = fk.LAUNCHES["fmul"]
    errors = prover.verify_vectorized(device=cuda)
    assert fk.LAUNCHES["fmul"] > before
    assert errors == prover.verify(streams=("gates",))
    assert bool(errors) == tamper
    flags = [ok for *_, ok in prover.gate_zero_flags(cuda)]
    plain = [ok for *_, ok in prover.gate_zero_flags("cpu")]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(flags, plain))


def test_golden_gadget_key_built_on_the_card(cuda):
    """keygen_vk of a golden gadget circuit at K = 11 on the card (its
    fixed and permutation commitments through the bucket-run kernel)
    equals zcash/halo2's pinned key, and its golden proof verifies."""
    from halo2_tpu_torch import gadget_circuits as gc
    name = "lookup_range_check"
    golden = os.path.join(os.path.dirname(__file__), "golden")
    params = Params.new(VESTA, gc.K, device=cuda, use_cache=False)
    before = dict(pk.LAUNCHES)
    vk = keygen_vk(params, gc.golden_circuit(gc.port_namespace(), name))
    assert pk.LAUNCHES["pmixed_bucket_runs"] > before["pmixed_bucket_runs"]
    with open(os.path.join(golden, f"vk_{name}.rdata")) as fh:
        assert vk.pinned_text() + "\n" == fh.read()
    with open(os.path.join(golden, f"proof_{name}.bin"), "rb") as fh:
        proof = fh.read()
    verify_proof(params, vk, SingleVerifier(params), [[]],
                 TranscriptRead(VESTA, proof))
