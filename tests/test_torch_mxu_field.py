"""The port's four-step NTT on shared-constant products
(halo2_tpu_torch/ops/mxu_field.py, kernel K1's plain version) against
the JAX package's halo2_tpu/ops/mxu_field.py, bit for bit: the band
tables, the grouped constant product (edge constants and values in both
fields), ntt_mxu and ntt_mxu_b forward and inverse, the domain's route
by size, and a K = 4 proof with every transform through the four-step.
"""
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from halo2_tpu.curves import PALLAS as R_PALLAS
from halo2_tpu.fields.device import (FP_DEV as R_FP_DEV, FQ_DEV as R_FQ_DEV,
                                     fmul as r_fmul)
from halo2_tpu.ops import mxu_field as rmxu
from halo2_tpu.ops.ntt import make_plan as r_make_plan, ntt as r_ntt
from halo2_tpu.poly import Params as RParams
from halo2_tpu.transcript import TranscriptWrite as RTranscriptWrite
from halo2_tpu.circuit import Circuit as RCircuit, Value as RValue
from halo2_tpu.poly.polynomial import Rotation as RRotation
from halo2_tpu import plonk as rplonk

from halo2_tpu_torch.circuit import Circuit, Value
from halo2_tpu_torch.convert import params_from_reference
from halo2_tpu_torch.curves.host import PALLAS
from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV
from halo2_tpu_torch.ops import mxu_field as mxu
from halo2_tpu_torch.ops.field_kernels import (fmul, fmul_plain, fadd_plain,
                                              fsub_plain)
from halo2_tpu_torch.ops.ntt import make_plan, ntt_many
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
from halo2_tpu_torch.plonk.prover import create_proof
from halo2_tpu_torch.poly import domain as port_domain
from halo2_tpu_torch.poly.polynomial import Rotation
from halo2_tpu_torch.transcript import TranscriptWrite

from test_torch_prover import mul_circuit_class, SEED

FIELDS = [(FP_DEV, R_FP_DEV), (FQ_DEV, R_FQ_DEV)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]


@pytest.mark.parametrize("fields", FIELDS, ids=["fp", "fq"])
def test_band_matrices_match_reference(fields):
    df, rdf = fields
    p = df.spec.modulus
    consts = [0, 1, p - 1, p - 2] + _values(p, 5, 1)
    got = mxu.band_matrices(df, consts)
    assert got.dtype == np.float32
    assert np.array_equal(got, rmxu.band_matrices(rdf, consts))
    assert np.array_equal(mxu.band_matrix(consts[5]),
                          rmxu.band_matrix(consts[5]))


@pytest.mark.parametrize("fields", FIELDS, ids=["fp", "fq"])
def test_mul_const_grouped_matches_reference_and_fmul(fields):
    """G = 6 groups of nb = 9 lanes: the constants and the values include
    0, 1, p - 1 and p - 2 (p - 1 times p - 1 is the column sums' worst
    case)."""
    df, rdf = fields
    p = df.spec.modulus
    G, nb = 6, 9
    consts = [0, 1, p - 1, p - 2] + _values(p, G - 4, 2)
    vals = [[0, 1, p - 1, p - 2] + _values(p, nb - 4, 3 + g)
            for g in range(G)]
    x = df.to_mont_np(vals)                                   # [G, nb, 16]
    c = df.to_mont_np(consts)                                 # [G, 16]
    got = mxu.mul_const_grouped(df, torch.from_numpy(x), torch.from_numpy(c))
    want = np.asarray(rmxu.mul_const_grouped(
        rdf, jnp.asarray(x.astype(np.uint32)),
        jnp.asarray(rmxu.band_matrices(rdf, consts))))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert torch.equal(got, fmul(df, torch.from_numpy(x),
                                 torch.from_numpy(c)[:, None]))
    for g in range(G):
        ref = np.asarray(r_fmul(rdf, jnp.asarray(x[g].astype(np.uint32)),
                                jnp.asarray(c[g].astype(np.uint32))))
        assert np.array_equal(got[g].numpy(), ref.astype(np.int32))


def _plans(df, rdf, k):
    p = df.spec.modulus
    omega = pow(df.spec.root_of_unity, 1 << (df.spec.s - k), p)
    omega_inv = pow(omega, p - 2, p)
    return [(make_plan(df, 1 << k, w), r_make_plan(rdf, 1 << k, w))
            for w in (omega, omega_inv)]


@pytest.mark.parametrize("k", [4, 7, 10])
def test_ntt_mxu_matches_reference(k):
    """ntt_mxu forward and inverse (and K1's emulated pass schedule,
    below) against the JAX ntt_mxu and the port's B7 plain version (held
    to the JAX ntt by tests/test_torch_ntt.py; the JAX ntt itself in the
    batched test below), in Fp (Fq below)."""
    df, rdf = FP_DEV, R_FP_DEV
    n = 1 << k
    x = df.to_mont_np(_values(df.spec.modulus, n, 10 + k))
    xj = jnp.asarray(x.astype(np.uint32))
    for plan, rplan in _plans(df, rdf, k):
        got = mxu.ntt_mxu(df, torch.from_numpy(x), plan).numpy()
        assert np.array_equal(
            got, np.asarray(rmxu.ntt_mxu(rdf, xj, rplan)).astype(np.int32))
        assert np.array_equal(
            got, _emulate_passes(df, torch.from_numpy(x)[None], plan)[0])
        assert np.array_equal(
            got, ntt_many(df, torch.from_numpy(x)[None], plan)[0].numpy())


def test_ntt_mxu_b_matches_reference():
    """m = 3 columns at k = 8, forward and inverse (and K1's emulated pass
    schedule, below), against the JAX ntt_mxu_b and ntt column by column,
    in Fq."""
    df, rdf = FQ_DEV, R_FQ_DEV
    k, m = 8, 3
    n = 1 << k
    x = df.to_mont_np([_values(df.spec.modulus, n, 20 + j)
                       for j in range(m)])
    xj = jnp.asarray(x.astype(np.uint32))
    for plan, rplan in _plans(df, rdf, k):
        got = mxu.ntt_mxu_b(df, torch.from_numpy(x), plan).numpy()
        assert np.array_equal(
            got, np.asarray(rmxu.ntt_mxu_b(rdf, xj, rplan)).astype(np.int32))
        assert np.array_equal(
            got, _emulate_passes(df, torch.from_numpy(x), plan).numpy())
        for j in range(m):
            assert np.array_equal(
                got[j], np.asarray(r_ntt(rdf, xj[j], rplan)).astype(np.int32))


def test_route_by_size():
    """The four-step only on CUDA, from MXU_NTT_MIN (2^16) up; never on the
    CPU, at any size."""
    assert port_domain.MXU_NTT_MIN == 1 << 16
    for n in (1, 1 << 10, 1 << 16, 1 << 20, 1 << 24):
        assert not port_domain._use_mxu(n, "cpu")
        assert port_domain._use_mxu(n, "cuda") == (n >= 1 << 16)
        assert port_domain._use_mxu(n, torch.device("cuda", 0)) == (
            n >= 1 << 16)


def k4_proofs(**port_kw):
    """MulCircuit (tests/test_torch_prover.py) at K = 4 proved by the JAX
    package and by the port (with create_proof keywords port_kw) from the
    same Params and RNG seed: (reference proof, port proof)."""
    k, a, b = 4, 7, 191
    out = R_PALLAS.scalar.mul(a, b)
    rparams = RParams.new(R_PALLAS, k, use_cache=False)
    params = params_from_reference("pallas", k, rparams.g,
                                   rparams.g_lagrange, rparams.w, rparams.u,
                                   "cpu")
    rcircuit = mul_circuit_class(RCircuit, RValue, RRotation,
                                 R_PALLAS.scalar)(a, b)
    circuit = mul_circuit_class(Circuit, Value, Rotation, PALLAS.scalar)(a, b)
    rvk = rplonk.keygen_vk(rparams, rcircuit)
    rpk = rplonk.keygen_pk(rparams, rvk, rcircuit)
    rtw = RTranscriptWrite(R_PALLAS)
    rplonk.create_proof(rparams, rpk, [rcircuit], [[[out]]],
                        random.Random(SEED), rtw)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    tw = TranscriptWrite(PALLAS)
    create_proof(params, pk, [circuit], [[[out]]], random.Random(SEED), tw,
                 **port_kw)
    return rtw.finalize(), tw.finalize()


def test_k4_proof_through_the_four_step(monkeypatch):
    """The route taken from n = 16 (a test hook on _use_mxu, not a knob):
    every keygen and prover transform goes through ntt_mxu_b, and the
    proof equals the JAX package's bytes."""
    calls = []
    orig = mxu.ntt_mxu_b

    def counted(df, x, plan):
        calls.append(tuple(x.shape[:2]))
        return orig(df, x, plan)

    monkeypatch.setattr(port_domain, "_use_mxu",
                        lambda n, device: n >= 16)
    monkeypatch.setattr(port_domain, "ntt_mxu_b", counted)
    monkeypatch.setattr(port_domain, "ntt_many", None)   # B7 never taken
    rproof, proof = k4_proofs()
    assert calls
    assert proof == rproof


# ---------------------------------------------------------------------------
# K1's pass kernel (csrc/mxu_kernels.cu::mxu_pass_kernel) emulated
# ---------------------------------------------------------------------------

def _bitrev(i: torch.Tensor, bits: int) -> torch.Tensor:
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def _emulate_passes(df, x, plan, max_log=mxu.MXU_PASS_LOG,
                    lanes_log=mxu.MXU_LANES_LOG):
    """The pass kernel's schedule over x [m, n, 16] on the CPU, launch by
    launch of mxu.four_step_passes and every block at once: block b is
    (residue b mod 2^a, higher group h, lane chunk); its tile of 2^cnt
    axis positions i = res + t 2^a + h 2^(a+cnt) times 2^lanes_log lanes
    is read through the pass's source strides (i bit-reversed where it
    gathers), lanes past the end zero; stage a + s pairs tile rows t and
    t + 2^(s-1) with the twiddle at row 2^(a+s-1) - 1 + res + (t mod
    2^(s-1)) 2^a of the axis plan's table; the tile is written through the
    destination strides, times the diagonal twiddle there on the column
    axis' last pass. Every element of the destination is written exactly
    once."""
    m, n = x.shape[0], x.shape[1]
    p4 = mxu._mxu4_plan(df, plan)
    diag = p4.on("cpu")["diag"]
    Lb = 1 << lanes_log
    src = x.reshape(m * n, 16)
    for ps in mxu.four_step_passes(m, n, max_log):
        N = 1 << ps.log_n
        table = (p4.row_plan if ps.axis else p4.col_plan).on("cpu")[1]
        chunks = -(-ps.lanes // Lb)
        n_res, highs = 1 << ps.a, N >> (ps.a + ps.cnt)
        b = torch.arange(chunks * highs * n_res)
        res, h = b % n_res, (b // n_res) % highs
        q = ((b // (n_res * highs)) * Lb)[:, None, None] + torch.arange(Lb)
        i = (res[:, None, None] + (torch.arange(1 << ps.cnt)[:, None]
                                   << ps.a) + (h[:, None, None]
                                               << (ps.a + ps.cnt)))
        valid = (q < ps.lanes).expand(-1, 1 << ps.cnt, -1)
        j, lane = q >> ps.lpc_log, q & ((1 << ps.lpc_log) - 1)
        si = _bitrev(i, ps.log_n) if ps.gather else i
        e = (j * n + si * ps.s_ax + lane * ps.s_ln).expand_as(valid)
        tile = torch.where(valid[..., None], src[e.clamp(0, m * n - 1)], 0)
        for s in range(1, ps.cnt + 1):
            ht = 1 << (s - 1)
            tlo = torch.tensor([t for t in range(1 << ps.cnt) if not t & ht])
            row = ((1 << (ps.a + s - 1)) - 1 + res[:, None]
                   + ((tlo & (ht - 1)) << ps.a))
            lo, hi = tile[:, tlo], tile[:, tlo + ht]
            prod = fmul_plain(df, hi, table[row][:, :, None])
            tile[:, tlo] = fadd_plain(df, lo, prod)
            tile[:, tlo + ht] = fsub_plain(df, lo, prod)
        pos = (i * ps.d_ax + lane * ps.d_ln).expand_as(valid)
        if ps.diag:
            tile = fmul_plain(df, tile, diag[pos])
        dst = (j * n + pos)[valid]
        assert torch.equal(torch.sort(dst).values, torch.arange(m * n))
        out = torch.empty_like(src)
        out[dst] = tile[valid]
        src = out
    return src.view(m, n, 16)


@pytest.mark.parametrize("fields", FIELDS, ids=["fp", "fq"])
@pytest.mark.parametrize("k", range(4, 13))
def test_pass_schedule_matches_b7(fields, k):
    """The pass kernel's emulated schedule (its residues, twiddle rows,
    fused gather, diagonal and transposes, in the plan's order) at m = 1
    and 3, forward and inverse, against the port's B7 plain version (held
    to the JAX ntt by tests/test_torch_ntt.py; the emulation is held to
    the JAX ntt_mxu and ntt_mxu_b themselves in the tests above, where
    the JAX transform is compiled anyway: 20-30 s a shape on a CPU)."""
    df, rdf = fields
    n = 1 << k
    for m in (1, 3):
        x = torch.from_numpy(df.to_mont_np(
            [_values(df.spec.modulus, n, 30 + k + j) for j in range(m)]))
        for plan, _ in _plans(df, rdf, k):
            assert torch.equal(_emulate_passes(df, x, plan),
                               ntt_many(df, x, plan))


def test_pass_schedule_other_plans():
    """The same emulation with passes of 3 and 6 stages and tiles of 64
    lanes (redesign_variants.py's builds) against B7's plain version."""
    df = FP_DEV
    k, m = 11, 2
    n = 1 << k
    x = torch.from_numpy(df.to_mont_np(
        [_values(df.spec.modulus, n, 60 + j) for j in range(m)]))
    plan = _plans(df, R_FP_DEV, k)[0][0]
    want = ntt_many(df, x, plan)
    for max_log, lanes_log in ((3, 5), (6, 5), (5, 6)):
        assert torch.equal(_emulate_passes(df, x, plan, max_log, lanes_log),
                           want)


def test_pass_plan_covers_every_stage():
    """four_step_passes at 2^2 .. 2^24: each axis' passes run its stages
    1 .. log2 N once each, in order, at most MXU_PASS_LOG a pass, so a
    transform of 2^12 to 2^20 makes four launches (2^11 three, smaller
    two); the first gathers, the column axis' last takes the diagonal,
    the row axis' last transposes; every tile fits the kernel's shared
    memory (csrc/mxu_kernels.cu::pass_smem, its constants read from the
    source), also the passes of 6 stages and the tiles of 64 lanes that
    redesign_variants.py builds."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(mxu.__file__), "..", "csrc",
                            "mxu_kernels.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    def fits(cnt, lanes_log):
        e = 1 << (lanes_log + cnt)
        smem = 4 * (8 * e + min(const("kPassWarps"), e >> 6) * 32
                    * const("kSumRow") + ((1 << cnt) - 1)
                    * const("kBandWords"))
        return (lanes_log + cnt <= const("kMaxTileLog")
                and smem <= 232448)
    assert mxu.MXU_PASS_LOG >= 5
    assert fits(6, 5) and fits(5, 6)
    for k in range(2, 25):
        for m in (1, 3):
            passes = mxu.four_step_passes(m, 1 << k)
            lr = (k + 1) // 2
            for axis, log_n in ((0, lr), (1, k - lr)):
                mine = [ps for ps in passes if ps.axis == axis]
                assert len(mine) == -(-log_n // mxu.MXU_PASS_LOG)
                a = 0
                for idx, ps in enumerate(mine):
                    assert ps.a == a and 1 <= ps.cnt <= mxu.MXU_PASS_LOG
                    assert ps.log_n == log_n and ps.gather == (idx == 0)
                    assert ps.lanes == m << (k - log_n)
                    assert fits(ps.cnt, mxu.MXU_LANES_LOG)
                    a += ps.cnt
                assert a == log_n
            assert [ps.diag for ps in passes].count(True) == 1
            assert passes[[ps.axis for ps in passes].index(1) - 1].diag
            assert (passes[-1].d_ax, passes[-1].d_ln) == (1 << lr, 1)
            assert len(passes) == (-(-lr // mxu.MXU_PASS_LOG)
                                   - (-(k - lr) // mxu.MXU_PASS_LOG))
            if k <= 20:
                assert len(passes) == (4 if k >= 12 else 3 if k == 11
                                       else 2)


def _byte_perm(x: int, y: int, s: int) -> int:
    b = [(x >> (8 * k)) & 0xFF for k in range(4)] + [
        (y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(b[(s >> (4 * e)) & 7] << (8 * e) for e in range(4))


def _limbs(v: int) -> list:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


@pytest.mark.parametrize("fields", FIELDS, ids=["fp", "fq"])
def test_fragment_order_emulated(fields):
    """K1's fragments on host ints, thread by thread of a warp: the B
    fragments built from the staged constant by byte_perm
    (band_fragments), the A fragments as limbs 2t, 2t + 1 of rows g and
    g + 8 of each m16 tile, the products by PTX's m16n8k32 fragment
    layout, the column pairs staged (products_to_sums) and carried into
    limbs (reduce_sums): every lane's 512-bit sum equals a c, with
    constants and values of 0xFF bytes."""
    df = fields[0]
    p = df.spec.modulus
    top = (1 << 254) - 1
    consts = [0, 1, p - 1, top] + _values(p, 3, 6)
    vals = [top, p - 1, 0, 1] + _values(p, 28, 7)
    for c in consts:
        cz = [0] * 8 + _limbs(c) + [0] * 12
        B = np.zeros((32, 64), np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            pw = 29 + g - 8 * t
            w0, o = pw >> 2, pw & 3
            sel = (o + 3) | ((o + 2) << 4) | ((o + 1) << 8) | (o << 12)
            v = [cz[w0 - 1 + k] for k in range(18)]
            for T in range(8):
                for hh, word in enumerate(
                        (_byte_perm(v[2 * T + 1], v[2 * T + 2], sel),
                         _byte_perm(v[2 * T], v[2 * T + 1], sel))):
                    for e in range(4):
                        B[16 * hh + 4 * t + e, 8 * T + g] = (
                            word >> (8 * e)) & 0xFF
        A = np.zeros((32, 32), np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for M in range(2):
                for rr in range(2):
                    row = 16 * M + g + 8 * rr
                    limbs = _limbs(vals[row])
                    for e in range(4):
                        A[row, 4 * t + e] = (limbs[2 * t] >> (8 * e)) & 0xFF
                        A[row, 16 + 4 * t + e] = (
                            limbs[2 * t + 1] >> (8 * e)) & 0xFF
        D = A @ B
        assert D.max() < 1 << 21
        sums = np.full((32, 32), -1, np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for M in range(2):
                for T in range(8):
                    for r in (16 * M + g, 16 * M + g + 8):
                        sums[r, 4 * T + t] = (D[r, 8 * T + 2 * t]
                                              + (D[r, 8 * T + 2 * t + 1]
                                                 << 8))
        assert sums.min() >= 0 and sums.max() < 1 << 30
        for row in range(32):
            acc, total = 0, 0
            for i in range(16):
                acc += int(sums[row, 2 * i]) + (int(sums[row, 2 * i + 1])
                                                << 16)
                total |= (acc & 0xFFFFFFFF) << (32 * i)
                acc >>= 32
            assert acc == 0 and total == vals[row] * c
