"""Products by shared constants on the tensor cores (kernel K1), and the
four-step NTT built on them.

Port of halo2_tpu/ops/mxu_field.py, whose twiddle products are 8-bit
digit matmuls on the TPU's MXU (an XLA `dot_general`, no Pallas call).
When many lanes multiply by the same constant c, as every butterfly of
an NTT stage at twiddle position j does, the digit product columns

    cols[k] = sum_{i+j=k} a_i c_j

are a matrix product A[lanes, 32 digits] @ W_c[32, 63] with W_c the
banded matrix of c's 8-bit digits. The reference runs it in float32 on
the MXU; kernel K1 (csrc/mxu_kernels.cu) runs it on the H100's tensor
cores as `mma.sync.m16n8k32` on u8 digits with s32 sums (each column
sums at most 32 products below 2^16, so below 2^21: exact), builds the
band of each twiddle in registers from its 32 digits, carries the 63
columns into a 512-bit product and runs the Montgomery reduction and the
butterfly lo +- t on the CUDA cores. Its results are bit-identical to
B1 (`fmul`) and the add/subtract: every output is the canonical value.

`mul_const_grouped` is one K1 launch (products only); `ntt_mxu_b` runs a
size-n transform as the reference's four-step n = R C: a size-R NTT down
the columns, the diagonal twiddles w^(k_r c), a transpose, a size-C NTT,
a transpose. On CUDA that is `four_step_passes`: each axis NTT in passes
of at most MXU_PASS_LOG stages, each pass one K1 launch that runs its
stages in shared memory on tiles of 2^cnt axis positions x 32 lanes (a
warp's two m16 tiles share one twiddle), with the bit-reversal gather in
each axis' first load, the diagonal twiddles in the column axis' last
store and the transposes in the passes' strides: four launches a
transform of 2^12 to 2^20 (three at 2^11), and nothing else. On the CPU
(and as the card's oracle, `ntt_mxu_b_plain`) the steps run one stage
at a time with the plain versions, in int64 with float64 column sums.
`LAUNCHES` counts K1's launches, nowhere else (tracing.launch, with a
launch's work: a pass its elements read and written, 128 bytes each,
its stages' packed twiddles (32 bytes each) and the packed diagonal (32
bytes an element) where it takes it, REDC_MULADDS a butterfly of its
stages and a product an element for the diagonal, the tensor-core digit
products not counted; the constant product its elements read and
written and the constants, a product an element).

The bound of K1 is bytes: a pass reads and writes every element once
(128 bytes an element) against 96 multiply-adds of reduction a product;
the tensor-core products are not counted.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..fields.device import DeviceField, NLIMBS, R as MONT_R, ints_to_digits
from .field_kernels import (MONT_MULADDS, fmul, fmul_plain, fadd_plain,
                            fsub_plain, redc_cols_plain, _dispatch)
from .ntt import NttPlan, make_plan

LAUNCHES = tracing.launch_counters("mxu")

D8 = 2 * NLIMBS          # 32 8-bit digits per element
COLS8 = 2 * D8 - 1       # 63 8-bit product columns
# multiply-adds of K1's reduction a product: 8 rounds of m = t_i n0 and
# m times the modulus's five nonzero limbs, two words each (the digit
# products run on the tensor cores and are not counted)
REDC_MULADDS = 2 * 48


# ---------------------------------------------------------------------------
# band tables (host numpy, equal to the reference's)
# ---------------------------------------------------------------------------

def _bands_from_mont_ints(mont_consts: list[int]) -> np.ndarray:
    """[G, 32, 63] f32 banded matrices (W[g, i, i+j] = c8[g, j]) from
    Montgomery-form constants."""
    buf = b"".join(int(c).to_bytes(D8, "little") for c in mont_consts)
    c8 = np.frombuffer(buf, np.uint8).reshape(-1, D8).astype(np.float32)
    W = np.zeros((c8.shape[0], D8, COLS8), np.float32)
    for i in range(D8):
        W[:, i, i:i + D8] = c8
    return W


def band_matrix(c_mont: int) -> np.ndarray:
    """[32, 63] f32 banded matrix of a constant's Montgomery-form 8-bit
    digits: W[i, i+j] = c8[j]."""
    return _bands_from_mont_ints([c_mont])[0]


def band_matrices(df: DeviceField, consts: list[int]) -> np.ndarray:
    """[G, 32, 63] f32 band matrices for plain-int constants (converted
    to Montgomery form here)."""
    p = df.spec.modulus
    return _bands_from_mont_ints([c * MONT_R % p for c in consts])


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _split8(x: torch.Tensor) -> torch.Tensor:
    """[..., 16] int32 16-bit digits -> [..., 32] float64 8-bit digits
    (little-endian interleave)."""
    x = x.to(torch.int64)
    return torch.stack([x & 0xFF, x >> 8], dim=-1).flatten(-2).to(
        torch.float64)


def _bands(consts: torch.Tensor) -> torch.Tensor:
    """[G, 16] Montgomery digits -> [G, 32, 63] float64 band matrices."""
    c8 = _split8(consts)
    W = torch.zeros((c8.shape[0], D8, COLS8), dtype=torch.float64,
                    device=consts.device)
    for i in range(D8):
        W[:, i, i:i + D8] = c8
    return W


def mul_const_grouped_plain(df: DeviceField, x: torch.Tensor,
                            consts: torch.Tensor) -> torch.Tensor:
    """x [G, nb, 16] times the constant of its group, consts [G, 16]
    (Montgomery digits): the band matmul in float64 (column sums below
    2^22, exact), its 63 byte columns paired into 33 columns of weight
    2^16, then fmul_plain's reduction."""
    p8 = torch.bmm(_split8(x), _bands(consts)).to(torch.int64)
    p8 = torch.nn.functional.pad(p8, (0, 1))                   # 64 cols
    cols = p8[..., 0::2] + (p8[..., 1::2] << 8)                # 32 cols
    return redc_cols_plain(df, torch.nn.functional.pad(cols, (0, 1)))


# ---------------------------------------------------------------------------
# kernel K1
# ---------------------------------------------------------------------------

# stages a K1 pass runs at most: a tile of 2^5 axis positions x 32 lanes
# is 32 KB of limbs, 71 KB with eight warps' staged sums and the pass's
# 31 twiddle bands (three blocks an SM), and an axis of up to 2^10 takes
# two passes
MXU_PASS_LOG = 5
# lanes a tile, log2: a warp's two m16 tiles
MXU_LANES_LOG = 5


def axis_passes(log_n: int, max_log: int = MXU_PASS_LOG) -> tuple:
    """(a, cnt) per pass of a size-2^log_n axis transform, stages a+1 ..
    a+cnt: ceil(log_n / max_log) passes of near equal counts (4 + 4 at
    2^8, so each pass of a 2^16 transform has 128 blocks)."""
    if log_n <= 0:
        return ()
    npass = -(-log_n // max_log)
    size, extra = divmod(log_n, npass)
    out, a = [], 0
    for p in range(npass):
        cnt = size + (p < extra)
        out.append((a, cnt))
        a += cnt
    return tuple(out)


class MxuPass(NamedTuple):
    """One K1 launch: stages a+1 .. a+cnt of the size-2^log_n transforms
    down `axis` (0: the columns, size R; 1: the rows, size C) of the
    [m, R, C] array. Lane q < lanes is column j = q >> lpc_log at
    position l = q & (2^lpc_log - 1) of the other axis; element (i, q) is
    read at j n + i s_ax + l s_ln (i bit-reversed over log_n bits if
    gather) and written at j n + i d_ax + l d_ln, times the diagonal
    twiddle at i d_ax + l d_ln if diag."""
    axis: int
    log_n: int
    a: int
    cnt: int
    lanes: int
    lpc_log: int
    s_ax: int
    s_ln: int
    d_ax: int
    d_ln: int
    gather: bool
    diag: bool


def four_step_passes(m: int, n: int, max_log: int = MXU_PASS_LOG
                     ) -> tuple:
    """The K1 launches of a four-step transform of m columns of n = R C:
    the column axis (lanes (j, c), contiguous) gathers in its first pass
    and takes the diagonal twiddles in its last; the row axis (lanes
    (j, r), C apart) gathers in its first and its last writes
    out[j, k_c R + k_r]."""
    k = n.bit_length() - 1
    lr = (k + 1) // 2
    lc = k - lr
    R, C = 1 << lr, 1 << lc
    out = []
    cols = axis_passes(lr, max_log)
    for i, (a, cnt) in enumerate(cols):
        out.append(MxuPass(0, lr, a, cnt, m * C, lc, C, 1, C, 1, a == 0,
                           i == len(cols) - 1))
    rows = axis_passes(lc, max_log)
    for i, (a, cnt) in enumerate(rows):
        last = i == len(rows) - 1
        out.append(MxuPass(1, lc, a, cnt, m * R, lr, 1, C,
                           R if last else 1, 1 if last else C, a == 0,
                           False))
    return tuple(out)


def mul_const_grouped(df: DeviceField, x: torch.Tensor,
                      consts: torch.Tensor) -> torch.Tensor:
    """x [G, nb, 16] Montgomery digits times consts [G, 16] (Montgomery
    digits), group by group: bit-identical to fmul against the broadcast
    constants. Kernel K1 on CUDA (one launch), the plain version on the
    CPU."""
    for t in (x, consts):
        if t.dtype != torch.int32 or t.shape[-1:] != (NLIMBS,):
            raise TypeError(f"field tensors are int32 [..., 16], got "
                            f"{t.dtype} {tuple(t.shape)}")
    if x.dim() != 3 or consts.shape != (x.shape[0], NLIMBS):
        raise ValueError(f"x [G, nb, 16] and consts [G, 16], got "
                         f"{tuple(x.shape)} and {tuple(consts.shape)}")
    if x.device != consts.device:
        raise ValueError(f"operands on {x.device} and {consts.device}")
    if not _dispatch(x):
        return mul_const_grouped_plain(df, x, consts)
    x, consts = x.contiguous(), consts.contiguous()
    out = torch.empty_like(x)
    G, nb = x.shape[0], x.shape[1]
    if G == 0 or nb == 0:
        return out
    from . import cuda_build
    lib = cuda_build.library("mxu_kernels")
    rc = lib.h2t_mxu_const_mul(df.field_id, out.data_ptr(), x.data_ptr(),
                               consts.data_ptr(), G, nb,
                               cuda_build.stream_ptr(x.device))
    cuda_build.check(rc, "h2t_mxu_const_mul")
    tracing.launch("mxu", G * nb, (2 * G * nb + G) * NLIMBS * 4,
                   G * nb * MONT_MULADDS)
    return out


# ---------------------------------------------------------------------------
# the four-step NTT
# ---------------------------------------------------------------------------
#
# n = R C with R = 2^ceil(k/2):
#   B[k_r, c]   = size-R NTT down axis 0 (root w^C)
#   Bt[k_r, c]  = B * w^(k_r c)          (the diagonal twiddles)
#   E[k_c, k_r] = size-C NTT of Bt^T down axis 0 (root w^R)
#   out[k_r + R k_c] = E[k_c, k_r]       (row-major flatten of E)
# Each stage of either axis NTT multiplies one twiddle across all of the
# other axis, so a group has at least sqrt(n) / 2 lanes.

_MXU4_CACHE: dict = {}


class _Mxu4Plan:
    """Host tables of a size-n four-step transform with root omega: R, C,
    the two axis plans (ops/ntt.py plans). `on(device)` gives the device
    tables, made once a device: each axis' bit-reversal perm, stage
    twiddles (the plain version's) and packed twiddle table ([N - 1, 8]
    32-bit limbs, K1's), and the diagonal twiddles w^(k_r c) as [n, 16]
    Montgomery digits and as [n, 8] packed limbs."""

    def __init__(self, df: DeviceField, n: int, omega: int):
        p = df.spec.modulus
        k = n.bit_length() - 1
        self.df = df
        self.n = n
        self.omega = omega
        self.R = 1 << ((k + 1) // 2)
        self.C = n // self.R
        self.col_plan = make_plan(df, self.R, pow(omega, self.C, p))
        self.row_plan = make_plan(df, self.C, pow(omega, self.R, p))
        self._dev: dict = {}

    def on(self, device) -> dict:
        device = torch.device(device)
        ent = self._dev.get(device)
        if ent is None:
            col, row = self.col_plan.on(device), self.row_plan.on(device)
            diag = self._diag(device)
            d = diag.to(torch.int64)
            w = d[:, 0::2] | (d[:, 1::2] << 16)
            ent = self._dev[device] = {
                "col_perm": col[0], "row_perm": row[0],
                "col_tw": col[2], "row_tw": row[2],
                "col_packed": col[3], "row_packed": row[3],
                "diag": diag,
                "diag_packed": (w - ((w >> 31) << 32)).to(
                    torch.int32).contiguous()}
        return ent

    def _diag(self, device) -> torch.Tensor:
        """T[k_r, c] = w^(k_r c) as [n, 16] Montgomery digits, by
        doubling: rows 2^i .. 2^(i+1) - 1 are rows 0 .. 2^i - 1 times
        w^(2^i c), one field product a doubling."""
        df, p = self.df, self.df.spec.modulus
        R, C = self.R, self.C
        rows = tracing.upload("mxu_plan", torch.from_numpy(
            ints_to_digits([MONT_R % p] * C)), device).view(1, C, NLIMBS)
        step = self.omega
        while rows.shape[0] < R:
            acc, vals = MONT_R % p, []
            for _ in range(C):
                vals.append(acc)
                acc = acc * step % p
            v = tracing.upload("mxu_plan", torch.from_numpy(
                ints_to_digits(vals)), device)
            rows = torch.cat([rows, fmul(df, rows, v)], dim=0)
            step = step * step % p
        return rows.reshape(self.n, NLIMBS)


def _mxu4_plan(df: DeviceField, plan: NttPlan) -> _Mxu4Plan:
    key = id(plan)
    ent = _MXU4_CACHE.get(key)
    if ent is None or ent[0] is not plan:
        ent = _MXU4_CACHE[key] = (plan, _Mxu4Plan(df, plan.n, plan.omega))
    return ent[1]


def _axis0_ntt_plain(df: DeviceField, x: torch.Tensor, perm: torch.Tensor,
                     stages: tuple) -> torch.Tensor:
    """Size-N NTT down axis 0 of x [N, L, 16] with the plain versions: the
    bit-reversal gather, then per stage the butterflies, twiddle j shared
    by the (N/m) L lanes of every block's position j."""
    N, L = x.shape[0], x.shape[1]
    x = x.index_select(0, perm)
    for s, tw in enumerate(stages, start=1):
        m = 1 << s
        half = m // 2
        xr = x.view(N // m, m, L, NLIMBS)
        lo, hi = xr[:, :half], xr[:, half:]
        hi_g = hi.transpose(0, 1).reshape(half, (N // m) * L, NLIMBS)
        t = mul_const_grouped_plain(df, hi_g, tw)
        t = t.view(half, N // m, L, NLIMBS).transpose(0, 1)
        x = torch.cat([fadd_plain(df, lo, t), fsub_plain(df, lo, t)],
                      dim=1).reshape(N, L, NLIMBS)
    return x


def _checked(x: torch.Tensor, plan: NttPlan) -> tuple:
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[2] != NLIMBS:
        raise TypeError(f"ntt_mxu_b takes int32 [m, n, 16], got {x.dtype} "
                        f"{tuple(x.shape)}")
    m, n = x.shape[0], x.shape[1]
    if n != plan.n:
        raise ValueError(f"plan of size {plan.n} for columns of {n}")
    return m, n


def ntt_mxu_b_plain(df: DeviceField, x: torch.Tensor, plan: NttPlan
                    ) -> torch.Tensor:
    """The four-step one stage at a time with the plain versions, on any
    device (its tables, the diagonal twiddles among them, made as
    ntt_mxu_b makes them): K1's CPU path and its oracle on the card."""
    m, n = _checked(x, plan)
    if m == 0 or n == 1:
        return x.clone()
    p4 = _mxu4_plan(df, plan)
    R, C = p4.R, p4.C
    t = p4.on(x.device)
    # [m, R, C] -> [R, m C]: R leading, the m columns side by side
    A = x.reshape(m, R, C, NLIMBS).transpose(0, 1).reshape(R, m * C, NLIMBS)
    B = _axis0_ntt_plain(df, A, t["col_perm"], t["col_tw"])
    B = B.view(R, m, C, NLIMBS).transpose(0, 1).reshape(m, n, NLIMBS)
    Bt = fmul_plain(df, B, t["diag"])
    # [m, R, C] -> [C, m R]
    D = Bt.view(m, R, C, NLIMBS).permute(2, 0, 1, 3).reshape(C, m * R,
                                                             NLIMBS)
    E = _axis0_ntt_plain(df, D, t["row_perm"], t["row_tw"])
    # out[j, k_r + R k_c] = E[k_c, j, k_r]
    return E.view(C, m, R, NLIMBS).transpose(0, 1).reshape(m, n, NLIMBS)


def run_passes(df: DeviceField, x: torch.Tensor, plan: NttPlan,
               passes: tuple) -> torch.Tensor:
    """K1's launches `passes` (four_step_passes) over x [m, n, 16] on
    CUDA, through two buffers in turn (a pass reads one and writes the
    other; x is not written); the last written is returned."""
    from . import cuda_build
    m, n = x.shape[0], x.shape[1]
    t = _mxu4_plan(df, plan).on(x.device)
    lib = cuda_build.library("mxu_kernels")
    stream = cuda_build.stream_ptr(x.device)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    src = x.contiguous()
    for i, ps in enumerate(passes):
        dst = bufs[i % 2]
        tw = t["row_packed" if ps.axis else "col_packed"]
        rc = lib.h2t_mxu_pass(
            df.field_id, dst.data_ptr(), src.data_ptr(), tw.data_ptr(),
            t["diag_packed"].data_ptr() if ps.diag else None, ps.lanes,
            ps.lpc_log, n, ps.log_n, ps.a, ps.cnt, MXU_LANES_LOG, ps.s_ax,
            ps.s_ln, ps.d_ax, ps.d_ln, int(ps.gather), stream)
        cuda_build.check(rc, "h2t_mxu_pass")
        tracing.launch(
            "mxu", m * n,
            2 * m * n * NLIMBS * 4 + (((1 << ps.cnt) - 1) << ps.a) * 32
            + (n * 32 if ps.diag else 0),
            m * (n // 2) * ps.cnt * REDC_MULADDS
            + (m * n * MONT_MULADDS if ps.diag else 0))
        src = dst
    return src


def ntt_mxu_b(df: DeviceField, x: torch.Tensor, plan: NttPlan
              ) -> torch.Tensor:
    """Forward NTT of [m, n, 16] int32 Montgomery digits along axis 1
    through the four-step (the m columns widen every stage's lanes):
    bit-identical to ops/ntt.py's ntt_many with the same plan. K1 on
    CUDA, one launch a pass of four_step_passes (four from 2^12 to 2^20)
    and nothing else; the plain version on the CPU."""
    m, n = _checked(x, plan)
    if not _dispatch(x):
        return ntt_mxu_b_plain(df, x, plan)
    if m == 0 or n == 1:
        return x.clone()
    return run_passes(df, x, plan, four_step_passes(m, n))


def ntt_mxu(df: DeviceField, a: torch.Tensor, plan: NttPlan
            ) -> torch.Tensor:
    """Forward NTT of [n, 16] through the four-step (ntt_mxu_b of one
    column)."""
    return ntt_mxu_b(df, a.unsqueeze(0), plan)[0]
