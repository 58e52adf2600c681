#!/usr/bin/env python3
"""Time build variants of the redesigned kernels on one NVIDIA GPU, each
beside the source as it is, in one process.

Copies of csrc/ are patched and built side by side under the gitignored
halo2_tpu_torch/_build/variants/:

  the GLV ladder (csrc/point_kernels.cu::glv_ladder_*kernel), one IPA fold
  round's 130 random bit pairs on tables of random PALLAS points, at
  GLV_WIDTHS lanes (1, 2 and the halves of the device fold rounds, 2^10 to
  2^17) and the sweep GLV_SWEEP between 2^14 and 2^17:
    lane, group
               the source's forms (h2t_glv_ladder_form): one thread a lane,
               one lane a group of four threads (coop_double, coop_add)
    group_inline
               the group form with its products inlined (GLV_INLINE)
  the bucket-run kernel (pmixed_bucket_runs_*kernel), a whole commit's
  bucket phase on m columns of random scalars over 2^k PALLAS bases (2^14
  native SRS points, repeated past 2^14) at BUCKET_COMMITS (one K = 11
  column, 7,424 lanes, to two k = 18 columns, 163,840) and the sweep
  BUCKET_SWEEP between them:
    lane, group
               the source's forms (h2t_pmixed_bucket_runs_form) on the
               lanes sorted by run length, longest first, as the wrapper
               sorts them (the argsort timed apart)
    group_prefetch
               the group form loading the next member and its base word
               before the current add (BUCKET_PREFETCH)
    lane_unsorted, group_unsorted
               the source's forms on the lanes in order
  B7 (csrc/ntt_kernels.cu), forward on the PALLAS scalar field, per
  transform at 2^10, 2^16 and 2^20 with 1 and 4 columns:
    pass       the source: two passes (one up to 2^10)
    pass_cc    with the carry-chain product
    stagewise  the kernel of an older checkout given as the argument (its
               halo2_tpu_torch/csrc/ntt_kernels.cu with the entry h2t_ntt:
               the bit-reversal gather and the first ten stages in shared
               memory, then one launch per stage)
  B4 (padd_kernel) at 8,192 and 2^17 lanes, and the scalar-multiplication
  ladder (scalar_mul_ladder_kernel) at a group-NTT stage of k = 14 and
  k = 18 (2^13 and 2^17 lanes, 255 bits, a twiddle table of half the
  lanes, the butterfly fused), PALLAS base field:
    group      the source: one lane a group of four threads (coop_add,
               coop_double)
    lane       one thread a lane, the forms the group replaced (LANE_FORMS,
               built beside the source as padd_lane_kernel and
               scalar_mul_ladder_lane_kernel)
    select     the ladder's add computed on every step and kept by a
               select, so that a warp never diverges
    inline     the ladder's products inlined rather than called
    window     the ladder with a fixed 4-bit window (WINDOW_FORM): about
               64 adds a lane instead of about 255, other projective values
    sums1      B4 and the ladder with coop_add's sums between its stages on
               rank 0 alone, their results shuffled (SUMS_ON_RANK0)
  B5 and B6 (pdouble_*_kernel) at 1, 2, 8,192, 2^17 and 2^20 lanes and a
  sweep of widths between them (DOUBLE_WIDTHS, DOUBLE_SWEEP), B6 with a
  random half of its lanes live (and all or none at DOUBLE_WIDTHS),
  PALLAS base field:
    lane, group
               the source's forms (h2t_pdouble_form): one thread a lane,
               one lane a group of four (coop_double); B6 doubles every
               lane and keeps a masked-off lane's input by a select
    fixed      one thread a lane in fixed blocks of 128 threads, the form
               both had before the group (PDOUBLE_FIXED)
    pair       one lane a pair of threads (PAIR_FORM: pair_double, Alg 9's
               stages two products a rank)
    *_branch   B6 in each form with a branch of each lane (group) to a copy
               of its rows before any load where the mask is 0, as the
               fixed form does (PDOUBLE_BRANCH), in place of the source's
               select
    *_vote     a warp whose lanes are all masked off writes its loads back
               and skips the doubling (__any_sync after the loads;
               PDOUBLE_VOTE)
    *_vote_early
               the same vote before the loads, such a warp copying its rows
               (PDOUBLE_VOTE_EARLY)
    lane_lb5, lane_lb6, lane_lb8
               the one-thread form with __launch_bounds__(128, n), n blocks
               resident an SM, its registers capped to fit them
  and chip_smoke.py's [horner] combine of two lanes (c B5 and one B4
  launch a window) with B5 in the fixed form and in the form h2t_pdouble
  picks. With --json PATH, every number of the glv, bucket and double
  groups also goes to a JSON file, keyed by group.

  B2 (pmixed_masked_*kernel) at B2_WIDTHS (1, 1,024, 8,192, 26,624, a
  k = 17 column, 2^17, k = 18 columns) and the sweep B2_SWEEP that places
  kPmixedLaneFrom, a random 80% of the lanes live, PALLAS base field:
    lane, group
               the source's forms (h2t_pmixed_masked_form): one thread a
               lane, one lane a group of four threads (coop_add with
               Z2 = mont 1)
    fixed      one thread a lane in fixed blocks of 128 threads
               (PMIXED_FIXED)
    parent     an older checkout's h2t_pmixed_masked, given as the argument

  K1's four-step NTT (csrc/mxu_kernels.cu), forward on the PALLAS scalar
  field, a transform at 2^16, 2^17 and 2^20 with 1 and 4 columns:
    S<s>_L<l>  the source's pass kernel in passes of at most s = 3..6
               stages on tiles of l = 32 or 64 lanes (S5_L32 the source's
               plan)
    batch2, batch8, warps4, lb3
               builds of the pass kernel in the source's plan
               (MXU_PATCHES)
    stagewise  the four-step of an older checkout given as the argument
               (its csrc/mxu_kernels.cu: one K1 launch a stage, the gathers
               and transposes as copies, the diagonal twiddles one B1)
  K2 (csrc/gate_kernels.cu) on Table16's gate set at 2^20 rows, the whole
  set as one chunk (60 slots) and in 400-node chunks (at most 21):
    local      the source: the slot file in local memory, the previous
               result in registers where the tape's flags say so
    grid, grid_lb8, rows2, local_cc
               the source with the grid sized to the blocks that fit at
               once, also with 64 registers, two rows a thread, and its
               products as MONT_MUL_CC (GATE_GRID, GATE_LB8,
               GATE_ROWS2_LOOP; on su tapes with the flags)
    shared     the slot file in shared memory, [slot][limb][thread]
               (GATE_SHARED), as many threads a block as leave room for two
               blocks an SM
    local_old  an older checkout's kernel (the slot file in local memory,
               no flags)
    each on tapes in evaluation order (eval) or compile_chunk's
    Sethi-Ullman order (su), with the register flags or without; LDL and
    STL counted in each build's SASS.

Every variant's output must equal the source's bit for bit (B7's, B2's,
B5's, B6's, the GLV ladder's and the bucket-run kernel's also the plain
version's). Each is timed from a CUDA graph (and, but for the GLV ladder
and the bucket-run kernel, by torch.profiler: chip_smoke.py's graph_ms and
device_ms); per variant the timed kernel's registers (nvcc -Xptxas -v)
and SASS instructions (cuobjdump -sass).

Run from the repository root (--only runs one of the eight groups):
    python3 redesign_variants.py [--only glv|bucket|ntt|points|double|
                                         b2|mxu|gate] [--json PATH]
                                 [OLD_CHECKOUT]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "halo2_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "halo2_tpu_torch", "_build", "variants")

# the Montgomery product with its carries in PTX carry chains: each CIOS
# row adds a b_i as one chain of low halves and one of high halves, then
# m p with m = -t_0 (N0 = -1, p_0 = 1) over p's nonzero limbs 1-3 and 7;
# fully reduced, so it equals mont_mul bit for bit
MONT_MUL_CC = r'''template <int F>
__device__ __forceinline__ void mont_mul_cc(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0,
           t8 = 0, t9 = 0;
  const uint32_t p1 = Field<F>::p(1), p2 = Field<F>::p(2),
                 p3 = Field<F>::p(3), p7 = Field<F>::p(7);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    // t += a b_i
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(b[i]));
    // t += m p, m = -t_0 mod 2^32, so that t_0 becomes 0
    const uint32_t m = 0u - t0;
    asm("add.cc.u32 %0, %0, %10;\n\t"
        "madc.lo.cc.u32 %1, %10, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %13, %3;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "madc.lo.cc.u32 %7, %10, %14, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %2, %10, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %10, %13, %4;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "madc.hi.cc.u32 %8, %10, %14, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(m), "r"(p1), "r"(p2), "r"(p3), "r"(p7));
    // shift down a limb (t_0 is 0)
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8;
    t8 = t9; t9 = 0;
  }
  uint32_t t[8] = {t0, t1, t2, t3, t4, t5, t6, t7}, d[8], p[8];
  load_p<F>(p);
  uint32_t br = sub_raw(d, t, p);
  bool use_d = (t8 != 0) | (br == 0);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = use_d ? d[i] : t[i];
}
'''

# the GLV ladder's group form with its step's products inlined
GLV_INLINE = (
    ("    coop_double<F, true>(acc, acc, r, gm);\n"
     "    const uint32_t b = s & 31;\n",
     "    coop_double<F, false>(acc, acc, r, gm);\n"
     "    const uint32_t b = s & 31;\n"),
    ("    coop_add<F, true>(acc, acc, a1, b0, b1, r, gm);\n  }\n"
     "  if (r < 3) store_rows(out + row, L, acc);\n",
     "    coop_add<F, false>(acc, acc, a1, b0, b1, r, gm);\n  }\n"
     "  if (r < 3) store_rows(out + row, L, acc);\n"))

# the bucket-run kernel's group form with a prefetch: the next member and
# its base word loaded before the current add, so that the add's latency
# hides theirs
BUCKET_PREFETCH = ((
    """#pragma unroll 1
  for (int32_t k = 0; k < cnt; k++) {
    const int32_t m = run[k];
    const uint4 q = bases[(size_t)(m & 0x7fffffff) * 4 + r];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
""", """  int32_t mn = 0;
  uint4 qn = make_uint4(0u, 0u, 0u, 0u);
  if (cnt > 0) {
    mn = run[0];
    qn = bases[(size_t)(mn & 0x7fffffff) * 4 + r];
  }
#pragma unroll 1
  for (int32_t k = 0; k < cnt; k++) {
    const int32_t m = mn;
    const uint32_t w[4] = {qn.x, qn.y, qn.z, qn.w};
    if (k + 1 < cnt) {
      mn = run[k + 1];
      qn = bases[(size_t)(mn & 0x7fffffff) * 4 + r];
    }
"""),)


# B4 and the scalar-multiplication ladder one thread a lane, as they were
# before the group of four threads replaced them
LANE_FORMS = r'''
template <int F>
__global__ void padd_lane_kernel(int32_t* __restrict__ out,
                                 const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b, uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  Pt p, q, r;
  load_pt(p, a + l, L);
  load_pt(q, b + l, L);
  rcb_add<F>(r, p, q);
  store_pt(out + l, L, r);
}

template <int F>
__global__ void __launch_bounds__(kMaxThreads)
scalar_mul_ladder_lane_kernel(int32_t* __restrict__ out,
                              int32_t* __restrict__ out2,
                              const int32_t* __restrict__ pts,
                              const int32_t* __restrict__ digits,
                              const int32_t* __restrict__ lo, uint32_t T,
                              uint32_t nbits, uint32_t L) {
  extern __shared__ uint32_t tab[];
  const uint32_t tid = threadIdx.x, bd = blockDim.x;
  const uint32_t l = blockIdx.x * bd + tid;
  if (l >= L) return;
  {
    Pt q;
    load_pt(q, pts + l, L);
#pragma unroll
    for (int i = 0; i < 8; i++) {
      tab[i * bd + tid] = q.x[i];
      tab[(8 + i) * bd + tid] = q.y[i];
      tab[(16 + i) * bd + tid] = q.z[i];
    }
  }
  const int32_t* d = digits + (size_t)(l % T) * 16;
  Pt acc, r;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc.x[i] = 0;
    acc.y[i] = Field<F>::one(i);
    acc.z[i] = 0;
  }
  uint32_t word = 0;
#pragma unroll 1
  for (int s = (int)nbits - 1; s >= 0; s--) {
    if (s == (int)nbits - 1 || (s & 31) == 31) {
      const int w = s >> 5;
      word = ((uint32_t)d[2 * w] & 0xFFFFu) |
             (((uint32_t)d[2 * w + 1] & 0xFFFFu) << 16);
    }
    rcb_double<F, true>(r, acc);
    if (((word >> (s & 31)) & 1u) == 0) {
      acc = r;
      continue;
    }
    Pt q;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      q.x[i] = tab[i * bd + tid];
      q.y[i] = tab[(8 + i) * bd + tid];
      q.z[i] = tab[(16 + i) * bd + tid];
    }
    rcb_add<F, true>(acc, r, q);
  }
  if (lo == nullptr) {
    store_pt(out + l, L, acc);
    return;
  }
  Pt a;
  load_pt(a, lo + l, L);
  rcb_add<F, true>(r, a, acc);
  store_pt(out + l, L, r);
  neg_in_place<F>(acc.y);
  rcb_add<F, true>(r, a, acc);
  store_pt(out2 + l, L, r);
}

extern "C" int h2t_padd_lane(int field, void* out, const void* a,
                             const void* b, long long L, void* stream) {
  return launch_lanes(field, padd_lane_kernel<0>, padd_lane_kernel<1>, L,
                      stream, (int32_t*)out, (const int32_t*)a,
                      (const int32_t*)b, (uint32_t)L);
}

extern "C" int h2t_scalar_mul_ladder_lane(int field, void* out, void* out2,
                                          const void* pts,
                                          const void* digits, const void* lo,
                                          long long T, int nbits, long long L,
                                          void* stream) {
  if (L <= 0) return 0;
  const int threads = spread_threads(L);
  dim3 grid((unsigned)((L + threads - 1) / threads));
  const size_t shmem = (size_t)24 * sizeof(uint32_t) * threads;
  auto kern = field ? scalar_mul_ladder_lane_kernel<1>
                    : scalar_mul_ladder_lane_kernel<0>;
  kern<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)out, (int32_t*)out2, (const int32_t*)pts,
      (const int32_t*)digits, (const int32_t*)lo, (uint32_t)T,
      (uint32_t)nbits, (uint32_t)L);
  return (int)cudaGetLastError();
}
'''

# the scalar ladder with a fixed 4-bit window, on the group's coop_add and
# coop_double: a table of jP (j = 1..15) a group in shared memory (15
# points of 25 words), then per window four doublings and, where its digit
# is not 0, one add of the digit's table point. The same points as the bit
# ladder, in other projective coordinates.
WINDOW_FORM = r'''
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
scalar_mul_ladder_window_kernel(int32_t* __restrict__ out,
                                int32_t* __restrict__ out2,
                                const int32_t* __restrict__ pts,
                                const int32_t* __restrict__ digits,
                                const int32_t* __restrict__ lo, uint32_t T,
                                uint32_t nbits, uint32_t L) {
  extern __shared__ uint32_t tab[];
  const uint32_t g = threadIdx.x / kGroup;
  const uint32_t l = blockIdx.x * (blockDim.x / kGroup) + g;
  if (l >= L) return;
  const int r = threadIdx.x % kGroup;
  const unsigned gm = group_mask();
  const int c = r == 3 ? 0 : r, cn = nib(kNext, r);
  const size_t row = (size_t)16 * c * L + l;
  uint32_t* W = tab + 375 * g;
  uint32_t p0[8], p1[8], acc[8], a1[8], b0[8], b1[8];
  load_rows(p0, pts + row, L);
  shfl8(p1, p0, cn, gm);
#pragma unroll
  for (int i = 0; i < 8; i++) acc[i] = p0[i];
#pragma unroll 1
  for (int j = 1; j <= 15; j++) {
    if (r < 3) {
#pragma unroll
      for (int i = 0; i < 8; i++) W[(j - 1) * 25 + 8 * r + i] = acc[i];
    }
    if (j == 15) break;
    if (j == 1) {
      coop_double<F, true>(acc, acc, r, gm);
    } else {
      shfl8(a1, acc, cn, gm);
      coop_add<F, true>(acc, acc, a1, p0, p1, r, gm);
    }
  }
  __syncwarp(gm);
#pragma unroll
  for (int i = 0; i < 8; i++) acc[i] = c == 1 ? Field<F>::one(i) : 0u;
  const int32_t* d = digits + (size_t)(l % T) * 16;
  const int nwin = ((int)nbits + 3) / 4;
#pragma unroll 1
  for (int w = nwin - 1; w >= 0; w--) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) coop_double<F, true>(acc, acc, r, gm);
    uint32_t dig = ((uint32_t)d[w >> 2] >> (4 * (w & 3))) & 15u;
    if (4 * w + 4 > (int)nbits) dig &= (1u << (nbits - 4 * w)) - 1u;
    if (dig == 0) continue;
    shfl8(a1, acc, cn, gm);
    const uint32_t* e = W + (dig - 1) * 25;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      b0[i] = e[8 * c + i];
      b1[i] = e[8 * cn + i];
    }
    coop_add<F, true>(acc, acc, a1, b0, b1, r, gm);
  }
  if (lo == nullptr) {
    if (r < 3) store_rows(out + row, L, acc);
    return;
  }
  uint32_t a0[8], o[8];
  load_rows(a0, lo + row, L);
  shfl8(a1, a0, cn, gm);
  shfl8(b1, acc, cn, gm);
  coop_add<F, true>(o, a0, a1, acc, b1, r, gm);
  if (r < 3) store_rows(out + row, L, o);
  if (c == 1) neg_in_place<F>(acc);
  shfl8(b1, acc, cn, gm);
  coop_add<F, true>(o, a0, a1, acc, b1, r, gm);
  if (r < 3) store_rows(out2 + row, L, o);
}

extern "C" int h2t_scalar_mul_ladder_window(int field, void* out, void* out2,
                                            const void* pts,
                                            const void* digits,
                                            const void* lo, long long T,
                                            int nbits, long long L,
                                            void* stream) {
  if (L <= 0) return 0;
  const long long n = L * kGroup;
  const int threads = spread_threads(n);
  dim3 grid((unsigned)((n + threads - 1) / threads));
  const size_t shmem = (size_t)375 * sizeof(uint32_t) * (threads / kGroup);
  auto kern = field ? scalar_mul_ladder_window_kernel<1>
                    : scalar_mul_ladder_window_kernel<0>;
  kern<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)out, (int32_t*)out2, (const int32_t*)pts,
      (const int32_t*)digits, (const int32_t*)lo, (uint32_t)T,
      (uint32_t)nbits, (uint32_t)L);
  return (int)cudaGetLastError();
}
'''

# coop_add with the sums between its stages on rank 0 alone: the six
# stage-1 products gathered to every rank, the sums of rcb_add computed in
# a branch of rank 0, and the six stage-2 operands shuffled from it (the
# source runs the sums on every rank, each on its own values); it replaces
# the text between these two lines of the source
SUMS_FROM = "  uint32_t tn[8], d[8], g3[8], f[8], z[8], s[8];\n"
SUMS_TO = "  // X3 = s1 t3 - t4 y3"
SUMS_ON_RANK0 = r'''  uint32_t t0[8], t1[8], t2[8], m3[8], m4[8], m5[8];
  shfl8(t0, t, 0, gm);
  shfl8(t1, t, 1, gm);
  shfl8(t2, t, 2, gm);
  shfl8(m3, m, 0, gm);
  shfl8(m4, m, 1, gm);
  shfl8(m5, m, 2, gm);
  uint32_t t3[8] = {0}, t4[8] = {0}, xz[8], s0[8] = {0}, b3z[8],
           z3[8] = {0}, s1[8] = {0}, y3[8] = {0};
  if (r == 0) {
    sub<F>(t3, m3, t0);
    sub<F>(t3, t3, t1);
    sub<F>(t4, m4, t1);
    sub<F>(t4, t4, t2);
    sub<F>(xz, m5, t0);
    sub<F>(xz, xz, t2);
    add<F>(s0, t0, t0);
    add<F>(s0, s0, t0);
    mul15<F>(b3z, t2);
    add<F>(z3, t1, b3z);
    sub<F>(s1, t1, b3z);
    mul15<F>(y3, xz);
  }
  shfl8(t3, t3, 0, gm);
  shfl8(t4, t4, 0, gm);
  shfl8(s0, s0, 0, gm);
  shfl8(s1, s1, 0, gm);
  shfl8(z3, z3, 0, gm);
  shfl8(y3, y3, 0, gm);
  select3(u, q, t4, y3, t4);
  select3(v, q, y3, s0, z3);
  pmul<F, CALL>(m, u, v);
  select3(u, q, s1, s1, t3);
  select3(v, q, t3, z3, s0);
  pmul<F, CALL>(t, u, v);
'''


# B5 and B6 as they were before the group: one thread a lane in fixed
# blocks of kMaxThreads (launch_lanes), no launch bounds
PDOUBLE_FIXED = r'''
template <int F, bool MASKED>
__global__ void pdouble_fixed_kernel(int32_t* __restrict__ out,
                                   const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ mask,
                                   uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  if (MASKED && mask[l] == 0) {
    copy_rows(out + l, a + l, L, 48);
    return;
  }
  Pt p, r;
  load_pt(p, a + l, L);
  rcb_double<F>(r, p);
  store_pt(out + l, L, r);
}

extern "C" int h2t_pdouble_fixed(int threads, int field, void* out,
                               const void* a, const void* mask, long long L,
                               void* stream) {
  if (mask == nullptr)
    return launch_lanes(field, pdouble_fixed_kernel<0, false>,
                        pdouble_fixed_kernel<1, false>, L, stream,
                        (int32_t*)out, (const int32_t*)a,
                        (const int32_t*)mask, (uint32_t)L);
  return launch_lanes(field, pdouble_fixed_kernel<0, true>,
                      pdouble_fixed_kernel<1, true>, L, stream, (int32_t*)out,
                      (const int32_t*)a, (const int32_t*)mask, (uint32_t)L);
}
'''

# B5 and B6 one lane a pair of threads: rank r (thread index % kPair) holds
# coordinates r and r + 1 of the point (X, Y at rank 0; Y, Z at rank 1),
# and every shuffle reads the other rank (kPairOther). Alg 9's two stages
# of four independent products run two a rank, the dependent chain 4
# products; both ranks hold Y3. B6 as in the source's forms.
PAIR_FORM = r"""
static constexpr int kPair = 2;
static constexpr uint32_t kPairOther = 0x01;

__device__ __forceinline__ unsigned pair_mask() {
  return 0x3u << (threadIdx.x & 31u & ~(unsigned)(kPair - 1));
}

__device__ __forceinline__ void shfl8_pair(uint32_t o[8], const uint32_t v[8],
                                           int src, unsigned pm) {
#pragma unroll
  for (int i = 0; i < 8; i++) o[i] = __shfl_sync(pm, v[i], src, kPair);
}

// c0 and c1 hold coordinates r and r + 1 of A; o0 and o1 get those of 2A
template <int F>
__device__ __forceinline__ void pair_double(uint32_t o0[8], uint32_t o1[8],
                                            const uint32_t c0[8],
                                            const uint32_t c1[8], int r,
                                            unsigned pm) {
  const int other = nib(kPairOther, r);
  uint32_t p0[8], p1[8], q[8];
  mont_mul<F>(p0, c0, c1);          // XY at rank 0, t1 = YZ at rank 1
  mont_mul<F>(p1, c1, c1);          // Y^2 at rank 0, Z^2 at rank 1
  shfl8_pair(q, p1, other, pm);
  uint32_t ysq[8], u[8], z3[8], t2[8], y3[8], t0[8];
  select(ysq, r == 0, p1, q);
  select(u, r == 0, q, p1);         // Z^2
  add<F>(z3, ysq, ysq);
  add<F>(z3, z3, z3);
  add<F>(z3, z3, z3);               // 8 Y^2
  mul15<F>(t2, u);                  // b3 Z^2
  add<F>(y3, ysq, t2);
  add<F>(u, t2, t2);
  add<F>(u, u, t2);
  sub<F>(t0, ysq, u);               // Y^2 - 3 b3 Z^2
  // stage 2: t0 xy and t0 y3 at rank 0, t1 z3 (= Z3) and t2 z3 at rank 1
  uint32_t a[8], b[8], e1[8], e2[8];
  select(a, r == 0, t0, p0);
  select(b, r == 0, p0, z3);
  mont_mul<F>(e1, a, b);
  select(a, r == 0, t0, t2);
  select(b, r == 0, y3, z3);
  mont_mul<F>(e2, a, b);
  shfl8_pair(q, e2, other, pm);
  add<F>(u, e2, q);                 // Y3 = t0 y3 + t2 z3 on both ranks
  add<F>(a, e1, e1);                // X3 = 2 t0 xy at rank 0
  select(o0, r == 0, a, u);
  select(o1, r == 0, u, e1);
}

// rank r reads and writes coordinate r, and rank 1 coordinate 2 too
template <int F, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
pdouble_pair_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                    const int32_t* __restrict__ mask, uint32_t L) {
  const uint32_t l = (blockIdx.x * blockDim.x + threadIdx.x) / kPair;
  if (l >= L) return;
  const int r = threadIdx.x % kPair;
  const size_t row = (size_t)16 * r * L + l, next = row + (size_t)16 * L;
  uint32_t c0[8], c1[8], d0[8], d1[8];
  load_rows(c0, a + row, L);
  load_rows(c1, a + next, L);
  const bool live = !MASKED || mask[l] != 0;
  pair_double<F>(d0, d1, c0, c1, r, pair_mask());
  select(d0, live, d0, c0);
  select(d1, live, d1, c1);
  store_rows(out + row, L, d0);
  if (r == 1) store_rows(out + next, L, d1);
}

extern "C" int h2t_pdouble_pair(int threads, int field, void* out,
                                const void* a, const void* mask, long long L,
                                void* stream) {
  if (L <= 0) return 0;
  typedef void (*Kern)(int32_t*, const int32_t*, const int32_t*, uint32_t);
  static const Kern kerns[2][2] = {
      {pdouble_pair_kernel<0, false>, pdouble_pair_kernel<0, true>},
      {pdouble_pair_kernel<1, false>, pdouble_pair_kernel<1, true>}};
  const long long n = L * kPair;
  const int block = spread_threads(n);
  dim3 grid((unsigned)((n + block - 1) / block));
  kerns[field != 0][mask != nullptr]<<<grid, block, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)mask, (uint32_t)L);
  return (int)cudaGetLastError();
}
"""

# B6 in the source's forms with their masked-off lanes (the source doubles
# every lane and selects) handled three other ways, each a patch of the
# lane kernel and one of the group kernel:
_LANE_BODY = ("  Pt p, r;\n"
              "  load_pt(p, a + l, L);\n"
              "  const bool live = !MASKED || mask[l] != 0;\n"
              "  rcb_double<F>(r, p);\n"
              "  if (!live) r = p;\n")
_GROUP_BODY = ("  uint32_t c[8], d[8];\n"
               "  load_rows(c, a + row, L);\n"
               "  const bool live = !MASKED || mask[l] != 0;\n"
               "  coop_double<F, false>(d, c, r, group_mask());\n"
               "  select(d, live, d, c);\n")
_VOTE = "!__any_sync(__activemask(), !MASKED || mask[l] != 0)"
# a branch of each lane (group) to a copy of its rows before any load, as
# the fixed form does
PDOUBLE_BRANCH = (
    (_LANE_BODY, "  if (MASKED && mask[l] == 0) {\n"
                 "    copy_rows(out + l, a + l, L, 48);\n"
                 "    return;\n"
                 "  }\n" + _LANE_BODY),
    (_GROUP_BODY, "  if (MASKED && mask[l] == 0) {\n"
                  "    if (r < 3) copy_rows(out + row, a + row, L, 16);\n"
                  "    return;\n"
                  "  }\n" + _GROUP_BODY))
# the warp's vote after the loads: a warp whose lanes are all masked off
# writes its loads back, any other doubles and selects
PDOUBLE_VOTE = (
    (_LANE_BODY, _LANE_BODY.replace(
        "  rcb_double", f"  if (MASKED && {_VOTE}) {{\n"
        "    store_pt(out + l, L, p);\n"
        "    return;\n"
        "  }\n"
        "  rcb_double")),
    (_GROUP_BODY, _GROUP_BODY.replace(
        "  coop_double", f"  if (MASKED && {_VOTE}) {{\n"
        "    if (r < 3) store_rows(out + row, L, c);\n"
        "    return;\n"
        "  }\n"
        "  coop_double")))
# the warp's vote before the loads: a warp whose lanes are all masked off
# copies its rows
PDOUBLE_VOTE_EARLY = (
    (_LANE_BODY, f"  if (MASKED && {_VOTE}) {{\n"
                 "    copy_rows(out + l, a + l, L, 48);\n"
                 "    return;\n"
                 "  }\n" + _LANE_BODY),
    (_GROUP_BODY, f"  if (MASKED && {_VOTE}) {{\n"
                  "    if (r < 3) copy_rows(out + row, a + row, L, 16);\n"
                  "    return;\n"
                  "  }\n" + _GROUP_BODY))

# the one-thread form with a minimum of resident blocks of kMaxThreads
# threads an SM, so that ptxas caps its registers at 65,536 / (n x 128)
LANE_BOUNDS = "__launch_bounds__(kMaxThreads)\npdouble_lane_kernel("


def lane_min_blocks(n: int) -> tuple:
    return ((LANE_BOUNDS, LANE_BOUNDS.replace("(kMaxThreads)",
                                              f"(kMaxThreads, {n})")),)


def sums_on_rank0(src_text: str) -> tuple:
    """The (old, new) patch that puts SUMS_ON_RANK0 into coop_add."""
    a = src_text.index(SUMS_FROM)
    return ((src_text[a:src_text.index(SUMS_TO, a)], SUMS_ON_RANK0),)


# the scalar ladder's add computed on every step and kept by a select,
# not a branch of the group
LADDER_SELECT = (
    ("    if (((word >> (s & 31)) & 1u) == 0) continue;\n", ""),
    ("    coop_add<F, true>(acc, acc, a1, b0, b1, r, gm);\n",
     "    uint32_t sum[8];\n"
     "    coop_add<F, true>(sum, acc, a1, b0, b1, r, gm);\n"
     "    select(acc, ((word >> (s & 31)) & 1u) != 0, sum, acc);\n"))
# the scalar ladder's products (those of its steps) inlined
LADDER_INLINE = tuple(
    (x, x.replace("true", "false")) for x in (
        "    coop_double<F, true>(acc, acc, r, gm);\n",
        "    coop_add<F, true>(acc, acc, a1, b0, b1, r, gm);\n"))


def make_variant(name: str, src: str, source: str, cc: bool = False,
                 patches=(), append: str = "") -> str:
    """Copy field.cuh and `source` from the directory src to OUT/name,
    patched: cc puts MONT_MUL_CC in place of every mont_mul of the source,
    each (old, new) of `patches` replaces old (which must be there) with
    new, and `append` goes at the end."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(src, "field.cuh")) as fh:
        hdr = fh.read()
    with open(os.path.join(src, source)) as fh:
        s = fh.read()
    if cc:
        end = "}  // namespace h2t"
        assert end in hdr
        hdr = hdr.replace(end, MONT_MUL_CC + "\n" + end)
        assert "mont_mul<F>(" in s
        s = s.replace("mont_mul<F>(", "mont_mul_cc<F>(")
    for a, b in patches:
        assert a in s, a
        s = s.replace(a, b)
    s += append
    with open(os.path.join(d, "field.cuh"), "w") as fh:
        fh.write(hdr)
    with open(os.path.join(d, source), "w") as fh:
        fh.write(s)
    return os.path.join(d, source)


# {variant: {kernel: {"ptxas": registers line, "sass": instructions}}} of
# every library build() made
BUILD_INFO: dict = {}


def build(variants: dict, kernel) -> dict:
    """{name: .cu path} -> {name: loaded library}, one nvcc each started
    together; prints (and keeps in BUILD_INFO) the registers and SASS size
    of the Fp instance of each kernel whose name holds `kernel` (a fragment
    or a tuple of them)."""
    kernel = (kernel,) if isinstance(kernel, str) else kernel
    import chip_smoke as cs
    from halo2_tpu_torch.ops import cuda_build as cb
    nvcc = cb._nvcc()
    procs = {}
    for name, cu in variants.items():
        so = cu[:-3] + ".so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", os.path.dirname(cu), "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, pr) in procs.items():
        log, _ = pr.communicate()
        if pr.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        info = BUILD_INFO.setdefault(name, {})
        for i, line in enumerate(lines):
            if "entry function" in line and "ILi0E" in line and \
                    any(k in line for k in kernel):
                fn = line.split("'")[1] if "'" in line else line
                regs = "; ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "Compiling" not in x)
                info.setdefault(fn, {})["ptxas"] = regs
                print(f"[{name}] {regs}")
        for fn, count in cs.sass_counts(so).items():
            if "ILi0E" in fn and any(k in fn for k in kernel):
                info.setdefault(fn, {})["sass"] = count
                print(f"[{name}] {fn}: {count} SASS instructions")
        libs[name] = ctypes.CDLL(so)
    return libs


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA launch failed: cudaError {rc}")


def _form_row(tag, L, variants, call, want, bound, reps, extra=""):
    """Run each (name, launch) of `variants` once into the tensor call
    returns, hold it to `want` bit for bit, time it from a CUDA graph
    (reps replays) and print one line: {"L", "bound_ms", "bound_by",
    "graph_ms": {name: ms}}."""
    import torch
    import chip_smoke as cs
    bd, by = bound
    row = {"L": L, "bound_ms": bd, "bound_by": by, "graph_ms": {}}
    for name, launch in variants:
        out = call(launch)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"[{tag}] {name} differs from the plain "
                                 f"version at L={L}")
        row["graph_ms"][name] = cs.graph_ms(lambda: call(launch), reps)
    best = min(row["graph_ms"], key=row["graph_ms"].get)
    print(f"[{tag}] L={L}{extra}: " + ", ".join(
        f"{k} {v:.5f}" for k, v in row["graph_ms"].items())
        + f" ms a launch from a graph (bound {bd:.5f} ms by {by}); "
        f"fastest {best}", flush=True)
    return row


# the GLV ladder's widths: 1 and 2 lanes (the last device fold rounds),
# 2^10 to 2^17 (the first fold round at k = 11 to 18), and the sweep
# between 2^14 and 2^17 that places kGlvLaneFrom
GLV_WIDTHS = (1, 2, 1 << 10, 1 << 12, 1 << 13, 1 << 14, 1 << 15, 1 << 16,
              1 << 17)
GLV_SWEEP = (5 << 12, 3 << 13, 7 << 12, 5 << 13, 3 << 14, 7 << 13,
             5 << 14, 3 << 15, 7 << 14)


def glv_variants(dev) -> dict:
    """The GLV ladder in both forms of the source and the group form with
    inlined products, against glv_ladder_plain bit for bit at every width
    of GLV_WIDTHS and GLV_SWEEP, each timed a launch from a CUDA graph
    beside the bound chip_smoke.py counts (L x 4 x 192 bytes against
    8 products a step and 12 an add)."""
    import random
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FP_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import ipa_device as ipd
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    libs = build({"source": make_variant("source", CSRC, src),
                  "inline": make_variant("inline", CSRC, src,
                                         patches=GLV_INLINE)},
                 "glv_ladder")
    for lib in libs.values():
        f = lib.h2t_glv_ladder_form
        f.argtypes = cb._ARGTYPES["point_kernels"]["h2t_glv_ladder_form"]
        f.restype = ctypes.c_int
    variants = [("lane", (libs["source"], 1)), ("group", (libs["source"], 4)),
                ("group_inline", (libs["inline"], 4))]
    df = FP_DEV
    g = pk.points_to_proj(df, native_srs_g(PALLAS, "glv-variants", 1024),
                          dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    rng = random.Random(18)
    nb = ipd.GLV_BITS
    bits = ([rng.randrange(2) for _ in range(nb)],
            [rng.randrange(2) for _ in range(nb)])
    nsel = sum(1 for b1, b2 in zip(*bits) if b1 or b2)
    packed = (pk._pack_bits(bits[0]), pk._pack_bits(bits[1]))
    record = []
    for L in sorted(GLV_WIDTHS + GLV_SWEEP):
        pts, _ = cs._ladder_inputs(df, g, L, gen, edge=False)
        t = ipd.glv_table(df, pts, 1, 0)
        want = pk.glv_ladder_plain(df, *t, *bits)
        out = torch.empty_like(pts)

        def call(launch, t=t, out=out, L=L):
            lib, threads = launch
            check(lib.h2t_glv_ladder_form(
                threads, df.field_id, out.data_ptr(), t[0].data_ptr(),
                t[1].data_ptr(), t[2].data_ptr(), *packed, nb, L, stream()))
            return out
        bound = cs.bound_ms(L * 4 * 192,
                            L * (8 * nb + 12 * nsel) * cs.MONT_MULADDS)
        record.append(_form_row("glv", L, variants, call, want, bound, 5))
    return {"widths": record, "nbits": nb, "adds": nsel}


# the bucket-run kernel's widths: (k, columns) of commits, 2^k bases and
# the window of pick_c(2^k): one K = 11 column (7,424 lanes, runs of 8 on
# average), one and two k = 14 columns (13,312 and 26,624, runs of 32), one
# k = 17 column (45,056, runs of 64), one and two k = 18 columns (81,920
# and 163,840), and the sweep between them
BUCKET_COMMITS = ((11, 1), (14, 1), (14, 2), (17, 1), (18, 1), (18, 2))
BUCKET_SWEEP = ((11, 2), (11, 3), (16, 1), (14, 3), (16, 2), (14, 4),
                (16, 3), (17, 2), (17, 3))


def bucket_variants(dev) -> dict:
    """The bucket-run kernel in both forms of the source on the lanes
    sorted by run length (the map the wrapper builds) and in order, and
    the group form with a prefetch, against pmixed_bucket_runs_plain bit
    for bit at every (k, columns) of BUCKET_COMMITS and BUCKET_SWEEP, each
    timed a launch from a CUDA graph beside the bound chip_smoke.py counts
    (68 bytes a member and 200 a lane against 11 products a live member);
    the sort's own time (CUDA events) beside them."""
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FP_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    libs = build({"source": make_variant("source", CSRC, src),
                  "prefetch": make_variant("prefetch", CSRC, src,
                                           patches=BUCKET_PREFETCH)},
                 "pmixed_bucket_runs")
    for lib in libs.values():
        f = lib.h2t_pmixed_bucket_runs_form
        f.argtypes = cb._ARGTYPES["point_kernels"][
            "h2t_pmixed_bucket_runs_form"]
        f.restype = ctypes.c_int
    # (library, threads a lane, the lanes sorted by run length or not)
    variants = [("lane", (libs["source"], 1, True)),
                ("group", (libs["source"], 4, True)),
                ("group_prefetch", (libs["prefetch"], 4, True)),
                ("lane_unsorted", (libs["source"], 1, False)),
                ("group_unsorted", (libs["source"], 4, False))]
    df = FP_DEV
    aff14 = pk.points_to_proj(df, native_srs_g(PALLAS, "bucket-variants",
                                               1 << 14), dev)[:32]
    one = pk.mont_one(df, dev)[:, None]
    record = []
    for k, m in sorted(BUCKET_COMMITS + BUCKET_SWEEP,
                       key=lambda km: cs.commit_lanes(*km)):
        n = 1 << k
        aff = aff14.repeat(1, max(n >> 14, 1))[:, :n].contiguous()
        gen = torch.Generator(device=dev).manual_seed(k * 8 + m)
        digits = torch.randint(0, 1 << 16, (m, n, 16), generator=gen,
                               device=dev, dtype=torch.int32)
        digits[..., 15] >>= 2                    # below 2^254 < q
        runs = mp.bucket_runs(PALLAS, digits, mp.pick_c(n))
        packed = pk.pack_affine(aff)
        members = pk.bucket_members(runs.order, runs.sg)
        starts = runs.starts_e.reshape(-1).to(torch.int32).contiguous()
        counts = runs.counts_e.reshape(-1).to(torch.int32).contiguous()
        L = starts.shape[0]
        want = pk.pmixed_bucket_runs_plain(df, packed, members, starts,
                                           counts, runs.BL)
        out = torch.empty((48, L), dtype=torch.int32, device=dev)
        # the lane maps: longest run first (as the wrapper sorts them),
        # and the lanes in order
        order = lambda counts=counts: torch.argsort(
            counts, descending=True).to(torch.int32)
        maps = {True: order(), False: torch.arange(
            L, dtype=torch.int32, device=dev)}
        sort_ms = cs.timed(order, 20)

        def call(launch, packed=packed, members=members, starts=starts,
                 counts=counts, out=out, BL=runs.BL, n=n, L=L, maps=maps):
            lib, threads, by_length = launch
            check(lib.h2t_pmixed_bucket_runs_form(
                threads, df.field_id, out.data_ptr(), packed.data_ptr(),
                members.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                maps[by_length].data_ptr(), BL, n, L, stream()))
            return out
        total = int(counts.sum())
        rows = torch.arange(L, device=dev) // runs.BL * n
        r = torch.arange(int(counts.max()), device=dev)[:, None]
        valid = r < counts[None]
        mem = members.reshape(-1).long()[
            rows + torch.where(valid, starts.long() + r, 0)] & 0x7FFFFFFF
        ident = (aff[:16] == 0).all(0) & (aff[16:] == one).all(0)
        live = total - int(ident[mem][valid].sum())
        bound = cs.bound_ms(total * (64 + 4) + L * (8 + 192),
                            live * 11 * cs.MONT_MULADDS)
        row = _form_row("bucket", L, variants, call, want, bound, 5,
                        f" (k={k}, {m} column{'s' if m > 1 else ''}, runs "
                        f"up to {int(counts.max())}, mean "
                        f"{total / L:.1f}; the argsort of the sorted map "
                        f"{sort_ms:.5f} ms a call, not in the graph)")
        row.update(k=k, columns=m, max_run=int(counts.max()),
                   members=total, live=live, sort_ms=sort_ms)
        record.append(row)
    return {"widths": record}


def ntt_variants(dev, old) -> None:
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import ntt
    src = "ntt_kernels.cu"
    variants = {"pass": make_variant("pass", CSRC, src),
                "pass_cc": make_variant("pass_cc", CSRC, src, cc=True)}
    if old:
        variants["stagewise"] = make_variant(
            "stagewise", os.path.join(old, "halo2_tpu_torch", "csrc"), src)
    libs = build(variants, "ntt_")
    for name, lib in libs.items():
        fn, args = (("h2t_ntt", [cb._I, cb._P, cb._P, cb._P, cb._P, cb._LL,
                                 cb._I, cb._I, cb._P])
                    if name == "stagewise" else
                    ("h2t_ntt_pass", cb._ARGTYPES["ntt_kernels"]
                     ["h2t_ntt_pass"]))
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    df = FQ_DEV
    spec = df.spec
    for log_n in (10, 16, 20):
        n = 1 << log_n
        plan = ntt.make_plan(df, n, pow(spec.root_of_unity,
                                        1 << (spec.s - log_n), spec.modulus))
        perm, table, _, packed = plan.on(dev)
        for m in (1, 4):
            x = cs.rand_field(df, m * n, log_n, dev).view(m, n, 16)
            want = ntt.ntt_many_plain(df, x, plan)
            for name, lib in libs.items():
                out = torch.empty_like(x)
                if name == "stagewise":
                    def fn(lib=lib, out=out):
                        check(lib.h2t_ntt(df.field_id, out.data_ptr(),
                                          x.data_ptr(), perm.data_ptr(),
                                          table.data_ptr(), m, log_n,
                                          min(log_n, 10), stream()))
                    kern = ("ntt_tile", "ntt_stage")
                else:
                    def fn(lib=lib, out=out):
                        src = x
                        for a, cnt, r_log in ntt.ntt_passes(log_n):
                            check(lib.h2t_ntt_pass(
                                df.field_id, out.data_ptr(), src.data_ptr(),
                                packed.data_ptr(), m, log_n, a, cnt, r_log,
                                int(a == 0), stream()))
                            src = out
                    kern = "ntt_pass"
                g = cs.graph_ms(fn, 20)
                p = cs.device_ms(fn, 20, kern, per_call=True)
                torch.cuda.synchronize()
                same = torch.equal(out, want)
                print(f"[ntt] n=2^{log_n} m={m} {name}: {g:.5f} ms per "
                      f"transform from a CUDA graph, {p:.5f} ms by the "
                      f"profiler (equal to the plain version: {same})")
                if not same:
                    raise AssertionError(f"{name} differs at 2^{log_n}")


# K2 with its slot file in shared memory, [slot][limb][thread of the block]
# (a warp reads one slot's limb from 32 banks), sized at launch from the
# tape's slots; the register flags honoured as in the source. Rows a block:
# as many warps (at most four) as leave room for two blocks an SM.
GATE_SHARED = r'''#include "field.cuh"

namespace {

using namespace h2t;

enum { OP_QUERY, OP_CONST, OP_NEG, OP_ADD, OP_MUL, OP_SCALE, OP_FOLD };
constexpr int kOpMask = 0xff;
constexpr int kKeep = 1 << 8;
constexpr int kXLast = 1 << 9;
constexpr int kYLast = 1 << 10;

__device__ __forceinline__ void copy8(uint32_t r[8], const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

__device__ __forceinline__ void sget(uint32_t r[8], const uint32_t* sl,
                                     int s, int T) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = sl[(s * 8 + i) * T];
}

__device__ __forceinline__ void sput(uint32_t* sl, int s, int T,
                                     const uint32_t v[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) sl[(s * 8 + i) * T] = v[i];
}

template <int F>
__global__ void __launch_bounds__(128)
gate_chunk_shared_kernel(int32_t* __restrict__ out, int has_prev,
                         const int4* __restrict__ code, int n_code,
                         const int32_t* __restrict__ consts, int n_consts,
                         const long long* __restrict__ ptrs, int n_ptrs,
                         int n_adv, int n_fix, const int32_t* __restrict__ yy,
                         long long n, long long rot_scale, size_t off_slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t** s_ptr = reinterpret_cast<const int32_t**>(smem);
  const size_t off_code = ((size_t)n_ptrs * 8 + 15) & ~(size_t)15;
  int4* s_code = reinterpret_cast<int4*>(smem + off_code);
  uint32_t* s_const =
      reinterpret_cast<uint32_t*>(smem + off_code + (size_t)n_code * 16);
  const int T = blockDim.x;
  uint32_t* sl = reinterpret_cast<uint32_t*>(smem + off_slots) + threadIdx.x;
  for (int i = threadIdx.x; i < n_ptrs; i += T)
    s_ptr[i] = reinterpret_cast<const int32_t*>(ptrs[i]);
  for (int i = threadIdx.x; i < n_code; i += T) s_code[i] = code[i];
  for (int i = threadIdx.x; i < n_consts + 2; i += T) {
    uint32_t v[8];
    load_digits(v, i < n_consts ? consts + 16 * i : yy + 16 * (i - n_consts));
#pragma unroll
    for (int w = 0; w < 8; w++) s_const[8 * i + w] = v[w];
  }
  __syncthreads();
  const uint32_t* y_m = s_const + 8 * n_consts;
  const uint32_t* yk_m = y_m + 8;
  const int base[3] = {0, n_adv, n_adv + n_fix};
  const long long mask = n - 1;

  for (long long r = (long long)blockIdx.x * T + threadIdx.x; r < n;
       r += (long long)gridDim.x * T) {
    uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t last[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int pc = 0; pc < n_code; pc++) {
      const int4 ins = s_code[pc];
      const int op = ins.x & kOpMask;
      uint32_t a[8], b[8], res[8];
      if (op >= OP_NEG) {
        if (ins.x & kXLast) copy8(a, last);
        else sget(a, sl, ins.z, T);
      }
      if (op == OP_ADD || op == OP_MUL) {
        if (ins.x & kYLast) copy8(b, last);
        else sget(b, sl, ins.w, T);
      }
      switch (op) {
        case OP_QUERY: {
          const int32_t* col = s_ptr[base[ins.z >> 16] + (ins.z & 0xffff)];
          const long long row = (r + (long long)ins.w * rot_scale) & mask;
          load_digits(res, col + row * 16);
          break;
        }
        case OP_CONST:
          copy8(res, s_const + 8 * ins.z);
          break;
        case OP_NEG: {
          const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          sub<F>(res, z, a);
          break;
        }
        case OP_ADD:
          add<F>(res, a, b);
          break;
        case OP_MUL:
          mont_mul<F>(res, a, b);
          break;
        case OP_SCALE:
          copy8(b, s_const + 8 * ins.w);
          mont_mul<F>(res, a, b);
          break;
        default: {
          if (ins.w) {
            copy8(acc, a);
          } else {
            copy8(b, y_m);
            mont_mul<F>(res, acc, b);
            add<F>(acc, res, a);
          }
          continue;
        }
      }
      if (!(ins.x & kKeep)) sput(sl, ins.y, T, res);
      copy8(last, res);
    }
    if (has_prev) {
      uint32_t h[8], k[8], t[8];
      load_digits(h, out + r * 16);
      copy8(k, yk_m);
      mont_mul<F>(t, h, k);
      add<F>(h, t, acc);
      store_digits(out + r * 16, h);
    } else {
      store_digits(out + r * 16, acc);
    }
  }
}

}  // namespace

extern "C" int h2t_gate_chunk_shared(int field, void* out, int has_prev,
                                     const void* code, int n_code,
                                     int n_slots, const void* consts,
                                     int n_consts, const void* ptrs,
                                     int n_ptrs, int n_adv, int n_fix,
                                     const void* yy, long long n,
                                     long long rot_scale, void* stream) {
  if (n <= 0) return 0;
  const size_t off_code = ((size_t)n_ptrs * 8 + 15) & ~(size_t)15;
  const size_t off_slots =
      (off_code + (size_t)n_code * 16 + (size_t)(n_consts + 2) * 32 + 15) &
      ~(size_t)15;
  const size_t row = (size_t)(n_slots > 0 ? n_slots : 1) * 32;
  int warps = 4;
  while (warps > 1 && 2 * (off_slots + row * 32 * warps) > 232448) warps--;
  const int threads = 32 * warps;
  const size_t bytes = off_slots + row * threads;
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  auto kern = field ? gate_chunk_shared_kernel<1> : gate_chunk_shared_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long per_sm = 232448 / (long long)bytes;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * per_sm) blocks = 132 * per_sm;
  kern<<<(unsigned)blocks, threads, bytes, (cudaStream_t)stream>>>(
      (int32_t*)out, has_prev, (const int4*)code, n_code,
      (const int32_t*)consts, n_consts, (const long long*)ptrs, n_ptrs, n_adv,
      n_fix, (const int32_t*)yy, n, rot_scale, off_slots);
  return (int)cudaGetLastError();
}
'''


# K2 variants patched into the source: the grid sized to the blocks that
# fit at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), where the
# source caps it at 132 x 8 blocks and 66 registers leave room for 7 an
# SM; that grid with __launch_bounds__(128, 8) (registers capped at 64);
# and two rows a thread (rows r and r + 128 of a block's 256), their
# products independent, with that grid
GATE_GRID = (
    "  long long blocks = (n + kThreads - 1) / kThreads;\n"
    "  if (blocks > 132 * 8) blocks = 132 * 8;\n",
    "  long long blocks = (n + kThreads * kRows - 1) / (kThreads * kRows);\n"
    "  int per_sm = 0, dev = 0, sms = 0;\n"
    "  cudaGetDevice(&dev);\n"
    "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
    "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,"
    " bytes);\n"
    "  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * "
    "per_sm;\n")
GATE_ROWS1 = ("constexpr int kThreads = 128;\n",
              "constexpr int kThreads = 128;\nconstexpr int kRows = 1;\n")
GATE_LB8 = ("__global__ void __launch_bounds__(kThreads)\n",
            "__global__ void __launch_bounds__(kThreads, 8)\n")
GATE_ROWS2_LOOP = r'''  for (long long r0 = (long long)blockIdx.x * blockDim.x * 2 + threadIdx.x;
       r0 < n; r0 += (long long)gridDim.x * blockDim.x * 2) {
    const long long rr[2] = {r0, r0 + blockDim.x};
    uint32_t slot[kSlots][2][8];
    uint32_t acc[2][8], last[2][8];
#pragma unroll
    for (int k = 0; k < 2; k++)
#pragma unroll
      for (int w = 0; w < 8; w++) acc[k][w] = last[k][w] = 0;
    for (int pc = 0; pc < n_code; pc++) {
      const int4 ins = s_code[pc];
      const int op = ins.x & kOpMask;
      uint32_t a[2][8], b[2][8], res[2][8];
#pragma unroll
      for (int k = 0; k < 2; k++) {
        if (op >= OP_NEG) {
          if (ins.x & kXLast) copy8(a[k], last[k]);
          else copy8(a[k], slot[ins.z][k]);
        }
        if (op == OP_ADD || op == OP_MUL) {
          if (ins.x & kYLast) copy8(b[k], last[k]);
          else copy8(b[k], slot[ins.w][k]);
        }
      }
      switch (op) {
        case OP_QUERY: {
          const int32_t* col = s_ptr[base[ins.z >> 16] + (ins.z & 0xffff)];
#pragma unroll
          for (int k = 0; k < 2; k++)
            load_digits(res[k],
                        col + ((rr[k] + (long long)ins.w * rot_scale) & mask)
                                  * 16);
          break;
        }
        case OP_CONST:
#pragma unroll
          for (int k = 0; k < 2; k++) copy8(res[k], s_const + 8 * ins.z);
          break;
        case OP_NEG: {
          const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
          for (int k = 0; k < 2; k++) sub<F>(res[k], z, a[k]);
          break;
        }
        case OP_ADD:
#pragma unroll
          for (int k = 0; k < 2; k++) add<F>(res[k], a[k], b[k]);
          break;
        case OP_MUL:
#pragma unroll
          for (int k = 0; k < 2; k++) mont_mul<F>(res[k], a[k], b[k]);
          break;
        case OP_SCALE:
#pragma unroll
          for (int k = 0; k < 2; k++) {
            copy8(b[k], s_const + 8 * ins.w);
            mont_mul<F>(res[k], a[k], b[k]);
          }
          break;
        default: {  // OP_FOLD
#pragma unroll
          for (int k = 0; k < 2; k++) {
            if (ins.w) {
              copy8(acc[k], a[k]);
            } else {
              copy8(b[k], y_m);
              mont_mul<F>(res[k], acc[k], b[k]);
              add<F>(acc[k], res[k], a[k]);
            }
          }
          continue;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; k++) {
        if (!(ins.x & kKeep)) copy8(slot[ins.y][k], res[k]);
        copy8(last[k], res[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 2; k++) {
      const long long r = rr[k];
      if (has_prev) {
        uint32_t h[8], kk[8], t[8];
        load_digits(h, out + r * 16);
        copy8(kk, yk_m);
        mont_mul<F>(t, h, kk);
        add<F>(h, t, acc[k]);
        store_digits(out + r * 16, h);
      } else {
        store_digits(out + r * 16, acc[k]);
      }
    }
  }
}
'''


def _gate_rows2(text: str) -> tuple:
    """The (old, new) patch that puts GATE_ROWS2_LOOP in place of the
    source's row loop."""
    a = text.index("  for (long long r = (long long)blockIdx.x")
    b = text.index("\ntemplate <int F>\nint launch(")
    return ((text[a:b], GATE_ROWS2_LOOP),)


# K1 builds beside the source's pass kernel (run in the source's plan):
# two and eight loads a thread in flight (kBatch, 4 in the source); four
# warps a block (kPassWarps, 8; smaller blocks, more of them an SM); and
# the source with at least three blocks an SM promised to ptxas
MXU_PATCHES = {
    "batch2": (("constexpr int kBatch = 4;", "constexpr int kBatch = 2;"),),
    "batch8": (("constexpr int kBatch = 4;", "constexpr int kBatch = 8;"),),
    "warps4": (("constexpr int kPassWarps = 8;",
                "constexpr int kPassWarps = 4;"),),
    "lb3": (("__global__ void __launch_bounds__(kPassWarps * 32)\n"
             "mxu_pass_kernel(",
             "__global__ void __launch_bounds__(kPassWarps * 32, 3)\n"
             "mxu_pass_kernel("),),
}


def mxu_variants(dev, old) -> dict:
    """The four-step NTT forward on the PALLAS scalar field at 2^16, 2^17
    and 2^20 with 1 and 4 columns: K1's passes (the source) with passes
    of at most S = 3..6 stages and tiles of 32 and 64 lanes, and, given an
    older checkout, its stage-by-stage four-step (one K1 launch a stage,
    the bit-reversal gathers and transposes as copies, the diagonal
    twiddles as one B1 launch). Each equal to the source (S = 5, 32 lanes)
    and to B7 bit for bit, timed a transform from a CUDA graph beside B7
    and the sum of the source's pass bounds."""
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import field_kernels as fk
    from halo2_tpu_torch.ops import mxu_field as mxu
    from halo2_tpu_torch.ops import ntt
    src = "mxu_kernels.cu"
    variants = {"pass": make_variant("pass", CSRC, src)}
    for name, patch in MXU_PATCHES.items():
        variants[name] = make_variant(name, CSRC, src, patches=patch)
    if old:
        variants["stagewise"] = make_variant(
            "stagewise", os.path.join(old, "halo2_tpu_torch", "csrc"), src)
    libs = build(variants, "mxu_")
    for name, lib in libs.items():
        if name != "stagewise":
            lib.h2t_mxu_pass.argtypes = cb._ARGTYPES["mxu_kernels"][
                "h2t_mxu_pass"]
            lib.h2t_mxu_pass.restype = ctypes.c_int
    stage = None
    if old:
        stage = libs["stagewise"].h2t_mxu_const_mul
        stage.argtypes = [cb._I, cb._P, cb._P, cb._P] + [cb._LL] * 6 + [
            cb._I, cb._P]
        stage.restype = ctypes.c_int
    df = FQ_DEV
    spec = df.spec

    def stagewise(x, plan):
        t = mxu._mxu4_plan(df, plan).on(dev)
        m, n = x.shape[0], x.shape[1]
        R = 1 << (((n.bit_length() - 1) + 1) // 2)
        C = n // R

        def axis(a, perm, stages):
            N, L = a.shape[0], a.shape[1]
            a = a.index_select(0, perm)
            for s, tw in enumerate(stages, start=1):
                half = 1 << (s - 1)
                check(stage(df.field_id, a.data_ptr(), a.data_ptr(),
                            tw.data_ptr(), half, (N >> s) * L, L,
                            2 * half * L, L, half * L, 1, stream()))
            return a
        A = x.reshape(m, R, C, 16).transpose(0, 1).reshape(R, m * C, 16)
        B = axis(A, t["col_perm"], t["col_tw"])
        B = B.view(R, m, C, 16).transpose(0, 1).reshape(m, n, 16)
        Bt = fk.fmul(df, B, t["diag"])
        D = Bt.view(m, R, C, 16).permute(2, 0, 1, 3).reshape(C, m * R, 16)
        E = axis(D, t["row_perm"], t["row_tw"])
        return E.view(C, m, R, 16).transpose(0, 1).reshape(m, n, 16)

    def run(lib, x, plan, passes, lanes_log):
        """mxu.run_passes through the build `lib`."""
        n = x.shape[1]
        t = mxu._mxu4_plan(df, plan).on(dev)
        bufs = (torch.empty_like(x), torch.empty_like(x))
        src = x
        for i, ps in enumerate(passes):
            dst = bufs[i % 2]
            tw = t["row_packed" if ps.axis else "col_packed"]
            check(lib.h2t_mxu_pass(
                df.field_id, dst.data_ptr(), src.data_ptr(), tw.data_ptr(),
                t["diag_packed"].data_ptr() if ps.diag else None, ps.lanes,
                ps.lpc_log, n, ps.log_n, ps.a, ps.cnt, lanes_log, ps.s_ax,
                ps.s_ln, ps.d_ax, ps.d_ln, int(ps.gather), stream()))
            src = dst
        return src

    record = []
    for log_n in (16, 17, 20):
        n = 1 << log_n
        plan = ntt.make_plan(df, n, pow(spec.root_of_unity,
                                        1 << (spec.s - log_n), spec.modulus))
        for m in (1, 4):
            x = cs.rand_field(df, m * n, log_n + m, dev).view(m, n, 16)
            want = mxu.ntt_mxu_b(df, x, plan)
            if not torch.equal(want, ntt.ntt_many(df, x, plan)):
                raise AssertionError(f"[mxu] the source differs from B7 at "
                                     f"2^{log_n}")
            row = {"log_n": log_n, "m": m,
                   "bound_ms": cs.mxu_transform_bound(m, n)[0],
                   "b7_ms": cs.graph_ms(lambda: ntt.ntt_many(df, x, plan),
                                        10),
                   "graph_ms": {}, "launches": {}}
            forms = [(f"S{s}_L{32 << lb}", ("pass", s, 5 + lb))
                     for s in (3, 4, 5, 6) for lb in (0, 1)]
            forms += [(name, (name, mxu.MXU_PASS_LOG, mxu.MXU_LANES_LOG))
                      for name in MXU_PATCHES]
            if stage is not None:
                forms.append(("stagewise", None))
            for name, form in forms:
                if form is None:
                    fn = lambda: stagewise(x, plan)
                    launches = log_n
                else:
                    passes = mxu.four_step_passes(m, n, form[1])
                    if any(form[2] + ps.cnt > 12       # kMaxTileLog
                           for ps in passes):
                        continue
                    fn = (lambda lib=libs[form[0]], passes=passes,
                          lb=form[2]: run(lib, x, plan, passes, lb))
                    launches = len(passes)
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"[mxu] {name} differs from the "
                                         f"source at 2^{log_n} m={m}")
                row["graph_ms"][name] = cs.graph_ms(fn, 10)
                row["launches"][name] = launches
            best = min(row["graph_ms"], key=row["graph_ms"].get)
            print(f"[mxu] n=2^{log_n} m={m}: " + ", ".join(
                f"{k} {v:.5f} ({row['launches'][k]})"
                for k, v in row["graph_ms"].items())
                + f" ms a transform from a graph (launches); B7 "
                f"{row['b7_ms']:.5f}; bound {row['bound_ms']:.5f}; fastest "
                f"{best}", flush=True)
            record.append(row)
            del x, want
    return {"shapes": record}


def _eval_order_compile():
    """compile_chunk with the operands in evaluation order (a before b),
    as tapes were compiled before the Sethi-Ullman order: its source
    with the order's test taken out."""
    import inspect
    from halo2_tpu_torch.plonk import evaluation as ev
    text = inspect.getsource(ev.compile_chunk)
    old = "            if need(e.b) > need(e.a):\n"
    assert old in text
    ns = dict(vars(ev))
    exec(text.replace(old, "            if False:\n"), ns)
    return ns["compile_chunk"]


def _strip_flags(tape):
    """The tape with its register flags cleared: every result written to
    its slot and every operand read from it."""
    from halo2_tpu_torch.ops import gate_kernels as gk
    return gk.GateTape(code=[(op & gk.OP_MASK, d, x, y)
                             for op, d, x, y in tape.code],
                       consts=tape.consts, n_slots=tape.n_slots,
                       n_polys=tape.n_polys)


def gate_variants(dev, old) -> dict:
    """K2 on Table16's gate set (selectors compressed over 64 rows of no
    activations, as tests/test_torch_cuda.py) at 2^20 rows, rot_scale 8,
    after an accumulator: the whole set as one chunk (60 slots) and its
    400-node chunks (at most 21) in turn, in the forms
      local      the slot file in local memory (the source's kernel; with
                 an older checkout, also that checkout's kernel as
                 `local_old`)
      shared     the slot file in shared memory (GATE_SHARED)
    on tapes in evaluation order (`eval`) or Sethi-Ullman order (`su`,
    compile_chunk's), with the register flags (`flags`) or without; each
    equal to the source's form (local, su, flags) bit for bit and to the
    plain tape on 2^12 of the rows; timed from a CUDA graph; registers
    and stack (nvcc -Xptxas -v), SASS size and local loads and stores
    (LDL, STL) of each build."""
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch import sha256_circuits
    from halo2_tpu_torch.fields.device import FP_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import gate_kernels as gk
    from halo2_tpu_torch.plonk import prover
    from halo2_tpu_torch.plonk.circuit import ConstraintSystem
    from halo2_tpu_torch.plonk.compress_selectors import compress_selectors
    from halo2_tpu_torch.plonk.evaluation import compile_chunk
    src = "gate_kernels.cu"
    with open(os.path.join(CSRC, src)) as fh:
        text = fh.read()
    grid = (GATE_ROWS1, GATE_GRID)
    variants = {"local": make_variant("local", CSRC, src),
                "grid": make_variant("grid", CSRC, src, patches=grid),
                "grid_lb8": make_variant("grid_lb8", CSRC, src,
                                         patches=grid + (GATE_LB8,)),
                "local_cc": make_variant("local_cc", CSRC, src, cc=True),
                "rows2": make_variant("rows2", CSRC, src, patches=(
                    (GATE_ROWS1[0], GATE_ROWS1[0] +
                     "constexpr int kRows = 2;\n"), GATE_GRID)
                    + _gate_rows2(text))}
    d = os.path.join(OUT, "shared")
    os.makedirs(d, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "field.cuh"), d)
    variants["shared"] = os.path.join(d, src)
    with open(variants["shared"], "w") as fh:
        fh.write(GATE_SHARED)
    if old:
        variants["local_old"] = make_variant(
            "local_old", os.path.join(old, "halo2_tpu_torch", "csrc"), src)
    libs = build(variants, "gate_chunk")
    sass = {}
    for name, cu in variants.items():
        for fn, ops in cs.sass_opcodes(cu[:-3] + ".so", "gate_chunk").items():
            if "ILi0E" in fn:
                sass[name] = {k: ops[k] for k in ("LDL", "LDL.128", "STL",
                                                  "STL.128", "LDS",
                                                  "LDS.128", "STS",
                                                  "STS.128")}
                BUILD_INFO[name].setdefault(fn, {})["memory_ops"] = sass[name]
                print(f"[gate] {name} {fn}: {sass[name]}")
    fns = {}
    for name, lib in libs.items():
        entry = "h2t_gate_chunk_shared" if name == "shared" else \
            "h2t_gate_chunk"
        f = getattr(lib, entry)
        f.argtypes = cb._ARGTYPES["gate_kernels"]["h2t_gate_chunk"]
        f.restype = ctypes.c_int
        fns[name] = f
    cs_ = ConstraintSystem()
    sha256_circuits.port_namespace().classes.Table16.configure(cs_)
    compress_selectors(cs_, [[False] * 64] * cs_.num_selectors)
    polys = [e for g in cs_.gates for e in g.polys]
    eval_compile = _eval_order_compile()
    df, n, rot = FP_DEV, 1 << 20, 8
    counts = (cs_.num_advice_columns, cs_.num_fixed_columns,
              cs_.num_instance_columns)
    cols = [[cs.rand_field(df, n, 300 + 10 * kind + i, dev)
             for i in range(c)] for kind, c in enumerate(counts)]
    every = [c for group in cols for c in group]
    ptrs = torch.tensor([c.data_ptr() for c in every],
                        dtype=torch.int64).to(dev)
    y = 0xC0FFEE
    y_m = df.scalar(y, dev)
    h0 = cs.rand_field(df, n, 299, dev)
    rows = torch.arange(1 << 12, device=dev)
    record = {"sass": sass}
    for label, chunks in (("whole", [polys]),
                          ("400", prover.gate_chunks(cs_, 400))):
        tapes = {"su": [compile_chunk(c) for c in chunks],
                 "eval": [eval_compile(c) for c in chunks]}
        forms = [(k, order, flags) for k in fns for order in ("su", "eval")
                 for flags in (True, False)
                 if not (k == "local_old" and flags)
                 and (k in ("local", "shared", "local_old")
                      or (order, flags) == ("su", True))]

        launches = {}
        for order in tapes:
            for flags in (True, False):
                ent = launches[order, flags] = []
                for tape in tapes[order]:
                    tp = tape if flags else _strip_flags(tape)
                    yk = df.scalar(pow(y, tp.n_polys, df.spec.modulus), dev)
                    ent.append(tp.on(df, dev) + (tp.n_slots, torch.stack(
                        [y_m.reshape(16), yk.reshape(16)]).contiguous()))

        def run(form, out):
            kern, order, flags = form
            for code, consts, slots, yy in launches[order, flags]:
                check(fns[kern](df.field_id, out.data_ptr(), 1,
                                code.data_ptr(), code.shape[0], slots,
                                consts.data_ptr(), consts.shape[0],
                                ptrs.data_ptr(), len(every), counts[0],
                                counts[1], yy.data_ptr(), n, rot, stream()))
            return out
        want = run(("local", "su", True), h0.clone())
        plain = h0[rows]
        for tape in tapes["su"]:
            yk = df.scalar(pow(y, tape.n_polys, df.spec.modulus), dev)
            plain = gk.run_chunk_plain(df, tape, plain, *cols, rot, y_m, yk,
                                       n, rows=rows)
        if not torch.equal(want[rows], plain):
            raise AssertionError(f"[gate] {label}: K2 differs from the "
                                 f"plain tape")
        row = {"slots": {o: max(t.n_slots for t in ts)
                         for o, ts in tapes.items()},
               "launches": len(chunks), "graph_ms": {}}
        scratch = h0.clone()
        for form in forms:
            name = f"{form[0]}_{form[1]}" + ("_flags" if form[2] else "")
            got = run(form, h0.clone())
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"[gate] {label} {name} differs from "
                                     f"the source's form")
            row["graph_ms"][name] = cs.graph_ms(
                lambda form=form: run(form, scratch), 3)
        best = min(row["graph_ms"], key=row["graph_ms"].get)
        print(f"[gate] {label} ({row['launches']} launches, slots "
              f"{row['slots']}): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in row["graph_ms"].items())
              + f" ms from a graph; fastest {best}", flush=True)
        record[label] = row
    return record


def same_points(df, a, b) -> bool:
    """[96, L] pairs of [48, L] projective batches: the same points (X1 Z2
    = X2 Z1, Y1 Z2 = Y2 Z1, and Z = 0 on the same lanes)."""
    import torch
    from halo2_tpu_torch.ops import field_kernels as fk
    ok = True
    for x, y in ((a[:48], b[:48]), (a[48:], b[48:])):
        X1, Y1, Z1 = (x[i:i + 16].T.contiguous() for i in (0, 16, 32))
        X2, Y2, Z2 = (y[i:i + 16].T.contiguous() for i in (0, 16, 32))
        ok &= torch.equal(fk.fmul(df, X1, Z2), fk.fmul(df, X2, Z1))
        ok &= torch.equal(fk.fmul(df, Y1, Z2), fk.fmul(df, Y2, Z1))
        ok &= torch.equal((Z1 == 0).all(1), (Z2 == 0).all(1))
    return bool(ok)


def point_variants(dev) -> None:
    """B4 and the scalar ladder: the source (group), the one-thread forms
    (lane) and the ladder's select and inline builds, each against the
    source's output."""
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FP_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    with open(os.path.join(CSRC, src)) as fh:
        source = fh.read()
    libs = build({"group": make_variant("group", CSRC, src),
                  "lane": make_variant("lane", CSRC, src, append=LANE_FORMS),
                  "select": make_variant("select", CSRC, src,
                                         patches=LADDER_SELECT),
                  "inline": make_variant("inline", CSRC, src,
                                         patches=LADDER_INLINE),
                  "window": make_variant("window", CSRC, src,
                                         append=WINDOW_FORM),
                  "sums1": make_variant("sums1", CSRC, src,
                                        patches=sums_on_rank0(source))},
                 ("padd_kernel", "padd_lane_kernel", "scalar_mul_ladder"))
    sig = cb._ARGTYPES["point_kernels"]
    entries = {"padd": {"group": "h2t_padd", "lane": "h2t_padd_lane",
                        "sums1": "h2t_padd"},
               "ladder": {"group": "h2t_scalar_mul_ladder",
                          "lane": "h2t_scalar_mul_ladder_lane",
                          "select": "h2t_scalar_mul_ladder",
                          "inline": "h2t_scalar_mul_ladder",
                          "window": "h2t_scalar_mul_ladder_window",
                          "sums1": "h2t_scalar_mul_ladder"}}
    for what, fns in entries.items():
        for name, fn in fns.items():
            f = getattr(libs[name], fn)
            f.argtypes = sig["h2t_padd" if what == "padd"
                             else "h2t_scalar_mul_ladder"]
            f.restype = ctypes.c_int
    df = FP_DEV
    g = pk.points_to_proj(df, native_srs_g(PALLAS, "point-variants", 1024),
                          dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    for L in (1 << 13, 1 << 17):
        a, _ = cs._ladder_inputs(df, g, L, gen, edge=False)
        b, _ = cs._ladder_inputs(df, g, L, gen, edge=False)
        b[:, 200:264] = a[:, 200:264]                 # a == b: doubling
        bd, by = cs.bound_ms(L * 3 * 192, L * 12 * cs.MONT_MULADDS)
        want = None
        for name, fn in entries["padd"].items():
            out = torch.empty_like(a)

            def call(fn=getattr(libs[name], fn), out=out):
                check(fn(df.field_id, out.data_ptr(), a.data_ptr(),
                         b.data_ptr(), L, stream()))
            gms = cs.graph_ms(call, 50)
            pms = cs.device_ms(call, 50, ("padd_kernel", "padd_lane_kernel"))
            torch.cuda.synchronize()
            want = out.clone() if want is None else want
            same = torch.equal(out, want)
            print(f"[padd] L={L} {name}: {gms:.5f} ms from a CUDA graph, "
                  f"{pms:.5f} ms by the profiler (bound {bd:.5f} ms by {by};"
                  f" equal to group: {same})")
            if not same:
                raise AssertionError(f"padd {name} differs at L={L}")
        # a group-NTT stage: 255 bits, a table of half the lanes, fused
        pts, digits = cs._ladder_inputs(df, g, L, gen, edge=False)
        lo, _ = cs._ladder_inputs(df, g, L, gen, edge=False)
        table = digits[:L // 2].contiguous()
        bd, by = cs.bound_ms(*cs.ladder_work(table, 255, L, fused=True))
        want = None
        for name, fn in entries["ladder"].items():
            out, out2 = torch.empty_like(pts), torch.empty_like(pts)

            def call(fn=getattr(libs[name], fn), out=out, out2=out2):
                check(fn(df.field_id, out.data_ptr(), out2.data_ptr(),
                         pts.data_ptr(), table.data_ptr(), lo.data_ptr(),
                         L // 2, 255, L, stream()))
            gms = cs.graph_ms(call, 3)
            pms = cs.device_ms(call, 3, "scalar_mul_ladder")
            torch.cuda.synchronize()
            got = torch.cat([out, out2])
            want = got.clone() if want is None else want
            same = (same_points(df, got, want) if name == "window"
                    else torch.equal(got, want))
            print(f"[scalar-ladder] L={L} {name}: {gms:.5f} ms from a CUDA "
                  f"graph, {pms:.5f} ms by the profiler (bound {bd:.5f} ms "
                  f"by {by}; equal to group"
                  f"{' as affine points' if name == 'window' else ''}: "
                  f"{same})")
            if not same:
                raise AssertionError(f"ladder {name} differs at L={L}")


# B5 and B6: the widths asked of them (1 lane: a traced MSM's combine; 2:
# chip_smoke's [horner]; 8,192 and 2^17: the first IPA fold at k = 14 and
# 18), and the sweep between them that places the form thresholds
DOUBLE_WIDTHS = (1, 2, 1 << 13, 1 << 17, 1 << 20)
DOUBLE_SWEEP = (1 << 10, 1 << 11, 1 << 12, 3 << 11, 3 << 12, 1 << 14,
                5 << 12, 3 << 13, 13 << 11, 7 << 12, 15 << 11, 1 << 15,
                3 << 14, 1 << 16, 3 << 15, 3 << 16, 1 << 18, 3 << 17,
                1 << 19)


# B2 in fixed blocks of 128 threads, one thread a lane: the launch it had
# before its forms (appended to the source's build as h2t_pmixed_masked_fixed)
PMIXED_FIXED = r'''
extern "C" int h2t_pmixed_masked_fixed(int threads, int field, void* out,
                                       const void* a, const void* b,
                                       const void* mask, const void* sign,
                                       long long L, void* stream) {
  if (L <= 0) return 0;
  dim3 grid((unsigned)((L + kMaxThreads - 1) / kMaxThreads));
  auto k = field ? pmixed_masked_kernel<1> : pmixed_masked_kernel<0>;
  k<<<grid, kMaxThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)b,
      (const int32_t*)mask, (const int32_t*)sign, (uint32_t)L);
  return (int)cudaGetLastError();
}
'''

# B2's widths: 1, 1,024, 8,192, [points]'s 26,624 (two k = 14 columns), a
# k = 17 column (45,056), 2^17, one and two k = 18 columns (81,920 and
# 163,840), and the sweep that places kPmixedLaneFrom
B2_WIDTHS = (1, 1 << 10, 1 << 13, 26624, 45056, 1 << 17, 81920, 163840)
B2_SWEEP = (1 << 12, 3 << 12, 1 << 14, 5 << 12, 3 << 13, 15 << 11, 1 << 15,
            9 << 12, 5 << 13, 13 << 12, 1 << 16, 3 << 15)


def b2_variants(dev, old) -> dict:
    """B2 in both forms of the source (h2t_pmixed_masked_form: one thread a
    lane, one lane a group of four threads), one thread a lane in fixed
    128-thread blocks (PMIXED_FIXED) and, given an older checkout, that
    checkout's h2t_pmixed_masked (the parent's kernel), against
    pmixed_masked_plain bit for bit at every width of B2_WIDTHS and
    B2_SWEEP, PALLAS base field, on chip_smoke.py [points]'s inputs (Z != 1
    accumulators, some identity accumulators and identity-coded bases, a
    random 80% of the lanes live, half the signs set), each timed a launch
    from a CUDA graph of 20 beside the bound chip_smoke.py counts (520
    bytes a lane against 11 products a live lane)."""
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FP_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    variants = {"source": make_variant("source", CSRC, src,
                                       append=PMIXED_FIXED)}
    if old:
        variants["parent"] = make_variant(
            "parent", os.path.join(old, "halo2_tpu_torch", "csrc"), src)
    libs = build(variants, "pmixed_masked")
    sig = cb._ARGTYPES["point_kernels"]
    for lib in libs.values():
        for fn in ("h2t_pmixed_masked_form", "h2t_pmixed_masked_fixed",
                   "h2t_pmixed_masked"):
            if hasattr(lib, fn):
                f = getattr(lib, fn)
                f.argtypes = sig.get(fn, sig["h2t_pmixed_masked_form"])
                f.restype = ctypes.c_int
    source = libs["source"]
    # (name, launch(threads-first arguments))
    forms = [(name, lambda *a, t=t: source.h2t_pmixed_masked_form(t, *a))
             for name, t in pk.FORMS.items()]
    forms.append(("fixed", lambda *a: source.h2t_pmixed_masked_fixed(1, *a)))
    if "parent" in libs:
        forms.append(("parent", libs["parent"].h2t_pmixed_masked))
    df = FP_DEV
    g = pk.points_to_proj(df, native_srs_g(PALLAS, "b2-variants", 1024), dev)
    ident = pk.ident_col(df, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    record = []
    for L in sorted(B2_WIDTHS + B2_SWEEP):
        pick = lambda: torch.randint(g.shape[1], (L,), generator=gen,
                                     device=dev)
        A = pk.padd_plain(df, g[:, pick()], g[:, pick()])
        B = g[:, pick()].clone()
        A[:, :L // 64] = ident[:, None]          # identity accumulators
        B[:, L // 2:L // 2 + L // 64] = ident[:, None]
        aff = B[:32].contiguous()
        mask = (torch.rand(L, generator=gen, device=dev) < 0.8).to(
            torch.int32)
        signs = (torch.rand(L, generator=gen, device=dev) < 0.5).to(
            torch.int32)
        want = pk.pmixed_masked_plain(df, A, aff, mask, signs)
        ident_b = ((aff[:16] == 0).all(0)
                   & (aff[16:] == ident[16:32, None]).all(0))
        live = int((mask.bool() & ~ident_b).sum())
        out = torch.empty_like(A)

        def call(launch, out=out, A=A, aff=aff, mask=mask, signs=signs, L=L):
            check(launch(df.field_id, out.data_ptr(), A.data_ptr(),
                         aff.data_ptr(), mask.data_ptr(), signs.data_ptr(),
                         L, stream()))
            return out
        bd, by = cs.bound_ms(L * (192 + 128 + 8 + 192),
                             live * 11 * cs.MONT_MULADDS)
        row = {"L": L, "live": live, "bound_ms": bd, "bound_by": by,
               "graph_ms": {}}
        for name, launch in forms:
            out.zero_()
            call(launch)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"[b2] {name} differs from the plain "
                                     f"version at L={L}")
            row["graph_ms"][name] = cs.graph_ms(
                lambda launch=launch: call(launch), 10, calls=20)
        best = min(row["graph_ms"], key=row["graph_ms"].get)
        record.append(row)
        print(f"[b2] L={L} ({live} live): " + ", ".join(
            f"{k} {v:.5f}" for k, v in row["graph_ms"].items())
            + f" ms a launch from a graph (bound {bd:.5f} ms by {by}); "
            f"fastest {best}", flush=True)
    # the threshold rule: the first measured width from which one thread
    # wins at every wider one
    widths = [r["L"] for r in record]
    lane_wins = [r["graph_ms"]["lane"] <= r["graph_ms"]["group"]
                 for r in record]
    at = next((w for i, w in enumerate(widths) if all(lane_wins[i:])), None)
    print(f"[b2] one thread a lane wins at every width from {at}", flush=True)
    return {"widths": record, "lane_from": at}


def double_variants(dev) -> dict:
    """B5 and B6 in every form (csrc/point_kernels.cu's lane and group
    through h2t_pdouble_form, the fixed form, the pair, B6's branch and
    vote builds and the one-thread form with a minimum of blocks) against
    the plain versions bit for bit at every width, each timed per launch
    from a CUDA graph of 20 launches (and by the profiler at
    DOUBLE_WIDTHS), beside its bound; the launches of chip_smoke.py's
    [horner] combine (two lanes) from a graph, with B5 in the fixed form
    and in the form h2t_pdouble picks. One line a width and kernel here;
    returns every number."""
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FP_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    libs = build({"forms": make_variant("forms", CSRC, src,
                                        append=PDOUBLE_FIXED + PAIR_FORM),
                  "branch": make_variant("branch", CSRC, src,
                                         patches=PDOUBLE_BRANCH),
                  "vote": make_variant("vote", CSRC, src,
                                       patches=PDOUBLE_VOTE),
                  "vote_early": make_variant("vote_early", CSRC, src,
                                             patches=PDOUBLE_VOTE_EARLY),
                  **{f"lane_lb{n}": make_variant(f"lane_lb{n}", CSRC, src,
                                                 patches=lane_min_blocks(n))
                     for n in (5, 6, 8)}},
                 "pdouble_")
    sig = cb._ARGTYPES["point_kernels"]
    for lib in libs.values():
        for fn in ("h2t_pdouble_form", "h2t_pdouble_fixed", "h2t_pdouble_pair",
                   "h2t_pdouble", "h2t_padd"):
            if hasattr(lib, fn):
                f = getattr(lib, fn)
                f.argtypes = sig.get(fn, sig["h2t_pdouble_form"])
                f.restype = ctypes.c_int
    forms = libs["forms"]
    # (name, entry, threads a lane, B5 too or B6 alone)
    variants = [("fixed", forms.h2t_pdouble_fixed, 1, True)] + [
        (name, forms.h2t_pdouble_form, t, True)
        for name, t in pk.FORMS.items()] + [
        ("pair", forms.h2t_pdouble_pair, 2, True)] + [
        (f"{name}_{how}", libs[how].h2t_pdouble_form, t, False)
        for how in ("branch", "vote", "vote_early")
        for name, t in pk.FORMS.items()] + [
        (f"lane_lb{n}", libs[f"lane_lb{n}"].h2t_pdouble_form, 1, True)
        for n in (5, 6, 8)]
    df = FP_DEV
    g = pk.points_to_proj(df, native_srs_g(PALLAS, "double-variants", 1024),
                          dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    record = []
    for L in sorted(DOUBLE_WIDTHS + DOUBLE_SWEEP):
        a, _ = cs._ladder_inputs(df, g, L, gen, edge=False)
        want = pk.pdouble_plain(df, a)
        half = (torch.rand(L, generator=gen, device=dev) < 0.5).to(
            torch.int32)
        masks = {"none": None, "half": half}
        if L in DOUBLE_WIDTHS:
            masks.update(ones=torch.ones_like(half),
                         zeros=torch.zeros_like(half))
        out = torch.empty_like(a)
        for what, mask in masks.items():
            live = L if mask is None else int(mask.sum())
            nbytes = L * (2 * 192 + (0 if mask is None else 4))
            bd, by = cs.bound_ms(nbytes, live * 8 * cs.MONT_MULADDS)
            exp = want if mask is None else torch.where(
                mask.bool()[None], want, a)
            row = {"L": L, "mask": what, "live": live, "bound_ms": bd,
                   "bound_by": by, "graph_ms": {}, "profiler_ms": {}}
            for name, entry, t, b5 in variants:
                if mask is None and not b5:
                    continue

                def call(entry=entry, t=t, mask=mask):
                    check(entry(t, df.field_id, out.data_ptr(),
                                a.data_ptr(), 0 if mask is None
                                else mask.data_ptr(), L, stream()))
                out.zero_()
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, exp):
                    raise AssertionError(f"pdouble {name} differs from the "
                                         f"plain version at L={L}, mask "
                                         f"{what}")
                reps = 3 if L >= 1 << 19 else 10
                row["graph_ms"][name] = cs.graph_ms(call, reps, calls=20)
                if L in DOUBLE_WIDTHS:
                    row["profiler_ms"][name] = cs.device_ms(call, 20,
                                                            "pdouble_")
            best = min(row["graph_ms"], key=row["graph_ms"].get)
            record.append(row)
            print(f"[double] L={L} {'B5' if mask is None else 'B6'} mask "
                  f"{what}: " + ", ".join(
                      f"{k} {v:.5f}" for k, v in row["graph_ms"].items())
                  + f" ms a launch from a graph (bound {bd:.5f} ms by {by});"
                  f" fastest {best}", flush=True)
    # [horner]: chip_smoke's device combine of two window sums at k = 14,
    # c B5 launches and one B4 a window, replayed from a graph
    c = mp.pick_c(1 << 14)
    W = -(-256 // c)
    a, _ = cs._ladder_inputs(df, g, 2, gen, edge=False)
    ws = [cs._ladder_inputs(df, g, 2, gen, edge=False)[0] for _ in range(W)]
    bufs = [torch.empty_like(a) for _ in range(2)]
    horner = {}
    for name, entry in (("fixed", forms.h2t_pdouble_fixed),
                        ("source", forms.h2t_pdouble)):
        def combine(entry=entry, name=name):
            acc = a
            for w in range(W):
                for _ in range(c):
                    nxt = bufs[0] if acc is not bufs[0] else bufs[1]
                    args = (df.field_id, nxt.data_ptr(), acc.data_ptr())
                    check(entry(1, *args, 0, 2, stream()) if name == "fixed"
                          else entry(*args, 2, stream()))
                    acc = nxt
                nxt = bufs[0] if acc is not bufs[0] else bufs[1]
                check(forms.h2t_padd(df.field_id, nxt.data_ptr(),
                                     acc.data_ptr(), ws[w].data_ptr(), 2,
                                     stream()))
                acc = nxt
        horner[name] = cs.graph_ms(combine, 10)
    print(f"[double] the [horner] combine, two lanes, c={c}, W={W} ({c * W} "
          f"B5 and {W} B4 launches): " + ", ".join(
              f"{k} {v:.4f}" for k, v in horner.items())
          + " ms a combine from a graph", flush=True)
    return {"widths": record, "horner": horner, "c": c, "W": W}


def main() -> int:
    import json
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: redesign_variants.py needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from halo2_tpu_torch.parallel import profiling
    # chip_smoke.py binds its roofline constants in its own main()
    cs.bound_ms, cs.MONT_MULADDS = profiling.bound_ms, profiling.MONT_MULADDS
    cs.phase_card()
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("glv", "bucket", "ntt", "points",
                                       "double", "b2", "mxu", "gate"))
    ap.add_argument("--json", default=None,
                    help="write every number of the glv, bucket, double, "
                         "b2, mxu and gate groups here")
    ap.add_argument("old", nargs="?", default=None)
    args = ap.parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    dev = torch.device("cuda")
    record = {}
    if args.only in (None, "glv"):
        record["glv"] = glv_variants(dev)
    if args.only in (None, "bucket"):
        record["bucket"] = bucket_variants(dev)
    if args.only in (None, "ntt"):
        ntt_variants(dev, args.old)
    if args.only in (None, "points"):
        point_variants(dev)
    if args.only in (None, "double"):
        record["double"] = double_variants(dev)
    if args.only in (None, "b2"):
        record["b2"] = b2_variants(dev, args.old)
    if args.only in (None, "mxu"):
        record["mxu"] = mxu_variants(dev, args.old)
    if args.only in (None, "gate"):
        record["gate"] = gate_variants(dev, args.old)
    if args.json:
        record["builds"] = BUILD_INFO
        with open(args.json, "w") as fh:
            json.dump(record, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
