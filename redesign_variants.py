#!/usr/bin/env python3
"""Time build variants of the redesigned kernels on one NVIDIA GPU, each
beside the source as it is, in one process.

Copies of csrc/ are patched and built side by side under the gitignored
halo2_tpu_torch/_build/variants/:

  the bucket-run kernel (csrc/point_kernels.cu::pmixed_bucket_runs_kernel),
  a whole commit's bucket phase at a k = 14 advice commit's 26,624 lanes
  and a k = 18 commit's 163,840 (two columns of random scalars over 2^k
  PALLAS bases, 2^14 native SRS points repeated):
    call       the source: every Montgomery product a call (mont_mul_call)
    inline     the products inlined, as the one-step kernels have them
    call_cc, inline_cc
               the same with the carry-chain product MONT_MUL_CC (PTX
               mad.lo.cc / madc.hi.cc) in place of mont_mul
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

Every variant's output must equal the source's bit for bit (B7's also
the plain version's). Each is timed from a CUDA graph and by
torch.profiler (chip_smoke.py's graph_ms and device_ms); per variant the
timed kernel's registers (nvcc -Xptxas -v) and SASS instructions
(cuobjdump -sass).

Run from the repository root (--only runs one of the three groups):
    python3 redesign_variants.py [--only bucket|ntt|points] [OLD_CHECKOUT]
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

INLINE_CALL = "rcb_mixed_add<F, true>(r2, acc, x2, y2)"

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
                 inline: bool = False, patches=(), append: str = "") -> str:
    """Copy field.cuh and `source` from the directory src to OUT/name,
    patched: cc puts MONT_MUL_CC in place of every mont_mul of the source,
    inline inlines the bucket-run kernel's products, each (old, new) of
    `patches` replaces old (which must be there) with new, and `append`
    goes at the end."""
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
    if inline:
        assert INLINE_CALL in s
        s = s.replace(INLINE_CALL, INLINE_CALL.replace("true", "false"))
    for a, b in patches:
        assert a in s, a
        s = s.replace(a, b)
    s += append
    with open(os.path.join(d, "field.cuh"), "w") as fh:
        fh.write(hdr)
    with open(os.path.join(d, source), "w") as fh:
        fh.write(s)
    return os.path.join(d, source)


def build(variants: dict, kernel) -> dict:
    """{name: .cu path} -> {name: loaded library}, one nvcc each started
    together; prints the registers and SASS size of the Fp instance of each
    kernel whose name holds `kernel` (a fragment or a tuple of them)."""
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
        for i, line in enumerate(lines):
            if "entry function" in line and "ILi0E" in line and \
                    any(k in line for k in kernel):
                print(f"[{name}] " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]))
        for fn, count in cs.sass_counts(so).items():
            if "ILi0E" in fn and any(k in fn for k in kernel):
                print(f"[{name}] {fn}: {count} SASS instructions")
        libs[name] = ctypes.CDLL(so)
    return libs


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA launch failed: cudaError {rc}")


def bucket_variants(dev) -> None:
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import DeviceField
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    libs = build({"call": make_variant("call", CSRC, src),
                  "inline": make_variant("inline", CSRC, src, inline=True),
                  "call_cc": make_variant("call_cc", CSRC, src, cc=True),
                  "inline_cc": make_variant("inline_cc", CSRC, src, cc=True,
                                            inline=True)},
                 "pmixed_bucket_runs_kernel")
    for lib in libs.values():
        f = lib.h2t_pmixed_bucket_runs
        f.argtypes = cb._ARGTYPES["point_kernels"]["h2t_pmixed_bucket_runs"]
        f.restype = ctypes.c_int
    df = DeviceField(PALLAS.base)
    aff14 = pk.points_to_proj(df, native_srs_g(PALLAS, "bucket-variants",
                                               1 << 14), dev)[:32]
    for k in (14, 18):
        n = 1 << k
        aff = aff14.repeat(1, n >> 14).contiguous()
        gen = torch.Generator(device=dev).manual_seed(k)
        digits = torch.randint(0, 1 << 16, (2, n, 16), generator=gen,
                               device=dev, dtype=torch.int32)
        digits[..., 15] >>= 2                    # below 2^254 < q
        runs = mp.bucket_runs(PALLAS, digits, mp.pick_c(n))
        packed = pk.pack_affine(aff)
        members = pk.bucket_members(runs.order, runs.sg)
        starts = runs.starts_e.reshape(-1).to(torch.int32).contiguous()
        counts = runs.counts_e.reshape(-1).to(torch.int32).contiguous()
        L = starts.shape[0]
        want = None
        for name, lib in libs.items():
            out = torch.empty((48, L), dtype=torch.int32, device=dev)

            def fn(lib=lib, out=out):
                check(lib.h2t_pmixed_bucket_runs(
                    df.field_id, out.data_ptr(), packed.data_ptr(),
                    members.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    runs.BL, n, L, stream()))
            g = cs.graph_ms(fn, 5)
            p = cs.device_ms(fn, 5, "pmixed_bucket_runs_kernel")
            torch.cuda.synchronize()
            want = out.clone() if want is None else want
            same = torch.equal(out, want)
            print(f"[bucket] k={k} L={L} runs up to {int(counts.max())} "
                  f"{name}: {g:.5f} ms from a CUDA graph, {p:.5f} ms by the "
                  f"profiler (equal to call: {same})")
            if not same:
                raise AssertionError(f"{name} differs at k={k}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: redesign_variants.py needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    cs.phase_card()
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("bucket", "ntt", "points"))
    ap.add_argument("old", nargs="?", default=None)
    args = ap.parse_args()
    shutil.rmtree(OUT, ignore_errors=True)
    dev = torch.device("cuda")
    if args.only in (None, "bucket"):
        bucket_variants(dev)
    if args.only in (None, "ntt"):
        ntt_variants(dev, args.old)
    if args.only in (None, "points"):
        point_variants(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
