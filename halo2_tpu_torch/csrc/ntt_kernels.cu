// Kernel B7: the radix-2 NTT over Pasta scalar fields.
//
// Replaces the TPU routine halo2_tpu/ops/pallas_field.py::ntt_pallas (:169),
// which gathers through the bit-reversal permutation and then runs log n
// stages, each one Pallas multiply (B1) for the twiddle products and XLA
// add/sub chains, one stage per dispatch.
//
// ntt_pass_kernel runs a transform of n <= 2^20 in two launches (one for
// n <= 2^10; ceil(log n / 10) in general), each a pass over the column
// that runs up to 10 stages in shared memory (ops/ntt.py::ntt_passes
// plans them):
//
//   pass 1  stages 1..s0 over contiguous tiles of 2^s0 elements, with the
//           bit-reversal gather fused into the load (the index reversed by
//           __brev, no permutation table read);
//   pass p  stages a+1..a+cnt. For a fixed residue j = i mod 2^a, the
//           elements j + t 2^a (t < 2^cnt) of each higher group form an
//           independent sub-transform: a block takes R = 2^r_log
//           consecutive residues (their 64-byte elements are whole
//           sectors, so the strided loads still use every byte), loads
//           R 2^cnt elements, runs the stages with the twiddles of its
//           residues and writes them back in place.
//
// Between barriers each thread does radix-4 units: four elements in
// registers, two stages of butterflies (four products, two of them
// independent at a time), then one barrier, where the stagewise kernel it
// replaced did one butterfly a thread a barrier; an odd stage count starts with
// one radix-2 stage. Every butterfly is the radix-2 butterfly lo + hi w,
// lo - hi w of ops/ntt.py::ntt_many_plain on the same operands, and
// every field op reduces fully, so the result is bit-identical to it.
// Twiddles are read as packed 32-bit limbs ([n - 1][8] words,
// NttPlan.on), 32 B each, with no repacking per butterfly. Shared memory is limb-major, [8][E + E/32],
// padded a word every 32 elements so that radix-4 units on neighbouring
// elements do not share banks: 33 KB at the largest tile (E = 2^10),
// under the 48 KB a block gets without opting in, so that several blocks
// share an SM.
//
// Bound on an H100: one read and one write of 64 B per element (128 m n
// bytes: 0.040 ms at m = 1, n = 2^20 at 3.35 TB/s) against (n/2) log n
// Montgomery products per column of 224 32-bit multiply-adds each
// (0.070 ms at 33.5e12/s): arithmetic bounds it at 2^20. Two passes move
// 256 m n bytes of column traffic, where the stagewise form this kernel
// replaced (a tile kernel for the first ten stages, then one launch per
// stage: 1 + log n - 10 launches) moved 128 m n (1 + log n - 10). At
// 2^16 and m = 1 the plan splits 8 + 8 stages, so each pass has 256
// blocks for the 132 SMs (the stagewise tile kernel had 64). On an H100
// (NVIDIA H100 80GB HBM3, 700 W) this halved the time (0.042 against
// 0.069 ms at 2^16, 0.47 against 0.90 ms at 2^20; PERF.md); what is left
// is latency at 2^16 (2^14 threads a pass) and the products at 2^20
// (6.7x the operation bound). A carry-chain product in PTX
// (mad.lo.cc / madc.hi.cc) was tried and ran 5-9% slower; the kernel
// keeps mont_mul.
#include "field.cuh"

using namespace h2t;

static const int kMaxPassLog = 10;      // a pass tile of at most 2^10 elements
static const int kPassThreads = 256;

// shared-memory word of element u in a limb row (one pad word per 32)
__device__ __forceinline__ uint32_t spad(uint32_t u) { return u + (u >> 5); }

__device__ __forceinline__ void load_tw(uint32_t w[8], const uint4* tw,
                                        uint32_t row) {
  const uint4 a = tw[2 * row], b = tw[2 * row + 1];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void sm_load(uint32_t r[8], const uint32_t* sm,
                                        uint32_t P, uint32_t u) {
#pragma unroll
  for (int l = 0; l < 8; l++) r[l] = sm[l * P + spad(u)];
}

__device__ __forceinline__ void sm_store(uint32_t* sm, uint32_t P, uint32_t u,
                                         const uint32_t r[8]) {
#pragma unroll
  for (int l = 0; l < 8; l++) sm[l * P + spad(u)] = r[l];
}

// lo, hi <- lo + hi w, lo - hi w
template <int F>
__device__ __forceinline__ void butterfly(uint32_t lo[8], uint32_t hi[8],
                                          const uint32_t w[8]) {
  uint32_t t[8];
  mont_mul<F>(t, hi, w);
  sub<F>(hi, lo, t);
  add<F>(lo, lo, t);
}

// One pass: stages a+1 .. a+cnt of every column of x [m, n, 16] into out
// (x may be out). Block -> (column, higher group h, residue group g); its
// local element u = r + R t (r < R = 2^r_log, t < 2^cnt) is the global
// element g R + r + t 2^a + h 2^(a + cnt). gather: read element i from
// x[brev(i)] (the first pass).
template <int F>
__global__ void __launch_bounds__(kPassThreads)
ntt_pass_kernel(int32_t* out, const int32_t* x, const uint4* __restrict__ tw,
                uint32_t log_n, uint32_t a, uint32_t cnt, uint32_t r_log,
                int gather) {
  extern __shared__ uint32_t sm[];
  const uint32_t E = 1u << (r_log + cnt);
  const uint32_t P = spad(E);
  const uint32_t n = 1u << log_n;
  const uint32_t groups = 1u << (a - r_log);
  const uint32_t highs = 1u << (log_n - a - cnt);
  uint32_t b = blockIdx.x;
  const uint32_t g = b % groups;
  b /= groups;
  const uint32_t h = b % highs;
  const uint32_t col = b / highs;
  const uint32_t rmask = (1u << r_log) - 1;
  const uint32_t base = (g << r_log) + (h << (a + cnt));
  const size_t off = (size_t)col * n * 16;
#define GIDX(u) (base + ((u) & rmask) + (((u) >> r_log) << a))
  const uint32_t tid = threadIdx.x, bd = blockDim.x;

  for (uint32_t u = tid; u < E; u += bd) {
    const uint32_t i = GIDX(u);
    const uint32_t j = gather ? __brev(i) >> (32 - log_n) : i;
    uint32_t r[8];
    load_digits(r, x + off + (size_t)j * 16);
    sm_store(sm, P, u, r);
  }
  __syncthreads();

  uint32_t sp = 1;  // the pass's next stage, 1-based
  if (cnt & 1) {
    // one radix-2 stage (stage a + 1)
    const uint32_t half = 1u << a;
    for (uint32_t q = tid; q < E / 2; q += bd) {
      const uint32_t u0 = (q & rmask) | ((q >> r_log) << (r_log + 1));
      uint32_t e0[8], e1[8], w[8];
      sm_load(e0, sm, P, u0);
      sm_load(e1, sm, P, u0 + (1u << r_log));
      load_tw(w, tw, half - 1 + (GIDX(u0) & (half - 1)));
      butterfly<F>(e0, e1, w);
      sm_store(sm, P, u0, e0);
      sm_store(sm, P, u0 + (1u << r_log), e1);
    }
    __syncthreads();
    sp = 2;
  }
  for (; sp < cnt; sp += 2) {
    // radix-4 units: stages s = a + sp and s + 1
    const uint32_t LS = r_log + sp - 1, ls = 1u << LS;
    const uint32_t half = 1u << (a + sp - 1);
    for (uint32_t q = tid; q < E / 4; q += bd) {
      const uint32_t u0 = (q & (ls - 1)) | ((q >> LS) << (LS + 2));
      const uint32_t jj = GIDX(u0) & (half - 1);
      uint32_t e0[8], e1[8], e2[8], e3[8], w[8];
      sm_load(e0, sm, P, u0);
      sm_load(e1, sm, P, u0 + ls);
      sm_load(e2, sm, P, u0 + 2 * ls);
      sm_load(e3, sm, P, u0 + 3 * ls);
      load_tw(w, tw, half - 1 + jj);
      butterfly<F>(e0, e1, w);
      butterfly<F>(e2, e3, w);
      load_tw(w, tw, 2 * half - 1 + jj);
      butterfly<F>(e0, e2, w);
      load_tw(w, tw, 2 * half - 1 + jj + half);
      butterfly<F>(e1, e3, w);
      sm_store(sm, P, u0, e0);
      sm_store(sm, P, u0 + ls, e1);
      sm_store(sm, P, u0 + 2 * ls, e2);
      sm_store(sm, P, u0 + 3 * ls, e3);
    }
    __syncthreads();
  }

  for (uint32_t u = tid; u < E; u += bd) {
    uint32_t r[8];
    sm_load(r, sm, P, u);
    store_digits(out + off + (size_t)GIDX(u) * 16, r);
  }
#undef GIDX
}

// One pass of the two-pass form over m columns of n = 2^log_n (m n < 2^31):
// stages a+1 .. a+cnt (1 <= cnt, a + cnt <= log_n), R = 2^r_log residues a
// block (r_log <= a), r_log + cnt <= 10; gather != 0 for the first pass
// (a = 0), which reads x through the bit reversal; later passes run in
// place (x == out). tw: the plan's packed twiddles, [n - 1][8] words.
// Returns cudaGetLastError() after the launch.
extern "C" int h2t_ntt_pass(int field, void* out, const void* x,
                            const void* tw, long long m, int log_n, int a,
                            int cnt, int r_log, int gather, void* stream) {
  if (m <= 0) return 0;
  if (log_n < 1 || log_n > 30 || cnt < 1 || a < 0 || a + cnt > log_n ||
      r_log < 0 || r_log > a || r_log + cnt > kMaxPassLog ||
      (gather && a != 0) || ((long long)m << log_n) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const uint32_t E = 1u << (r_log + cnt);
  const size_t smem = (size_t)8 * (E + (E >> 5)) * sizeof(uint32_t);
  const uint32_t units = E / 4 > 0 ? E / 4 : 1;
  const uint32_t threads =
      units < 32 ? 32 : (units > kPassThreads ? kPassThreads : units);
  const long long blocks = m << (log_n - r_log - cnt);
  auto k = field ? ntt_pass_kernel<1> : ntt_pass_kernel<0>;
  k<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)x, (const uint4*)tw, (uint32_t)log_n,
      (uint32_t)a, (uint32_t)cnt, (uint32_t)r_log, gather);
  return (int)cudaGetLastError();
}
