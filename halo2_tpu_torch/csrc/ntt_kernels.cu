// Kernel B7: the radix-2 NTT over Pasta scalar fields.
//
// Replaces the TPU routine halo2_tpu/ops/pallas_field.py::ntt_pallas (:169),
// which gathers through the bit-reversal permutation and then runs log n
// stages, each one Pallas multiply (B1) for the twiddle products and XLA
// add/sub chains, one stage per dispatch. Here the whole transform is
// 1 + log n - s0 launches, s0 = min(log n, 10) (ops/ntt.py::TILE_LOG):
//
//   ntt_tile_kernel   one block per tile of T = 2^s0 elements of one
//                     column: the bit-reversal gather fused into the
//                     load, stages 1..s0 in shared memory (8 x 32-bit
//                     limbs per element, limb-major so that
//                     neighbouring threads hit neighbouring banks; 32 KB at
//                     T = 1024), one write back;
//   ntt_stage_kernel  one launch per later stage s: one thread per
//                     butterfly of every column, lo + hi*w and lo - hi*w in
//                     place.
//
// Layout: x is [m, n, 16] int32 16-bit Montgomery digits (the port's field
// layout); the twiddles of stage s (2^(s-1) of them) sit at rows
// 2^(s-1) - 1 .. 2^s - 2 of one [n - 1, 16] table; perm is the plan's
// bit-reversal index (int64). Every field op reduces fully, so the result
// is bit-identical to the stage loop of ops/ntt.py::ntt_many_plain.
//
// Bound on an H100: one read and one write of 64 B per element (128 m n
// bytes: 0.040 ms at m = 1, n = 2^20 at 3.35 TB/s) against (n/2) log n
// Montgomery products per column of 224 32-bit multiply-adds each
// (0.070 ms at 33.5e12/s): arithmetic bounds it at 2^20. The later stages
// each read and write the whole column again (log n - s0 extra passes),
// which keeps them near the byte rate; the tile kernel's stages cost no
// device-memory traffic.
#include "field.cuh"

using namespace h2t;

static const int kMaxTileLog = 10;     // 32 KB of shared memory
static const int kStageThreads = 256;

template <int F>
__global__ void __launch_bounds__(512)
ntt_tile_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ x,
                const long long* __restrict__ perm,
                const int32_t* __restrict__ tw, uint32_t n, int log_tile) {
  extern __shared__ uint32_t sm[];              // [8][T] limbs
  const uint32_t T = 1u << log_tile;
  const uint32_t tiles = n >> log_tile;
  const uint32_t col = blockIdx.x / tiles;
  const uint32_t base = (blockIdx.x % tiles) << log_tile;
  const int32_t* src = x + (size_t)col * n * 16;
  int32_t* dst = out + (size_t)col * n * 16;

  for (uint32_t i = threadIdx.x; i < T; i += blockDim.x) {
    uint32_t r[8];
    load_digits(r, src + (size_t)perm[base + i] * 16);
#pragma unroll
    for (int l = 0; l < 8; l++) sm[l * T + i] = r[l];
  }
  __syncthreads();

  for (int s = 1; s <= log_tile; s++) {
    const uint32_t half = 1u << (s - 1);
    for (uint32_t b = threadIdx.x; b < T / 2; b += blockDim.x) {
      const uint32_t j = b & (half - 1);
      const uint32_t lo = ((b >> (s - 1)) << s) | j;
      const uint32_t hi = lo + half;
      uint32_t a[8], h[8], w[8], t[8];
#pragma unroll
      for (int l = 0; l < 8; l++) {
        a[l] = sm[l * T + lo];
        h[l] = sm[l * T + hi];
      }
      load_digits(w, tw + (size_t)(half - 1 + j) * 16);
      mont_mul<F>(t, h, w);
      add<F>(h, a, t);
      sub<F>(a, a, t);
#pragma unroll
      for (int l = 0; l < 8; l++) {
        sm[l * T + lo] = h[l];
        sm[l * T + hi] = a[l];
      }
    }
    __syncthreads();
  }

  for (uint32_t i = threadIdx.x; i < T; i += blockDim.x) {
    uint32_t r[8];
#pragma unroll
    for (int l = 0; l < 8; l++) r[l] = sm[l * T + i];
    store_digits(dst + (size_t)(base + i) * 16, r);
  }
}

template <int F>
__global__ void __launch_bounds__(kStageThreads)
ntt_stage_kernel(int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                 uint32_t n, int s, uint32_t total) {
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= total) return;
  const uint32_t halfn = n >> 1;
  const uint32_t col = b / halfn;
  const uint32_t r = b - col * halfn;
  const uint32_t half = 1u << (s - 1);
  const uint32_t j = r & (half - 1);
  const uint32_t lo = ((r >> (s - 1)) << s) | j;
  int32_t* p = x + (size_t)col * n * 16;
  uint32_t a[8], h[8], w[8], t[8];
  load_digits(a, p + (size_t)lo * 16);
  load_digits(h, p + (size_t)(lo + half) * 16);
  load_digits(w, tw + (size_t)(half - 1 + j) * 16);
  mont_mul<F>(t, h, w);
  add<F>(h, a, t);
  sub<F>(a, a, t);
  store_digits(p + (size_t)lo * 16, h);
  store_digits(p + (size_t)(lo + half) * 16, a);
}

template <int F>
static int ntt_launch(int32_t* out, const int32_t* x, const long long* perm,
                      const int32_t* tw, uint32_t m, int log_n, int log_tile,
                      cudaStream_t s) {
  const uint32_t n = 1u << log_n;
  const uint32_t T = 1u << log_tile;
  const uint32_t threads = T / 2 < 512 ? (T / 2 > 0 ? T / 2 : 1) : 512;
  const size_t smem = (size_t)8 * T * sizeof(uint32_t);
  ntt_tile_kernel<F><<<m * (n >> log_tile), threads, smem, s>>>(
      out, x, perm, tw, n, log_tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint32_t total = m * (n >> 1);
  const uint32_t blocks = (total + kStageThreads - 1) / kStageThreads;
  for (int st = log_tile + 1; st <= log_n; st++) {
    ntt_stage_kernel<F><<<blocks, kStageThreads, 0, s>>>(out, tw, n, st,
                                                         total);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// out[m, n, 16] = NTT of x[m, n, 16] along n (n = 2^log_n, m * n < 2^31)
// with the first log_tile stages in shared memory (1 <= log_tile <=
// min(log_n, 10)); returns the first non-zero cudaGetLastError() of its
// 1 + log_n - log_tile launches
extern "C" int h2t_ntt(int field, void* out, const void* x, const void* perm,
                       const void* tw, long long m, int log_n, int log_tile,
                       void* stream) {
  if (m <= 0) return 0;
  if (log_tile < 1 || log_tile > kMaxTileLog || log_tile > log_n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    return ntt_launch<0>((int32_t*)out, (const int32_t*)x,
                         (const long long*)perm, (const int32_t*)tw,
                         (uint32_t)m, log_n, log_tile, s);
  return ntt_launch<1>((int32_t*)out, (const int32_t*)x,
                       (const long long*)perm, (const int32_t*)tw,
                       (uint32_t)m, log_n, log_tile, s);
}
