// The card's peak rate of 32-bit integer multiply-adds: a microbenchmark
// of independent chains, the instruction mix of the field kernels' products
// (IMAD, IMAD.HI, IMAD.WIDE), and a float FMA chain beside them as the
// control. It replaces no TPU kernel; chip_smoke.py's [peak] phase times it
// and from it sets the "operations" bound of every kernel (MULADD_PER_S).
//
// Each thread runs CHAINS independent chains of `iters` steps; each step is
// one instruction of the mode's kind, dependent on the chain's last:
//   mode 0  x = x * m + c            IMAD        (one 32-bit result)
//   mode 1  x = hi(x * m) + x        IMAD.HI     (one 32-bit result)
//   mode 2  w = hi32(w) * m + w      IMAD.WIDE   (a 64-bit result: two)
//   mode 3  f = f * g + h            FFMA        (the float control)
// m, c, g and h come from the caller, so nothing folds at compile time, and
// every chain's end is written out, so nothing is dead.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;

template <int MODE>
__global__ void peak_kernel(uint32_t* __restrict__ out, int iters,
                            uint32_t m, uint32_t c) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t x[CHAINS];
  uint64_t w[CHAINS];
  float f[CHAINS];
  const float g = __uint_as_float(0x3f7ffff0u ^ (m & 7u));  // just below 1
  const float h = __uint_as_float(0x3a800000u ^ (c & 7u));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    x[j] = t * 0x9e3779b9u + j;
    w[j] = ((uint64_t)x[j] << 32) | (x[j] ^ c);
    f[j] = (float)(x[j] & 0xffffu);
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (MODE == 0) {
        x[j] = x[j] * m + c;
      } else if (MODE == 1) {
        x[j] = __umulhi(x[j], m) + x[j];
      } else if (MODE == 2) {
        w[j] = (uint64_t)(uint32_t)(w[j] >> 32) * m + w[j];
      } else {
        f[j] = fmaf(f[j], g, h);
      }
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    acc ^= MODE == 2 ? (uint32_t)(w[j] ^ (w[j] >> 32))
           : MODE == 3 ? __float_as_uint(f[j]) : x[j];
  }
  out[t] = acc;
}

}  // namespace

extern "C" {

// One launch of mode `mode` (0-3) over blocks x threads threads; out holds
// blocks * threads words. Returns cudaGetLastError().
int h2t_peak(int mode, void* out, int iters, unsigned m, unsigned c,
             int blocks, int threads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  switch (mode) {
    case 0: peak_kernel<0><<<blocks, threads, 0, s>>>(o, iters, m, c); break;
    case 1: peak_kernel<1><<<blocks, threads, 0, s>>>(o, iters, m, c); break;
    case 2: peak_kernel<2><<<blocks, threads, 0, s>>>(o, iters, m, c); break;
    default: peak_kernel<3><<<blocks, threads, 0, s>>>(o, iters, m, c); break;
  }
  return (int)cudaGetLastError();
}

// Steps (instructions) per thread of one launch: iters * CHAINS.
int h2t_peak_chains() { return CHAINS; }

}  // extern "C"
