// Kernel B1: the elementwise 255-bit Montgomery multiply, and the modular
// add/subtract that runs beside it; kernel B8, the same multiply on the
// limbs-first layout (below).
//
// B1 replaces the TPU kernel halo2_tpu/ops/pallas_field.py::_mont_mul_kernel
// (built at :76/:94, wrapped by fmul_pallas at :105), which the JAX package
// computes bit-identically in jnp at halo2_tpu/fields/device.py:375. The
// add/subtract replaces the jnp limb chains of fields/device.py:335/:354
// (no Pallas kernel there; plain torch would be ~60 launches per add).
//
// Layout: field tensors are [..., 16] int32 16-bit digits, element-major
// (64 bytes per element). One thread per output element: four 16-byte
// loads per operand, pack to 8 x 32-bit limbs, CIOS with 64-bit partial
// products, conditional subtract, unpack, four 16-byte stores.
//
// Bound on an H100: per element B1 moves 192 bytes (two operands read, one
// result written: 57 ps at 3.35 TB/s) and does 112 32x32->64 products (64
// for a*b, 48 for the reduction, which skips the three zero limbs of p),
// i.e. 224 32-bit multiply-adds: 13.4 ps at the card's 16.7e12 integer
// multiply-adds/s (64 a clock an SM, half the float rate; chip_smoke.py
// [peak] measures it). So by that count B1 is bytes-bound at full width;
// its SASS puts about 250 instructions a product on the IMAD pipe (moves
// and carries among them), which brings the two bounds within a factor of
// a few. The design keeps
// every limb in registers, reads each operand exactly once with 16-byte
// vector loads, and indexes a broadcast operand (a scalar, a twiddle row)
// modulo its period instead of materialising it.
#include "field.cuh"

using namespace h2t;

template <int F>
__global__ void fmul_kernel(int32_t* __restrict__ out,
                            const int32_t* __restrict__ a,
                            const int32_t* __restrict__ b, uint32_t n,
                            uint32_t a_period, uint32_t b_period) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load_digits(x, a + (size_t)(i % a_period) * 16);
  load_digits(y, b + (size_t)(i % b_period) * 16);
  mont_mul<F>(r, x, y);
  store_digits(out + (size_t)i * 16, r);
}

template <int F>
__global__ void faddsub_kernel(int32_t* __restrict__ out,
                               const int32_t* __restrict__ a,
                               const int32_t* __restrict__ b, uint32_t n,
                               uint32_t a_period, uint32_t b_period, int op) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load_digits(x, a + (size_t)(i % a_period) * 16);
  load_digits(y, b + (size_t)(i % b_period) * 16);
  if (op == 0)
    add<F>(r, x, y);
  else
    sub<F>(r, x, y);
  store_digits(out + (size_t)i * 16, r);
}

// Kernel B8: B1's product on the limbs-first layout [16, N] (row i holds
// digit i of every element), the Hopper counterpart of the TPU layout
// benchmark scripts/bench_fmul3d.py::kernel3d (:29, pallas_call :71). Same
// CIOS, one thread per element; a warp reads 128 contiguous bytes per digit
// row instead of B1's 64 contiguous bytes per thread. No proving path
// calls it: chip_smoke.py times it beside B1 to decide the port's layout.
template <int F>
__global__ void fmul_limbs_first_kernel(int32_t* __restrict__ out,
                                        const int32_t* __restrict__ a,
                                        const int32_t* __restrict__ b,
                                        uint32_t n) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load_rows(x, a + i, n);
  load_rows(y, b + i, n);
  mont_mul<F>(r, x, y);
  store_rows(out + i, n, r);
}

static const int kThreads = 256;

extern "C" int h2t_fmul_limbs_first(int field, void* out, const void* a,
                                    const void* b, long long n,
                                    void* stream) {
  if (n <= 0) return 0;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    fmul_limbs_first_kernel<0><<<grid, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)n);
  else
    fmul_limbs_first_kernel<1><<<grid, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)n);
  return (int)cudaGetLastError();
}

extern "C" int h2t_fmul(int field, void* out, const void* a, const void* b,
                        long long n, long long a_period, long long b_period,
                        void* stream) {
  if (n <= 0) return 0;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    fmul_kernel<0><<<grid, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)n,
        (uint32_t)a_period, (uint32_t)b_period);
  else
    fmul_kernel<1><<<grid, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)n,
        (uint32_t)a_period, (uint32_t)b_period);
  return (int)cudaGetLastError();
}

extern "C" int h2t_faddsub(int field, int op, void* out, const void* a,
                           const void* b, long long n, long long a_period,
                           long long b_period, void* stream) {
  if (n <= 0) return 0;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (field == 0)
    faddsub_kernel<0><<<grid, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)n,
        (uint32_t)a_period, (uint32_t)b_period, op);
  else
    faddsub_kernel<1><<<grid, kThreads, 0, s>>>(
        (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)n,
        (uint32_t)a_period, (uint32_t)b_period, op);
  return (int)cudaGetLastError();
}
