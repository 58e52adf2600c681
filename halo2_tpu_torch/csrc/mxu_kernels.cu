// Kernel K1: Montgomery products by constants shared across a group of
// lanes, on the tensor cores, with the NTT butterfly fused.
//
// Replaces halo2_tpu/ops/mxu_field.py:98-121 (mul_const_grouped: an XLA
// dot_general of 8-bit digits [G, nb, 32] @ [G, 32, 63] on the TPU's
// MXU; no Pallas call) and the butterfly around it in the four-step NTT
// (:175-194). When every lane of a group multiplies by one constant c,
// the digit-product columns cols[k] = sum_{i+j=k} a_i c_j are a matrix
// product A[lanes, 32] @ W_c[32, 63] with W_c[i][i+j] = c_j, the band of
// c's 8-bit digits.
//
// Here the product is mma.sync.m16n8k32 on u8 digits with s32 sums: a
// column sums at most 32 products of at most 255^2, so below 2^21, and
// every sum is exact. A warp takes 32 lanes of one group (two m16 tiles;
// a group of fewer lanes, or not a multiple of 32, pads its tiles with
// zero rows) and runs up to kChunks such chunks with one constant. The
// lane's 32 bytes are the A tile, read straight from its 16-bit digits
// (bytes 4t..4t+3 of an element are its 32-bit limb t). The band never
// exists in memory: each thread builds its B fragments of the 8 column
// tiles (64 columns, the last one zero) from the constant's 32 bytes,
// staged between zero bytes in shared memory. The 8 x 2 products of a
// chunk land in shared memory as [32 lanes][64 columns]; each thread then
// carries its lane's 64 columns of weight 2^8 into a 512-bit product,
// runs the Montgomery reduction (the REDC half of field.cuh::mont_mul) on
// the CUDA cores, and, for a butterfly, writes lo + t and lo - t. Every
// result is canonical (< p), bit-identical to B1 and the add/subtract.
//
// Lane q of group j is element (q / L) * stride_b + j * stride_j + q % L
// (the lo element of a butterfly; its hi element hi_off further). One
// launch runs one NTT stage (groups = the stage's twiddles) or one
// grouped product. A stage may run in place: each lane's elements are
// read and written by one warp, its loads before its stores.
//
// Bound: bytes. A butterfly reads and writes two elements (256 bytes)
// against 96 multiply-adds of reduction on the CUDA cores.
#include "field.cuh"

namespace {

using namespace h2t;

constexpr int kWarps = 4;     // warps a block
constexpr int kChunks = 4;    // 32-lane chunks a warp runs with one constant
constexpr int kRow = 65;      // words a staged row of column sums (padded)

// D (16x8, s32) = A (16x32, u8, row) x B (32x8, u8, col)
__device__ __forceinline__ void mma_u8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// limbs w and w + 4 of the element at src (digits 2w, 2w + 1 and
// 2w + 8, 2w + 9): the A fragment's bytes 4w..4w+3 and 16+4w..19+4w
__device__ __forceinline__ void load_limb_pair(uint32_t& lo, uint32_t& hi,
                                               const int32_t* src, int w) {
  int2 v0 = *reinterpret_cast<const int2*>(src + 2 * w);
  int2 v1 = *reinterpret_cast<const int2*>(src + 8 + 2 * w);
  lo = (uint32_t)v0.x | ((uint32_t)v0.y << 16);
  hi = (uint32_t)v1.x | ((uint32_t)v1.y << 16);
}

// 64 column sums of weight 2^8 (each < 2^21) -> T as 16 32-bit limbs,
// then T R^-1 mod p, fully reduced (T < p^2)
template <int F>
__device__ __forceinline__ void reduce_cols(uint32_t r[8], const int* s) {
  uint32_t w[17];
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < 16; i++) {
    acc += (uint64_t)(uint32_t)s[4 * i] +
           ((uint64_t)(uint32_t)s[4 * i + 1] << 8) +
           ((uint64_t)(uint32_t)s[4 * i + 2] << 16) +
           ((uint64_t)(uint32_t)s[4 * i + 3] << 24);
    w[i] = (uint32_t)acc;
    acc >>= 32;
  }
  w[16] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t m = w[i] * N0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint32_t pj = Field<F>::p(j);
      uint64_t t = (pj ? (uint64_t)m * pj : 0ull) + w[i + j] + c;
      w[i + j] = (uint32_t)t;
      c = t >> 32;
    }
#pragma unroll
    for (int j = i + 8; j < 17; j++) {
      uint64_t t = (uint64_t)w[j] + c;
      w[j] = (uint32_t)t;
      c = t >> 32;
    }
  }
  // (T + m p) / R = w[8..16] < 2p
  uint32_t d[8], p[8];
  load_p<F>(p);
  uint32_t br = sub_raw(d, w + 8, p);
  bool use_d = (w[16] != 0) | (br == 0);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = use_d ? d[i] : w[8 + i];
}

template <int F>
__global__ void __launch_bounds__(kWarps * 32)
mxu_const_mul_kernel(int32_t* dst, const int32_t* src,
                     const int32_t* __restrict__ consts, long long groups,
                     long long lanes, long long L, long long stride_b,
                     long long stride_j, long long hi_off, int butterfly,
                     long long warps_per_group) {
  __shared__ uint8_t cz_all[kWarps][96];
  __shared__ int sums_all[kWarps][32 * kRow];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= groups * warps_per_group) return;   // the whole warp
  const long long j = gw / warps_per_group;
  const long long chunk0 = (gw % warps_per_group) * kChunks;
  uint8_t* cz = cz_all[warp];
  int* sums = sums_all[warp];

  // the constant's 32 bytes at cz[32..63], zeros on either side
  cz[lane] = 0;
  cz[64 + lane] = 0;
  if (lane < 16) {
    uint32_t d = (uint32_t)consts[j * 16 + lane];
    cz[32 + 2 * lane] = (uint8_t)(d & 0xffu);
    cz[33 + 2 * lane] = (uint8_t)(d >> 8);
  }
  __syncwarp();
  // B fragments: thread (g, t) holds rows k = 4t..4t+3 (b0) and
  // 16+4t..19+4t (b1) of column 8T + g of the band, W[k][col] =
  // c8[col - k] = cz[32 + col - k]
  const int g = lane >> 2, t = lane & 3;
  uint32_t b[8][2];
#pragma unroll
  for (int T = 0; T < 8; T++) {
#pragma unroll
    for (int h = 0; h < 2; h++) {
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 4; e++) {
        int k = 16 * h + 4 * t + e;
        v |= (uint32_t)cz[32 + 8 * T + g - k] << (8 * e);
      }
      b[T][h] = v;
    }
  }
  const long long in_off = butterfly ? hi_off : 0;

  for (int c = 0; c < kChunks; c++) {
    const long long q0 = (chunk0 + c) * 32;
    if (q0 >= lanes) break;                   // uniform across the warp
    // A fragments of the chunk's two 16-row tiles: thread (g, t) holds
    // rows g and g + 8, bytes 4t..4t+3 (a0, a1) and 16+4t..19+4t (a2, a3)
    uint32_t a[2][4];
#pragma unroll
    for (int M = 0; M < 2; M++) {
#pragma unroll
      for (int rr = 0; rr < 2; rr++) {
        const long long q = q0 + 16 * M + g + 8 * rr;
        uint32_t lo = 0, hi = 0;
        if (q < lanes) {
          const long long e =
              (q / L) * stride_b + j * stride_j + q % L + in_off;
          load_limb_pair(lo, hi, src + e * 16, t);
        }
        a[M][rr] = lo;
        a[M][2 + rr] = hi;
      }
    }
#pragma unroll
    for (int M = 0; M < 2; M++) {
#pragma unroll
      for (int T = 0; T < 8; T++) {
        int d[4];
        mma_u8(d, a[M], b[T][0], b[T][1]);
        // D: thread (g, t) holds rows g, g + 8, columns 8T + 2t, 8T + 2t + 1
        int* r0 = sums + (16 * M + g) * kRow + 8 * T + 2 * t;
        int* r1 = r0 + 8 * kRow;
        r0[0] = d[0];
        r0[1] = d[1];
        r1[0] = d[2];
        r1[1] = d[3];
      }
    }
    __syncwarp();
    const long long q = q0 + lane;
    if (q < lanes) {
      uint32_t prod[8];
      reduce_cols<F>(prod, sums + lane * kRow);
      const long long e = (q / L) * stride_b + j * stride_j + q % L;
      if (butterfly) {
        uint32_t lo[8], s[8], dd[8];
        load_digits(lo, src + e * 16);
        add<F>(s, lo, prod);
        sub<F>(dd, lo, prod);
        store_digits(dst + e * 16, s);
        store_digits(dst + (e + hi_off) * 16, dd);
      } else {
        store_digits(dst + e * 16, prod);
      }
    }
    __syncwarp();                             // sums free for the next chunk
  }
}

}  // namespace

extern "C" int h2t_mxu_const_mul(int field, void* dst, const void* src,
                                 const void* consts, long long groups,
                                 long long lanes, long long L,
                                 long long stride_b, long long stride_j,
                                 long long hi_off, int butterfly,
                                 void* stream) {
  const long long chunks = (lanes + 31) / 32;
  const long long wpg = (chunks + kChunks - 1) / kChunks;
  const long long blocks = (groups * wpg + kWarps - 1) / kWarps;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((unsigned)blocks), block(kWarps * 32);
  int32_t* d = (int32_t*)dst;
  const int32_t* x = (const int32_t*)src;
  const int32_t* c = (const int32_t*)consts;
  if (field == 0)
    mxu_const_mul_kernel<0><<<grid, block, 0, s>>>(
        d, x, c, groups, lanes, L, stride_b, stride_j, hi_off, butterfly, wpg);
  else
    mxu_const_mul_kernel<1><<<grid, block, 0, s>>>(
        d, x, c, groups, lanes, L, stride_b, stride_j, hi_off, butterfly, wpg);
  return (int)cudaGetLastError();
}
