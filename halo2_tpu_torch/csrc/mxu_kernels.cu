// Kernel K1: the four-step NTT's axis transforms as a few multi-stage
// passes through shared memory, every twiddle product on the tensor cores;
// and products by constants shared across a group of lanes.
//
// Replaces halo2_tpu/ops/mxu_field.py:98-121 (mul_const_grouped: an XLA
// dot_general of 8-bit digits [G, nb, 32] @ [G, 32, 63] on the TPU's
// MXU; no Pallas call) and the four-step built on it (:175-194). When
// every lane of a group multiplies by one constant c, the digit-product
// columns cols[k] = sum_{i+j=k} a_i c_j are a matrix product A[lanes, 32]
// @ W_c[32, 63] with W_c[i][i+j] = c_j, the band of c's 8-bit digits.
//
// The product is mma.sync.m16n8k32 on u8 digits with s32 sums: a column
// sums at most 32 products of at most 255^2, so below 2^21, and every
// sum is exact. A warp multiplies 32 lanes (two m16 tiles) by one
// constant. The band never exists in memory: each thread builds its B
// fragments of the 8 column tiles (64 columns, the last one zero) from
// the constant's 8 words, staged between zero words in shared memory,
// one byte_perm a fragment. The fragments take the k dimension in the
// order byte 8t..8t+3, then 8t+4..8t+7 for thread t of a quad (the
// band's rows in the same order, so the sums are unchanged): a thread's
// A fragment is two adjacent 32-bit limbs, one 8-byte load. The 16
// products land in shared memory as 32 column pairs of weight 2^16 a
// lane; each thread then carries its lane's pairs into a 512-bit
// product, runs the Montgomery reduction (the REDC half of
// field.cuh::mont_mul) on the CUDA cores, and for a butterfly writes
// lo + t and lo - t. Every result is canonical (< p), bit-identical to
// B1 and the add/subtract.
//
// mxu_pass_kernel runs stages a+1 .. a+cnt of size-N transforms down one
// axis of the four-step's [m, R, C] array (ops/mxu_field.py plans the
// passes: at most 5 stages each, so two an axis of 2^6 to 2^10 and four
// launches a transform of 2^12 to 2^20, where the stagewise form made
// log2 n). A block loads a tile of 2^cnt axis positions i = res + t 2^a +
// h 2^(a+cnt) (one residue res mod 2^a, t < 2^cnt) times 32 lanes of the
// other axis into shared memory as 32-bit limbs, [element][8], and runs
// the stages there:
// every butterfly of a tile row pair shares one twiddle across the 32
// lanes, which is the warp's band. The bit-reversal gather is fused into
// an axis' first load, the diagonal twiddles w^(k_r c) into the column
// axis' last store (one Montgomery product an element on the CUDA cores,
// the table read as packed limbs) and the final transpose into the row
// axis' last store, so no other launch or copy runs. A pass reads its
// source and writes another buffer (the wrapper alternates two). The
// block stages its pass's 2^cnt - 1 twiddles as bands once, with its
// tile, and keeps kBatch loads a thread in flight.
//
// Bound: bytes. A pass reads and writes every element once (128 bytes an
// element) against 96 multiply-adds of reduction a butterfly; the
// tensor-core products are not counted. On an H100 80GB HBM3 a transform
// takes 0.0462 ms at 2^16 and 0.530 ms at 2^20 (the stagewise form 0.259
// and 1.559, B7 0.042 and 0.457; redesign_variants.py --only mxu), 3.1x
// the passes' byte bound at 2^20: a block's stages wait on their chains
// (staged sums, carries) with three blocks an SM, which registers (80)
// and shared memory (71 KB) both allow. Passes of 3, 4 or 6 stages,
// tiles of 64 lanes and two or eight loads in flight were no faster;
// four warps a block gained 1-3% at 2^16 and 2^17 x 4 columns and lost
// 6% at 2^20 x 1.
#include "field.cuh"

namespace {

using namespace h2t;

constexpr int kWarps = 4;      // products kernel: warps a block
constexpr int kChunks = 4;     // products kernel: 32-lane chunks a warp
constexpr int kPassWarps = 8;  // pass kernel: warps a block at most
constexpr int kSumRow = 36;    // words a staged row of 32 column pairs
constexpr int kBandWords = 28; // a staged constant: 8 zero words, its 8
                               // words, 12 zero words
constexpr int kMaxTileLog = 12;  // a pass tile holds at most 2^12 elements
constexpr int kBatch = 4;        // loads a thread keeps in flight

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

// B fragments of the band of the constant at cz[8..15]: thread (g, t)
// holds, for column tile T, k slots 4t..4t+3 (b0, bytes 8t..8t+3 of a
// lane) and 16+4t..19+4t (b1, bytes 8t+4..8t+7) of column 8T + g. Slot e
// of b0 is c8[d - e] with d = 8T + g - 8t (d - 4 - e for b1): the bytes
// 29 + d .. 32 + d of cz reversed, from two words by one byte_perm.
__device__ __forceinline__ void band_fragments(uint32_t b[8][2],
                                               const uint32_t* cz,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int p = 29 + g - 8 * t;             // b0's window at T = 0, >= 5
  const int w0 = p >> 2, o = p & 3;
  const uint32_t sel = (o + 3) | ((o + 2) << 4) | ((o + 1) << 8) | (o << 12);
  uint32_t v[18];
#pragma unroll
  for (int k = 0; k < 18; k++) v[k] = cz[w0 - 1 + k];
#pragma unroll
  for (int T = 0; T < 8; T++) {
    b[T][0] = __byte_perm(v[2 * T + 1], v[2 * T + 2], sel);
    b[T][1] = __byte_perm(v[2 * T], v[2 * T + 1], sel);
  }
}

// the 16 products of two m16 tiles (A fragments a[M]) with the band, as
// column pairs: row r, pair 4T + t = D[r][8T + 2t] + (D[r][8T + 2t + 1] << 8)
// (each below 2^30, of weight 2^(16 (4T + t)))
__device__ __forceinline__ void products_to_sums(uint32_t* sums,
                                                 const uint32_t a[2][4],
                                                 const uint32_t b[8][2],
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int M = 0; M < 2; M++) {
#pragma unroll
    for (int T = 0; T < 8; T++) {
      int d[4];
      mma_u8(d, a[M], b[T][0], b[T][1]);
      // D: thread (g, t) holds rows g, g + 8, columns 8T + 2t, 8T + 2t + 1
      uint32_t* r0 = sums + (16 * M + g) * kSumRow + 4 * T + t;
      r0[0] = (uint32_t)d[0] + ((uint32_t)d[1] << 8);
      r0[8 * kSumRow] = (uint32_t)d[2] + ((uint32_t)d[3] << 8);
    }
  }
}

// 32 column pairs of weight 2^16 -> T as 16 32-bit limbs, then T R^-1
// mod p, fully reduced (T < p^2)
template <int F>
__device__ __forceinline__ void reduce_sums(uint32_t r[8],
                                            const uint32_t* row) {
  uint32_t w[17];
  uint64_t acc = 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint4 v = s4[i];
    acc += (uint64_t)v.x + ((uint64_t)v.y << 16);
    w[2 * i] = (uint32_t)acc;
    acc >>= 32;
    acc += (uint64_t)v.z + ((uint64_t)v.w << 16);
    w[2 * i + 1] = (uint32_t)acc;
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

__device__ __forceinline__ void zero_band(uint32_t* cz, int lane) {
  if (lane < 8) cz[lane] = 0u;
  if (lane < 12) cz[16 + lane] = 0u;
}

__device__ __forceinline__ void load8(uint32_t r[8], const uint32_t* s) {
  const uint4 a = reinterpret_cast<const uint4*>(s)[0];
  const uint4 b = reinterpret_cast<const uint4*>(s)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

__device__ __forceinline__ void store8(uint32_t* d, const uint32_t r[8]) {
  reinterpret_cast<uint4*>(d)[0] = make_uint4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<uint4*>(d)[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// x [G, lanes, 16] times consts [G, 16] group by group: warp -> (group j,
// kChunks chunks of 32 lanes)
template <int F>
__global__ void __launch_bounds__(kWarps * 32)
mxu_const_mul_kernel(int32_t* __restrict__ dst,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ consts, long long groups,
                     long long lanes, long long warps_per_group) {
  __shared__ __align__(16) uint32_t sums_all[kWarps][32 * kSumRow];
  __shared__ uint32_t cz_all[kWarps][kBandWords];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + warp;
  if (gw >= groups * warps_per_group) return;   // the whole warp
  const long long j = gw / warps_per_group;
  const long long chunk0 = (gw % warps_per_group) * kChunks;
  uint32_t* cz = cz_all[warp];
  uint32_t* sums = sums_all[warp];
  zero_band(cz, lane);
  if (lane < 8)
    cz[8 + lane] = (uint32_t)consts[j * 16 + 2 * lane] |
                   ((uint32_t)consts[j * 16 + 2 * lane + 1] << 16);
  __syncwarp();
  uint32_t b[8][2];
  band_fragments(b, cz, lane);
  const int g = lane >> 2, t = lane & 3;
  const int32_t* x = src + j * lanes * 16;

  for (int c = 0; c < kChunks; c++) {
    const long long q0 = (chunk0 + c) * 32;
    if (q0 >= lanes) break;                   // uniform across the warp
    // A fragments: rows g and g + 8 of each m16 tile, limbs 2t and 2t + 1
    uint32_t a[2][4];
#pragma unroll
    for (int M = 0; M < 2; M++) {
#pragma unroll
      for (int rr = 0; rr < 2; rr++) {
        const long long q = q0 + 16 * M + g + 8 * rr;
        uint32_t lo = 0, hi = 0;
        if (q < lanes) {
          const int4 d = *reinterpret_cast<const int4*>(x + q * 16 + 4 * t);
          lo = (uint32_t)d.x | ((uint32_t)d.y << 16);
          hi = (uint32_t)d.z | ((uint32_t)d.w << 16);
        }
        a[M][rr] = lo;
        a[M][2 + rr] = hi;
      }
    }
    products_to_sums(sums, a, b, lane);
    __syncwarp();
    const long long q = q0 + lane;
    if (q < lanes) {
      uint32_t prod[8];
      reduce_sums<F>(prod, sums + lane * kSumRow);
      store_digits(dst + (j * lanes + q) * 16, prod);
    }
    __syncwarp();                             // sums free for the next chunk
  }
}

// One pass: stages a+1 .. a+cnt of the size-2^log_N transforms down one
// axis. Lane q (< lanes) is column q >> lpc_log, position q & (2^lpc_log
// - 1) of the other axis; element (axis i, lane q) is read at (q >>
// lpc_log) n + i s_ax + l s_ln (i bit-reversed over log_N bits if gather)
// and written at the same with d_ax, d_ln, times diag[i d_ax + l d_ln] if
// diag. Block -> (residue res < 2^a, higher group h, lane chunk); tile
// element u = t 2^lb_log + lane offset. tw: the axis plan's twiddles as
// packed limbs, [N - 1][8] (stage s at rows 2^(s-1) - 1 ..).
template <int F>
__global__ void __launch_bounds__(kPassWarps * 32)
mxu_pass_kernel(int32_t* __restrict__ dst, const int32_t* __restrict__ src,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ diag, long long lanes,
                int lpc_log, long long n, int log_N, int a, int cnt,
                int lb_log, long long s_ax, long long s_ln, long long d_ax,
                long long d_ln, int gather) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int E = 1 << (lb_log + cnt);
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x, nt = blockDim.x;
  uint32_t* tile = sm;                                   // [E][8]
  uint32_t* sums = sm + 8 * E + warp * (32 * kSumRow);
  // the pass's twiddles, each staged as a band (kBandWords words): stage
  // s's 2^(s-1) at entries 2^(s-1) - 1 ..
  uint32_t* bands = sm + 8 * E + nwarps * (32 * kSumRow);

  long long b = blockIdx.x;
  const long long res = b & ((1LL << a) - 1);
  b >>= a;
  const int hbits = log_N - a - cnt;
  const long long h = b & ((1LL << hbits) - 1);
  const long long q0 = (b >> hbits) << lb_log;
  const long long i0 = res + (h << (a + cnt));
  const long long lmask = (1LL << lpc_log) - 1;
  const int lbm = (1 << lb_log) - 1;

  // the bands: entry k = 2^(s-1) - 1 + j holds the twiddle at position
  // res + j 2^a of stage a + s (row 2^(a+s-1) - 1 + that of tw)
  for (int k = tid; k < ((1 << cnt) - 1) * kBandWords; k += nt) {
    const int e = k / kBandWords, w = k - e * kBandWords - 8;
    uint32_t v = 0u;
    if (w >= 0 && w < 8) {
      const int s = 32 - __clz(e + 1);               // stage s of the pass
      const long long j = e + 1 - (1 << (s - 1));
      v = __ldg(tw + ((1LL << (a + s - 1)) - 1 + res + (j << a)) * 8 + w);
    }
    bands[k] = v;
  }
  // load: four threads an element, 16 bytes (4 digits, 2 limbs) each, in
  // batches of kBatch loads in flight
  for (int k0 = tid; k0 < 4 * E; k0 += kBatch * nt) {
    int4 d[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; r++) {
      const int k = k0 + r * nt;
      const int u = k >> 2;
      const long long q = q0 + (u & lbm);
      d[r] = make_int4(0, 0, 0, 0);
      if (k < 4 * E && q < lanes) {
        long long i = i0 + ((long long)(u >> lb_log) << a);
        if (gather) i = __brev((unsigned)i) >> (32 - log_N);
        const long long e =
            (q >> lpc_log) * n + i * s_ax + (q & lmask) * s_ln;
        d[r] = *reinterpret_cast<const int4*>(src + e * 16 + 4 * (k & 3));
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; r++) {
      const int k = k0 + r * nt;
      if (k < 4 * E)
        *reinterpret_cast<uint2*>(tile + 2 * k) =
            make_uint2((uint32_t)d[r].x | ((uint32_t)d[r].y << 16),
                       (uint32_t)d[r].z | ((uint32_t)d[r].w << 16));
    }
  }
  __syncthreads();

  // stage a + s: tile rows t and t + 2^(s-1) (bit s - 1 of t clear), the
  // twiddle at position res + (t mod 2^(s-1)) 2^a of the stage; a unit is
  // one such row pair on 32 lanes
  const int units = E >> 6;
  const int ulog = lb_log - 5;
  for (int s = 1; s <= cnt; s++) {
    const int ht = 1 << (s - 1);
    for (int unit = warp; unit < units; unit += nwarps) {
      const int br = unit >> ulog, lc = unit & ((1 << ulog) - 1);
      const int tlo = (br & (ht - 1)) | ((br >> (s - 1)) << s);
      uint32_t bf[8][2];
      band_fragments(bf, bands + (ht - 1 + (tlo & (ht - 1))) * kBandWords,
                     lane);
      uint32_t* lo_t = tile + 8 * ((tlo << lb_log) + (lc << 5));
      uint32_t* hi_t = lo_t + 8 * (ht << lb_log);
      // A fragments of the hi row: thread (g, t) takes limbs 2t, 2t + 1 of
      // rows g, g + 8 of each m16 tile
      const int g = lane >> 2, t4 = lane & 3;
      uint32_t af[2][4];
#pragma unroll
      for (int M = 0; M < 2; M++) {
#pragma unroll
        for (int rr = 0; rr < 2; rr++) {
          const uint2 w = *reinterpret_cast<const uint2*>(
              hi_t + 8 * (16 * M + g + 8 * rr) + 2 * t4);
          af[M][rr] = w.x;
          af[M][2 + rr] = w.y;
        }
      }
      products_to_sums(sums, af, bf, lane);
      __syncwarp();
      uint32_t prod[8], lo[8], x0[8], x1[8];
      reduce_sums<F>(prod, sums + lane * kSumRow);
      load8(lo, lo_t + 8 * lane);
      add<F>(x0, lo, prod);
      sub<F>(x1, lo, prod);
      store8(lo_t + 8 * lane, x0);
      store8(hi_t + 8 * lane, x1);
      __syncwarp();                           // sums free
    }
    __syncthreads();
  }

  if (diag) {
    // one thread an element: times its diagonal twiddle, the twiddles of
    // kBatch elements in flight
    for (int u0 = tid; u0 < E; u0 += kBatch * nt) {
      uint4 w[kBatch][2];
#pragma unroll
      for (int r = 0; r < kBatch; r++) {
        const int u = u0 + r * nt;
        const long long q = q0 + (u & lbm);
        if (u < E && q < lanes) {
          const long long i = i0 + ((long long)(u >> lb_log) << a);
          const uint4* dp = reinterpret_cast<const uint4*>(
              diag + (i * d_ax + (q & lmask) * d_ln) * 8);
          w[r][0] = __ldg(dp);
          w[r][1] = __ldg(dp + 1);
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; r++) {
        const int u = u0 + r * nt;
        const long long q = q0 + (u & lbm);
        if (u >= E || q >= lanes) continue;
        const long long i = i0 + ((long long)(u >> lb_log) << a);
        const long long pos = i * d_ax + (q & lmask) * d_ln;
        const uint32_t wv[8] = {w[r][0].x, w[r][0].y, w[r][0].z, w[r][0].w,
                                w[r][1].x, w[r][1].y, w[r][1].z, w[r][1].w};
        uint32_t x[8], o[8];
        load8(x, tile + 8 * u);
        mont_mul<F>(o, x, wv);
        store_digits(dst + ((q >> lpc_log) * n + pos) * 16, o);
      }
    }
    return;
  }
  for (int k = tid; k < 4 * E; k += nt) {
    const int u = k >> 2;
    const long long q = q0 + (u & lbm);
    if (q >= lanes) continue;
    const long long i = i0 + ((long long)(u >> lb_log) << a);
    const long long e = (q >> lpc_log) * n + i * d_ax + (q & lmask) * d_ln;
    const uint2 v = *reinterpret_cast<const uint2*>(tile + 2 * k);
    *reinterpret_cast<int4*>(dst + e * 16 + 4 * (k & 3)) =
        make_int4((int)(v.x & 0xffffu), (int)(v.x >> 16),
                  (int)(v.y & 0xffffu), (int)(v.y >> 16));
  }
}

// the pass block's shared memory: its tile, its warps' sums, its bands
size_t pass_smem(int E, int cnt, int warps) {
  return ((size_t)E * 8 + (size_t)warps * 32 * kSumRow +
          (size_t)((1 << cnt) - 1) * kBandWords) * 4;
}

}  // namespace

// x [groups, lanes, 16] times consts [groups, 16] (Montgomery digits),
// group by group, into dst (not x)
extern "C" int h2t_mxu_const_mul(int field, void* dst, const void* src,
                                 const void* consts, long long groups,
                                 long long lanes, void* stream) {
  const long long chunks = (lanes + 31) / 32;
  const long long wpg = (chunks + kChunks - 1) / kChunks;
  const long long blocks = (groups * wpg + kWarps - 1) / kWarps;
  if (blocks <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto k = field ? mxu_const_mul_kernel<1> : mxu_const_mul_kernel<0>;
  k<<<(unsigned)blocks, kWarps * 32, 0, s>>>(
      (int32_t*)dst, (const int32_t*)src, (const int32_t*)consts, groups,
      lanes, wpg);
  return (int)cudaGetLastError();
}

// One pass of mxu_pass_kernel (see there): 1 <= cnt, a + cnt <= log_N,
// 5 <= lb_log, lb_log + cnt <= kMaxTileLog; diag may be null; dst != src.
extern "C" int h2t_mxu_pass(int field, void* dst, const void* src,
                            const void* tw, const void* diag,
                            long long lanes, int lpc_log, long long n,
                            int log_N, int a, int cnt, int lb_log,
                            long long s_ax, long long s_ln, long long d_ax,
                            long long d_ln, int gather, void* stream) {
  if (lanes <= 0) return 0;
  if (log_N < 1 || log_N > 30 || cnt < 1 || a < 0 || a + cnt > log_N ||
      lb_log < 5 || lb_log + cnt > kMaxTileLog || lpc_log < 0 ||
      lpc_log > 40 || dst == src)
    return (int)cudaErrorInvalidValue;
  const int E = 1 << (lb_log + cnt);
  const int units = E >> 6;
  const int warps = units < kPassWarps ? units : kPassWarps;
  const size_t smem = pass_smem(E, cnt, warps);
  const long long chunks = (lanes + (1LL << lb_log) - 1) >> lb_log;
  const long long blocks = chunks << (log_N - cnt);
  if (blocks > 0x7fffffffLL || smem > 232448)
    return (int)cudaErrorInvalidValue;
  auto k = field ? mxu_pass_kernel<1> : mxu_pass_kernel<0>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<(unsigned)blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      (int32_t*)dst, (const int32_t*)src, (const uint32_t*)tw,
      (const uint32_t*)diag, lanes, lpc_log, n, log_N, a, cnt, lb_log, s_ax,
      s_ln, d_ax, d_ln, gather);
  return (int)cudaGetLastError();
}
