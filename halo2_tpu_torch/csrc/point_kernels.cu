// Kernels B2-B6, the GLV ladder and the scalar-multiplication ladder:
// complete additions and doublings of Pasta points in homogeneous
// projective coordinates (Renes-Costello-Batina 2015, a = 0, b3 = 15): the
// bucket and reduction rounds of every Pippenger commit, the ladder that
// folds G' in the device IPA rounds, and the per-lane scalar
// multiplication of the SRS's group NTT.
//
// B2 (pmixed_masked) replaces halo2_tpu/ops/pallas_point.py::
// _pmixed_masked_kernel (:297, built at :463/:477, wrapped by
// pmixed_masked_flat at :613): out = mask ? A +/- B_aff : A with the RCB
// Alg 8 mixed add (11 wide multiplies), the per-lane sign negating y as
// p - y, and identity-coded (0, mont 1) bases masked off in-kernel.
// pmixed_bucket_runs replaces B2 as the commits drive it: the reference
// runs _pmixed_masked_kernel once per bucket round, round r adding the
// r-th member of every (window row, bucket) run over all lanes, its bases
// gathered with jnp.take (halo2_tpu/ops/msm_pallas.py:327-397, fused by
// XLA on the TPU). Here one launch runs every round: each lane sums its
// whole run from the identity, in the same order with the same Alg 8
// formulas, so the projective result is the round loop's bit for bit.
// B3 (padd_masked) replaces _padd_masked_kernel (:281, _build_padd(seg=True)
// at :426/:442, wrapped by padd_masked_flat at :591): out[l] = mask[l] ?
// A[l] + B[j(l)] : A[l] with the RCB Alg 7 complete add (12 wide
// multiplies), where j(l) is l, the lane `shift` places before l within
// its row of `width` lanes (a torch.roll of each row), or idx[l] with the
// per-lane sign negating Y. The reference builds that operand outside its
// kernel with jnp.roll and jnp.take (msm_pallas.py:335-347, 413, 466,
// 513, 535), which XLA fuses on the TPU; in eager PyTorch each would be
// its own pass over device memory and its own host call.
// B4 (padd) replaces _padd_kernel (:266, _build_padd(seg=False) at
// :426/:451, wrapped by padd_flat at :574): the unmasked complete add.
// B5 (pdouble) replaces _pdouble_kernel (:274, _build_pdouble(masked=False)
// at :489/:512, wrapped by pdouble_flat at :663): RCB Alg 9 doubling
// (8 wide multiplies). B6 (pdouble_masked) replaces _pdouble_masked_kernel
// (:330, _build_pdouble(masked=True) at :489/:503, wrapped by
// pdouble_masked_flat at :677): out = mask ? 2A : A.
// scalar_mul_ladder replaces the reference's per-lane variable-base scalar
// multiplication, batch_scalar_mul (halo2_tpu/curves/device.py:151-169):
// a jax.lax.fori_loop of 255 or 256 steps of pdouble, padd and pselect on
// the lane's own bit, jnp group ops with no Pallas kernel. It serves the
// group NTT that builds the SRS's g_lagrange (halo2_tpu/ops/ntt.py:179),
// the 1/n scale after it and msm_small: acc = O, then for each bit of the
// lane's scalar, most significant first, acc = 2 acc and, where the bit is
// set, acc = acc + P. Optionally it ends with the group NTT's butterfly:
// given lo, it writes lo + acc and lo - acc instead of acc.
// glv_ladder replaces the reference's 130-step jax.lax.fori_loop of B5
// and a masked B3 in one jitted program per IPA round
// (halo2_tpu/ops/ipa_device.py:219-230): acc = O, then for each bit pair
// (b1, b2), most significant first, acc = 2 acc and, where
// sel = b1 + 2 b2 != 0, acc = acc + {t1, t2, t12}[sel].
//
// Layout: a point batch is [48, L] int32 (rows 0-15 X, 16-31 Y, 32-47 Z
// as 16-bit Montgomery digits, lanes last); an affine batch is [32, L].
// One thread per lane: neighbouring threads read neighbouring words of
// each row, so every load and store coalesces (B3's index form gathers).
// The formulas are written straight-line with all coordinates in
// registers (8 x 32-bit limbs each).
//
// What bounds them on an H100, and what the design does about it:
// - By the roofline B3 moves 2 x 192 + 4 bytes in and 192 out per lane
//   (580 B, 173 ps at 3.35 TB/s) against 12 Montgomery products of 224
//   32-bit multiply-adds (80 ps at 33.5e12 multiply-adds/s); B2 moves
//   520 B for 11 products, B4 576 B for 12, B5 384 B for 8 (53 ps), B6
//   388 B for 8 on its live lanes. In practice each thread runs a chain
//   of dependent products at low occupancy (26,624 lanes are 832 warps,
//   about six per SM), so latency decides. The masked-off lanes' work is
//   a plain copy, every intermediate stays in registers, and no input is
//   read twice.
// - B3's second operand is read by the kernel itself, from a lane offset
//   or an index, so no rolled or gathered copy (192 B per lane written
//   and read again, plus a host call) precedes it; the output never
//   aliases an input, since a lane reads other lanes.
// - The bucket-run kernel is bound by operations over the whole commit:
//   every member's mixed add (11 products) against a 68-byte read per
//   member (a packed 64-byte base and its index) and one 192-byte write
//   per lane. Run as one B2 launch per round (50-140 of them per commit)
//   it re-read and re-wrote the accumulator each round, and each round
//   was preceded by a gather of the bases and a host call. One launch
//   keeps each lane's accumulator in registers for its whole run, reads
//   its own run bounds, members (index, sign in bit 31) and bases, the
//   bases point-major and packed (pack_affine, built once per base
//   tensor: four 16-byte loads a base, where the lanes-last batch needs
//   32 strided reads). A warp runs as long as its longest run; splitting
//   long runs over more threads would change the order of additions
//   (ROADMAP B). At 26,624 lanes (six warps a SM) each thread is a
//   latency-bound chain of about 70 x 11 dependent products. The inlined
//   body is 7,224 SASS instructions, the called one 2,080; the called
//   product measured faster at both commit widths (0.79 against 0.98 ms
//   at 26,624 lanes, 5.45 against 7.10 ms at 163,840, NVIDIA H100 80GB
//   HBM3, 700 W; PERF.md), so the instruction caches decide here too and
//   only the called build is kept. Also tried and lost: a carry-chain
//   product in PTX (mad.lo.cc / madc.hi.cc, 5-10% slower in both forms)
//   and a build calling two independent products at a time (0.82 ms at
//   26,624 lanes): the chain of dependent calls is not what bounds it.
// - The ladder is bound by operations: 130 doublings (8 products) and up
//   to 130 adds (12) per lane, about 2,200-2,600 products, against
//   4 x 192 B of traffic. Run as 260 launches (B5, then B3) it re-read and
//   re-wrote the accumulator twice a step and paid a host call for each
//   launch. One launch keeps the accumulator on the SM for all steps,
//   stages the lane's three table points in shared memory once (72
//   packed limbs, 288 B a thread), and takes the bits by value as kernel
//   parameters: they are the same for every lane, so no warp diverges and
//   a round needs no host-to-device copy.
// - What then limits the ladder is instruction fetch. With its 20
//   products inlined, a step's body is over 14,000 instructions (about
//   228 KB), far beyond the SM's instruction caches, and the one launch
//   ran no faster than the 260 (slower at 8,192 lanes, two warps a SM).
//   So the ladder calls the product (mont_mul_call) rather than inline
//   it: under 4,000 instructions, about 2x faster at 8,192 lanes and
//   1.4x at 2^17 on an H100 (ladder_variants.py). The one-step kernels
//   keep the inlined product, which is as fast or faster for them.
// - The scalar-multiplication ladder is bound by operations too: 255 or
//   256 doublings (8 products) and an add (12) for each set bit, about
//   3,600 products a lane for a random 255-bit scalar, against a 192-byte
//   read and write and a 64-byte scalar. As a loop of jnp ops it would be
//   3 x nbits launches, each re-reading and re-writing the accumulator;
//   one launch keeps it in registers, stages P in shared memory (24 limbs
//   a thread, as the GLV ladder stages its table) and calls the product
//   (the instruction-fetch finding above). Unlike the GLV ladder, each
//   lane reads its own scalar: row l % T of a [T, 16] digit table (T = L
//   for one scalar a lane; T = half for a group-NTT stage, whose lanes
//   share the stage's half twiddles, so no n/2-row copy is written). So
//   lanes of one warp hold different bits. The add is a branch, not an
//   always-computed add and a select: a warp runs the add once whenever
//   any of its lanes has the bit set, which a masked add would also pay,
//   and skips it when none has (a group NTT's first stage and its 1/n
//   scale, where every lane holds the same scalar); the select would be
//   24 more moves a step. So with random scalars every step costs a
//   doubling and an add: 3.99 ms at 2^13 lanes and 21.8 ms at 2^17 for a
//   fused 255-bit stage (NVIDIA H100 80GB HBM3, 700 W; PERF.md), 20x and
//   6.9x the bound. The fused butterfly adds two complete adds (24
//   products) and saves the two B4 launches and the negation of a stage.
// - Block size (B3 and the ladder): `nvcc -Xptxas -v` reports 106, 122
//   and 124 registers for B3's lane, offset and index forms and 96 (with
//   a 672-byte stack frame) for the ladder, no spills. A 128-thread block
//   then holds 12-16K of an SM's 64K registers (and the ladder's 36 KB of
//   shared memory), so every block of B3's 26,624 lanes or the ladder's
//   8,192 is resident at once, and what the block size decides is how
//   evenly the lanes spread over the 132 SMs. (The scalar-multiplication
//   ladder takes 168 registers and a 672-byte frame: at most 12 warps a
//   SM, so its 2^17-lane stages run in waves.) spread_threads picks, from
//   32, 64 and 128 threads, the size that puts the fewest lanes on the
//   busiest SM (B3 at 26,624 lanes: 32, at most 224 a SM against 256;
//   the ladder at 8,192 lanes: 64, one block on each of 128 SMs, where
//   128 threads would fill only 64 SMs). For the ladder with inlined
//   products, 32, 64 and 128 measured the same (ladder_variants.py).
#include "field.cuh"

using namespace h2t;

struct Pt {
  uint32_t x[8], y[8], z[8];
};

// The Montgomery product as a real call: one copy of its code serves
// every product of a formula, and the operands pass through the stack
// frame (local memory, resident in L1).
template <int F>
__device__ __noinline__ void mont_mul_call(uint32_t r[8], const uint32_t a[8],
                                           const uint32_t b[8]) {
  mont_mul<F>(r, a, b);
}

// The product the formulas use: inlined (straight-line, for the one-step
// kernels) or called (CALL, for the ladder's and the bucket runs' loops;
// see the design note)
template <int F, bool CALL>
__device__ __forceinline__ void pmul(uint32_t r[8], const uint32_t a[8],
                                     const uint32_t b[8]) {
  if (CALL)
    mont_mul_call<F>(r, a, b);
  else
    mont_mul<F>(r, a, b);
}

// RCB15 Alg 7 on field values (the polynomials of pallas_point._rcb_add)
template <int F, bool CALL = false>
__device__ __forceinline__ void rcb_add(Pt& o, const Pt& a, const Pt& b) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], xz[8], u[8], v[8];
  pmul<F, CALL>(t0, a.x, b.x);
  pmul<F, CALL>(t1, a.y, b.y);
  pmul<F, CALL>(t2, a.z, b.z);
  add<F>(u, a.x, a.y);
  add<F>(v, b.x, b.y);
  pmul<F, CALL>(t3, u, v);
  sub<F>(t3, t3, t0);
  sub<F>(t3, t3, t1);  // X1Y2 + X2Y1
  add<F>(u, a.y, a.z);
  add<F>(v, b.y, b.z);
  pmul<F, CALL>(t4, u, v);
  sub<F>(t4, t4, t1);
  sub<F>(t4, t4, t2);  // Y1Z2 + Y2Z1
  add<F>(u, a.x, a.z);
  add<F>(v, b.x, b.z);
  pmul<F, CALL>(xz, u, v);
  sub<F>(xz, xz, t0);
  sub<F>(xz, xz, t2);  // X1Z2 + X2Z1
  uint32_t s0[8], b3z[8], z3[8], s1[8], y3[8];
  add<F>(s0, t0, t0);
  add<F>(s0, s0, t0);  // 3 X1X2
  mul15<F>(b3z, t2);
  add<F>(z3, t1, b3z);
  sub<F>(s1, t1, b3z);
  mul15<F>(y3, xz);
  pmul<F, CALL>(u, t3, s1);
  pmul<F, CALL>(v, t4, y3);
  sub<F>(o.x, u, v);
  pmul<F, CALL>(u, y3, s0);
  pmul<F, CALL>(v, s1, z3);
  add<F>(o.y, u, v);
  pmul<F, CALL>(u, z3, t4);
  pmul<F, CALL>(v, s0, t3);
  add<F>(o.z, u, v);
}

// RCB15 Alg 8: second operand affine (Z2 = 1); the polynomials of
// pallas_point._rcb_mixed_add
template <int F, bool CALL = false>
__device__ __forceinline__ void rcb_mixed_add(Pt& o, const Pt& a,
                                              const uint32_t x2[8],
                                              const uint32_t y2[8]) {
  uint32_t t0[8], t1[8], t3[8], t4[8], xz[8], u[8], v[8];
  pmul<F, CALL>(t0, a.x, x2);
  pmul<F, CALL>(t1, a.y, y2);
  add<F>(u, a.x, a.y);
  add<F>(v, x2, y2);
  pmul<F, CALL>(t3, u, v);
  sub<F>(t3, t3, t0);
  sub<F>(t3, t3, t1);  // X1Y2 + X2Y1
  pmul<F, CALL>(t4, y2, a.z);
  add<F>(t4, t4, a.y);  // Y1 + Y2 Z1
  pmul<F, CALL>(xz, x2, a.z);
  add<F>(xz, xz, a.x);  // X1 + X2 Z1
  uint32_t s0[8], b3z[8], z3[8], s1[8], y3[8];
  add<F>(s0, t0, t0);
  add<F>(s0, s0, t0);  // 3 X1X2
  mul15<F>(b3z, a.z);  // b3 Z1 Z2 = 15 Z1
  add<F>(z3, t1, b3z);
  sub<F>(s1, t1, b3z);
  mul15<F>(y3, xz);
  pmul<F, CALL>(u, t3, s1);
  pmul<F, CALL>(v, t4, y3);
  sub<F>(o.x, u, v);
  pmul<F, CALL>(u, y3, s0);
  pmul<F, CALL>(v, s1, z3);
  add<F>(o.y, u, v);
  pmul<F, CALL>(u, z3, t4);
  pmul<F, CALL>(v, s0, t3);
  add<F>(o.z, u, v);
}

// RCB15 Alg 9 doubling: the polynomials of pallas_point._rcb_double (and
// msm_pallas._host_proj_double). Any other doubling formula gives another
// projective representative of 2A, and the IPA's G' fold state is held
// bit for bit against the reference's.
template <int F, bool CALL = false>
__device__ __forceinline__ void rcb_double(Pt& o, const Pt& a) {
  uint32_t t0[8], t1[8], t2[8], xy[8], z3[8], y3[8], u[8], v[8];
  pmul<F, CALL>(t0, a.y, a.y);
  pmul<F, CALL>(t1, a.y, a.z);
  pmul<F, CALL>(u, a.z, a.z);
  pmul<F, CALL>(xy, a.x, a.y);
  add<F>(z3, t0, t0);
  add<F>(z3, z3, z3);
  add<F>(z3, z3, z3);  // 8 Y^2
  mul15<F>(t2, u);     // b3 Z^2
  add<F>(y3, t0, t2);
  add<F>(u, t2, t2);
  add<F>(u, u, t2);
  sub<F>(t0, t0, u);   // Y^2 - 3 b3 Z^2
  pmul<F, CALL>(u, t2, z3);
  pmul<F, CALL>(o.z, t1, z3);
  pmul<F, CALL>(v, t0, y3);
  add<F>(o.y, v, u);
  pmul<F, CALL>(v, t0, xy);
  add<F>(o.x, v, v);
}

__device__ __forceinline__ void load_pt(Pt& p, const int32_t* src,
                                        size_t stride) {
  load_rows(p.x, src, stride);
  load_rows(p.y, src + 16 * stride, stride);
  load_rows(p.z, src + 32 * stride, stride);
}

__device__ __forceinline__ void store_pt(int32_t* dst, size_t stride,
                                         const Pt& p) {
  store_rows(dst, stride, p.x);
  store_rows(dst + 16 * stride, stride, p.y);
  store_rows(dst + 32 * stride, stride, p.z);
}

__device__ __forceinline__ void copy_rows(int32_t* dst, const int32_t* src,
                                          size_t stride, int rows) {
  for (int r = 0; r < rows; r++) dst[r * stride] = src[r * stride];
}

// -Y as p - Y, with 0 kept at 0 (the reference's fneg)
template <int F>
__device__ __forceinline__ void neg_in_place(uint32_t y[8]) {
  if (is_zero(y)) return;
  uint32_t p[8];
  load_p<F>(p);
  sub_raw(y, p, y);
}

// where B3 reads its second operand for lane l
enum SrcMode { SRC_LANE = 0, SRC_ROLL = 1, SRC_INDEX = 2 };

// the largest block of every kernel here
static const int kMaxThreads = 128;

// B3: out[l] = mask[l] ? a[l] + src[j(l)] : a[l]. SRC_LANE: j = l;
// SRC_ROLL: j = the lane `shift` (0 <= shift < width) places before l
// within its row of `width` lanes (torch.roll of each row by shift);
// SRC_INDEX: j = idx[l], and Y negated where sign (may be null) is set.
// src has Ls lanes; a and out have L.
template <int F, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
padd_masked_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ mask,
                   const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ sign, uint32_t width,
                   uint32_t shift, uint32_t Ls, uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  if (mask[l] == 0) {
    copy_rows(out + l, a + l, L, 48);
    return;
  }
  uint32_t j = l;
  if (MODE == SRC_ROLL) {
    uint32_t c = l % width;
    j = l - c + (c >= shift ? c - shift : c + width - shift);
  } else if (MODE == SRC_INDEX) {
    j = (uint32_t)idx[l];
  }
  Pt p, q, r;
  load_pt(p, a + l, L);
  load_pt(q, src + j, Ls);
  if (MODE == SRC_INDEX && sign != nullptr && sign[l] != 0)
    neg_in_place<F>(q.y);
  rcb_add<F>(r, p, q);
  store_pt(out + l, L, r);
}

// The ladder's bits, most significant first: bit i of b1 (of b2) is bit
// i % 32 of b1[i / 32]; up to 160 steps.
struct LadderBits {
  uint32_t b1[5], b2[5];
};

// glv_ladder: acc = O; for i < nbits: acc = 2 acc, then, where
// sel = b1_i + 2 b2_i is not 0, acc += {t1, t2, t12}[sel - 1]. The table
// lives in dynamic shared memory as [72 limbs][blockDim.x]: each thread
// reads and writes only its own column, word by word, without bank
// conflicts.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
glv_ladder_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ t1,
                  const int32_t* __restrict__ t2,
                  const int32_t* __restrict__ t12, LadderBits bits,
                  uint32_t nbits, uint32_t L) {
  extern __shared__ uint32_t tab[];
  __shared__ uint32_t sbits[10];
  const uint32_t tid = threadIdx.x, bd = blockDim.x;
  const uint32_t l = blockIdx.x * bd + tid;
  if (tid == 0) {
#pragma unroll
    for (int w = 0; w < 5; w++) {
      sbits[w] = bits.b1[w];
      sbits[5 + w] = bits.b2[w];
    }
  }
  const bool live = l < L;
  if (live) {
    const int32_t* srcs[3] = {t1, t2, t12};
#pragma unroll
    for (int k = 0; k < 3; k++) {
      Pt q;
      load_pt(q, srcs[k] + l, L);
#pragma unroll
      for (int i = 0; i < 8; i++) {
        tab[(24 * k + i) * bd + tid] = q.x[i];
        tab[(24 * k + 8 + i) * bd + tid] = q.y[i];
        tab[(24 * k + 16 + i) * bd + tid] = q.z[i];
      }
    }
  }
  __syncthreads();
  if (!live) return;
  Pt acc, r;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc.x[i] = 0;
    acc.y[i] = Field<F>::one(i);
    acc.z[i] = 0;
  }
#pragma unroll 1
  for (uint32_t s = 0; s < nbits; s++) {
    rcb_double<F, true>(r, acc);
    const uint32_t w = s >> 5, b = s & 31;
    const uint32_t sel = ((sbits[w] >> b) & 1u) |
                         (((sbits[5 + w] >> b) & 1u) << 1);
    if (sel == 0) {
      acc = r;
      continue;
    }
    const uint32_t* e = tab + 24 * (sel - 1) * bd + tid;
    Pt q;
#pragma unroll
    for (int i = 0; i < 8; i++) {
      q.x[i] = e[i * bd];
      q.y[i] = e[(8 + i) * bd];
      q.z[i] = e[(16 + i) * bd];
    }
    rcb_add<F, true>(acc, r, q);
  }
  store_pt(out + l, L, acc);
}

// scalar_mul_ladder: acc = O; for s = nbits - 1 down to 0: acc = 2 acc,
// then acc = acc + P where bit s of the lane's scalar is set. Lane l reads
// P = pts[l] and its scalar from row l % T of `digits` (16 canonical
// 16-bit digits, int32). P lives in dynamic shared memory as
// [24 limbs][blockDim.x]: each thread reads only its own column. With lo,
// out = lo + acc and out2 = lo - acc (the group NTT's butterfly), else
// out = acc.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
scalar_mul_ladder_kernel(int32_t* __restrict__ out,
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

template <int F>
__global__ void pmixed_masked_kernel(int32_t* __restrict__ out,
                                     const int32_t* __restrict__ a,
                                     const int32_t* __restrict__ b,
                                     const int32_t* __restrict__ mask,
                                     const int32_t* __restrict__ sign,
                                     uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint32_t x2[8], y2[8];
  bool live = mask[l] != 0;
  if (live) {
    load_rows(x2, b + l, L);
    load_rows(y2, b + 16 * (size_t)L + l, L);
    // identity base marker: X == 0 and Y == mont(1) (not a curve point)
    live = !(is_zero(x2) && is_one<F>(y2));
  }
  if (!live) {
    copy_rows(out + l, a + l, L, 48);
    return;
  }
  if (sign[l] != 0) {
    // -B = (x, p - y); y = 0 would be 2-torsion, absent on Pasta
    uint32_t p[8];
    load_p<F>(p);
    sub_raw(y2, p, y2);
  }
  Pt acc, r;
  load_pt(acc, a + l, L);
  rcb_mixed_add<F>(r, acc, x2, y2);
  store_pt(out + l, L, r);
}

// pmixed_bucket_runs: every lane l (bucket l % BL of window row l / BL)
// sums its run of affine bases from the identity, in the order of the
// B2 round loop it replaces: acc = O, then for r < counts[l], with
// m = members[row, starts[l] + r], acc = acc +/- bases[m & 0x7fffffff],
// negated where bit 31 of m is set; identity-coded bases are skipped.
// bases: point-major packed [n][16] words (x limbs 0-7, y limbs 0-7), 64 B
// per point, read as four 16-byte loads. The products are called, not
// inlined (see the design note).
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
pmixed_bucket_runs_kernel(int32_t* __restrict__ out,
                          const uint4* __restrict__ bases,
                          const int32_t* __restrict__ members,
                          const int32_t* __restrict__ starts,
                          const int32_t* __restrict__ counts, uint32_t BL,
                          uint32_t n, uint32_t L) {
  const uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const size_t run = (size_t)(l / BL) * n + (uint32_t)starts[l];
  const int32_t cnt = counts[l];
  Pt acc;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc.x[i] = 0;
    acc.y[i] = Field<F>::one(i);
    acc.z[i] = 0;
  }
#pragma unroll 1
  for (int32_t r = 0; r < cnt; r++) {
    const int32_t m = members[run + r];
    const uint4* b = bases + (size_t)(m & 0x7fffffff) * 4;
    uint32_t x2[8], y2[8];
    const uint4 q0 = b[0], q1 = b[1], q2 = b[2], q3 = b[3];
    x2[0] = q0.x; x2[1] = q0.y; x2[2] = q0.z; x2[3] = q0.w;
    x2[4] = q1.x; x2[5] = q1.y; x2[6] = q1.z; x2[7] = q1.w;
    y2[0] = q2.x; y2[1] = q2.y; y2[2] = q2.z; y2[3] = q2.w;
    y2[4] = q3.x; y2[5] = q3.y; y2[6] = q3.z; y2[7] = q3.w;
    // identity base marker: X == 0 and Y == mont(1), masked off as B2 does
    if (is_zero(x2) && is_one<F>(y2)) continue;
    if (m < 0) {
      // -B = (x, p - y), as B2
      uint32_t p[8];
      load_p<F>(p);
      sub_raw(y2, p, y2);
    }
    Pt r2;
    rcb_mixed_add<F, true>(r2, acc, x2, y2);
    acc = r2;
  }
  store_pt(out + l, L, acc);
}

template <int F>
__global__ void padd_kernel(int32_t* __restrict__ out,
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
__global__ void pdouble_kernel(int32_t* __restrict__ out,
                               const int32_t* __restrict__ a, uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  Pt p, r;
  load_pt(p, a + l, L);
  rcb_double<F>(r, p);
  store_pt(out + l, L, r);
}

template <int F>
__global__ void pdouble_masked_kernel(int32_t* __restrict__ out,
                                      const int32_t* __restrict__ a,
                                      const int32_t* __restrict__ mask,
                                      uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  if (mask[l] == 0) {
    copy_rows(out + l, a + l, L, 48);
    return;
  }
  Pt p, r;
  load_pt(p, a + l, L);
  rcb_double<F>(r, p);
  store_pt(out + l, L, r);
}

// Launch the field's instance (k0 for Fp, k1 for Fq) over L lanes, one
// thread per lane in blocks of kMaxThreads, on `stream`; returns
// cudaGetLastError().
template <typename... P, typename... A>
static int launch_lanes(int field, void (*k0)(P...), void (*k1)(P...),
                        long long L, void* stream, A... args) {
  if (L <= 0) return 0;
  dim3 grid((unsigned)((L + kMaxThreads - 1) / kMaxThreads));
  void (*k)(P...) = field == 0 ? k0 : k1;
  k<<<grid, kMaxThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 1;
  }
  return sms;
}

// The block size of 32, 64 or 128 threads that puts the fewest lanes on
// the busiest SM when L lanes are dealt out in blocks; ties go to the
// larger block.
static int spread_threads(long long L) {
  const long long sms = sm_count();
  int best = kMaxThreads;
  long long best_load = -1;
  for (int t = kMaxThreads; t >= 32; t >>= 1) {
    long long blocks = (L + t - 1) / t;
    long long load = (blocks + sms - 1) / sms * t;
    if (best_load < 0 || load < best_load) {
      best_load = load;
      best = t;
    }
  }
  return best;
}

extern "C" int h2t_padd_masked(int field, void* out, const void* a,
                               const void* src, const void* mask,
                               const void* idx, const void* sign, int mode,
                               long long width, long long shift,
                               long long Ls, long long L, void* stream) {
  if (L <= 0) return 0;
  if (mode < SRC_LANE || mode > SRC_INDEX ||
      (mode == SRC_ROLL && (width <= 0 || L % width != 0 || shift < 0 ||
                            shift >= width)) ||
      (mode == SRC_INDEX && idx == nullptr))
    return (int)cudaErrorInvalidValue;
  typedef void (*Kern)(int32_t*, const int32_t*, const int32_t*,
                       const int32_t*, const int32_t*, const int32_t*,
                       uint32_t, uint32_t, uint32_t, uint32_t);
  static const Kern kerns[2][3] = {
      {padd_masked_kernel<0, SRC_LANE>, padd_masked_kernel<0, SRC_ROLL>,
       padd_masked_kernel<0, SRC_INDEX>},
      {padd_masked_kernel<1, SRC_LANE>, padd_masked_kernel<1, SRC_ROLL>,
       padd_masked_kernel<1, SRC_INDEX>}};
  const int threads = spread_threads(L);
  dim3 grid((unsigned)((L + threads - 1) / threads));
  kerns[field != 0][mode]<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)src,
      (const int32_t*)mask, (const int32_t*)idx, (const int32_t*)sign,
      (uint32_t)width, (uint32_t)shift, (uint32_t)Ls, (uint32_t)L);
  return (int)cudaGetLastError();
}

// bits1/bits2: host arrays of 5 words each (LadderBits); nbits <= 160
extern "C" int h2t_glv_ladder(int field, void* out, const void* t1,
                              const void* t2, const void* t12,
                              const uint32_t* bits1, const uint32_t* bits2,
                              int nbits, long long L, void* stream) {
  if (L <= 0) return 0;
  if (nbits < 0 || nbits > 160) return (int)cudaErrorInvalidValue;
  LadderBits bits;
  for (int w = 0; w < 5; w++) {
    bits.b1[w] = bits1[w];
    bits.b2[w] = bits2[w];
  }
  const int threads = spread_threads(L);
  dim3 grid((unsigned)((L + threads - 1) / threads));
  const size_t shmem = (size_t)72 * sizeof(uint32_t) * threads;
  void (*k)(int32_t*, const int32_t*, const int32_t*, const int32_t*,
            LadderBits, uint32_t, uint32_t) =
      field == 0 ? glv_ladder_kernel<0> : glv_ladder_kernel<1>;
  k<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)t1, (const int32_t*)t2,
      (const int32_t*)t12, bits, (uint32_t)nbits, (uint32_t)L);
  return (int)cudaGetLastError();
}

// digits [T, 16] (lane l reads row l % T); nbits <= 256; lo and out2
// both given (the fused butterfly) or both null
extern "C" int h2t_scalar_mul_ladder(int field, void* out, void* out2,
                                     const void* pts, const void* digits,
                                     const void* lo, long long T, int nbits,
                                     long long L, void* stream) {
  if (L <= 0) return 0;
  if (T <= 0 || nbits < 1 || nbits > 256 || (lo == nullptr) != (out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int threads = spread_threads(L);
  dim3 grid((unsigned)((L + threads - 1) / threads));
  const size_t shmem = (size_t)24 * sizeof(uint32_t) * threads;
  auto kern = field ? scalar_mul_ladder_kernel<1> : scalar_mul_ladder_kernel<0>;
  kern<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)out, (int32_t*)out2, (const int32_t*)pts,
      (const int32_t*)digits, (const int32_t*)lo, (uint32_t)T,
      (uint32_t)nbits, (uint32_t)L);
  return (int)cudaGetLastError();
}

extern "C" int h2t_pmixed_masked(int field, void* out, const void* a,
                                 const void* b, const void* mask,
                                 const void* sign, long long L,
                                 void* stream) {
  return launch_lanes(field, pmixed_masked_kernel<0>,
                      pmixed_masked_kernel<1>, L, stream, (int32_t*)out,
                      (const int32_t*)a, (const int32_t*)b,
                      (const int32_t*)mask, (const int32_t*)sign,
                      (uint32_t)L);
}

// bases [n][16] packed words, members [L / BL][n], starts and counts [L]
extern "C" int h2t_pmixed_bucket_runs(int field, void* out,
                                      const void* bases, const void* members,
                                      const void* starts, const void* counts,
                                      long long BL, long long n, long long L,
                                      void* stream) {
  if (L <= 0) return 0;
  if (BL <= 0 || L % BL != 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = spread_threads(L);
  dim3 grid((unsigned)((L + threads - 1) / threads));
  auto kern = field ? pmixed_bucket_runs_kernel<1> : pmixed_bucket_runs_kernel<0>;
  kern<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const uint4*)bases, (const int32_t*)members,
      (const int32_t*)starts, (const int32_t*)counts, (uint32_t)BL,
      (uint32_t)n, (uint32_t)L);
  return (int)cudaGetLastError();
}

extern "C" int h2t_padd(int field, void* out, const void* a, const void* b,
                        long long L, void* stream) {
  return launch_lanes(field, padd_kernel<0>, padd_kernel<1>, L, stream,
                      (int32_t*)out, (const int32_t*)a, (const int32_t*)b,
                      (uint32_t)L);
}

extern "C" int h2t_pdouble(int field, void* out, const void* a, long long L,
                           void* stream) {
  return launch_lanes(field, pdouble_kernel<0>, pdouble_kernel<1>, L, stream,
                      (int32_t*)out, (const int32_t*)a, (uint32_t)L);
}

extern "C" int h2t_pdouble_masked(int field, void* out, const void* a,
                                  const void* mask, long long L,
                                  void* stream) {
  return launch_lanes(field, pdouble_masked_kernel<0>,
                      pdouble_masked_kernel<1>, L, stream, (int32_t*)out,
                      (const int32_t*)a, (const int32_t*)mask, (uint32_t)L);
}
