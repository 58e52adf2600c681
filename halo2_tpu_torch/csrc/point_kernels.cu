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
// One thread per lane (B3), one lane a group of four threads (B4, the
// scalar ladder), or either by lane count (B2, B5, B6, the GLV ladder,
// the bucket-run kernel; see the last notes): neighbouring lanes read
// neighbouring words of each row, so every load and store coalesces (B3's
// index form gathers). The formulas are written straight-line with the
// coordinates in registers (8 x 32-bit limbs each).
//
// What bounds them on an H100, and what the design does about it:
// - By the roofline B3 moves 2 x 192 + 4 bytes in and 192 out per lane
//   (580 B, 173 ps at 3.35 TB/s) against 12 Montgomery products of 224
//   32-bit multiply-adds (161 ps at 16.7e12 multiply-adds/s); B2 moves
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
//   32 strided reads). A warp runs as long as its longest run (so the
//   lanes go longest run first; see the last note); splitting long runs
//   over more threads would change the order of additions (ROADMAP B).
//   One thread a lane, at 26,624 lanes (six warps a SM) each thread is a
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
//   one launch keeps it in registers, stages P in shared memory and calls
//   the product (the instruction-fetch finding above). Unlike the GLV
//   ladder, each lane reads its own scalar: row l % T of a [T, 16] digit
//   table (T = L for one scalar a lane; T = half for a group-NTT stage,
//   whose lanes share the stage's half twiddles, so no n/2-row copy is
//   written). So lanes of one warp hold different bits, and with random
//   scalars a warp runs the add on nearly every step. The fused butterfly
//   adds two complete adds (24 products) and saves the two B4 launches and
//   the negation of a stage.
// - Block size (B3 and the GLV ladder one thread a lane): `nvcc -Xptxas -v`
//   reports 106, 122 and 124 registers for B3's lane, offset and index forms
//   and 96 (with a 672-byte stack frame) for the ladder, no spills. A
//   128-thread block then holds 12-16K of an SM's 64K registers (and the
//   ladder's 36 KB of shared memory), so every block of B3's 26,624 lanes or
//   the ladder's 8,192 is resident at once, and what the block size decides
//   is how evenly the lanes spread over the 132 SMs. spread_threads picks,
//   from 32, 64 and 128 threads, the size that puts the fewest threads on the
//   busiest SM (B3 at 26,624 lanes: 32, at most 224 a SM against 256; the
//   ladder at 8,192 lanes: 64, one block on each of 128 SMs, where 128
//   threads would fill only 64 SMs). For the ladder with inlined products,
//   32, 64 and 128 measured the same (ladder_variants.py).
// - B4 and the scalar ladder, one thread a lane, ran a chain of dependent
//   products at too few warps to hide it: B4 12 inlined products in
//   fixed 128-thread blocks (8,192 lanes filled 64 of the 132 SMs with
//   four warps each: 0.01289 ms against a 0.00141 ms byte bound); the
//   scalar ladder about 5,100 called products at 2^13 lanes (two warps a
//   SM: 4.02 ms against 0.197) and, at 168 registers, at most 12 warps a
//   SM at 2^17 (21.9 ms against 3.15; NVIDIA H100 80GB HBM3, 700 W;
//   PERF.md). RCB's formulas leave parallelism unused: Alg 7's 12
//   products fall into two stages of 6 independent ones, with only adds
//   and two mul15 between them, Alg 9's 8 into two stages of 4. So a group
//   of four threads serves a lane (coop_add, coop_double): Alg 7 runs in
//   four product rounds on three ranks, Alg 9 in two on four, the
//   results exchanged by shuffles within the group, and the card holds
//   four times the warps at the same lane count. The price is the sums,
//   which every rank runs on its own values (15 field adds an add, 10 a
//   doubling, against 21 and 11 on one thread), the selects and shuffles
//   around them, and rank 3's idle add: more issued instructions a lane,
//   where the lanes already fill the card. B4 launches L x 4 threads in
//   blocks from spread_threads, so 8,192 lanes reach every SM; the ladder
//   stages P once a group (25 words, not 24 a thread). wgmma, TMA and
//   clusters fit none of this: 8 x 32-bit limb products are IMAD work, and
//   each lane reads its operands once.
// - Measured beside the one-thread forms in one process
//   (redesign_variants.py; NVIDIA H100 80GB HBM3, 700 W; PERF.md): B4
//   0.0083 ms at 8,192 lanes against 0.0141, the ladder 2.12 ms a 2^13-
//   lane stage against 4.03, from 112 and 168 registers to 79 and 122.
//   Where the lanes fill the card the group loses: B4 0.0817 ms at 2^17
//   against 0.0721, the ladder 28.6 ms a 2^17-lane stage against 22.0,
//   since the card is then bound by issued instructions and the group
//   issues about 1.5x as many a lane. The add as an always-computed add
//   and a select measured the same as the branch; the ladder's products
//   inlined (13,832 SASS instructions against 8,576) ran 1.2-1.7x slower;
//   the sums on rank 0 alone, their results shuffled out, 8-23% slower.
// - B5 and B6 run in either form, picked by lane count at launch: one lane
//   a group of four threads (coop_double, the products inlined; 63 and 72
//   registers, 3,664 and 3,688 SASS instructions) below kPdoubleLaneFrom
//   and kPdoubleMaskedLaneFrom (30,720) lanes, one thread a lane
//   (rcb_double inlined; 106 and 109 registers, 5,064 instructions each)
//   from there, both in blocks from spread_threads. The doubling suits the
//   group better than the add: every rank is busy in both product rounds
//   and the dependent chain is 2 products, not 8. One thread a lane,
//   8,192 lanes are 256 warps: the 0.0084 ms of the form in fixed
//   128-thread blocks (64 SMs) is latency; the group takes 0.0045 ms.
//   At 2^17 lanes the card is full either way and the group's extra sums
//   and shuffles cost more than its warps buy (0.0428 against 0.0416 ms).
//   Between 26,624 and 30,720 lanes the two forms are within 1-8%; the
//   threshold is the first measured width from which one thread wins at
//   every wider one (redesign_variants.py; NVIDIA H100 80GB HBM3, 700 W,
//   each time a launch from a CUDA graph of 20; PERF.md).
// - B6 doubles every lane and keeps a masked-off lane's input by a select,
//   reading the mask word before the doubling. Measured against it with
//   half the lanes live at 2^17 (same process): a branch of each lane to
//   a copy before any load, 1.3x slower (a warp runs both paths; 1.4x for
//   the group); a vote of the warp that skips the doubling where none of its
//   lanes is live, taken after the loads (138 registers) or before them
//   (114), 2.3-2.4x faster with no lane live but 8-14% slower with half.
//   Also tried and not kept: a pair of threads a lane (Alg 9's stages two
//   products a rank, 84 registers; never the fastest, behind both forms
//   at 2^17) and __launch_bounds__(128, 5, 6 or 8) on the one-thread form,
//   which caps it at 96, 80 or 64 registers, each with spills, and is
//   slower at 2^17.
// - The GLV ladder and the bucket-run kernel run in either form as well,
//   picked by lane count at launch: one lane a group of four threads
//   (coop_double, coop_add, the products called) below kGlvLaneFrom
//   (32,768) and kBucketLaneFrom (45,056) lanes, one thread a lane from
//   there. One thread a lane, the ladder is a chain of about 20 dependent
//   products a step at two warps a SM or fewer: 1.95-1.99 ms a launch at
//   1 to 8,192 lanes, whatever the width. The group (95 registers and a
//   272-byte stack frame against 96 and 672; 4,600 SASS instructions
//   against 3,752) takes 0.645-0.671 ms at 1 to 4,096 lanes and 0.927 at
//   8,192; from 32,768 lanes one thread wins at every width measured
//   (9.427 against 12.259 ms at 2^17: the card is full, and the group
//   issues more a lane). Its products inlined (9,496 instructions) won
//   only at 1 and 2 lanes (0.550 ms) and lost from 1,024 on.
// - A warp of the bucket-run kernel runs as long as its longest run, so
//   both forms serve the lanes longest run first: thread (group) i takes
//   lane lanes[i], the wrapper's argsort of the run lengths on the card.
//   Each lane's sum is the same whichever thread makes it. That alone
//   took one thread a lane from 0.767 to 0.707 ms at 26,624 lanes and
//   from 5.475 to 3.886 at 163,840, the group from 0.869 to 0.562 at
//   26,624 (the argsort adds about 0.06-0.1 ms a call, host included).
//   Sorted, the group (84 registers, 2,920 instructions, against 96 and
//   2,080) wins up to 39,936 lanes, one thread from 45,056 (a k = 17
//   column) at every width measured. Loading the next member and its base
//   word before each add measured no faster. (redesign_variants.py --only
//   glv|bucket; NVIDIA H100 80GB HBM3, 700 W; each a launch from a CUDA
//   graph; PERF.md.)
// - B2 runs in either form too, below and from kPmixedLaneFrom (26,624)
//   lanes: one lane a group of four threads (coop_add with Z2 = mont 1,
//   its products inlined; 80 registers, 5,376 SASS instructions) or one
//   thread a lane (rcb_mixed_add inlined; 124 registers, 7,624), both in
//   blocks from spread_threads. Every rank reads the mask word and the
//   whole base, so the identity test and the sign need no exchange; a
//   masked-off or identity lane is a branch of the group. Each a launch
//   from a CUDA graph of 20, a random 80% of the lanes live
//   (redesign_variants.py --only b2; NVIDIA H100 80GB HBM3, 700 W;
//   PERF.md): the group 0.0050-0.0081 ms at 1 to 8,192 lanes against
//   0.0114-0.0138 one thread a lane (the form in fixed 128-thread blocks
//   the same), 0.0168 against 0.0181-0.0201 at 20,480; level at 24,576
//   (0.0195 both); from 26,624 to 2^17 one thread wins at every width
//   (0.0195 against 0.0233 at 26,624, 0.0860-0.0863 against 0.0945 at
//   2^17): B2's add is Alg 8, 11 products a lane, where the group runs 16
//   and every rank its own sums, so the group issues more a lane and
//   loses once the lanes give the one-thread form six warps an SM. At
//   163,840 lanes the group won (0.1124 against 0.1178-0.1211): one
//   thread a lane at 124 registers holds 16 warps an SM, and 163,840
//   lanes leave it a third, part-filled wave.
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

// ---------------------------------------------------------------------------
// Cooperative forms (B4 and the scalar-multiplication ladder): a group of
// kGroup consecutive threads of a warp serves one lane. Rank r (thread
// index % kGroup) holds coordinate c(r) = {X, Y, Z, X}[r] of a point, 8
// limbs; rank 3 repeats rank 0's part of the add, so it always holds X.
// Each stage's independent products are dealt out over the ranks and the
// results exchanged with __shfl_sync over the group's four lanes. For rank
// r, nibble r of each map names the rank a shuffle reads. The sums between
// stages run on every rank, each on its own values, and pick their
// operands by rank with selects, so the group never diverges. Every value
// is a canonical field element and every product the same mont_mul on the
// same operands as rcb_add / rcb_double, so the results are theirs bit for
// bit (tests/test_torch_coop_point.py runs this schedule on the CPU).
static constexpr int kGroup = 4;
// c(r) + 1 (mod 3): the rank that holds the next coordinate
static constexpr uint32_t kNext = 0x1021;
// Alg 7, stage 2: round 1's first and second operands, round 2's first
static constexpr uint32_t kAddOpA1 = 0x1121;
static constexpr uint32_t kAddOpB1 = 0x2102;
static constexpr uint32_t kAddOpA2 = 0x1011;
// Alg 9: stage 1's operands, and where each rank's result coordinate lies
static constexpr uint32_t kDblOpA = 0x0211;
static constexpr uint32_t kDblOpB = 0x1221;
static constexpr uint32_t kDblOut = 0x3103;

__device__ __forceinline__ int nib(uint32_t map, int r) {
  return (int)((map >> (4 * r)) & 15u);
}

// the four lanes of the calling thread's group
__device__ __forceinline__ unsigned group_mask() {
  return 0xFu << (threadIdx.x & 31u & ~(unsigned)(kGroup - 1));
}

// o = v of rank src of the group, limb by limb (o may alias v)
__device__ __forceinline__ void shfl8(uint32_t o[8], const uint32_t v[8],
                                      int src, unsigned gm) {
#pragma unroll
  for (int i = 0; i < 8; i++) o[i] = __shfl_sync(gm, v[i], src, kGroup);
}

// o = {v0, v1, v2}[q]
__device__ __forceinline__ void select3(uint32_t o[8], int q,
                                        const uint32_t v0[8],
                                        const uint32_t v1[8],
                                        const uint32_t v2[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) o[i] = q == 0 ? v0[i] : q == 1 ? v1[i] : v2[i];
}

// RCB15 Alg 7 over a group: a0 and b0 hold coordinate c(r) of A and B, a1
// and b1 coordinate c(r) + 1 (mod 3); o gets coordinate c(r) of A + B.
// Two stages of two product rounds (ranks 0-2 busy, rank 3 repeating rank
// 0), the dependent chain 4 products instead of 12. o may alias a0.
template <int F, bool CALL>
__device__ __forceinline__ void coop_add(uint32_t o[8], const uint32_t a0[8],
                                         const uint32_t a1[8],
                                         const uint32_t b0[8],
                                         const uint32_t b1[8], int r,
                                         unsigned gm) {
  const int q = r == 3 ? 0 : r;
  uint32_t t[8], m[8], u[8], v[8];
  // stage 1: t0, t1, t2 = A_q B_q and (A_q + A_q+1)(B_q + B_q+1) at rank q
  pmul<F, CALL>(t, a0, b0);
  add<F>(u, a0, a1);
  add<F>(v, b0, b1);
  pmul<F, CALL>(m, u, v);
  uint32_t tn[8], d[8], g3[8], f[8], z[8], s[8];
  shfl8(tn, t, nib(kNext, r), gm);  // t1, t2, t0 at ranks 0, 1, 2
  sub<F>(d, m, t);
  sub<F>(d, d, tn);                 // t3, t4, xz at ranks 0, 1, 2
  select(u, q == 0, t, tn);         // t0 at ranks 0 and 2
  add<F>(g3, u, u);
  add<F>(g3, g3, u);                // s0 = 3 t0 at ranks 0 and 2
  select(u, q == 2, d, tn);
  mul15<F>(f, u);                   // b3z = 15 t2 at 1, y3 = 15 xz at 2
  add<F>(z, t, f);                  // z3 = t1 + b3z at 1
  sub<F>(s, t, f);                  // s1 = t1 - b3z at 1
  // stage 2, round 1: t4 y3, y3 s0, t4 z3 at ranks 0, 1, 2
  select(u, q == 2, f, d);
  shfl8(u, u, nib(kAddOpA1, r), gm);
  select3(v, q, g3, z, f);
  shfl8(v, v, nib(kAddOpB1, r), gm);
  pmul<F, CALL>(m, u, v);
  // round 2: s1 t3, s1 z3, t3 s0 (the second operand is the rank's own)
  select(u, q == 1, s, d);
  shfl8(u, u, nib(kAddOpA2, r), gm);
  select3(v, q, d, z, g3);
  pmul<F, CALL>(t, u, v);
  // X3 = s1 t3 - t4 y3, Y3 = y3 s0 + s1 z3, Z3 = z3 t4 + s0 t3
  sub<F>(u, t, m);
  add<F>(v, m, t);
  select(o, q == 0, u, v);
}

// RCB15 Alg 9 over a group: c holds coordinate c(r) of A; o gets coordinate
// c(r) of 2A. Two stages of one product round each (every rank busy), the
// dependent chain 2 products instead of 8. o may alias c.
template <int F, bool CALL>
__device__ __forceinline__ void coop_double(uint32_t o[8], const uint32_t c[8],
                                            int r, unsigned gm) {
  uint32_t a[8], b[8], p[8], e[8], f[8];
  shfl8(a, c, nib(kDblOpA, r), gm);
  shfl8(b, c, nib(kDblOpB, r), gm);
  pmul<F, CALL>(p, a, b);           // Y^2, YZ, Z^2, XY at ranks 0-3
  add<F>(e, p, p);
  add<F>(e, e, e);
  add<F>(e, e, e);                  // z3 = 8 Y^2 at rank 0
  add<F>(f, e, e);
  sub<F>(f, f, p);                  // t2 = 15 Z^2 (b3 Z^2) at rank 2
  uint32_t t0[8], z3[8], t2[8];
  shfl8(t0, p, 0, gm);
  shfl8(z3, e, 0, gm);
  shfl8(t2, f, 2, gm);
  add<F>(f, t0, t2);                // y3
  add<F>(e, t2, t2);
  add<F>(e, e, t2);
  sub<F>(t0, t0, e);                // Y^2 - 3 b3 Z^2
  // stage 2: t0 y3, t1 z3 (= Z3), t2 z3, t0 xy at ranks 0-3
  select(a, r == 2, t2, t0);
  select(a, r == 1, p, a);
  select(b, r == 0, f, z3);
  select(b, r == 3, p, b);
  pmul<F, CALL>(e, a, b);
  shfl8(f, e, 2, gm);
  select(f, r == 0, f, e);
  add<F>(f, e, f);                  // Y3 at rank 0, X3 = 2 t0 xy at rank 3
  select(f, r == 1, e, f);          // Z3 at rank 1
  shfl8(o, f, nib(kDblOut, r), gm);
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
// the most lanes a cooperative kernel takes (its thread index is 32-bit)
static const long long kMaxGroupLanes = (1LL << 32) / 4 - kMaxThreads;
// B5 (B6) runs one lane a group of kGroup threads below kPdoubleLaneFrom
// (kPdoubleMaskedLaneFrom) lanes, one thread a lane from there up; so do
// the GLV ladder below kGlvLaneFrom and the bucket-run kernel below
// kBucketLaneFrom
static constexpr int kPdoubleLaneFrom = 30720;
static constexpr int kPdoubleMaskedLaneFrom = 30720;
static constexpr int kGlvLaneFrom = 32768;
static constexpr int kBucketLaneFrom = 45056;
// B2 runs one lane a group of kGroup threads below kPmixedLaneFrom lanes,
// one thread a lane from there up
static constexpr int kPmixedLaneFrom = 26624;
// words of shared memory a group of the GLV ladder's group form: its three
// table points (72 limbs) and a pad, so that the ranks' reads of one
// coordinate of each of the warp's eight groups fall in distinct banks
static constexpr int kGlvTabStride = 73;

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

// glv_ladder, one lane a group of kGroup threads (coop_double, coop_add):
// rank r keeps coordinate c(r) of acc in registers. Ranks 0-2 stage
// coordinate c(r) of the lane's three table points once a group in dynamic
// shared memory (kGlvTabStride words a group); at an add each rank reads
// coordinates c(r) and c(r) + 1 of point sel - 1. The bits are the same
// for every lane, so the add is a branch that no warp diverges on.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
glv_ladder_group_kernel(int32_t* __restrict__ out,
                        const int32_t* __restrict__ t1,
                        const int32_t* __restrict__ t2,
                        const int32_t* __restrict__ t12, LadderBits bits,
                        uint32_t nbits, uint32_t L) {
  extern __shared__ uint32_t tab[];
  const uint32_t g = threadIdx.x / kGroup;
  const uint32_t l = blockIdx.x * (blockDim.x / kGroup) + g;
  if (l >= L) return;  // whole groups: kGroup divides the block
  const int r = threadIdx.x % kGroup;
  const unsigned gm = group_mask();
  const int c = r == 3 ? 0 : r, cn = nib(kNext, r);
  const size_t row = (size_t)16 * c * L + l;
  uint32_t* T = tab + kGlvTabStride * g;
  uint32_t acc[8], a1[8], b0[8], b1[8];
  if (r < 3) {
    const int32_t* srcs[3] = {t1, t2, t12};
#pragma unroll
    for (int k = 0; k < 3; k++) {
      load_rows(acc, srcs[k] + row, L);
#pragma unroll
      for (int i = 0; i < 8; i++) T[24 * k + 8 * r + i] = acc[i];
    }
  }
  __syncwarp(gm);
#pragma unroll
  for (int i = 0; i < 8; i++) acc[i] = c == 1 ? Field<F>::one(i) : 0u;
  uint32_t w1 = 0, w2 = 0;
#pragma unroll 1
  for (uint32_t s = 0; s < nbits; s++) {
    if ((s & 31) == 0) {
      // the words of steps s..s+31, read by constant index from the
      // parameters (no copy in local memory)
#pragma unroll
      for (int w = 0; w < 5; w++) {
        if (w == (int)(s >> 5)) {
          w1 = bits.b1[w];
          w2 = bits.b2[w];
        }
      }
    }
    coop_double<F, true>(acc, acc, r, gm);
    const uint32_t b = s & 31;
    const uint32_t sel = ((w1 >> b) & 1u) | (((w2 >> b) & 1u) << 1);
    if (sel == 0) continue;
    shfl8(a1, acc, cn, gm);
    const uint32_t* e = T + 24 * (sel - 1);
#pragma unroll
    for (int i = 0; i < 8; i++) {
      b0[i] = e[8 * c + i];
      b1[i] = e[8 * cn + i];
    }
    coop_add<F, true>(acc, acc, a1, b0, b1, r, gm);
  }
  if (r < 3) store_rows(out + row, L, acc);
}

// scalar_mul_ladder: acc = O; for s = nbits - 1 down to 0: acc = 2 acc,
// then acc = acc + P where bit s of the lane's scalar is set. Lane l reads
// P = pts[l] and its scalar from row l % T of `digits` (16 canonical
// 16-bit digits, int32). With lo, out = lo + acc and out2 = lo - acc (the
// group NTT's butterfly), else out = acc. One lane a group of kGroup
// threads (coop_double, coop_add): rank r keeps coordinate c(r) of acc in
// registers; P is staged once a group in dynamic shared memory, 25 words a
// group (24 limbs and a pad, so that the ranks' reads of coordinates 0-2
// of the warp's eight groups fall in 24 distinct banks). The group's bit
// is the same on all its ranks, so the add is a branch of the group.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
scalar_mul_ladder_kernel(int32_t* __restrict__ out,
                         int32_t* __restrict__ out2,
                         const int32_t* __restrict__ pts,
                         const int32_t* __restrict__ digits,
                         const int32_t* __restrict__ lo, uint32_t T,
                         uint32_t nbits, uint32_t L) {
  extern __shared__ uint32_t tab[];
  const uint32_t g = threadIdx.x / kGroup;
  const uint32_t l = blockIdx.x * (blockDim.x / kGroup) + g;
  if (l >= L) return;  // whole groups: kGroup divides the block
  const int r = threadIdx.x % kGroup;
  const unsigned gm = group_mask();
  const int c = r == 3 ? 0 : r, cn = nib(kNext, r);
  const size_t row = (size_t)16 * c * L + l;
  uint32_t* P = tab + 25 * g;
  uint32_t acc[8], a1[8], b0[8], b1[8];
  load_rows(acc, pts + row, L);
  if (r < 3) {
#pragma unroll
    for (int i = 0; i < 8; i++) P[8 * r + i] = acc[i];
  }
  __syncwarp(gm);
#pragma unroll
  for (int i = 0; i < 8; i++) acc[i] = c == 1 ? Field<F>::one(i) : 0u;
  const int32_t* d = digits + (size_t)(l % T) * 16;
  uint32_t word = 0;
#pragma unroll 1
  for (int s = (int)nbits - 1; s >= 0; s--) {
    if (s == (int)nbits - 1 || (s & 31) == 31) {
      const int w = s >> 5;
      word = ((uint32_t)d[2 * w] & 0xFFFFu) |
             (((uint32_t)d[2 * w + 1] & 0xFFFFu) << 16);
    }
    coop_double<F, true>(acc, acc, r, gm);
    if (((word >> (s & 31)) & 1u) == 0) continue;
    shfl8(a1, acc, cn, gm);
#pragma unroll
    for (int i = 0; i < 8; i++) {
      b0[i] = P[8 * c + i];
      b1[i] = P[8 * cn + i];
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
  if (c == 1) neg_in_place<F>(acc);  // -acc: Y as p - Y, 0 kept
  shfl8(b1, acc, cn, gm);
  coop_add<F, true>(o, a0, a1, acc, b1, r, gm);
  if (r < 3) store_rows(out2 + row, L, o);
}

// B2: out = mask ? a +/- b : a, one thread a lane (rcb_mixed_add inlined)
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
pmixed_masked_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                     const int32_t* __restrict__ b,
                     const int32_t* __restrict__ mask,
                     const int32_t* __restrict__ sign, uint32_t L) {
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

// B2, one lane a group of kGroup threads: coop_add with Z2 = mont(1), which
// gives Alg 8's field values bit for bit (as the bucket-run kernel's group
// form). Every rank reads the lane's mask word and, where it is set, the
// whole base, so the identity test and the sign act on x and y before
// select3 spreads them over the ranks as b0 = {x, y, 1}[c(r)] and
// b1 = {y, 1, x}[c(r)]; a masked-off or identity lane is a branch of the
// whole group (ranks 0-2 copy their coordinate of A). Rank r reads
// coordinate c(r) of A and takes the next one from its neighbour; ranks
// 0-2 write X, Y and Z.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
pmixed_masked_group_kernel(int32_t* __restrict__ out,
                           const int32_t* __restrict__ a,
                           const int32_t* __restrict__ b,
                           const int32_t* __restrict__ mask,
                           const int32_t* __restrict__ sign, uint32_t L) {
  const uint32_t l = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (l >= L) return;  // whole groups: kGroup divides the block
  const int r = threadIdx.x % kGroup;
  const int c = r == 3 ? 0 : r;
  const size_t row = (size_t)16 * c * L + l;
  uint32_t x2[8], y2[8];
  bool live = mask[l] != 0;
  if (live) {
    load_rows(x2, b + l, L);
    load_rows(y2, b + 16 * (size_t)L + l, L);
    // identity base marker: X == 0 and Y == mont(1) (not a curve point)
    live = !(is_zero(x2) && is_one<F>(y2));
  }
  if (!live) {
    if (r < 3) copy_rows(out + row, a + row, L, 16);
    return;
  }
  if (sign[l] != 0) {
    // -B = (x, p - y), as the one-thread form
    uint32_t p[8];
    load_p<F>(p);
    sub_raw(y2, p, y2);
  }
  const unsigned gm = group_mask();
  uint32_t one[8], a0[8], a1[8], b0[8], b1[8], o[8];
#pragma unroll
  for (int i = 0; i < 8; i++) one[i] = Field<F>::one(i);
  select3(b0, c, x2, y2, one);
  select3(b1, c, y2, one, x2);
  load_rows(a0, a + row, L);
  shfl8(a1, a0, nib(kNext, r), gm);
  coop_add<F, false>(o, a0, a1, b0, b1, r, gm);
  if (r < 3) store_rows(out + row, L, o);
}

// pmixed_bucket_runs: every lane l (bucket l % BL of window row l / BL)
// sums its run of affine bases from the identity, in the order of the
// B2 round loop it replaces: acc = O, then for r < counts[l], with
// m = members[row, starts[l] + r], acc = acc +/- bases[m & 0x7fffffff],
// negated where bit 31 of m is set; identity-coded bases are skipped.
// bases: point-major packed [n][16] words (x limbs 0-7, y limbs 0-7), 64 B
// per point, read as four 16-byte loads. Thread (or group) i serves lane
// lanes[i], a permutation of the lanes: sorted by run length, a warp's
// runs are alike (see the design note). The products are called, not
// inlined.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
pmixed_bucket_runs_kernel(int32_t* __restrict__ out,
                          const uint4* __restrict__ bases,
                          const int32_t* __restrict__ members,
                          const int32_t* __restrict__ starts,
                          const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ lanes, uint32_t BL,
                          uint32_t n, uint32_t L) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const uint32_t l = (uint32_t)lanes[i];
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

// pmixed_bucket_runs, one lane a group of kGroup threads: coop_add with
// Z2 = mont(1), which gives Alg 8's field values bit for bit (t2 = Z1,
// t4 = Y1 + Y2 Z1, xz = X1 + X2 Z1, b3z = 15 Z1), so the sums are the
// one-thread form's. Rank r keeps coordinate c(r) of acc, loads 16-byte
// word r of the member's packed base, and the group exchanges the four
// words by shuffles: each base is read once a group. A whole group skips
// an identity-coded base; a member with bit 31 set negates Y, as the
// one-thread form does.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
pmixed_bucket_runs_group_kernel(int32_t* __restrict__ out,
                                const uint4* __restrict__ bases,
                                const int32_t* __restrict__ members,
                                const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ counts,
                                const int32_t* __restrict__ lanes,
                                uint32_t BL, uint32_t n, uint32_t L) {
  const uint32_t i = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (i >= L) return;  // whole groups: kGroup divides the block
  const uint32_t l = (uint32_t)lanes[i];
  const int r = threadIdx.x % kGroup;
  const unsigned gm = group_mask();
  const int c = r == 3 ? 0 : r, cn = nib(kNext, r);
  const int32_t* run = members + (size_t)(l / BL) * n + (uint32_t)starts[l];
  const int32_t cnt = counts[l];
  uint32_t acc[8], a1[8], b0[8], b1[8], one[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    one[i] = Field<F>::one(i);
    acc[i] = c == 1 ? one[i] : 0u;
  }
#pragma unroll 1
  for (int32_t k = 0; k < cnt; k++) {
    const int32_t m = run[k];
    const uint4 q = bases[(size_t)(m & 0x7fffffff) * 4 + r];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t x2[8], y2[8];
#pragma unroll
    for (int i = 0; i < 4; i++) {
      x2[i] = __shfl_sync(gm, w[i], 0, kGroup);
      x2[4 + i] = __shfl_sync(gm, w[i], 1, kGroup);
      y2[i] = __shfl_sync(gm, w[i], 2, kGroup);
      y2[4 + i] = __shfl_sync(gm, w[i], 3, kGroup);
    }
    // identity base marker: X == 0 and Y == mont(1), masked off as B2 does
    if (is_zero(x2) && is_one<F>(y2)) continue;
    if (m < 0) {
      // -B = (x, p - y), as B2
      uint32_t p[8];
      load_p<F>(p);
      sub_raw(y2, p, y2);
    }
    select3(b0, c, x2, y2, one);
    select3(b1, c, y2, one, x2);
    shfl8(a1, acc, cn, gm);
    coop_add<F, true>(acc, acc, a1, b0, b1, r, gm);
  }
  if (r < 3) store_rows(out + (size_t)16 * c * L + l, L, acc);
}

// B4: out = a + b, one lane a group of kGroup threads (coop_add, the
// products inlined): rank r reads coordinate c(r) of a and b and takes the
// next one from its neighbour; ranks 0-2 write coordinates X, Y, Z.
template <int F>
__global__ void __launch_bounds__(kMaxThreads)
padd_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
            const int32_t* __restrict__ b, uint32_t L) {
  const uint32_t l = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (l >= L) return;  // whole groups: kGroup divides the block
  const int r = threadIdx.x % kGroup;
  const unsigned gm = group_mask();
  const size_t row = (size_t)16 * (r == 3 ? 0 : r) * L + l;
  uint32_t a0[8], a1[8], b0[8], b1[8], o[8];
  load_rows(a0, a + row, L);
  load_rows(b0, b + row, L);
  shfl8(a1, a0, nib(kNext, r), gm);
  shfl8(b1, b0, nib(kNext, r), gm);
  coop_add<F, false>(o, a0, a1, b0, b1, r, gm);
  if (r < 3) store_rows(out + row, L, o);
}

// B5 (out = 2a) and, with MASKED, B6 (out = mask ? 2a : a), the products
// inlined, in two forms. B6 doubles every lane and keeps a masked-off
// lane's input by a select, as the reference's kernel does, so no warp
// diverges (see the design note for the branches measured against it).
// One thread a lane (rcb_double):
template <int F, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
pdouble_lane_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                    const int32_t* __restrict__ mask, uint32_t L) {
  const uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  Pt p, r;
  load_pt(p, a + l, L);
  const bool live = !MASKED || mask[l] != 0;
  rcb_double<F>(r, p);
  if (!live) r = p;
  store_pt(out + l, L, r);
}

// One lane a group of kGroup threads (coop_double): rank r reads
// coordinate c(r), ranks 0-2 write X, Y, Z.
template <int F, bool MASKED>
__global__ void __launch_bounds__(kMaxThreads)
pdouble_group_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                     const int32_t* __restrict__ mask, uint32_t L) {
  const uint32_t l = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (l >= L) return;  // whole groups: kGroup divides the block
  const int r = threadIdx.x % kGroup;
  const size_t row = (size_t)16 * (r == 3 ? 0 : r) * L + l;
  uint32_t c[8], d[8];
  load_rows(c, a + row, L);
  const bool live = !MASKED || mask[l] != 0;
  coop_double<F, false>(d, c, r, group_mask());
  select(d, live, d, c);
  if (r < 3) store_rows(out + row, L, d);
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

// The block size of 32, 64 or 128 threads that puts the fewest threads on
// the busiest SM when L threads (a lane each, or kGroup a lane for the
// cooperative kernels, so a group never straddles a block) are dealt out
// in blocks; ties go to the larger block.
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

// Whether a form of `threads` threads a lane (1 or kGroup) takes L lanes
// (its thread index is 32-bit)
static bool form_takes(int threads, long long L) {
  return (threads == 1 || threads == kGroup) &&
         L <= (1LL << 32) / threads - kMaxThreads;
}

// The GLV ladder over L lanes in the form of `threads` threads a lane (1 or
// kGroup): L x threads threads in blocks of spread_threads(L x threads).
// bits1/bits2: host arrays of 5 words each (LadderBits); nbits <= 160
extern "C" int h2t_glv_ladder_form(int threads, int field, void* out,
                                   const void* t1, const void* t2,
                                   const void* t12, const uint32_t* bits1,
                                   const uint32_t* bits2, int nbits,
                                   long long L, void* stream) {
  if (L <= 0) return 0;
  if (!form_takes(threads, L) || nbits < 0 || nbits > 160)
    return (int)cudaErrorInvalidValue;
  LadderBits bits;
  for (int w = 0; w < 5; w++) {
    bits.b1[w] = bits1[w];
    bits.b2[w] = bits2[w];
  }
  typedef void (*Kern)(int32_t*, const int32_t*, const int32_t*,
                       const int32_t*, LadderBits, uint32_t, uint32_t);
  static const Kern kerns[2][2] = {
      {glv_ladder_kernel<0>, glv_ladder_group_kernel<0>},
      {glv_ladder_kernel<1>, glv_ladder_group_kernel<1>}};
  const long long n = L * threads;
  const int block = spread_threads(n);
  dim3 grid((unsigned)((n + block - 1) / block));
  const size_t words = threads == 1
                          ? (size_t)72 * block
                          : (size_t)kGlvTabStride * (block / kGroup);
  kerns[field != 0][threads == kGroup]
      <<<grid, block, words * sizeof(uint32_t), (cudaStream_t)stream>>>(
          (int32_t*)out, (const int32_t*)t1, (const int32_t*)t2,
          (const int32_t*)t12, bits, (uint32_t)nbits, (uint32_t)L);
  return (int)cudaGetLastError();
}

// The form of the GLV ladder (the bucket-run kernel) at L lanes: the faster
// one measured at that width (see the design note)
static int glv_threads(long long L) {
  return L >= kGlvLaneFrom ? 1 : kGroup;
}

static int bucket_threads(long long L) {
  return L >= kBucketLaneFrom ? 1 : kGroup;
}

extern "C" int h2t_glv_ladder(int field, void* out, const void* t1,
                              const void* t2, const void* t12,
                              const uint32_t* bits1, const uint32_t* bits2,
                              int nbits, long long L, void* stream) {
  return h2t_glv_ladder_form(glv_threads(L), field, out, t1, t2, t12, bits1,
                             bits2, nbits, L, stream);
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
  if (L > kMaxGroupLanes) return (int)cudaErrorInvalidValue;
  const long long n = L * kGroup;
  const int threads = spread_threads(n);
  dim3 grid((unsigned)((n + threads - 1) / threads));
  const size_t shmem = (size_t)25 * sizeof(uint32_t) * (threads / kGroup);
  auto kern = field ? scalar_mul_ladder_kernel<1> : scalar_mul_ladder_kernel<0>;
  kern<<<grid, threads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)out, (int32_t*)out2, (const int32_t*)pts,
      (const int32_t*)digits, (const int32_t*)lo, (uint32_t)T,
      (uint32_t)nbits, (uint32_t)L);
  return (int)cudaGetLastError();
}

// B2 over L lanes in the form of `threads` threads a lane (1 or kGroup):
// L x threads threads in blocks of spread_threads(L x threads)
extern "C" int h2t_pmixed_masked_form(int threads, int field, void* out,
                                      const void* a, const void* b,
                                      const void* mask, const void* sign,
                                      long long L, void* stream) {
  if (L <= 0) return 0;
  if (!form_takes(threads, L) || mask == nullptr || sign == nullptr)
    return (int)cudaErrorInvalidValue;
  typedef void (*Kern)(int32_t*, const int32_t*, const int32_t*,
                       const int32_t*, const int32_t*, uint32_t);
  static const Kern kerns[2][2] = {
      {pmixed_masked_kernel<0>, pmixed_masked_group_kernel<0>},
      {pmixed_masked_kernel<1>, pmixed_masked_group_kernel<1>}};
  const long long n = L * threads;
  const int block = spread_threads(n);
  dim3 grid((unsigned)((n + block - 1) / block));
  kerns[field != 0][threads == kGroup]
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (int32_t*)out, (const int32_t*)a, (const int32_t*)b,
          (const int32_t*)mask, (const int32_t*)sign, (uint32_t)L);
  return (int)cudaGetLastError();
}

// The form of B2 at L lanes: the faster one measured at that width (see
// the design note)
static int pmixed_threads(long long L) {
  return L >= kPmixedLaneFrom ? 1 : kGroup;
}

extern "C" int h2t_pmixed_masked(int field, void* out, const void* a,
                                 const void* b, const void* mask,
                                 const void* sign, long long L,
                                 void* stream) {
  return h2t_pmixed_masked_form(pmixed_threads(L), field, out, a, b, mask,
                                sign, L, stream);
}

// The bucket-run kernel over L lanes in the form of `threads` threads a
// lane (1 or kGroup), in blocks of spread_threads(L x threads). bases
// [n][16] packed words, members [L / BL][n], starts and counts [L], lanes
// [L] a permutation of 0..L-1 (thread or group i serves lane lanes[i])
extern "C" int h2t_pmixed_bucket_runs_form(int threads, int field, void* out,
                                           const void* bases,
                                           const void* members,
                                           const void* starts,
                                           const void* counts,
                                           const void* lanes, long long BL,
                                           long long n, long long L,
                                           void* stream) {
  if (L <= 0) return 0;
  if (!form_takes(threads, L) || BL <= 0 || L % BL != 0 || n <= 0 ||
      lanes == nullptr)
    return (int)cudaErrorInvalidValue;
  typedef void (*Kern)(int32_t*, const uint4*, const int32_t*,
                       const int32_t*, const int32_t*, const int32_t*,
                       uint32_t, uint32_t, uint32_t);
  static const Kern kerns[2][2] = {
      {pmixed_bucket_runs_kernel<0>, pmixed_bucket_runs_group_kernel<0>},
      {pmixed_bucket_runs_kernel<1>, pmixed_bucket_runs_group_kernel<1>}};
  const long long nt = L * threads;
  const int block = spread_threads(nt);
  dim3 grid((unsigned)((nt + block - 1) / block));
  kerns[field != 0][threads == kGroup]
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (int32_t*)out, (const uint4*)bases, (const int32_t*)members,
          (const int32_t*)starts, (const int32_t*)counts,
          (const int32_t*)lanes, (uint32_t)BL, (uint32_t)n, (uint32_t)L);
  return (int)cudaGetLastError();
}

extern "C" int h2t_pmixed_bucket_runs(int field, void* out,
                                      const void* bases, const void* members,
                                      const void* starts, const void* counts,
                                      const void* lanes, long long BL,
                                      long long n, long long L,
                                      void* stream) {
  return h2t_pmixed_bucket_runs_form(bucket_threads(L), field, out, bases,
                                     members, starts, counts, lanes, BL, n,
                                     L, stream);
}

// L x kGroup threads in blocks of spread_threads(L x kGroup)
extern "C" int h2t_padd(int field, void* out, const void* a, const void* b,
                        long long L, void* stream) {
  if (L <= 0) return 0;
  if (L > kMaxGroupLanes) return (int)cudaErrorInvalidValue;
  const long long n = L * kGroup;
  const int threads = spread_threads(n);
  dim3 grid((unsigned)((n + threads - 1) / threads));
  auto kern = field ? padd_kernel<1> : padd_kernel<0>;
  kern<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)a, (const int32_t*)b, (uint32_t)L);
  return (int)cudaGetLastError();
}

// B5 or, given a mask, B6 over L lanes in the form of `threads` threads a
// lane (1 or kGroup): L x threads threads in blocks of
// spread_threads(L x threads)
extern "C" int h2t_pdouble_form(int threads, int field, void* out,
                                const void* a, const void* mask, long long L,
                                void* stream) {
  if (L <= 0) return 0;
  if (!form_takes(threads, L)) return (int)cudaErrorInvalidValue;
  typedef void (*Kern)(int32_t*, const int32_t*, const int32_t*, uint32_t);
  static const Kern kerns[2][2][2] = {
      {{pdouble_lane_kernel<0, false>, pdouble_group_kernel<0, false>},
       {pdouble_lane_kernel<0, true>, pdouble_group_kernel<0, true>}},
      {{pdouble_lane_kernel<1, false>, pdouble_group_kernel<1, false>},
       {pdouble_lane_kernel<1, true>, pdouble_group_kernel<1, true>}}};
  const long long n = L * threads;
  const int block = spread_threads(n);
  dim3 grid((unsigned)((n + block - 1) / block));
  kerns[field != 0][mask != nullptr][threads == kGroup]
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (int32_t*)out, (const int32_t*)a, (const int32_t*)mask, (uint32_t)L);
  return (int)cudaGetLastError();
}

// The form of B5 (B6) at L lanes: the faster one measured at that width
// (see the design note)
static int pdouble_threads(long long L, bool masked) {
  return L >= (masked ? kPdoubleMaskedLaneFrom : kPdoubleLaneFrom) ? 1
                                                                     : kGroup;
}

extern "C" int h2t_pdouble(int field, void* out, const void* a, long long L,
                           void* stream) {
  return h2t_pdouble_form(pdouble_threads(L, false), field, out, a, nullptr,
                          L, stream);
}

extern "C" int h2t_pdouble_masked(int field, void* out, const void* a,
                                  const void* mask, long long L,
                                  void* stream) {
  if (mask == nullptr) return (int)cudaErrorInvalidValue;
  return h2t_pdouble_form(pdouble_threads(L, true), field, out, a, mask, L,
                          stream);
}
