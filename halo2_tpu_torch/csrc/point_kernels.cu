// Kernels B2-B6: complete additions and doublings of Pasta points in
// homogeneous projective coordinates (Renes-Costello-Batina 2015, a = 0,
// b3 = 15): the bucket and reduction rounds of every Pippenger commit, and
// the GLV ladder that folds G' in the device IPA rounds.
//
// B2 (pmixed_masked) replaces halo2_tpu/ops/pallas_point.py::
// _pmixed_masked_kernel (:297, built at :463/:477, wrapped by
// pmixed_masked_flat at :613): out = mask ? A +/- B_aff : A with the RCB
// Alg 8 mixed add (11 wide multiplies), the per-lane sign negating y as
// p - y, and identity-coded (0, mont 1) bases masked off in-kernel.
// B3 (padd_masked) replaces _padd_masked_kernel (:281, _build_padd(seg=True)
// at :426/:442, wrapped by padd_masked_flat at :591): out = mask ? A + B : A
// with the RCB Alg 7 complete add (12 wide multiplies).
// B4 (padd) replaces _padd_kernel (:266, _build_padd(seg=False) at
// :426/:451, wrapped by padd_flat at :574): the unmasked complete add.
// B5 (pdouble) replaces _pdouble_kernel (:274, _build_pdouble(masked=False)
// at :489/:512, wrapped by pdouble_flat at :663): RCB Alg 9 doubling
// (8 wide multiplies). B6 (pdouble_masked) replaces _pdouble_masked_kernel
// (:330, _build_pdouble(masked=True) at :489/:503, wrapped by
// pdouble_masked_flat at :677): out = mask ? 2A : A.
//
// Layout: a point batch is [48, L] int32 (rows 0-15 X, 16-31 Y, 32-47 Z
// as 16-bit Montgomery digits, lanes last); an affine batch is [32, L].
// One thread per lane: neighbouring threads read neighbouring words of
// each row, so every load and store coalesces. The formulas are written
// straight-line with all coordinates in registers (8 x 32-bit limbs each).
//
// Bound on an H100: B3 moves 2 x 192 + 4 bytes in and 192 out per lane
// (580 B, 173 ps at 3.35 TB/s) and does 12 Montgomery products of 224
// 32-bit multiply-adds (80 ps at 33.5e12 multiply-adds/s); B2 moves
// 192 + 128 + 8 in and 192 out (520 B) for 11 products; B4 576 B for 12
// products; B5 384 B for 8 products (53 ps); B6 388 B for 8 products on its
// live lanes. All are therefore near the balance point; in practice the
// integer multiplier (half the float rate) and register pressure decide.
// The design does the masked-off lanes' work as a plain copy (no
// products), keeps every intermediate in registers, and never re-reads an
// input.
#include "field.cuh"

using namespace h2t;

struct Pt {
  uint32_t x[8], y[8], z[8];
};

// RCB15 Alg 7 on field values (the polynomials of pallas_point._rcb_add)
template <int F>
__device__ __forceinline__ void rcb_add(Pt& o, const Pt& a, const Pt& b) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], xz[8], u[8], v[8];
  mont_mul<F>(t0, a.x, b.x);
  mont_mul<F>(t1, a.y, b.y);
  mont_mul<F>(t2, a.z, b.z);
  add<F>(u, a.x, a.y);
  add<F>(v, b.x, b.y);
  mont_mul<F>(t3, u, v);
  sub<F>(t3, t3, t0);
  sub<F>(t3, t3, t1);  // X1Y2 + X2Y1
  add<F>(u, a.y, a.z);
  add<F>(v, b.y, b.z);
  mont_mul<F>(t4, u, v);
  sub<F>(t4, t4, t1);
  sub<F>(t4, t4, t2);  // Y1Z2 + Y2Z1
  add<F>(u, a.x, a.z);
  add<F>(v, b.x, b.z);
  mont_mul<F>(xz, u, v);
  sub<F>(xz, xz, t0);
  sub<F>(xz, xz, t2);  // X1Z2 + X2Z1
  uint32_t s0[8], b3z[8], z3[8], s1[8], y3[8];
  add<F>(s0, t0, t0);
  add<F>(s0, s0, t0);  // 3 X1X2
  mul15<F>(b3z, t2);
  add<F>(z3, t1, b3z);
  sub<F>(s1, t1, b3z);
  mul15<F>(y3, xz);
  mont_mul<F>(u, t3, s1);
  mont_mul<F>(v, t4, y3);
  sub<F>(o.x, u, v);
  mont_mul<F>(u, y3, s0);
  mont_mul<F>(v, s1, z3);
  add<F>(o.y, u, v);
  mont_mul<F>(u, z3, t4);
  mont_mul<F>(v, s0, t3);
  add<F>(o.z, u, v);
}

// RCB15 Alg 8: second operand affine (Z2 = 1); the polynomials of
// pallas_point._rcb_mixed_add
template <int F>
__device__ __forceinline__ void rcb_mixed_add(Pt& o, const Pt& a,
                                              const uint32_t x2[8],
                                              const uint32_t y2[8]) {
  uint32_t t0[8], t1[8], t3[8], t4[8], xz[8], u[8], v[8];
  mont_mul<F>(t0, a.x, x2);
  mont_mul<F>(t1, a.y, y2);
  add<F>(u, a.x, a.y);
  add<F>(v, x2, y2);
  mont_mul<F>(t3, u, v);
  sub<F>(t3, t3, t0);
  sub<F>(t3, t3, t1);  // X1Y2 + X2Y1
  mont_mul<F>(t4, y2, a.z);
  add<F>(t4, t4, a.y);  // Y1 + Y2 Z1
  mont_mul<F>(xz, x2, a.z);
  add<F>(xz, xz, a.x);  // X1 + X2 Z1
  uint32_t s0[8], b3z[8], z3[8], s1[8], y3[8];
  add<F>(s0, t0, t0);
  add<F>(s0, s0, t0);  // 3 X1X2
  mul15<F>(b3z, a.z);  // b3 Z1 Z2 = 15 Z1
  add<F>(z3, t1, b3z);
  sub<F>(s1, t1, b3z);
  mul15<F>(y3, xz);
  mont_mul<F>(u, t3, s1);
  mont_mul<F>(v, t4, y3);
  sub<F>(o.x, u, v);
  mont_mul<F>(u, y3, s0);
  mont_mul<F>(v, s1, z3);
  add<F>(o.y, u, v);
  mont_mul<F>(u, z3, t4);
  mont_mul<F>(v, s0, t3);
  add<F>(o.z, u, v);
}

// RCB15 Alg 9 doubling: the polynomials of pallas_point._rcb_double (and
// msm_pallas._host_proj_double). Any other doubling formula gives another
// projective representative of 2A, and the IPA's G' fold state is held
// bit for bit against the reference's.
template <int F>
__device__ __forceinline__ void rcb_double(Pt& o, const Pt& a) {
  uint32_t t0[8], t1[8], t2[8], xy[8], z3[8], y3[8], u[8], v[8];
  mont_mul<F>(t0, a.y, a.y);
  mont_mul<F>(t1, a.y, a.z);
  mont_mul<F>(u, a.z, a.z);
  mont_mul<F>(xy, a.x, a.y);
  add<F>(z3, t0, t0);
  add<F>(z3, z3, z3);
  add<F>(z3, z3, z3);  // 8 Y^2
  mul15<F>(t2, u);     // b3 Z^2
  add<F>(y3, t0, t2);
  add<F>(u, t2, t2);
  add<F>(u, u, t2);
  sub<F>(t0, t0, u);   // Y^2 - 3 b3 Z^2
  mont_mul<F>(u, t2, z3);
  mont_mul<F>(o.z, t1, z3);
  mont_mul<F>(v, t0, y3);
  add<F>(o.y, v, u);
  mont_mul<F>(v, t0, xy);
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

template <int F>
__global__ void padd_masked_kernel(int32_t* __restrict__ out,
                                   const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b,
                                   const int32_t* __restrict__ mask,
                                   uint32_t L) {
  uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  if (mask[l] == 0) {
    copy_rows(out + l, a + l, L, 48);
    return;
  }
  Pt p, q, r;
  load_pt(p, a + l, L);
  load_pt(q, b + l, L);
  rcb_add<F>(r, p, q);
  store_pt(out + l, L, r);
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

static const int kThreads = 128;

// Launch the field's instance (k0 for Fp, k1 for Fq) over L lanes, one
// thread per lane, on `stream`; returns cudaGetLastError().
template <typename... P, typename... A>
static int launch_lanes(int field, void (*k0)(P...), void (*k1)(P...),
                        long long L, void* stream, A... args) {
  if (L <= 0) return 0;
  dim3 grid((unsigned)((L + kThreads - 1) / kThreads));
  void (*k)(P...) = field == 0 ? k0 : k1;
  k<<<grid, kThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

extern "C" int h2t_padd_masked(int field, void* out, const void* a,
                               const void* b, const void* mask, long long L,
                               void* stream) {
  return launch_lanes(field, padd_masked_kernel<0>, padd_masked_kernel<1>,
                      L, stream, (int32_t*)out, (const int32_t*)a,
                      (const int32_t*)b, (const int32_t*)mask, (uint32_t)L);
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
