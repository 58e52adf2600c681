// Pasta prime-field arithmetic for the port's CUDA kernels.
//
// A field element lives in registers as 8 little-endian 32-bit limbs in
// Montgomery form with R = 2^256 -- the same integers as the reference's
// 16 x 16-bit digits (halo2_tpu/fields/device.py), so every result is
// bit-identical to it. In device memory an element is 16 int32 digits
// (64 bytes); load_digits/store_digits repack.
//
// F selects the field: 0 = Fp (Pallas base, Vesta scalar), 1 = Fq.
// The constants below are checked against fields/host.py by
// tests/test_torch_field.py::test_cuda_header_constants.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace h2t {

template <int F> struct Field;

// p = 0x40000000000000000000000000000000224698fc094cf91b992d30ed00000001
template <> struct Field<0> {
  __device__ static __forceinline__ uint32_t p(int i) {
    switch (i) {
      case 0: return 0x00000001u; case 1: return 0x992d30edu;
      case 2: return 0x094cf91bu; case 3: return 0x224698fcu;
      case 7: return 0x40000000u; default: return 0u;
    }
  }
  // R mod p: the Montgomery form of 1
  __device__ static __forceinline__ uint32_t one(int i) {
    switch (i) {
      case 0: return 0xfffffffdu; case 1: return 0x34786d38u;
      case 2: return 0xe41914adu; case 3: return 0x992c350bu;
      case 7: return 0x3fffffffu; default: return 0xffffffffu;
    }
  }
};

// q = 0x40000000000000000000000000000000224698fc0994a8dd8c46eb2100000001
template <> struct Field<1> {
  __device__ static __forceinline__ uint32_t p(int i) {
    switch (i) {
      case 0: return 0x00000001u; case 1: return 0x8c46eb21u;
      case 2: return 0x0994a8ddu; case 3: return 0x224698fcu;
      case 7: return 0x40000000u; default: return 0u;
    }
  }
  __device__ static __forceinline__ uint32_t one(int i) {
    switch (i) {
      case 0: return 0xfffffffdu; case 1: return 0x5b2b3e9cu;
      case 2: return 0xe3420567u; case 3: return 0x992c350bu;
      case 7: return 0x3fffffffu; default: return 0xffffffffu;
    }
  }
};

// -p^{-1} mod 2^32 for 32-bit CIOS (both Pasta moduli are 1 mod 2^32).
// The reference's n0 is the 16-bit constant; this is its 32-bit analogue.
constexpr uint32_t N0 = 0xffffffffu;

// r = a + b - borrow-free raw add; returns the carry out of 256 bits
__device__ __forceinline__ uint32_t add_raw(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a[i] + b[i] + c;
    r[i] = (uint32_t)t;
    c = t >> 32;
  }
  return (uint32_t)c;
}

// r = a - b without modular correction (valid when a >= b, e.g. p - y);
// returns the borrow (0/1)
__device__ __forceinline__ uint32_t sub_raw(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t br = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a[i] - b[i] - br;
    r[i] = (uint32_t)t;
    br = (uint32_t)(t >> 32) & 1u;
  }
  return br;
}

template <int F>
__device__ __forceinline__ void load_p(uint32_t r[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = Field<F>::p(i);
}

// r = (a + b) mod p, inputs < p
template <int F>
__device__ __forceinline__ void add(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t s[8], d[8], p[8];
  load_p<F>(p);
  uint32_t c = add_raw(s, a, b);
  uint32_t br = sub_raw(d, s, p);
  bool use_d = c | (br ^ 1u);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = use_d ? d[i] : s[i];
}

// r = (a - b) mod p, inputs < p
template <int F>
__device__ __forceinline__ void sub(uint32_t r[8], const uint32_t a[8],
                                    const uint32_t b[8]) {
  uint32_t d[8], dp[8], p[8];
  load_p<F>(p);
  uint32_t br = sub_raw(d, a, b);
  add_raw(dp, d, p);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = br ? dp[i] : d[i];
}

// r = 15 a mod p = 16a - a: four modular doublings and a subtract
// (b3 = 3 b = 15 for the Pasta curves y^2 = x^3 + 5)
template <int F>
__device__ __forceinline__ void mul15(uint32_t r[8], const uint32_t a[8]) {
  uint32_t x[8];
  add<F>(x, a, a);
  add<F>(x, x, x);
  add<F>(x, x, x);
  add<F>(x, x, x);
  sub<F>(r, x, a);
}

// Montgomery product r = a b R^{-1} mod p (CIOS over 32-bit limbs,
// 64-bit partial products); inputs < p, output fully reduced
template <int F>
__device__ __forceinline__ void mont_mul(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * N0;
    s = (uint64_t)m * Field<F>::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      uint32_t pj = Field<F>::p(j);
      s = (pj ? (uint64_t)m * pj : 0ull) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  uint32_t d[8], p[8];
  load_p<F>(p);
  uint32_t br = sub_raw(d, t, p);
  bool use_d = (t[8] != 0) | (br == 0);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = use_d ? d[i] : t[i];
}

__device__ __forceinline__ bool is_zero(const uint32_t a[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) acc |= a[i];
  return acc == 0;
}

template <int F>
__device__ __forceinline__ bool is_one(const uint32_t a[8]) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < 8; i++) eq &= (a[i] == Field<F>::one(i));
  return eq;
}

__device__ __forceinline__ void select(uint32_t r[8], bool c,
                                       const uint32_t a[8],
                                       const uint32_t b[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = c ? a[i] : b[i];
}

// 16 contiguous int32 digits (one element of a [..., 16] field tensor)
// -> 8 limbs, with four 16-byte loads
__device__ __forceinline__ void load_digits(uint32_t r[8], const int32_t* src) {
  const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int4 v = s[q];
    r[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

__device__ __forceinline__ void store_digits(int32_t* dst, const uint32_t a[8]) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; q++) {
    int4 v;
    v.x = (int32_t)(a[2 * q] & 0xffffu);
    v.y = (int32_t)(a[2 * q] >> 16);
    v.z = (int32_t)(a[2 * q + 1] & 0xffffu);
    v.w = (int32_t)(a[2 * q + 1] >> 16);
    d[q] = v;
  }
}

// 16 digit rows of a lanes-last [rows, L] batch (row stride L) -> 8 limbs
__device__ __forceinline__ void load_rows(uint32_t r[8], const int32_t* src,
                                          size_t stride) {
#pragma unroll
  for (int i = 0; i < 8; i++)
    r[i] = (uint32_t)src[(2 * i) * stride] |
           ((uint32_t)src[(2 * i + 1) * stride] << 16);
}

__device__ __forceinline__ void store_rows(int32_t* dst, size_t stride,
                                           const uint32_t a[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) {
    dst[(2 * i) * stride] = (int32_t)(a[i] & 0xffffu);
    dst[(2 * i + 1) * stride] = (int32_t)(a[i] >> 16);
  }
}

}  // namespace h2t
