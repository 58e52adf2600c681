// Kernel K2: one chunk of gate polynomials evaluated and folded into the
// quotient accumulator, one launch a chunk.
//
// Replaces one jitted gate chunk of halo2_tpu/plonk/prover.py:220-255
// (an XLA program traced from the chunk's expressions; no Pallas call).
// The chunk arrives as a tape (ops/gate_kernels.py, compiled by
// plonk/evaluation.py::compile_chunk): int4 instructions (op, dst, x, y)
// over numbered slots,
//
//   QUERY  slot dst = column (x & 0xffff) of kind x >> 16 at row
//          (r + y * rot_scale) mod n (advice, fixed, instance)
//   CONST  slot dst = constant x
//   NEG    slot dst = -slot x
//   ADD    slot dst = slot x + slot y
//   MUL    slot dst = slot x * slot y
//   SCALE  slot dst = slot x * constant y
//   FOLD   acc = y ? slot x : acc * y_m + slot x
//
// then out[r] = h_prev[r] * y^k + acc (or acc where there is no
// accumulator yet). The tape is data: one kernel for every circuit, and
// every thread of a warp runs the same instruction (no divergence). A
// thread takes a row, grid-stride. The tape, the constants (Montgomery
// form, with y and y^k after them) and the column pointers are copied
// into shared memory once a block; slots are 8 x 32-bit limbs in local
// memory. Operands are read into registers before a result is written,
// so a result may take the slot of an operand whose last use it is.
//
// The previous result stays in registers: the op word's flag bits say
// that an operand is the previous instruction's result (X_LAST, Y_LAST),
// read from registers and not from its slot, and that a result is read
// by the next instruction alone (KEEP), so it is never written to its
// slot; compile_chunk orders each node's operands by the slots they need
// (Sethi-Ullman). On Table16's whole gate set that halves the slot
// traffic (2,685 to about 1,340 slot accesses a row, 60 slots) and took
// 0.8% off a launch (19.63 against 19.80 ms at 2^20 rows on an H100 80GB
// HBM3, redesign_variants.py --only gate): the slots did not bound K2,
// its products do. A Montgomery product is about 500 instructions here,
// 254 of them on the IMAD pipe, which puts a row's 660 products at
// about 12 ms of that pipe at 2^20 rows. The slot file in shared memory
// ([slot][limb][row], sized by the tape: room for 64 rows an SM at 60
// slots) ran 3.6x slower, two rows a thread 1.3x, carry-chain products
// 1.05x; a grid of the resident blocks or 64 registers gained nothing.
//
// Bound: operations. A row costs one Montgomery product a MUL, SCALE and
// FOLD (Table16's whole gate set: 660 a row) against 64 bytes a query.
#include "field.cuh"

namespace {

using namespace h2t;

constexpr int kThreads = 128;
enum { OP_QUERY, OP_CONST, OP_NEG, OP_ADD, OP_MUL, OP_SCALE, OP_FOLD };
// the op word: the opcode in its low byte, then the register flags
constexpr int kOpMask = 0xff;
constexpr int kKeep = 1 << 8;    // the result is read by the next op alone
constexpr int kXLast = 1 << 9;   // operand x is the previous op's result
constexpr int kYLast = 1 << 10;  // operand y is the previous op's result
constexpr int kSlots = 128;      // slots a thread (MAX_SLOTS)

__device__ __forceinline__ void copy8(uint32_t r[8], const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = a[i];
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gate_chunk_kernel(int32_t* __restrict__ out, int has_prev,
                  const int4* __restrict__ code, int n_code,
                  const int32_t* __restrict__ consts, int n_consts,
                  const long long* __restrict__ ptrs, int n_ptrs, int n_adv,
                  int n_fix, const int32_t* __restrict__ yy, long long n,
                  long long rot_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t** s_ptr = reinterpret_cast<const int32_t**>(smem);
  const size_t off_code = ((size_t)n_ptrs * 8 + 15) & ~(size_t)15;
  int4* s_code = reinterpret_cast<int4*>(smem + off_code);
  uint32_t* s_const =
      reinterpret_cast<uint32_t*>(smem + off_code + (size_t)n_code * 16);
  for (int i = threadIdx.x; i < n_ptrs; i += blockDim.x)
    s_ptr[i] = reinterpret_cast<const int32_t*>(ptrs[i]);
  for (int i = threadIdx.x; i < n_code; i += blockDim.x) s_code[i] = code[i];
  for (int i = threadIdx.x; i < n_consts + 2; i += blockDim.x) {
    uint32_t v[8];
    load_digits(v, i < n_consts ? consts + 16 * i : yy + 16 * (i - n_consts));
#pragma unroll
    for (int w = 0; w < 8; w++) s_const[8 * i + w] = v[w];
  }
  __syncthreads();
  const uint32_t* y_m = s_const + 8 * n_consts;
  const uint32_t* yk_m = y_m + 8;
  const int base[3] = {0, n_adv, n_adv + n_fix};
  const long long mask = n - 1;

  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    uint32_t slot[kSlots][8];
    uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t last[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // the previous result
    for (int pc = 0; pc < n_code; pc++) {
      const int4 ins = s_code[pc];
      const int op = ins.x & kOpMask;
      uint32_t a[8], b[8], res[8];
      // (branches, not a pointer select, so that last stays in registers)
      if (op >= OP_NEG) {
        if (ins.x & kXLast) copy8(a, last);
        else copy8(a, slot[ins.z]);
      }
      if (op == OP_ADD || op == OP_MUL) {
        if (ins.x & kYLast) copy8(b, last);
        else copy8(b, slot[ins.w]);
      }
      switch (op) {
        case OP_QUERY: {
          const int32_t* col = s_ptr[base[ins.z >> 16] + (ins.z & 0xffff)];
          const long long row = (r + (long long)ins.w * rot_scale) & mask;
          load_digits(res, col + row * 16);
          break;
        }
        case OP_CONST:
          copy8(res, s_const + 8 * ins.z);
          break;
        case OP_NEG: {
          const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
          sub<F>(res, z, a);
          break;
        }
        case OP_ADD:
          add<F>(res, a, b);
          break;
        case OP_MUL:
          mont_mul<F>(res, a, b);
          break;
        case OP_SCALE:
          copy8(b, s_const + 8 * ins.w);
          mont_mul<F>(res, a, b);
          break;
        default: {  // OP_FOLD
          if (ins.w) {
            copy8(acc, a);
          } else {
            copy8(b, y_m);
            mont_mul<F>(res, acc, b);
            add<F>(acc, res, a);
          }
          continue;
        }
      }
      if (!(ins.x & kKeep)) copy8(slot[ins.y], res);
      copy8(last, res);
    }
    if (has_prev) {
      uint32_t h[8], k[8], t[8];
      load_digits(h, out + r * 16);
      copy8(k, yk_m);
      mont_mul<F>(t, h, k);
      add<F>(h, t, acc);
      store_digits(out + r * 16, h);
    } else {
      store_digits(out + r * 16, acc);
    }
  }
}

template <int F>
int launch(int32_t* out, int has_prev, const int4* code, int n_code,
           const int32_t* consts, int n_consts, const long long* ptrs,
           int n_ptrs, int n_adv, int n_fix, const int32_t* yy, long long n,
           long long rot_scale, cudaStream_t s) {
  const size_t off_code = ((size_t)n_ptrs * 8 + 15) & ~(size_t)15;
  const size_t bytes =
      off_code + (size_t)n_code * 16 + (size_t)(n_consts + 2) * 32;
  auto kern = gate_chunk_kernel<F>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  kern<<<(unsigned)blocks, kThreads, bytes, s>>>(
      out, has_prev, code, n_code, consts, n_consts, ptrs, n_ptrs, n_adv,
      n_fix, yy, n, rot_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int h2t_gate_chunk(int field, void* out, int has_prev,
                              const void* code, int n_code, int n_slots,
                              const void* consts, int n_consts,
                              const void* ptrs, int n_ptrs, int n_adv,
                              int n_fix, const void* yy, long long n,
                              long long rot_scale, void* stream) {
  if (n <= 0) return 0;
  if (n_slots > kSlots) return (int)cudaErrorInvalidValue;
  auto f = field == 0 ? launch<0> : launch<1>;
  return f((int32_t*)out, has_prev, (const int4*)code, n_code,
           (const int32_t*)consts, n_consts, (const long long*)ptrs, n_ptrs,
           n_adv, n_fix, (const int32_t*)yy, n, rot_scale,
           (cudaStream_t)stream);
}
