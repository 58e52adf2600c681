#!/usr/bin/env python3
"""Time design variants of the fused GLV ladder kernel on one NVIDIA GPU.

The ladder (csrc/point_kernels.cu::glv_ladder_kernel) runs 130 steps of a
doubling and an add in one launch. This script builds three variants of
csrc/point_kernels.cu side by side and times each at 2^13, 2^15, 26,624
and 2^17 lanes, with the standalone B5 and B3 kernels beside it:

  call    the source as it is: the ladder calls the Montgomery product
          (mont_mul_call) instead of inlining it;
  inline  the ladder's products inlined, as the one-step kernels have them;
  rolled  inlined, with the product's row loop rolled (an eighth of its
          code);
  inline_bs32, inline_bs128
          inlined, in blocks of 32 or 128 threads whatever the width.

It also times the loop the ladder replaced (B5, then a masked B3, for each
bit pair: 260 launches) captured in a CUDA graph, which is its device time
without the host's gaps. Every variant's ladder output must equal the
`call` variant's bit for bit. Per variant it prints the ladder's registers,
stack frame and spills (`nvcc -Xptxas -v`) and each kernel's SASS
instruction count (`cuobjdump -sass`).

Run from the repository root: python3 ladder_variants.py
(builds into the gitignored halo2_tpu_torch/_build/variants/).
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "halo2_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "halo2_tpu_torch", "_build", "variants")
LANES = (1 << 13, 1 << 15, 26624, 1 << 17)
NBITS = 130

ROLLED_MUL = r'''template <int F>
__device__ __forceinline__ void mont_mul(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8]) {
  uint32_t t[10], bb[8];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) bb[j] = b[j];
#pragma unroll 1
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = bb[0];
#pragma unroll
    for (int j = 0; j < 7; j++) bb[j] = bb[j + 1];
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)a[j] * bi + t[j] + c;
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

'''


def make_variant(name: str) -> str:
    """Copy the sources to OUT/name and patch them for the variant."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in ("field.cuh", "point_kernels.cu"):
        shutil.copy(os.path.join(CSRC, f), d)
    if name != "call":
        p = os.path.join(d, "point_kernels.cu")
        with open(p) as fh:
            s = fh.read()
        for call in ("rcb_double<F, true>", "rcb_add<F, true>"):
            assert call in s, call
            s = s.replace(call, call.replace("true", "false"))
        if "_bs" in name:
            head = "static int spread_threads(long long L) {\n"
            assert head in s
            s = s.replace(head, head + f"  return {name.split('_bs')[1]};\n")
        with open(p, "w") as fh:
            fh.write(s)
    if name == "rolled":
        p = os.path.join(d, "field.cuh")
        with open(p) as fh:
            s = fh.read()
        a = s.index("template <int F>\n__device__ __forceinline__ "
                    "void mont_mul(")
        b = s.index("__device__ __forceinline__ bool is_zero(")
        with open(p, "w") as fh:
            fh.write(s[:a] + ROLLED_MUL + s[b:])
    return d


def build(names):
    from halo2_tpu_torch.ops import cuda_build as cb
    nvcc = cb._nvcc()
    procs = {}
    for name in names:
        d = make_variant(name)
        so = os.path.join(d, "point_kernels.so")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", d, "-o", so,
               os.path.join(d, "point_kernels.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    libs = {}
    for name, (so, pr) in procs.items():
        log, _ = pr.communicate()
        if pr.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and "glv_ladder_kernelILi0" in line:
                print(f"[{name}] ladder: " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]))
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                              text=True, check=True).stdout
        counts, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
                counts[cur] = 0
            elif cur and re.search(r"/\*[0-9a-f]{4,6}\*/", line):
                counts[cur] += 1
        print(f"[{name}] SASS instructions (Fp): " + ", ".join(
            f"{k.split('EEv')[0]} {v}" for k, v in counts.items()
            if "ILi0E" in k))
        lib = ctypes.CDLL(so)
        for fn, argtypes in cb._ARGTYPES["point_kernels"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: ladder_variants.py needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build(("call", "inline", "rolled", "inline_bs32",
                  "inline_bs128"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    words = ([0x9e3779b9 * (w + 1) & 0xffffffff for w in range(5)],
             [0x7f4a7c15 * (w + 3) & 0xffffffff for w in range(5)])
    bits = [(ctypes.c_uint32 * 5)(*w) for w in words]
    b1 = [(words[0][i >> 5] >> (i & 31)) & 1 for i in range(NBITS)]
    b2 = [(words[1][i >> 5] >> (i & 31)) & 1 for i in range(NBITS)]

    def coords(L):
        # any values below p have the same cost: random 254-bit digits
        x = torch.randint(0, 1 << 16, (48, L), generator=gen, device=dev,
                          dtype=torch.int32)
        for r in (15, 31, 47):
            x[r] >>= 2
        return x

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def loop_graph_ms(lib, L, tab, on, off):
        acc = [torch.empty_like(tab[1]) for _ in range(2)]

        def run(stream):
            for i in range(NBITS):
                sel = b1[i] + 2 * b2[i]
                lib.h2t_pdouble(0, acc[1].data_ptr(), acc[0].data_ptr(), L,
                                stream)
                lib.h2t_padd_masked(0, acc[0].data_ptr(), acc[1].data_ptr(),
                                    tab[sel].data_ptr(),
                                    (on if sel else off).data_ptr(), None,
                                    None, 0, 0, 0, L, L, stream)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            run(side.cuda_stream)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=side):
                run(side.cuda_stream)
        torch.cuda.synchronize()
        return timed(graph.replay, 5)

    stream = torch.cuda.current_stream().cuda_stream
    for L in LANES:
        t1, t2, t12 = coords(L), coords(L), coords(L)
        on = torch.ones(L, dtype=torch.int32, device=dev)
        off = torch.zeros_like(on)
        ms = loop_graph_ms(libs["call"], L, (t1, t1, t2, t12), on, off)
        print(f"L={L}: the B5/B3 loop (260 launches) in a CUDA graph "
              f"{ms:.4f} ms per round")
        ref = None
        for name, lib in libs.items():
            out = torch.empty_like(t1)
            o2 = torch.empty_like(t1)
            ms = timed(lambda: lib.h2t_glv_ladder(
                0, out.data_ptr(), t1.data_ptr(), t2.data_ptr(),
                t12.data_ptr(), bits[0], bits[1], NBITS, L, stream), 3)
            ref = out.clone() if ref is None else ref
            b5 = timed(lambda: lib.h2t_pdouble(
                0, o2.data_ptr(), t1.data_ptr(), L, stream), 50)
            b3 = timed(lambda: lib.h2t_padd_masked(
                0, o2.data_ptr(), t1.data_ptr(), t2.data_ptr(),
                on.data_ptr(), None, None, 0, 0, 0, L, L, stream), 50)
            same = torch.equal(out, ref)
            print(f"L={L} {name}: ladder {ms:.4f} ms per round (equal to "
                  f"call: {same}); B5 {b5:.5f} ms, B3 {b3:.5f} ms")
            if not same:
                raise AssertionError(f"{name} ladder differs at L={L}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
