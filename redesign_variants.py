#!/usr/bin/env python3
"""Time build variants of the bucket-run kernel and of kernel B7 on one
NVIDIA GPU, each beside the source as it is, in one process.

Copies of csrc/ are patched and built side by side under the gitignored
halo2_tpu_torch/_build/variants/:

  the bucket-run kernel (csrc/point_kernels.cu::pmixed_bucket_runs_kernel),
  a whole commit's bucket phase at a k = 14 advice commit's 26,624 lanes
  and a k = 18 commit's 163,840 (two columns of random scalars over 2^k
  PALLAS bases, 2^14 native SRS points repeated):
    call       the source: every Montgomery product a call (mont_mul_call)
    inline     the products inlined, as the one-step kernels have them
    call_cc, inline_cc
               the same with the carry-chain product MONT_MUL_CC (PTX
               mad.lo.cc / madc.hi.cc) in place of mont_mul
  B7 (csrc/ntt_kernels.cu), forward on the PALLAS scalar field, per
  transform at 2^10, 2^16 and 2^20 with 1 and 4 columns:
    pass       the source: two passes (one up to 2^10)
    pass_cc    with the carry-chain product
    stagewise  the kernel of an older checkout given as the argument (its
               halo2_tpu_torch/csrc/ntt_kernels.cu with the entry h2t_ntt:
               the bit-reversal gather and the first ten stages in shared
               memory, then one launch per stage)

Every variant's output must equal the source's bit for bit (B7's also
the plain version's). Each is timed from a CUDA graph and by
torch.profiler (chip_smoke.py's graph_ms and device_ms); per variant the
timed kernel's registers (nvcc -Xptxas -v) and SASS instructions
(cuobjdump -sass).

Run from the repository root:
    python3 redesign_variants.py [OLD_CHECKOUT]
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "halo2_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "halo2_tpu_torch", "_build", "variants")

# the Montgomery product with its carries in PTX carry chains: each CIOS
# row adds a b_i as one chain of low halves and one of high halves, then
# m p with m = -t_0 (N0 = -1, p_0 = 1) over p's nonzero limbs 1-3 and 7;
# fully reduced, so it equals mont_mul bit for bit
MONT_MUL_CC = r'''template <int F>
__device__ __forceinline__ void mont_mul_cc(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0,
           t8 = 0, t9 = 0;
  const uint32_t p1 = Field<F>::p(1), p2 = Field<F>::p(2),
                 p3 = Field<F>::p(3), p7 = Field<F>::p(7);
#pragma unroll
  for (int i = 0; i < 8; i++) {
    // t += a b_i
    asm("mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
        "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
        "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
        "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
        "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
        "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
        "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
        "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
        "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
        "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
        "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
        "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
        "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
        "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
        "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
          "r"(a[6]), "r"(a[7]), "r"(b[i]));
    // t += m p, m = -t_0 mod 2^32, so that t_0 becomes 0
    const uint32_t m = 0u - t0;
    asm("add.cc.u32 %0, %0, %10;\n\t"
        "madc.lo.cc.u32 %1, %10, %11, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %12, %2;\n\t"
        "madc.lo.cc.u32 %3, %10, %13, %3;\n\t"
        "addc.cc.u32 %4, %4, 0;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "madc.lo.cc.u32 %7, %10, %14, %7;\n\t"
        "addc.cc.u32 %8, %8, 0;\n\t"
        "addc.u32 %9, %9, 0;\n\t"
        "mad.hi.cc.u32 %2, %10, %11, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %12, %3;\n\t"
        "madc.hi.cc.u32 %4, %10, %13, %4;\n\t"
        "addc.cc.u32 %5, %5, 0;\n\t"
        "addc.cc.u32 %6, %6, 0;\n\t"
        "addc.cc.u32 %7, %7, 0;\n\t"
        "madc.hi.cc.u32 %8, %10, %14, %8;\n\t"
        "addc.u32 %9, %9, 0;"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
          "+r"(t6), "+r"(t7), "+r"(t8), "+r"(t9)
        : "r"(m), "r"(p1), "r"(p2), "r"(p3), "r"(p7));
    // shift down a limb (t_0 is 0)
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8;
    t8 = t9; t9 = 0;
  }
  uint32_t t[8] = {t0, t1, t2, t3, t4, t5, t6, t7}, d[8], p[8];
  load_p<F>(p);
  uint32_t br = sub_raw(d, t, p);
  bool use_d = (t8 != 0) | (br == 0);
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = use_d ? d[i] : t[i];
}
'''

INLINE_CALL = "rcb_mixed_add<F, true>(r2, acc, x2, y2)"


def make_variant(name: str, src: str, source: str, cc: bool = False,
                 inline: bool = False) -> str:
    """Copy field.cuh and `source` from the directory src to OUT/name,
    patched: cc puts MONT_MUL_CC in place of every mont_mul of the source,
    inline inlines the bucket-run kernel's products."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(src, "field.cuh")) as fh:
        hdr = fh.read()
    with open(os.path.join(src, source)) as fh:
        s = fh.read()
    if cc:
        end = "}  // namespace h2t"
        assert end in hdr
        hdr = hdr.replace(end, MONT_MUL_CC + "\n" + end)
        assert "mont_mul<F>(" in s
        s = s.replace("mont_mul<F>(", "mont_mul_cc<F>(")
    if inline:
        assert INLINE_CALL in s
        s = s.replace(INLINE_CALL, INLINE_CALL.replace("true", "false"))
    with open(os.path.join(d, "field.cuh"), "w") as fh:
        fh.write(hdr)
    with open(os.path.join(d, source), "w") as fh:
        fh.write(s)
    return os.path.join(d, source)


def build(variants: dict, kernel: str) -> dict:
    """{name: .cu path} -> {name: loaded library}, one nvcc each started
    together; prints `kernel`'s (Fp instance's) registers and SASS size."""
    import chip_smoke as cs
    from halo2_tpu_torch.ops import cuda_build as cb
    nvcc = cb._nvcc()
    procs = {}
    for name, cu in variants.items():
        so = cu[:-3] + ".so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", os.path.dirname(cu), "-o", so, cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, pr) in procs.items():
        log, _ = pr.communicate()
        if pr.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "entry function" in line and kernel in line and \
                    "ILi0E" in line:
                print(f"[{name}] " + "; ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]))
        for fn, count in cs.sass_counts(so).items():
            if kernel in fn and "ILi0E" in fn:
                print(f"[{name}] {fn}: {count} SASS instructions")
        libs[name] = ctypes.CDLL(so)
    return libs


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


def check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"CUDA launch failed: cudaError {rc}")


def bucket_variants(dev) -> None:
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import DeviceField
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    src = "point_kernels.cu"
    libs = build({"call": make_variant("call", CSRC, src),
                  "inline": make_variant("inline", CSRC, src, inline=True),
                  "call_cc": make_variant("call_cc", CSRC, src, cc=True),
                  "inline_cc": make_variant("inline_cc", CSRC, src, cc=True,
                                            inline=True)},
                 "pmixed_bucket_runs_kernel")
    for lib in libs.values():
        f = lib.h2t_pmixed_bucket_runs
        f.argtypes = cb._ARGTYPES["point_kernels"]["h2t_pmixed_bucket_runs"]
        f.restype = ctypes.c_int
    df = DeviceField(PALLAS.base)
    aff14 = pk.points_to_proj(df, native_srs_g(PALLAS, "bucket-variants",
                                               1 << 14), dev)[:32]
    for k in (14, 18):
        n = 1 << k
        aff = aff14.repeat(1, n >> 14).contiguous()
        gen = torch.Generator(device=dev).manual_seed(k)
        digits = torch.randint(0, 1 << 16, (2, n, 16), generator=gen,
                               device=dev, dtype=torch.int32)
        digits[..., 15] >>= 2                    # below 2^254 < q
        runs = mp.bucket_runs(PALLAS, digits, mp.pick_c(n))
        packed = pk.pack_affine(aff)
        members = pk.bucket_members(runs.order, runs.sg)
        starts = runs.starts_e.reshape(-1).to(torch.int32).contiguous()
        counts = runs.counts_e.reshape(-1).to(torch.int32).contiguous()
        L = starts.shape[0]
        want = None
        for name, lib in libs.items():
            out = torch.empty((48, L), dtype=torch.int32, device=dev)

            def fn(lib=lib, out=out):
                check(lib.h2t_pmixed_bucket_runs(
                    df.field_id, out.data_ptr(), packed.data_ptr(),
                    members.data_ptr(), starts.data_ptr(), counts.data_ptr(),
                    runs.BL, n, L, stream()))
            g = cs.graph_ms(fn, 5)
            p = cs.device_ms(fn, 5, "pmixed_bucket_runs_kernel")
            torch.cuda.synchronize()
            want = out.clone() if want is None else want
            same = torch.equal(out, want)
            print(f"[bucket] k={k} L={L} runs up to {int(counts.max())} "
                  f"{name}: {g:.5f} ms from a CUDA graph, {p:.5f} ms by the "
                  f"profiler (equal to call: {same})")
            if not same:
                raise AssertionError(f"{name} differs at k={k}")


def ntt_variants(dev, old) -> None:
    import torch
    import chip_smoke as cs
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import cuda_build as cb
    from halo2_tpu_torch.ops import ntt
    src = "ntt_kernels.cu"
    variants = {"pass": make_variant("pass", CSRC, src),
                "pass_cc": make_variant("pass_cc", CSRC, src, cc=True)}
    if old:
        variants["stagewise"] = make_variant(
            "stagewise", os.path.join(old, "halo2_tpu_torch", "csrc"), src)
    libs = build(variants, "ntt_")
    for name, lib in libs.items():
        fn, args = (("h2t_ntt", [cb._I, cb._P, cb._P, cb._P, cb._P, cb._LL,
                                 cb._I, cb._I, cb._P])
                    if name == "stagewise" else
                    ("h2t_ntt_pass", cb._ARGTYPES["ntt_kernels"]
                     ["h2t_ntt_pass"]))
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    df = FQ_DEV
    spec = df.spec
    for log_n in (10, 16, 20):
        n = 1 << log_n
        plan = ntt.make_plan(df, n, pow(spec.root_of_unity,
                                        1 << (spec.s - log_n), spec.modulus))
        perm, table, _, packed = plan.on(dev)
        for m in (1, 4):
            x = cs.rand_field(df, m * n, log_n, dev).view(m, n, 16)
            want = ntt.ntt_many_plain(df, x, plan)
            for name, lib in libs.items():
                out = torch.empty_like(x)
                if name == "stagewise":
                    def fn(lib=lib, out=out):
                        check(lib.h2t_ntt(df.field_id, out.data_ptr(),
                                          x.data_ptr(), perm.data_ptr(),
                                          table.data_ptr(), m, log_n,
                                          min(log_n, 10), stream()))
                    kern = ("ntt_tile", "ntt_stage")
                else:
                    def fn(lib=lib, out=out):
                        src = x
                        for a, cnt, r_log in ntt.ntt_passes(log_n):
                            check(lib.h2t_ntt_pass(
                                df.field_id, out.data_ptr(), src.data_ptr(),
                                packed.data_ptr(), m, log_n, a, cnt, r_log,
                                int(a == 0), stream()))
                            src = out
                    kern = "ntt_pass"
                g = cs.graph_ms(fn, 20)
                p = cs.device_ms(fn, 20, kern, per_call=True)
                torch.cuda.synchronize()
                same = torch.equal(out, want)
                print(f"[ntt] n=2^{log_n} m={m} {name}: {g:.5f} ms per "
                      f"transform from a CUDA graph, {p:.5f} ms by the "
                      f"profiler (equal to the plain version: {same})")
                if not same:
                    raise AssertionError(f"{name} differs at 2^{log_n}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: redesign_variants.py needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    cs.phase_card()
    old = sys.argv[1] if len(sys.argv) > 1 else None
    shutil.rmtree(OUT, ignore_errors=True)
    dev = torch.device("cuda")
    bucket_variants(dev)
    ntt_variants(dev, old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
