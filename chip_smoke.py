#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2_tpu_torch) on one NVIDIA GPU.

Phases, in this order (any failure exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in
     parallel); registers and spills, and the SASS size of the bucket-run,
     B2, B4, scalar-ladder and NTT kernels;
  2b. [peak] the card's rate of 32-bit integer multiply-adds (independent
     IMAD, IMAD.HI and IMAD.WIDE chains, an FFMA chain as the control,
     csrc/peak_kernels.cu), which sets MULADD_PER_S, the "operations"
     bound of every kernel; the SM clock, the chains' SASS and B1's
     multiply-adds a product;
  3. kernel B1 (Montgomery multiply) and the field add/sub kernel against
     their plain PyTorch versions, bit-exact, 2^20 operands + edges, both
     fields;
  4. [ntt] kernel B7 (the two-pass NTT) against the plain version,
     bit-exact, at n = 2^10,
     2^16 and 2^20 with 1 and 4 columns, forward and inverse, both
     fields; device time per transform from a CUDA graph and by the
     profiler, wrapper time, bound;
  4b. [mxu] kernel K1 (products by a constant shared across a group of
     lanes on the tensor cores, mma.sync on u8 digits; the four-step
     NTT's axis transforms as passes of up to 5 stages in shared memory,
     the gathers, diagonal twiddles and transposes fused) against its
     plain version at 1, 15, 16, 17 and 4,096 lanes a group, both
     fields, with 0xFF bytes; the four-step NTT (ops/mxu_field.py)
     against B7 at 2^16, 2^17 and 2^20 with 1 and 4 columns, forward and
     inverse, both fields, and against the plain four-step at 2^10 and
     2^16, in the pass plan's launches with no B1 launch (and by the
     profiler, no kernel but K1's); each pass's time from a CUDA graph
     beside its bound, the four-step's beside B7's and its bound, and a
     float32 torch.bmm of each pass's digit products (TF32 off) as the
     yardstick;
  5. [layout] kernel B8 (limbs-first [16, N] multiply) beside B1
     (element-major [N, 16]) at N = 2^12 .. 2^20, both against the plain
     version, device time against the same byte bound;
  6. the main path at k=14 (its transforms, of 2^14 and 2^15, on B7):
     Params.new (g_lagrange by the device group iNTT), keygen_vk,
     keygen_pk, create_proof
     twice (cold, warm), verify_proof, a wrong public input rejected, and
     the proof's sha256 against the JAX reference's recorded hash; the
     bucket-run kernel launched and no one-step B2; every transform on
     its route (B7 below 2^16); then [ntt-main], each route timed at the
     shapes the warm prove transforms;
  7. kernels B2 (masked mixed add) and B3 (masked complete add) against
     their plain versions, bit-exact, at the lane count of a k=14 commit,
     with random masks and signs and identity-coded bases; B3's forms
     that read the second operand at a lane offset or by index with
     signs, timed beside B3 after torch.roll or a gather and a negation
     (how the commits called it before); B4 (complete add, one lane a
     group of four threads) likewise at 2^17 lanes (k=18's first IPA
     fold) and 8,192 lanes (k=14's), with identity lanes and lanes with
     a == b; B5 (doubling) and B6 (masked doubling) in each form (one
     thread a lane, one lane a group of four threads) and through the
     wrappers, which pick the form by lane count, at 1, 2, 8,191, 8,192
     and 2^17 lanes and at each form threshold and one lane either side,
     both fields, B6 with masks of a random half, all ones and all zeros;
     each form's device time a launch from a CUDA graph of 20 launches at
     1, 2, 8,192 and 2^17 lanes beside its bound;
  7b. [ladder] the fused GLV ladder kernel (one launch per IPA fold
     round) against the B5/B3 kernel loop it replaced at 2^13 and 2^17
     lanes and against its plain version at 256 lanes, both fields;
     device time per round beside its bound and the loop's time (its
     wall time, and its device time replayed from a CUDA graph);
  7c. [scalar-ladder] the per-lane scalar-multiplication ladder (one
     lane a group of four threads, one launch per group-NTT stage, with
     the butterfly fused) against its
     plain version at 256 lanes and against the B5/B4/torch.where loop at
     2^13 and 2^17 lanes, both fields, edge scalars, identity lanes, one
     scalar a lane and a table read by lane % T; device time from a CUDA
     graph and by the profiler beside its bound, the loop's and the plain
     version's;
  8. k=14 commits (random, all-zero, all-equal columns) against the native
     host MSM, exact affine equality;
  9. the device window combine (B5, B4) against the host one on the
     window sums of a k=14 MSM (B5's only caller), its B5 launches and
     its device time by the profiler;
 10. the warm k=14 prove once more under torch.profiler: device time by
     kernel and the device's busy share of the wall time;
 11. the device IPA path at k=14: create_proof with every IPA round on
     the card (native_ipa_threshold=0), cold and warm, verified, its
     sha256 against the same JAX hash, its launches (one ladder per
     fold round, no B5), and the warm prove profiled;
 11b. [verify] AccumulatorStrategy (its G, a device MSM, against the
     native MSM), BatchVerifier (a pair of k=14 proofs accepted, a
     corrupted proof and a wrong instance rejected) and the device branch
     of MSMAccumulator.eval against the host one;
 11c. [v1] BenchCircuit at k=14 laid out by the V1 floor planner:
     keygen, a cold and a warm prove, verify, a wrong public input
     rejected, the proof's sha256 against the JAX reference's (recorded
     with reference_proof_hash.py --planner v1); V1's host planning
     time on lines of its own; every main-path kernel launched;
 11d. [mock] MockProver on BenchCircuit at k=14 and k=REF_K and on
     dev_lookup at k=14: the host verify() and the gate check on the
     card (verify_vectorized, B1 and the add/subtract) find nothing; a
     changed advice cell gives the same gate failures on both, field by
     field; a wrong instance gives the reference's failure kinds; the
     k=REF_K per-row zero flags equal the plain versions' on the CPU;
     the gate check's device time (the kernel calls of its field-kernel
     launches replayed from a CUDA graph) beside its wall time;
 11e. [gadgets] zcash/halo2's fifteen golden gadget circuits
     (halo2_tpu_torch/gadget_circuits.py) at K = 11: Params.new(VESTA,
     11) on the card; keygen_vk of each, its pinned text equal to
     tests/golden/vk_*.rdata, each golden proof verified, one corrupted
     proof rejected; for ecc_chip, sinsemilla_chip, merkle_chip and
     lookup_range_check keygen_pk, a cold and a warm prove (launches
     per kernel and phases of the warm one), the proof's sha256 against
     the JAX reference's (recorded with reference_proof_hash.py
     --circuit ecc|sinsemilla|merkle|lookup-range-check, and --circuit
     bench --transcript poseidon --k 14), verified; the fixed-base tables and the
     Sinsemilla S table timed apart as host work; the first call of
     each kernel at each shape the path gave it (B1, add/subtract, B3,
     the bucket-run kernel, B7, the scalar ladder), recorded with its
     operands, against its plain version; BenchCircuit at k=14 proved
     with the Poseidon transcript against the JAX hash; the ecc_chip
     mock prover's gate check on the card equal to the host checker's
     (device time as in [mock]), for the good witness and one changed
     cell, and its per-row zero flags equal to the plain versions';
 11f. [sha256] SHA-256 (halo2_tpu_torch/sha256_circuits.py): the
     bit-decomposition chip's CompressCircuit at K = 14 through the
     card's gate check, its per-row zero flags against the plain
     versions', a wrong output word reported by the card and a wrong
     instance by the permutation stream; Table16's two-block circuit at
     K = 17 through the card's gate check, its kernel calls held against
     the plain versions on lane slices; halo2's bench circuit (Table16,
     31 words, k = 17): Params.new uncached, the keygens, a cold prove
     with the debug checks on and a warm prove, launches per prover
     phase (the `h terms build` count), card memory, SingleVerifier and
     BatchVerifier, a corrupted proof rejected, every kernel of the path
     (B1, add/subtract, B3 in its three forms, B4, the bucket-run
     kernel, B7, the GLV and scalar ladders) held against its plain
     version at the path's shapes on its own data, a profiled warm
     prove, and the proof's sha256 against the JAX reference's
     (reference_proof_hash.py --circuit sha256); the gate-chunk branch
     (create_proof(h_chunk_nodes=...), kernel K2, one launch a chunk)
     with the whole gate set as one chunk and in chunks of 400 nodes,
     each proof byte-equal, `h terms build`'s time and launches beside
     the eager fold's, K2's calls held against the plain tape on row
     slices, and K2 timed alone at 2^20 rows from a CUDA graph;
 12. BenchCircuit proved at 2^REF_K rows, the largest size the JAX
     reference was run at, at the default IPA schedule (four device
     rounds, then native; cold, then warm), with every round native and
     with every round on the card; each proof's sha256 against that
     run's; every transform (2^18, 2^19) on the four-step, K1's launches
     counted from keygen to the last prove and no B7; the default and
     the all-device proves profiled;
 12b. [bucket] the bucket-run kernel against its plain version and the
     one-step B2 kernel run round by round, at a k=14 advice commit's
     26,624 lanes and a k=REF_K commit's 163,840, both fields; the kernel
     and the round loop timed from a CUDA graph and by the profiler,
     beside the bound over the whole commit;
 13. [lookup] the lookup path: halo2's dev_lookup circuit at k = 14 and
     k = REF_K (PALLAS Params of phases 6 and 12) and the plonk_api
     circuit at K = 5 (VESTA, two instances): keygen, a cold and a warm
     prove, verify, a corrupted proof or a wrong instance rejected, the
     proof's sha256 against the JAX reference's (the golden file for
     plonk_api; zcash/halo2's own plonk_api proof verifies), launches per
     kernel, and one profiled warm prove at each k; the warm k = REF_K
     prove records the lane counts and row widths of B3's offset form;
 13a. [points] B3's offset form at those widths against its plain
     version, device time beside its byte bound;
 13b. [srs] Params.new(use_cache=False) at k=14 and k=REF_K on the card:
     write() bytes equal to those with the native library's g_lagrange
     at k=14, and their sha256 equal to the JAX reference's
     (REF_PARAMS_SHA256) at k=REF_K, where the native group iNTT takes
     minutes on the host; native g and the device group iNTT timed
     apart; one
     ladder launch a stage and one for the 1/n scale;
 13c. [mesh] the multi-device layer (halo2_tpu_torch/parallel/) at
     k = 14: a world of one rank over NCCL in this process (BenchCircuit
     proved cold and warm under ProverMesh against the JAX hash, both
     verifiers, the sharded commit, NTT and scan counted, every kernel
     call of the path held against its plain version; the process group
     destroyed after), then worlds of 2 and 4 spawned ranks sharing the
     card over gloo (parallel/launch.py::run_ranks; each rank's cold and
     warm proofs against the JAX hash, a sharded 2^16 NTT and a sharded
     k = 14 commit against the single-device ones, its kernel calls
     against their plain versions on lane slices, its warm prove time
     and the bytes it staged through host memory; dev_lookup at k = 14
     in the world of 2 against its JAX hash);
 14. a `kernels` JSON line: launches on the path that runs each kernel
     (main, ipa, srs, ref-k for K1, sha256 for K2), mismatches, each
     kernel's device time per launch (torch.profiler; from a CUDA graph
     for B7, K1, K2 and the bucket-run kernel, with the profiler's beside
     some) against its bound, the wrapper's time per call (CUDA events),
     the plain version's and, for K1, a float32 torch.bmm of the same
     digit products (library_ms);
and, last, {"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import random
import subprocess
import sys
import time

K = 14
# sha256 of the JAX reference's proof at 2^k rows, rng seed PROOF_SEED,
# keyed by (circuit, k): BenchCircuit at witness SEED_A and halo2's
# dev_lookup circuit over PALLAS Params (python reference_proof_hash.py
# --circuit C --k k, on a CPU), the golden gadget circuits over VESTA
# (--circuit ecc|sinsemilla|merkle|lookup-range-check), halo2's SHA-256
# bench circuit over PALLAS (--circuit sha256); REF_K is the largest k
# the BenchCircuit runs were made at
REF_SHA256 = {
    ("bench", 14):
        "d74239f9d0320f99b2fc80c89ab5df1ad8a8d2588dc7541eb6017078e986a12f",
    ("bench", 18):
        "87c0cff028bdb678cd0b99461464b033d82e345153d261b8573b55c145515abe",
    ("dev-lookup", 14):
        "6b3b2e64470bc5b3673cd81897e6431e8f062e5071385553a8b62ff4b1bce9e0",
    ("dev-lookup", 18):
        "bc9eede3360704f004a40ac2d2c5be8f190a2dc4d2fbd5c4d87a73b6faff9d28",
    # BenchCircuit under the V1 floor planner (--planner v1)
    ("bench-v1", 14):
        "78347be96697241f5853b05e4914ab92002cd3c6492d6fc717f57325de88586f",
    # BenchCircuit with the Poseidon transcript (--transcript poseidon)
    ("bench-poseidon", 14):
        "a0fd6b87fc45a143f76ad36ebbe746c4631934114980ef786b191bde1708a2a9",
    # the golden gadget circuits of halo2_tpu_torch/gadget_circuits.py at
    # K = 11 over VESTA Params (--circuit ecc|sinsemilla|merkle|
    # lookup-range-check)
    ("ecc_chip", 11):
        "7a5ee67c0e60d0ac0ba3c23e933c6977496df92d85e25372e2e5d33b6935ac95",
    ("sinsemilla_chip", 11):
        "d40c8ce930d0af7a5ba112c9baf8bdd161a1eea421efdd0d4c7dde0c6b0632c7",
    ("merkle_chip", 11):
        "52d2f96561bd478b19f7626b14958c1e2e6339405338fd271bd93f65d28ff79e",
    ("lookup_range_check", 11):
        "536d53abde630e4ec5c638ca6ed8572776d87fe295af3cdae9594474e3cff0ab",
    # halo2_tpu_torch/sha256_circuits.py's bench circuit (Table16, 31
    # words) at k = 17 over PALLAS Params (--circuit sha256)
    ("sha256", 17):
        "445f4716ce0f07bda8da7d50b95dfab50527c1b66bc1e8602fdb2e4a8d9f0629",
}
REF_K = 18
# sha256 of the JAX reference's Params.new(PALLAS, k, use_cache=False)
# .write() (g, its Lagrange basis from the native group iNTT, w, u;
# reference_proof_hash.py --circuit params --k k, on a CPU): [srs] holds
# the card's k = REF_K g_lagrange to it
REF_PARAMS_SHA256 = {
    18: "e29113a93c5dbcabc42b58ef2d1f1ba300694cb696ac9e97b6aa5b513971bda7",
}
# kernels of the main path (the default IPA schedule at k=14 runs every
# IPA round natively; its transforms are of 2^14 and 2^15, so B7's) and
# of the lookup path; K1 runs every transform of n >= 2^16 (the
# BenchCircuit proves at k = REF_K, [ref-k], the k = 18 dev_lookup and
# SHA-256 at k = 17), K2 the gate-chunk proves of [sha256];
# B4 and the GLV ladder run
# on the device IPA path (phase_ipa), B5 (the device Horner combine), B6,
# B8 and the one-step B2 on no proving path
MAIN_PATH_KERNELS = ("fmul", "faddsub", "pmixed_bucket_runs", "padd_masked",
                     "ntt")

# the card's peaks (H100 SXM at 700 W: HBM bytes and 32-bit integer
# multiply-adds a second), the multiply-adds of one Montgomery product and
# bound_ms(nbytes, muladds), the least time of a kernel's work: from
# halo2_tpu_torch/parallel/profiling.py, bound by main() once the package
# imports (this file alone must start and fail without it)
HBM_BYTES_PER_S = MULADD_PER_S = MONT_MULADDS = bound_ms = None


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int, warm: bool = True) -> float:
    """Mean ms per call over `reps` calls, CUDA events, after a warm-up
    (unless warm is False): the wall time of the calls on the stream,
    host work between launches included."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(ev) -> float:
    dev_us = getattr(ev, "self_device_time_total", None)
    return ev.self_cuda_time_total if dev_us is None else dev_us


def device_ms(fn, reps: int, kernel, per_call: bool = False) -> float:
    """Mean device time per launch of the CUDA kernels whose names hold
    `kernel` (a name fragment, or a tuple of them) over `reps` calls of fn
    (per call of fn with per_call), from torch.profiler: the kernels
    alone, without the wrapper's host work between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity, schedule
    fn()
    torch.cuda.synchronize()
    names = (kernel,) if isinstance(kernel, str) else kernel
    # one warm-up step before the recorded one: device tracing that starts
    # with the window can miss its first launches, and a window of a few
    # ms can then show none at all; where it still shows none, the window
    # is recorded again with four and then sixteen times the calls
    for reps in (reps, 4 * reps, 16 * reps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                     ) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and any(k in ev.key
                                                         for k in names):
                total += _device_us(ev)
                count += ev.count
        if count:
            return total / (reps if per_call else count) / 1e3
    raise RuntimeError(f"the profiler saw no launch of {kernel}")


def max_abs(got, want) -> int:
    """Largest digit difference (0 when bit-exact)."""
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")


def sass_counts(so: str) -> dict:
    """SASS instructions of each kernel of the built library at path `so`
    (cuobjdump -sass beside nvcc; {} where it is missing)."""
    import os
    import re
    from halo2_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.search(r"/\*[0-9a-f]{4,6}\*/", line):
            counts[cur] += 1
    return counts


def phase_build():
    from halo2_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f}s")
    for name, ent in logs.items():
        for line in ent["ptxas"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error")):
                log(f"[ptxas {name}] {line.strip()}")
    # the redesigned kernels' code size (instruction fetch, as the ladder
    # showed)
    for name, key in (("point_kernels", "pmixed_bucket_runs"),
                      ("point_kernels", "glv_ladder"),
                      ("point_kernels", "pmixed_masked_"),
                      ("point_kernels", "scalar_mul_ladder"),
                      ("point_kernels", "padd_kernel"),
                      ("point_kernels", "pdouble_"),
                      ("ntt_kernels", "ntt_"),
                      ("mxu_kernels", "mxu_"),
                      ("gate_kernels", "gate_chunk")):
        for fn, count in sass_counts(cuda_build._so_path(name)).items():
            if key in fn:
                log(f"[sass {name}] {fn}: {count} instructions")
    # K2's slot file: its local-memory loads and stores in the SASS
    for fn, ops in sass_opcodes(cuda_build._so_path("gate_kernels"),
                                "gate_chunk").items():
        log(f"[sass gate_kernels] {fn}: LDL {ops['LDL']}, LDL.128 "
            f"{ops['LDL.128']}, STL {ops['STL']}, STL.128 {ops['STL.128']}")


def rand_field(df, n, seed, device):
    """n field elements in Montgomery form made on the device: random
    values below 2^254 < p (any value below p is a Montgomery form), the
    last three the forms of 0, 1 and p - 1."""
    import torch
    from halo2_tpu_torch.fields.device import ints_to_digits
    p = df.spec.modulus
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=device,
                      dtype=torch.int32)
    x[:, 15] >>= 2
    x[-3:] = torch.from_numpy(ints_to_digits(
        [v * (1 << 256) % p for v in (0, 1, p - 1)]))
    return x


def phase_field(results):
    import torch
    from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV
    from halo2_tpu_torch.ops import field_kernels as fk
    dev = torch.device("cuda")
    n = 1 << 20
    mism = {"fmul": 0, "faddsub": 0}
    err = {"fmul": 0, "faddsub": 0}
    for df in (FP_DEV, FQ_DEV):
        a = rand_field(df, n, 2 * df.field_id, dev)
        b = rand_field(df, n, 2 * df.field_id + 1, dev)
        b[-3:] = a[-1]                    # (0, 1, p-1) x (p-1)
        pairs = [("fmul", fk.fmul, fk.fmul_plain),
                 ("faddsub", fk.fadd, fk.fadd_plain),
                 ("faddsub", fk.fsub, fk.fsub_plain)]
        for name, kern, plain in pairs:
            got = kern(df, a, b)
            want = torch.cat([plain(df, a[i:i + (1 << 18)],
                                    b[i:i + (1 << 18)])
                              for i in range(0, n, 1 << 18)])
            mism[name] += int((got != want).any(dim=-1).sum())
            err[name] = max(err[name], max_abs(got, want))
        # broadcast operand (a scalar and a twiddle row)
        got = fk.fmul(df, a[:4096].view(16, 256, 16), b[:256])
        want = fk.fmul_plain(df, a[:4096].view(16, 256, 16), b[:256])
        mism["fmul"] += int((got != want).any(dim=-1).sum())
    torch.cuda.synchronize()
    log(f"[field] mismatches {mism}")
    # times at the main path's widest shape: one extended-domain column
    # pair of the gate fold (2^15 elements at k=14)
    df = FP_DEV
    N = 1 << 15
    a = rand_field(df, N, 4, dev)
    b = rand_field(df, N, 5, dev)
    for name, kern, plain, muladds in (
            ("fmul", fk.fmul, fk.fmul_plain, MONT_MULADDS),
            ("faddsub", fk.fadd, fk.fadd_plain, 0)):
        ms = device_ms(lambda: kern(df, a, b), 200, name + "_kernel")
        call_ms = timed(lambda: kern(df, a, b), 200)
        pms = timed(lambda: plain(df, a, b), 5)
        bd, by = bound_ms(N * 192, N * muladds)
        results[name].update(mismatches=mism[name], max_abs_err=err[name],
                             ms=ms, call_ms=call_ms, plain_ms=pms,
                             bound_ms=bd, bound_by=by, shape=[N, 16])
        log(f"[field] {name} N={N}: {ms:.5f} ms on the device, "
            f"{call_ms:.4f} ms per wrapper call (plain {pms:.3f} ms, "
            f"bound {bd:.5f} ms by {by})")
    if any(mism.values()):
        raise AssertionError(f"field kernel mismatches {mism}")


def commit_lanes(k: int, m: int) -> int:
    from halo2_tpu_torch.ops.msm_pippenger import pick_c
    c = pick_c(1 << k)
    return m * (-(-256 // c)) * (1 << (c - 1))


def phase_points(results, params):
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    df = params.base_df
    rng = random.Random(12)
    L = commit_lanes(K, 2)               # an advice commit (m = 2)
    g = params.g_dev
    idx = torch.as_tensor([rng.randrange(params.n) for _ in range(L)],
                          device=dev)
    A = g[:, idx].clone()
    # projective accumulators with Z != 1: A + A' on a fresh batch
    A = pk.padd_masked_plain(df, A, g[:, idx.flip(0)],
                             torch.ones(L, dtype=torch.int32, device=dev))
    ident = pk.ident_col(df, dev)
    A[:, :64] = ident[:, None]           # identity accumulators
    B = g[:, torch.randint(params.n, (L,), device=dev)].clone()
    B[:, 64:128] = ident[:, None]        # identity-coded affine bases
    B[:, 128] = A[:, 128]                # doubling case in B3
    mask = torch.as_tensor([rng.random() < 0.8 for _ in range(L)],
                           device=dev).to(torch.int32)
    signs = torch.as_tensor([rng.random() < 0.5 for _ in range(L)],
                            device=dev).to(torch.int32)
    aff = B[:32].contiguous()
    mism, err = {}, {}
    got = pk.padd_masked_flat(df, A, B, mask)
    want = pk.padd_masked_plain(df, A, B, mask)
    mism["padd_masked"] = int((got != want).any(dim=0).sum())
    err["padd_masked"] = max_abs(got, want)
    got = pk.pmixed_masked_flat(df, A, aff, mask, signs)
    want = pk.pmixed_masked_plain(df, A, aff, mask, signs)
    mism["pmixed_masked"] = int((got != want).any(dim=0).sum())
    err["pmixed_masked"] = max_abs(got, want)
    torch.cuda.synchronize()
    log(f"[points] L={L} mismatches {mism}")
    live = int(mask.sum())
    r1 = ident[16:32]
    ident_b = ((aff[:16] == 0).all(0) & (aff[16:] == r1[:, None]).all(0))
    live_mixed = int((mask.bool() & ~ident_b).sum())
    for name, fn, plain, nbytes, muladds in (
            ("padd_masked", lambda: pk.padd_masked_flat(df, A, B, mask),
             lambda: pk.padd_masked_plain(df, A, B, mask),
             L * (192 + 192 + 4 + 192), live * 12 * MONT_MULADDS),
            ("pmixed_masked",
             lambda: pk.pmixed_masked_flat(df, A, aff, mask, signs),
             lambda: pk.pmixed_masked_plain(df, A, aff, mask, signs),
             L * (192 + 128 + 8 + 192), live_mixed * 11 * MONT_MULADDS)):
        ms = device_ms(fn, 50, name + "_")
        call_ms = timed(fn, 50)
        pms = timed(plain, 3)
        bd, by = bound_ms(nbytes, muladds)
        results[name].update(mismatches=mism[name], max_abs_err=err[name],
                             ms=ms, call_ms=call_ms, plain_ms=pms,
                             bound_ms=bd, bound_by=by, shape=[48, L])
        log(f"[points] {name} L={L}: {ms:.5f} ms on the device, "
            f"{call_ms:.4f} ms per wrapper call (plain {pms:.3f} ms, "
            f"bound {bd:.5f} ms by {by})")
    if any(mism.values()):
        raise AssertionError(f"point kernel mismatches {mism}")
    phase_b3_forms(results, params, A, mask, signs)
    phase_b2_forms(results, params)


# B2's widths: 1 and 8,192 lanes, kPmixedLaneFrom and one lane either side,
# 2^17; its forms are timed at B2_TIMED
B2_WIDTHS = (1, 8192, 1 << 17)
B2_TIMED = (8192, 1 << 17)


def _b2_inputs(df, pts, L, gen):
    """B2's operands at L lanes: [48, L] accumulators with Z != 1 and
    identity lanes, [32, L] affine bases from pts (Z = 1) with a 64th of
    them identity-coded, a random 80% of the lanes live and half the
    signs set; and the lanes live with a base that is not the identity."""
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = pts.device
    a, _ = _ladder_inputs(df, pts, L, gen, edge=False)
    aff = pts[:32, torch.randint(pts.shape[1], (L,), generator=gen,
                                 device=dev)].clone()
    ident = pk.ident_col(df, dev)[:32, None]
    aff[:, L // 2:L // 2 + max(1, L // 64)] = ident
    mask = (torch.rand(L, generator=gen, device=dev) < 0.8).to(torch.int32)
    signs = (torch.rand(L, generator=gen, device=dev) < 0.5).to(torch.int32)
    ident_b = (aff == ident).all(0)
    return a, aff, mask, signs, int((mask.bool() & ~ident_b).sum())


def phase_b2_forms(results, params):
    """B2 in both forms (pmixed_masked_form: one thread a lane, one lane a
    group of four threads) and through its wrapper (the form picked by
    lane count) against pmixed_masked_plain bit for bit, on both fields,
    at B2_WIDTHS and at kPmixedLaneFrom and one lane either side. Then, on
    the PALLAS base field at B2_TIMED and the threshold's two sides, each
    form's device time a launch from a CUDA graph of 20 launches and the
    wrapper's, beside the bound (520 bytes a lane against 11 products a
    live lane)."""
    import torch
    from halo2_tpu_torch.curves.host import VESTA
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    at = lane_from()["kPmixedLaneFrom"]
    widths = sorted(set(B2_WIDTHS) | {at - 1, at, at + 1})
    gen = torch.Generator(device=dev).manual_seed(19)
    vesta = pk.points_to_proj(FQ_DEV, native_srs_g(
        VESTA, "chip-smoke-b2", 1024), dev)
    r = results["pmixed_masked"]
    bad, err = 0, 0
    for df, pts in ((params.base_df, params.g_dev), (FQ_DEV, vesta)):
        for L in widths:
            a, aff, mask, signs, _ = _b2_inputs(df, pts, L, gen)
            want = pk.pmixed_masked_plain(df, a, aff, mask, signs)
            outs = [pk.pmixed_masked_form(df, a, aff, mask, signs, t)
                    for t in pk.FORMS.values()]
            outs.append(pk.pmixed_masked_flat(df, a, aff, mask, signs))
            for got in outs:
                bad += int((got != want).any(dim=0).sum())
                err = max(err, max_abs(got, want))
    torch.cuda.synchronize()
    log(f"[points] B2 both fields: both forms and the wrapper against the "
        f"plain version at {widths} lanes: {bad} mismatches")
    r["mismatches"] += bad
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["forms_lane_from"] = at
    if bad:
        raise AssertionError(f"B2 forms: {bad} mismatches")
    df = params.base_df
    forms = r.setdefault("forms", {})
    for L in sorted(set(B2_TIMED) | {at - 2048, at}):
        a, aff, mask, signs, live = _b2_inputs(df, params.g_dev, L, gen)
        bd, by = bound_ms(L * (192 + 128 + 8 + 192),
                          live * 11 * MONT_MULADDS)
        parts = []
        for form, t in pk.FORMS.items():
            ms = graph_ms(lambda t=t: pk.pmixed_masked_form(
                df, a, aff, mask, signs, t), 10, calls=20)
            forms.setdefault(form, {"threads": t})[f"ms_L{L}"] = ms
            parts.append(f"{form} {ms:.5f}")
        ms = graph_ms(lambda: pk.pmixed_masked_flat(df, a, aff, mask, signs),
                      10, calls=20)
        picked = form_picked("kPmixedLaneFrom", L)
        r.update({f"graph_ms_L{L}": ms, f"bound_ms_L{L}": bd,
                  f"form_L{L}": picked})
        log(f"[points] pmixed_masked L={L} ({live} live): "
            + ", ".join(parts) + f" ms a launch from a graph; the wrapper "
            f"({picked}) {ms:.5f} ms (bound {bd:.5f} ms by {by})")


def phase_b3_forms(results, params, A, mask, signs):
    """B3 reading its second operand itself, at the k=14 commit's lane
    count: at a lane offset within each window's row of BL lanes (the
    first suffix round) and by index with signs from the SRS bases (a
    projective bucket round), each against its plain version and timed
    beside B3 after torch.roll, or after a gather and a Y negation: how
    the commits called it before."""
    import torch
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    df = params.base_df
    L = A.shape[1]
    BL = 1 << (mp.pick_c(1 << K) - 1)
    g = params.g_dev
    gen = torch.Generator(device=dev).manual_seed(17)
    idx = torch.randint(g.shape[1], (L,), generator=gen, device=dev,
                        dtype=torch.int32)
    r = results["padd_masked"]
    live = int(mask.sum())
    forms = (
        ("roll", dict(width=BL, shift=-1), A,
         lambda: pk.padd_masked_flat(
             df, A, pk.gather_operand(df, A, width=BL, shift=-1), mask),
         L * (3 * 192 + 4)),
        ("index", dict(idx=idx, sign=signs), g,
         lambda: pk.padd_masked_flat(
             df, A, mp._negate_y(df, g[:, idx.long()], signs), mask),
         L * (3 * 192 + 12)))
    bad = 0
    for name, kw, src, before, nbytes in forms:
        fn = lambda: pk.padd_masked_flat(df, A, src, mask, **kw)
        got = fn()
        want = pk.padd_masked_plain(df, A, src, mask, **kw)
        bad += int((got != want).any(dim=0).sum())
        r["max_abs_err"] = max(r["max_abs_err"], max_abs(got, want))
        if not torch.equal(before(), got):
            bad += 1
        ms = device_ms(fn, 50, "padd_masked_kernel")
        call_ms = timed(fn, 50)
        before_ms = timed(before, 50)
        bd, by = bound_ms(nbytes, live * 12 * MONT_MULADDS)
        r.update({f"ms_{name}": ms, f"call_ms_{name}": call_ms,
                  f"call_ms_{name}_before": before_ms,
                  f"bound_ms_{name}": bd})
        log(f"[points] padd_masked {name} form L={L}: {ms:.5f} ms on the "
            f"device, {call_ms:.4f} ms per wrapper call; before (B3 after "
            f"{'torch.roll' if name == 'roll' else 'a gather and negation'})"
            f" {before_ms:.4f} ms per call (bound {bd:.5f} ms by {by})")
    r["mismatches"] += bad
    log(f"[points] B3 operand forms mismatches {bad}")
    if bad:
        raise AssertionError(f"B3 operand forms: {bad} mismatches")


class OffsetWidths:
    """Within `with`, every call of B3's offset form by the MSM
    (msm_pippenger.padd_masked_flat with width) is counted by its lane
    count and row width: {(L, width): [calls, live lanes over the calls]}."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        from halo2_tpu_torch.ops import msm_pippenger as mp
        self.real = real = mp.padd_masked_flat

        def recorded(df, a, b, mask, idx=None, sign=None, width=None,
                     shift=0, live=None):
            if width is not None:
                ent = self.seen.setdefault((a.shape[1], width), [0, 0])
                ent[0] += 1
                ent[1] = ent[1] + mask.sum()      # no sync in the prove
            return real(df, a, b, mask, idx, sign, width, shift, live=live)
        mp.padd_masked_flat = recorded
        return self

    def __exit__(self, *exc):
        from halo2_tpu_torch.ops import msm_pippenger as mp
        mp.padd_masked_flat = self.real


def phase_b3_widths(results, params, widths):
    """[points] B3's offset form at the widths the warm dev_lookup k=REF_K
    prove launched it with (recorded by OffsetWidths): at each lane count
    and row width, as the first suffix-sum round runs it (shift -1, every
    lane live but the last of each row), on projective points, against
    its plain version; device time by the profiler beside the byte bound
    (a, its rolled copy and the output, as B3's other forms count
    them). The points are B4 sums of two SRS points (_ladder_inputs)."""
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    df = params.base_df
    gen = torch.Generator(device=params.device).manual_seed(18)
    r = results["padd_masked"]
    bad = 0
    for (L, width), (calls, live_all) in sorted(widths.items()):
        A, _ = _ladder_inputs(df, params.g_dev, L, gen, edge=False)
        shift = -1
        bidx = torch.arange(width, device=params.device)
        mask = (bidx - shift < width).repeat(L // width)
        fn = lambda: pk.padd_masked_flat(df, A, A, mask, width=width,
                                         shift=shift)
        got = fn()
        # the plain version over whole rows of at most 2^16 lanes at a time
        # (its temporaries at the scan's millions of lanes would not fit
        # in the card's memory)
        step = max(1, (1 << 16) // width) * width
        for s in range(0, L, step):
            a = A[:, s:s + step].contiguous()
            bad += int((got[:, s:s + step] != pk.padd_masked_plain(
                df, a, a, mask[s:s + step], width=width, shift=shift)
                        ).any(dim=0).sum())
        del got
        ms = device_ms(fn, 20, "padd_masked_kernel")
        live = int(mask.sum())
        bd, by = bound_ms(L * (3 * 192 + 4), live * 12 * MONT_MULADDS)
        r.update({f"ms_offset_L{L}_w{width}": ms,
                  f"bound_ms_offset_L{L}_w{width}": bd,
                  f"launches_offset_L{L}_w{width}": calls})
        log(f"[points] padd_masked offset form at a k={REF_K} width, L={L} "
            f"rows of {width} (shift {shift}, {live} live lanes): {ms:.5f} ms"
            f" on the device (bound {bd:.5f} ms by {by}); {calls} launches "
            f"in the warm dev_lookup k={REF_K} prove, "
            f"{int(live_all) / calls:.0f}"
            f" live lanes a launch on average")
    r["mismatches"] += bad
    log(f"[points] B3 offset form at k={REF_K} widths: {bad} mismatches")
    if bad:
        raise AssertionError(f"B3 offset form at k={REF_K}: {bad} "
                             f"mismatches")


def b2_round_loop(df, aff, gidx, valid, sig, acc):
    """The affine bucket loop as it ran before the bucket-run kernel: from
    the identity batch acc, per round, a gather of every lane's base,
    aff[:, gidx[r]], then the one-step B2 kernel (the index rows built
    beforehand, as the old loop built them in blocks)."""
    from halo2_tpu_torch.ops import point_kernels as pk
    for r in range(gidx.shape[0]):
        acc = pk.pmixed_masked_flat(df, acc, aff[:, gidx[r]], valid[r],
                                    signs=sig[r])
    return acc


def edge_runs(aff, L, gen):
    """Bucket runs over L lanes in one window row (BL = L) of n = 2 L + 16
    packed bases (aff's points repeated), the row's members a random
    permutation with a random third negated, cut into runs at random
    (empty ones among them): (packed, members, starts, counts)."""
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = aff.device
    n = 2 * L + 16
    packed = pk.pack_affine(aff[:, torch.arange(n, device=dev)
                                % aff.shape[1]])
    order = torch.randperm(n, generator=gen, device=dev)[None]
    signs = (torch.rand((1, n), generator=gen, device=dev) < 0.33).long()
    cuts = torch.sort(torch.randint(0, n + 1, (L - 1,), generator=gen,
                                    device=dev)).values
    edges = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), n)])
    return (packed, pk.bucket_members(order, signs),
            edges[:-1].to(torch.int32), edges.diff().to(torch.int32))


def phase_bucket(results, params, params_ref_k):
    """[bucket] The bucket-run kernel, in both forms (one thread a lane,
    one lane a group of four threads, through pmixed_bucket_runs_form) and
    through its wrapper (the form picked by lane count), against its plain
    version and against the one-step B2 kernel run round by round over the
    gathered bases, on two columns of random scalars: at a k = 14 advice
    commit's 26,624 lanes (2^14 bases) and a k = 18 commit's 163,840 lanes
    (2^18 bases), on the PALLAS base field (the SRS) and the VESTA one
    (native SRS points; at 2^18, 2^14 of them repeated); then every form
    against the plain version at kBucketLaneFrom and one lane either side
    (edge_runs). Then, on PALLAS at both commit widths: each form's device
    time a launch from a CUDA graph, the wrapper's from a graph and by the
    profiler and per call, and those of the B2 round loop (its gathers and
    launches) replayed from a graph and called; the bound over the whole
    commit."""
    import torch
    from halo2_tpu_torch.curves.host import PALLAS, VESTA
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    r = results["pmixed_bucket_runs"]
    vesta14 = pk.points_to_proj(FQ_DEV, native_srs_g(
        VESTA, "chip-smoke-bucket", 1 << K), dev)[:32]
    mism, err = 0, 0
    for k, pallas in ((K, params), (REF_K, params_ref_k)):
        n = 1 << k
        c = mp.pick_c(n)
        for curve, df, aff in (
                (PALLAS, params.base_df, pallas.g_dev[:32].contiguous()),
                (VESTA, FQ_DEV, vesta14.repeat(1, n >> K).contiguous())):
            gen = torch.Generator(device=dev).manual_seed(k)
            digits = torch.randint(0, 1 << 16, (2, n, 16), generator=gen,
                                   device=dev, dtype=torch.int32)
            digits[..., 15] >>= 2                # below 2^254 < q
            runs = mp.bucket_runs(curve, digits, c)
            packed = pk.pack_affine(aff)
            members = pk.bucket_members(runs.order, runs.sg)
            starts = runs.starts_e.reshape(-1).to(torch.int32)
            counts = runs.counts_e.reshape(-1).to(torch.int32)
            L = starts.shape[0]
            maxc = int(counts.max())
            rr = torch.arange(maxc, device=dev)[:, None]
            valid = rr < counts[None]
            m = members.reshape(-1).long()[
                torch.arange(L, device=dev) // runs.BL * n
                + torch.where(valid, starts.long() + rr, 0)]
            gidx = m & 0x7FFFFFFF
            sig = (m < 0).to(torch.int32)
            valid = valid.to(torch.int32)
            # made outside any graph capture (a copy from the host)
            ident = pk.ident_col(df, dev)[:, None].expand(48, L).contiguous()
            want = pk.pmixed_bucket_runs_plain(df, packed, members, starts,
                                               counts, runs.BL)
            loop = b2_round_loop(df, aff, gidx, valid, sig, ident)
            bad = int((loop != want).any(dim=0).sum())
            # the kernel takes the int64 run bounds, as the MSM passes them
            starts64 = runs.starts_e.reshape(-1)
            counts64 = runs.counts_e.reshape(-1)
            outs = [pk.pmixed_bucket_runs(df, packed, members, starts64,
                                          counts64, runs.BL)]
            outs += [pk.pmixed_bucket_runs_form(df, packed, members,
                                                starts64, counts64, runs.BL,
                                                t)
                     for t in pk.FORMS.values()]
            for got in outs:
                bad += int((got != want).any(dim=0).sum())
                err = max(err, max_abs(got, want))
            mism += bad
            log(f"[bucket] k={k} {curve.name}: {L} lanes, runs up to {maxc}"
                f": the wrapper ({form_picked('kBucketLaneFrom', L)}) and "
                f"both forms against the plain version and the B2 round "
                f"loop, {bad} mismatches")
            if curve is not PALLAS:
                continue
            # timing on PALLAS: the whole commit's bucket phase
            forms = r.setdefault("forms", {})
            parts = []
            for form, t in pk.FORMS.items():
                ms = graph_ms(lambda t=t: pk.pmixed_bucket_runs_form(
                    df, packed, members, starts64, counts64, runs.BL, t), 5)
                forms.setdefault(form, {"threads": t})[f"ms_L{L}"] = ms
                parts.append(f"{form} {ms:.5f}")
            fn = lambda: pk.pmixed_bucket_runs(
                df, packed, members, starts64, counts64, runs.BL)
            g_ms, p_ms, c_ms = (graph_ms(fn, 5),
                                device_ms(fn, 5, "pmixed_bucket_runs_"),
                                timed(fn, 5))
            loop_fn = lambda: b2_round_loop(df, aff, gidx, valid, sig, ident)
            loop_graph = graph_ms(loop_fn, 3)
            loop_b2 = device_ms(loop_fn, 2, "pmixed_masked_",
                                per_call=True)
            loop_call = timed(loop_fn, 2)
            members_total = int(counts.sum())
            ident_base = ((aff[:16] == 0).all(0)
                          & (aff[16:] == pk.mont_one(df, dev)[:, None]).all(0))
            live = members_total - int(ident_base[gidx][valid.bool()].sum())
            bd, by = bound_ms(members_total * (64 + 4) + L * (8 + 192),
                              live * 11 * MONT_MULADDS)
            key = f"k{k}"
            picked = form_picked("kBucketLaneFrom", L)
            log(f"[bucket] k={k} L={L}: " + ", ".join(parts) + " ms a "
                f"launch from a graph; the wrapper ({picked}) {g_ms:.5f} ms "
                f"from a CUDA graph, {p_ms:.5f} ms by the profiler, "
                f"{c_ms:.4f} ms per wrapper call")
            r.update({f"graph_ms_{key}": g_ms, f"profiler_ms_{key}": p_ms,
                      f"call_ms_{key}": c_ms, f"form_L{L}": picked})
            log(f"[bucket] k={k} L={L}: the B2 round loop ({maxc} gathers "
                f"and launches) {loop_graph:.5f} ms from a CUDA graph, its "
                f"B2 launches {loop_b2:.5f} ms by the profiler, "
                f"{loop_call:.4f} ms called; bound {bd:.5f} ms by {by} "
                f"({members_total} members, {live} live)")
            r.update({f"graph_ms_b2_loop_{key}": loop_graph,
                      f"profiler_ms_b2_loop_{key}": loop_b2,
                      f"call_ms_b2_loop_{key}": loop_call,
                      f"bound_ms_{key}": bd})
            if k == K:
                pms = timed(lambda: pk.pmixed_bucket_runs_plain(
                    df, packed, members, starts, counts, runs.BL), 1,
                    warm=False)
                r.update(ms=g_ms, profiler_ms=p_ms, call_ms=c_ms,
                         plain_ms=pms, bound_ms=bd, bound_by=by,
                         shape=[48, L])
                log(f"[bucket] k={k}: plain {pms:.3f} ms")
    # each form at the threshold and one lane either side, both fields
    at = lane_from()["kBucketLaneFrom"]
    gen = torch.Generator(device=dev).manual_seed(19)
    bad = 0
    for df, aff in ((params.base_df, params.g_dev[:32]), (FQ_DEV, vesta14)):
        for L in (at - 1, at, at + 1):
            packed, members, starts, counts = edge_runs(aff, L, gen)
            want = pk.pmixed_bucket_runs_plain(df, packed, members, starts,
                                               counts, L)
            outs = [pk.pmixed_bucket_runs(df, packed, members, starts,
                                          counts, L)]
            outs += [pk.pmixed_bucket_runs_form(df, packed, members, starts,
                                                counts, L, t)
                     for t in pk.FORMS.values()]
            for got in outs:
                bad += int((got != want).any(dim=0).sum())
                err = max(err, max_abs(got, want))
    mism += bad
    r["forms_lane_from"] = at
    log(f"[bucket] the wrapper and both forms at kBucketLaneFrom = {at} "
        f"and one lane either side, both fields: {bad} mismatches")
    torch.cuda.synchronize()
    r.update(mismatches=mism, max_abs_err=err)
    log(f"[bucket] mismatches {mism}")
    if mism:
        raise AssertionError(f"bucket-run kernel mismatches: {mism}")


def graph_ms(fn, reps: int, calls: int = 1) -> float:
    """Mean ms per call of fn over `reps` replays of a CUDA graph of
    `calls` calls: the device time of fn's launches without the host's
    gaps between them (with calls > 1, each launch beside its neighbours,
    as a chain of short launches runs)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return timed(graph.replay, reps) / calls


def unfused_ladder(df, t1, t2, t12, bits1, bits2, consts):
    """The GLV ladder as it ran before the fused kernel: B5, then a masked
    B3, for each bit pair. consts: (the identity batch, an all-on and an
    all-off mask) on the lanes of t1, made outside any graph capture."""
    from halo2_tpu_torch.ops import point_kernels as pk
    acc, on, off = consts
    table = (t1, t1, t2, t12)
    for b1, b2 in zip(bits1, bits2):
        sel = b1 + 2 * b2
        acc = pk.pdouble_flat(df, acc)
        acc = pk.padd_masked_flat(df, acc, table[sel], on if sel else off)
    return acc


def phase_ladder(results, params, lanes=(1 << 13, 1 << 17)):
    """The fused GLV ladder, in both forms (one thread a lane, one lane a
    group of four threads, through glv_ladder_form) and through its
    wrapper (the form picked by lane count), against the B5/B3 kernel
    loop at 2^13 (k=14's first IPA fold) and 2^17 lanes (k=18's) and
    against its plain version at 256 lanes and at kGlvLaneFrom and one
    lane either side, on both fields, 130 random bit pairs; then on the
    base field of the PALLAS Params at 2^13 and 2^17 lanes each form's
    device time a launch from a CUDA graph beside the bound, the wrapper's
    by the profiler and per call, the loop's time (its wall time, and its
    device time from a CUDA graph replay) and the plain version's."""
    import torch
    from halo2_tpu_torch.curves.host import VESTA
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import ipa_device as ipd
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    rng = random.Random(16)
    nb = ipd.GLV_BITS
    bits = ([rng.randrange(2) for _ in range(nb)],
            [rng.randrange(2) for _ in range(nb)])
    nsel = sum(1 for b1, b2 in zip(*bits) if b1 or b2)
    gen = torch.Generator(device=dev).manual_seed(16)
    vesta = pk.points_to_proj(FQ_DEV, native_srs_g(
        VESTA, "chip-smoke-ladder", 1024), dev)
    at = lane_from()["kGlvLaneFrom"]

    def consts(df, L):
        ident = pk.ident_col(df, dev)[:, None].expand(48, L).contiguous()
        on = torch.ones(L, dtype=torch.int32, device=dev)
        return ident, on, torch.zeros_like(on)

    def table(df, pts, L):
        pick = torch.randint(pts.shape[1], (2, L), generator=gen, device=dev)
        g = pk.padd_flat(df, pts[:, pick[0]], pts[:, pick[1]])
        g[:, :4] = pk.ident_col(df, dev)[:, None]
        return ipd.glv_table(df, g, 1, 0)

    mism, err = 0, 0
    plain_widths = (256, at - 1, at, at + 1)
    for df, pts in ((params.base_df, params.g_dev), (FQ_DEV, vesta)):
        tables, outs = {}, {}
        for L in lanes + plain_widths:
            t = tables[L] = table(df, pts, L)
            outs[L] = [pk.glv_ladder_flat(df, *t, *bits)]
            outs[L] += [pk.glv_ladder_form(df, *t, *bits, th)
                        for th in pk.FORMS.values()]
        # the plain version walks the bits a launch at a time, seconds a
        # call at any width: one call on the plain-checked widths' lanes
        plain = pk.glv_ladder_plain(df, *(torch.cat(
            [tables[L][i] for L in plain_widths], 1) for i in range(3)),
            *bits).split(plain_widths, 1)
        wants = dict(zip(plain_widths, plain))
        for L in lanes + plain_widths:
            want = wants.get(L)
            if want is None:
                want = unfused_ladder(df, *tables[L], *bits, consts(df, L))
            bad = 0
            for got in outs[L]:
                bad += int((got != want).any(dim=0).sum())
                err = max(err, max_abs(got, want))
            mism += bad
            log(f"[ladder] field {df.field_id} L={L}: the wrapper "
                f"({form_picked('kGlvLaneFrom', L)}) and both forms against "
                f"the {'B5/B3 kernel loop' if L in lanes else 'plain version'}"
                f", {bad} mismatches")
    torch.cuda.synchronize()
    r = results["glv_ladder"]
    r["forms_lane_from"] = at
    forms = r.setdefault("forms", {})
    df = params.base_df
    for L in lanes:
        t = table(df, params.g_dev, L)
        c = consts(df, L)
        parts = []
        for form, th in pk.FORMS.items():
            ms = graph_ms(lambda th=th: pk.glv_ladder_form(df, *t, *bits, th),
                          3)
            forms.setdefault(form, {"threads": th})[f"ms_L{L}"] = ms
            parts.append(f"{form} {ms:.5f}")
        fn = lambda: pk.glv_ladder_flat(df, *t, *bits)
        loop = lambda: unfused_ladder(df, *t, *bits, c)
        ms = device_ms(fn, 5, "glv_ladder_")
        call_ms = timed(fn, 5)
        loop_ms = timed(loop, 3)
        loop_dev = graph_ms(loop, 3)
        bd, by = bound_ms(L * 4 * 192,
                          L * (8 * nb + 12 * nsel) * MONT_MULADDS)
        picked = form_picked("kGlvLaneFrom", L)
        log(f"[ladder] L={L}: " + ", ".join(parts) + " ms a launch from a "
            f"graph; the wrapper ({picked}) {ms:.5f} ms on the device per "
            f"round, {call_ms:.4f} ms per wrapper call (bound {bd:.5f} ms by "
            f"{by}); the B5/B3 loop {loop_dev:.5f} ms replayed from a CUDA "
            f"graph, {loop_ms:.4f} ms per round with its {2 * nb} "
            f"launches")
        r.update({f"ms_L{L}": ms, f"bound_ms_L{L}": bd,
                  f"call_ms_L{L}": call_ms, f"call_ms_loop_L{L}": loop_ms,
                  f"ms_loop_L{L}": loop_dev, f"form_L{L}": picked})
        if L == lanes[0]:
            pms = timed(lambda: pk.glv_ladder_plain(df, *t, *bits), 1,
                        warm=False)
            r.update(ms=ms, call_ms=call_ms, plain_ms=pms, bound_ms=bd,
                     bound_by=by, shape=[48, L])
            log(f"[ladder] L={L}: plain {pms:.3f} ms")
    r.update(mismatches=mism, max_abs_err=err)
    log(f"[ladder] mismatches {mism}")
    if mism:
        raise AssertionError(f"glv_ladder mismatches: {mism}")


def _rand_points(params, L, rng):
    """[48, L] projective batch with Z != 1: sums of two random SRS
    points."""
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    g = params.g_dev
    idx = torch.as_tensor([rng.randrange(params.n) for _ in range(2 * L)],
                          device=params.device)
    return pk.padd_plain(params.base_df, g[:, idx[:L]], g[:, idx[L:]])


def phase_add_double(results, params, lanes=(1 << 17, 1 << 13)):
    """B4 against its plain version at 2^17 lanes (k=18's first IPA fold)
    and 8,192 lanes (k=14's); device time at both, the wrapper and plain
    times at the last (the [ipa] path's first fold); then B5 and B6 in
    every form (phase_pdouble_forms)."""
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    df = params.base_df
    rng = random.Random(14)
    ident = pk.ident_col(df, dev)
    mism, err = 0, 0
    r = results["padd"]
    for L in lanes:
        A = _rand_points(params, L, rng)
        A[:, :64] = ident[:, None]                    # identity lanes
        B = _rand_points(params, L, rng)
        B[:, 32:96] = ident[:, None]
        B[:, 200:264] = A[:, 200:264]                 # a == b: doubling
        fn = lambda: pk.padd_flat(df, A, B)
        plain = lambda: pk.padd_plain(df, A, B)
        got, want = fn(), plain()
        mism += int((got != want).any(dim=0).sum())
        err = max(err, max_abs(got, want))
        torch.cuda.synchronize()
        ms = device_ms(fn, 50, "padd_kernel")
        bd, by = bound_ms(L * 3 * 192, L * 12 * MONT_MULADDS)
        log(f"[points] padd L={L}: {ms:.5f} ms on the device "
            f"(bound {bd:.5f} ms by {by})")
        r[f"ms_L{L}"] = ms
        r[f"bound_ms_L{L}"] = bd
        if L == lanes[-1]:
            call_ms = timed(fn, 50)
            pms = timed(plain, 3)
            r.update(ms=ms, call_ms=call_ms, plain_ms=pms, bound_ms=bd,
                     bound_by=by, shape=[48, L])
            log(f"[points] padd L={L}: {call_ms:.4f} ms per wrapper call, "
                f"plain {pms:.3f} ms")
    log(f"[points] B4 mismatches {mism}")
    r.update(mismatches=mism, max_abs_err=err)
    if mism:
        raise AssertionError(f"B4 mismatches {mism}")
    phase_pdouble_forms(results, params)


# B5's and B6's widths: 1 lane (a traced MSM's combine), 2 ([horner]),
# 8,192 and 2^17 (the first IPA fold at k = 14 and 18) and the edges of a
# block; the forms are held to the plain versions at all of them and at
# each form threshold and one lane either side, and timed at PDOUBLE_TIMED
PDOUBLE_WIDTHS = (1, 2, 8191, 8192, 1 << 17)
PDOUBLE_TIMED = (1, 2, 8192, 1 << 17)


def lane_from() -> dict:
    """csrc/point_kernels.cu's k*LaneFrom constants: from that many lanes
    B5 (kPdoubleLaneFrom), B6 (kPdoubleMaskedLaneFrom), the GLV ladder
    (kGlvLaneFrom), the bucket-run kernel (kBucketLaneFrom) and B2
    (kPmixedLaneFrom) run one thread a lane, below it one lane a group of
    four threads."""
    import os
    import re
    from halo2_tpu_torch.ops import cuda_build
    with open(os.path.join(cuda_build.CSRC, "point_kernels.cu")) as fh:
        src = fh.read()
    return {k: int(v) for k, v in re.findall(
        r"static constexpr int (k\w+LaneFrom) = (\d+);", src)}


def form_picked(name: str, L: int) -> str:
    """The form (a key of point_kernels.FORMS) the wrapper picks at L
    lanes, by the threshold `name` of lane_from()."""
    return "lane" if L >= lane_from()[name] else "group"


def phase_pdouble_forms(results, params):
    """B5 and B6 in every form (pdouble_form: one thread a lane, one lane a
    group of four threads) and through their wrappers (the form picked by
    lane count) against pdouble_plain and pdouble_masked_plain, bit for
    bit, on both fields, at PDOUBLE_WIDTHS and at each form threshold and
    one lane either side, with identity lanes, B6 with masks of a random
    half, all ones and all zeros. Then, on the PALLAS base field at
    PDOUBLE_TIMED lanes (B6 with the random half), each form's device time
    a launch from a CUDA graph of 20 launches beside its bound, and the
    wrappers' from a graph and by the profiler; their call and plain times
    at 8,192 lanes."""
    import torch
    from halo2_tpu_torch.curves.host import VESTA
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    thresholds = {k: v for k, v in lane_from().items()
                  if k.startswith("kPdouble")}
    widths = sorted(set(PDOUBLE_WIDTHS) | {t + d for t in thresholds.values()
                                           for d in (-1, 0, 1)})
    gen = torch.Generator(device=dev).manual_seed(17)
    vesta = pk.points_to_proj(FQ_DEV, native_srs_g(
        VESTA, "chip-smoke-pdouble", 1024), dev)
    mism = {"pdouble": 0, "pdouble_masked": 0}
    err = dict(mism)
    for df, pts in ((params.base_df, params.g_dev), (FQ_DEV, vesta)):
        for L in widths:
            a, _ = _ladder_inputs(df, pts, L, gen, edge=False)
            a[:, L // 3] = pk.ident_col(df, dev)
            half = (torch.rand(L, generator=gen, device=dev) < 0.5).to(
                torch.int32)
            for mask in (None, half, torch.ones_like(half),
                         torch.zeros_like(half)):
                name = "pdouble" if mask is None else "pdouble_masked"
                want = (pk.pdouble_plain(df, a) if mask is None
                        else pk.pdouble_masked_plain(df, a, mask))
                outs = [pk.pdouble_form(df, a, t, mask)
                        for t in pk.FORMS.values()]
                outs.append(pk.pdouble_flat(df, a) if mask is None
                            else pk.pdouble_masked_flat(df, a, mask))
                for got in outs:
                    mism[name] += int((got != want).any(dim=0).sum())
                    err[name] = max(err[name], max_abs(got, want))
        torch.cuda.synchronize()
        log(f"[points] B5, B6 field {df.field_id}: every form and the "
            f"wrappers against the plain versions at {widths} lanes; "
            f"mismatches so far {mism}")
    for name in mism:
        results[name].update(mismatches=mism[name], max_abs_err=err[name])
    if any(mism.values()):
        raise AssertionError(f"B5/B6 mismatches {mism}")
    df = params.base_df
    for L in PDOUBLE_TIMED:
        a, _ = _ladder_inputs(df, params.g_dev, L, gen, edge=False)
        half = (torch.rand(L, generator=gen, device=dev) < 0.5).to(
            torch.int32)
        live = int(half.sum())
        for name, mask, nbytes, muladds in (
                ("pdouble", None, L * 2 * 192, L * 8 * MONT_MULADDS),
                ("pdouble_masked", half, L * (2 * 192 + 4),
                 live * 8 * MONT_MULADDS)):
            bd, by = bound_ms(nbytes, muladds)
            r = results[name]
            forms = r.setdefault("forms", {})
            parts = []
            for form, t in pk.FORMS.items():
                ms = graph_ms(lambda t=t, mask=mask: pk.pdouble_form(
                    df, a, t, mask), 10, calls=20)
                forms.setdefault(form, {"threads": t})[f"ms_L{L}"] = ms
                parts.append(f"{form} {ms:.5f}")
            if mask is None:
                fn = lambda: pk.pdouble_flat(df, a)
                plain = lambda: pk.pdouble_plain(df, a)
            else:
                fn = lambda mask=mask: pk.pdouble_masked_flat(df, a, mask)
                plain = lambda mask=mask: pk.pdouble_masked_plain(df, a,
                                                                  mask)
            ms = graph_ms(fn, 10, calls=20)
            prof = device_ms(fn, 50, "pdouble_")
            key = "kPdoubleLaneFrom" if mask is None else \
                "kPdoubleMaskedLaneFrom"
            picked = form_picked(key, L)
            r.update({f"ms_L{L}": ms, f"profiler_ms_L{L}": prof,
                      f"bound_ms_L{L}": bd, f"form_L{L}": picked})
            log(f"[points] {name} L={L}: " + ", ".join(parts) + f" ms a "
                f"launch from a graph; the wrapper ({picked}) {ms:.5f} ms "
                f"from a graph, {prof:.5f} ms by the profiler (bound "
                f"{bd:.5f} ms by {by})")
            if L == 8192:
                call_ms = timed(fn, 50)
                pms = timed(plain, 3)
                r.update(ms=ms, call_ms=call_ms, plain_ms=pms, bound_ms=bd,
                         bound_by=by, shape=[48, L],
                         forms_lane_from=thresholds[key])
                log(f"[points] {name} L={L}: {call_ms:.4f} ms per wrapper "
                    f"call, plain {pms:.3f} ms")


def phase_horner(params, results):
    """device_horner_combine (c B5 doublings and one B4 add per window)
    against host_horner_combine on the window sums of a k=14 MSM; its B5
    and B4 launches, its device time by the profiler (every kernel of one
    combine, and B5's part) and its wall time."""
    import torch
    from halo2_tpu_torch.fields.device import from_mont
    from halo2_tpu_torch.ops import msm_pippenger as mp
    from halo2_tpu_torch.ops import point_kernels as pk
    q = params.curve.scalar.modulus
    rng = random.Random(15)
    df = params.scalar_df
    cols = [[rng.randrange(q) for _ in range(params.n)] for _ in range(2)]
    digits = from_mont(df, torch.stack([df.upload_values(c, params.device)
                                        for c in cols]))
    wsums, c = mp.msm_window_sums_many(params.curve, params.base_df,
                                       digits, params.g_dev)
    ws = wsums.permute(1, 0, 2)
    combine = lambda: mp.device_horner_combine(params.base_df, ws, c)
    torch.cuda.synchronize()
    before = launch_counts()
    t = time.perf_counter()
    got = combine()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    diff = diff_counts(before)
    wnp = wsums.cpu().numpy()
    want = [mp.host_horner_combine(params.curve,
                                   pk.points_from_proj(params.base_df,
                                                       wnp[j]),
                                   c) for j in range(len(cols))]
    got = pk.points_from_proj(params.base_df, got)
    # every kernel and copy of the combine: B5, B4, the copies that make
    # each window's sums contiguous and the identity's upload
    dev_ms = device_ms(combine, 3, ("pdouble_", "padd_kernel", "copy",
                                    "Memcpy"), per_call=True)
    b5_ms = device_ms(combine, 3, "pdouble_", per_call=True)
    W = wsums.shape[-1]
    log(f"[horner] k={K} c={c} W={W}, two sums: device combine "
        f"{dt * 1e3:.1f} ms; B5 {diff['pdouble']} launches, B4 "
        f"{diff['padd']}; {dev_ms:.4f} ms of device time a combine by the "
        f"profiler, B5 {b5_ms:.4f} ms of it; equal to the host combine: "
        f"{got == want}")
    results["pdouble"].update(horner_launches=diff["pdouble"],
                              horner_device_ms=dev_ms, horner_b5_ms=b5_ms,
                              horner_wall_ms=dt * 1e3)
    if got != want:
        raise AssertionError("device Horner combine != host combine")
    if diff["pdouble"] != c * W:
        raise AssertionError(f"{diff['pdouble']} B5 launches in the "
                             f"combine, want c W = {c * W}")


def phase_commit(params):
    import torch
    q = params.curve.scalar.modulus
    rng = random.Random(13)
    n = params.n
    cols = [[rng.randrange(q) for _ in range(n)], [0] * n,
            [rng.randrange(q)] * n]
    df = params.scalar_df
    polys = [df.upload_values(c, params.device) for c in cols]
    t0 = time.perf_counter()
    got = params.commit_many(polys, [0, 0, 0], lagrange=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = [params.curve.msm(c, params.g) for c in cols]
    bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    log(f"[commit] k={K} three columns in {dt:.3f}s; mismatching columns "
        f"{bad}")
    if bad:
        raise AssertionError(f"commit mismatch in columns {bad}")


def phase_main_path(results):
    import torch
    from halo2_tpu_torch.bench_circuit import (BenchCircuit, regions_for_k,
                                               expected_output, SEED_A,
                                               PROOF_SEED)
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.ops import field_kernels as fk
    from halo2_tpu_torch.ops import point_kernels as pk
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                VerificationError)
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

    reset_counts()                        # the main path's count starts
    regions = regions_for_k(K)
    fs = PALLAS.scalar
    out = expected_output(fs, SEED_A, regions)
    circuit = BenchCircuit(SEED_A, regions)
    t0 = time.perf_counter()
    params = Params.new(PALLAS, K)
    t1 = time.perf_counter()
    vk = keygen_vk(params, circuit)
    pk_ = keygen_pk(params, vk, circuit)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[main] k={K} regions={regions}: Params.new {t1 - t0:.2f}s, "
        f"keygen {t2 - t1:.2f}s")
    log(f"[main] launches in Params.new + keygen {launch_counts()}")
    proofs, times = [], []
    for label in ("cold", "warm"):
        before = launch_counts()
        tw = TranscriptWrite(PALLAS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with ntt_shapes() as shapes:
            pv.create_proof(params, pk_, [circuit], [[[out]]],
                            random.Random(PROOF_SEED), tw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        proofs.append(tw.finalize())
        log(f"[main] create_proof {label}: {times[-1]:.3f}s, "
            f"{len(proofs[-1])} bytes, launches {diff_counts(before)}")
    log(f"[main] transforms of the warm prove, (route, columns, n): "
        f"count {dict(shapes)}")
    check_routes("main", shapes)
    log("[main] warm phases " + json.dumps(
        {name: round(s, 4) for name, s in pv.LAST_PHASES}))
    t = time.perf_counter()
    verify_proof(params, vk, SingleVerifier(params), [[[out]]],
                 TranscriptRead(PALLAS, proofs[1]))
    log(f"[main] verify_proof: {time.perf_counter() - t:.3f}s (accepted)")
    try:
        verify_proof(params, vk, SingleVerifier(params), [[[out + 1]]],
                     TranscriptRead(PALLAS, proofs[1]))
    except VerificationError:
        log("[main] wrong public input rejected")
    else:
        raise AssertionError("a wrong public input was accepted")
    launches = launch_counts()
    for name in MAIN_PATH_KERNELS + ("pmixed_masked",):
        results[name]["launches"] = launches[name]
    log(f"[main] B3 launches {launches['padd_masked']} (each reads its "
        f"operand itself), GLV ladder {launches['glv_ladder']}, B5 "
        f"{launches['pdouble']}")
    log(f"[main] B2 family: bucket-run kernel {launches['pmixed_bucket_runs']}"
        f" launches (one per affine-base commit), one-step B2 "
        f"{launches['pmixed_masked']}; B7 {launches['ntt']} launches, K1 "
        f"{launches['mxu']}")
    if launches["glv_ladder"] or launches["pdouble"]:
        raise AssertionError("the default k=14 schedule folds no IPA round "
                             "on the card, yet a ladder or B5 ran")
    if launches["pmixed_masked"]:
        raise AssertionError("the main path ran a per-round B2")
    if proofs[0] != proofs[1]:
        raise AssertionError("cold and warm proofs differ")
    digest = hashlib.sha256(proofs[1]).hexdigest()
    log(f"[main] proof sha256 {digest}")
    if digest != REF_SHA256["bench", K]:
        raise AssertionError(f"proof hash {digest} != JAX reference "
                             f"{REF_SHA256['bench', K]}")
    log("[main] proof bytes equal the JAX reference's")
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the main path not launched: "
                             f"{idle}")
    return params, pk_, circuit, out, shapes


class ntt_shapes:
    """Within the block, the (route, columns, n) of every transform the
    domain runs, counted: route "mxu" for the four-step (K1), "b7" for
    B7 (a measurement hook around poly/domain.py's _ntt_dispatch)."""

    def __enter__(self):
        from collections import Counter
        from halo2_tpu_torch.poly import domain
        self.shapes = Counter()
        self.orig = orig = domain._ntt_dispatch

        def recording(df, x, plan):
            route = "mxu" if domain._use_mxu(plan.n, x.device) else "b7"
            self.shapes[(route,) + tuple(x.shape[:2])] += 1
            return orig(df, x, plan)

        domain._ntt_dispatch = recording
        return self.shapes

    def __exit__(self, *exc):
        from halo2_tpu_torch.poly import domain
        domain._ntt_dispatch = self.orig
        return False


def k1_launches(shapes) -> int:
    """K1's launches for the four-step transforms in `shapes` (from
    ntt_shapes): one a pass of each transform's plan."""
    from halo2_tpu_torch.ops import mxu_field as mxu
    return sum(c * len(mxu.four_step_passes(m, n))
               for (route, m, n), c in shapes.items()
               if route == "mxu" and m and n > 1)


def check_routes(tag, shapes):
    """Every transform of n >= 2^16 took the four-step and every smaller
    one B7 (shapes from ntt_shapes); raises otherwise."""
    from halo2_tpu_torch.poly.domain import MXU_NTT_MIN
    wrong = {k: c for k, c in shapes.items()
             if (k[0] == "mxu") != (k[2] >= MXU_NTT_MIN)}
    if wrong:
        raise AssertionError(f"[{tag}] transforms on the wrong route: "
                             f"{wrong}")


def _counters() -> tuple:
    from halo2_tpu_torch.ops import field_kernels as fk
    from halo2_tpu_torch.ops import gate_kernels as gk
    from halo2_tpu_torch.ops import mxu_field as mxu
    from halo2_tpu_torch.ops import ntt
    from halo2_tpu_torch.ops import point_kernels as pk
    return fk.LAUNCHES, pk.LAUNCHES, ntt.LAUNCHES, mxu.LAUNCHES, gk.LAUNCHES


def launch_counts() -> dict:
    return {k: v for d in _counters() for k, v in d.items()}


def diff_counts(before: dict) -> dict:
    """Launches of each kernel since `before` (a launch_counts())."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def reset_counts() -> None:
    """Every kernel's launch count to 0: a path's run starts here."""
    for d in _counters():
        for key in d:
            d[key] = 0


def profile_call(tag, fn, what="warm prove"):
    """fn() (one warm prove, or the call `what` names) under
    torch.profiler: device time by kernel and the busy share of the wall
    time. Reports "not measured" where the profiler sees no device
    activity. Returns the rows (device us, launches, kernel name), the
    longest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for ev in prof.key_averages():
        # kernels and copies only: a CPU op's device time repeats theirs
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = _device_us(ev)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    if not rows:
        log(f"[{tag}] {what} {wall:.3f}s; device time not measured "
            f"(the profiler saw no device activity)")
        return rows
    log(f"[{tag}] {what} {wall:.3f}s wall, device busy {busy:.4f}s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for dev_us, count, key in rows[:12]:
        log(f"[{tag}]   {dev_us / 1e3:9.3f} ms {count:6d}x {key[:90]}")
    return rows


def profile_prove(tag, params, pk_, circuit, out, **kw):
    """One warm BenchCircuit prove under the profiler (profile_call);
    returns its rows."""
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.transcript import TranscriptWrite
    return profile_call(tag, lambda: pv.create_proof(
        params, pk_, [circuit], [[[out]]], random.Random(PROOF_SEED),
        TranscriptWrite(PALLAS), **kw))


def phase_profile(params, pk_, circuit, out):
    profile_prove("profile", params, pk_, circuit, out)


def phase_ipa(results, params, pk_, circuit, out):
    """The device IPA path at k=14: every IPA round on the card
    (native_ipa_threshold=0). Counts start at 0 just before the proves and
    are read just after; the proof must hash to the JAX reference's."""
    import torch
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.verifier import verify_proof, SingleVerifier
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead
    reset_counts()
    proofs = []
    for label in ("cold", "warm"):
        before = launch_counts()
        tw = TranscriptWrite(PALLAS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pv.create_proof(params, pk_, [circuit], [[[out]]],
                        random.Random(PROOF_SEED), tw,
                        native_ipa_threshold=0)
        torch.cuda.synchronize()
        proofs.append(tw.finalize())
        diff = diff_counts(before)
        log(f"[ipa] create_proof {label}, every IPA round on the card: "
            f"{time.perf_counter() - t:.3f}s, launches {diff}")
        # one fused ladder per fold round (K of them), no B5
        log(f"[ipa] {label}: GLV ladder {diff['glv_ladder']} launches for "
            f"{K} device fold rounds, B5 {diff['pdouble']}, B3 "
            f"{diff['padd_masked']}")
        if diff["glv_ladder"] != K or diff["pdouble"]:
            raise AssertionError(f"device IPA prove: {diff['glv_ladder']} "
                                 f"ladders for {K} fold rounds, "
                                 f"{diff['pdouble']} B5 launches")
    launches = launch_counts()
    log(f"[ipa] launches in the two proves {launches}")
    log("[ipa] warm phases " + json.dumps(
        {name: round(s, 4) for name, s in pv.LAST_PHASES}))
    # B5 and B6: no caller on a proving path
    for name in ("padd", "glv_ladder", "pdouble", "pdouble_masked"):
        results[name]["launches"] = launches[name]
    verify_proof(params, pk_.vk, SingleVerifier(params), [[[out]]],
                 TranscriptRead(PALLAS, proofs[1]))
    digest = hashlib.sha256(proofs[1]).hexdigest()
    log(f"[ipa] proof sha256 {digest} (verified)")
    if proofs[0] != proofs[1] or digest != REF_SHA256["bench", K]:
        raise AssertionError(f"device-IPA proof hash {digest} != JAX "
                             f"reference {REF_SHA256['bench', K]}")
    log("[ipa] proof bytes equal the JAX reference's")
    idle = [k for k in MAIN_PATH_KERNELS + ("padd", "glv_ladder")
            if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the IPA path not launched: {idle}")
    rows = profile_prove("ipa", params, pk_, circuit, out,
                         native_ipa_threshold=0)
    glv = [(us, n) for us, n, key in rows if "glv_ladder_" in key]
    if glv:
        ms, n = sum(us for us, _ in glv) / 1e3, sum(n for _, n in glv)
        results["glv_ladder"].update(ipa_profiled_ms=ms,
                                     ipa_profiled_launches=n)
        log(f"[ipa] profiled warm prove: the GLV ladder {ms:.3f} ms of "
            f"device time in {n} launches")


def phase_reference_k(results):
    """BenchCircuit at 2^REF_K rows: keygen and a proof under each IPA
    schedule, whose bytes must hash to the JAX reference's. Every
    transform here is of 2^18 or 2^19, so the four-step's (K1): counts set
    to 0 just before keygen and read after the proves, K1 launched and
    B7 not, every transform on its route, each prove's K1 launches those
    of its transforms' pass plans (28 a warm prove)."""
    import torch
    from halo2_tpu_torch.bench_circuit import (BenchCircuit, regions_for_k,
                                               expected_output, SEED_A,
                                               PROOF_SEED)
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.transcript import TranscriptWrite
    regions = regions_for_k(REF_K)
    out = expected_output(PALLAS.scalar, SEED_A, regions)
    circuit = BenchCircuit(SEED_A, regions)
    t0 = time.perf_counter()
    params = Params.new(PALLAS, REF_K)
    t1 = time.perf_counter()
    reset_counts()                        # the ref-k path's count starts
    vk = keygen_vk(params, circuit)
    pk_ = keygen_pk(params, vk, circuit)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[ref-k] k={REF_K} regions={regions}: Params.new {t1 - t0:.2f}s, "
        f"keygen {t2 - t1:.2f}s")
    # the IPA schedules: the default (device rounds while half > 8192,
    # then native), every round native, every round on the card; the
    # first prove is cold, so the default runs again warm; then the
    # default and the all-device proves once more under the profiler
    schedules = (("default IPA schedule, cold", {}),
                 ("every IPA round native",
                  {"native_ipa_threshold": 1 << REF_K}),
                 ("every IPA round on the card",
                  {"native_ipa_threshold": 0}),
                 ("default IPA schedule, warm", {}))
    for label, kw in schedules:
        before = launch_counts()
        tw = TranscriptWrite(PALLAS)
        t = time.perf_counter()
        with ntt_shapes() as shapes:
            pv.create_proof(params, pk_, [circuit], [[[out]]],
                            random.Random(PROOF_SEED), tw, **kw)
        torch.cuda.synchronize()
        check_routes("ref-k", shapes)
        digest = hashlib.sha256(tw.finalize()).hexdigest()
        d = diff_counts(before)
        log(f"[ref-k] create_proof, {label}: "
            f"{time.perf_counter() - t:.3f}s, launches {d}; K1 "
            f"{d['mxu']} for {sum(shapes.values())} four-step transforms")
        if d["mxu"] != k1_launches(shapes):
            raise AssertionError(f"[ref-k] {d['mxu']} K1 launches, the pass "
                                 f"plans make {k1_launches(shapes)}")
        if label.endswith("warm"):
            results["mxu"]["launches_warm_prove_ref_k"] = d["mxu"]
        log("[ref-k] phases " + json.dumps(
            {name: round(s, 4) for name, s in pv.LAST_PHASES}))
        log(f"[ref-k] proof sha256 {digest}")
        if digest != REF_SHA256["bench", REF_K]:
            raise AssertionError(f"k={REF_K} proof hash {digest} != JAX "
                                 f"reference {REF_SHA256['bench', REF_K]}")
        log(f"[ref-k] proof bytes equal the JAX reference's at k={REF_K}")
    launches = launch_counts()
    log(f"[ref-k] launches in keygen and the four proves {launches}; the "
        f"last prove's transforms (route, columns, n): {dict(shapes)}")
    results["mxu"]["launches"] = launches["mxu"]
    results["ntt"]["ref_k_launches"] = launches["ntt"]
    if not launches["mxu"] or launches["ntt"]:
        raise AssertionError(f"[ref-k] K1 {launches['mxu']} and B7 "
                             f"{launches['ntt']} launches: every transform "
                             f"at k={REF_K} is of 2^16 or more")
    for label, kw in schedules[2:]:
        log(f"[ref-k] profiled: {label.split(',')[0]}")
        profile_prove("ref-k", params, pk_, circuit, out, **kw)
    return params


def ntt_times(df, x, plan):
    """B7 on x [m, n, 16] from a CUDA graph (device time without host
    gaps), by the profiler, and per wrapper call."""
    from halo2_tpu_torch.ops import ntt
    fn = lambda: ntt.ntt_many(df, x, plan)
    return {"graph_ms": graph_ms(fn, 20),
            "profiler_ms": device_ms(fn, 20, "ntt_pass", per_call=True),
            "call_ms": timed(fn, 20)}


def ntt_bound(m, n, log_n):
    """Each column read and written once, the packed twiddles read once,
    (n/2) log n products a column."""
    return bound_ms(m * n * 128 + (n - 1) * 32,
                    m * (n // 2) * log_n * MONT_MULADDS)


def phase_ntt(results):
    """B7 against the plain version at n = 2^10 (one pass), 2^16 (k = 14's
    extended domain) and 2^20 (k = 18's), 1 and 4 columns, forward and
    inverse, both fields, with its launches per transform (at most two);
    its device time per transform from a CUDA graph and by the profiler,
    its wrapper time and the bound."""
    import torch
    from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV
    from halo2_tpu_torch.ops import ntt
    dev = torch.device("cuda")
    mism, err, launches = 0, 0, {}
    r = results["ntt"]
    for log_n in (10, 16, 20):
        n = 1 << log_n
        for df in (FP_DEV, FQ_DEV):
            spec = df.spec
            omega = pow(spec.root_of_unity, 1 << (spec.s - log_n),
                        spec.modulus)
            x = rand_field(df, 4 * n, log_n, dev).view(4, n, 16)
            plans = {"fwd": ntt.make_plan(df, n, omega),
                     "inv": ntt.make_plan(df, n, pow(omega, spec.modulus - 2,
                                                     spec.modulus))}
            for direction, plan in plans.items():
                for m in (1, 4):
                    want = ntt.ntt_many_plain(df, x[:m], plan)
                    before = ntt.LAUNCHES["ntt"]
                    got = ntt.ntt_many(df, x[:m], plan)
                    launches[log_n] = ntt.LAUNCHES["ntt"] - before
                    bad = int((got != want).any(dim=-1).sum())
                    mism += bad
                    err = max(err, max_abs(got, want))
                    del got, want
                    if bad:
                        log(f"[ntt] n=2^{log_n} m={m} {direction} "
                            f"field {df.field_id}: {bad} mismatches")
                    if launches[log_n] != (1 if log_n <= 10 else 2):
                        raise AssertionError(
                            f"B7 made {launches[log_n]} launches for a "
                            f"transform of 2^{log_n}")
            if df is FQ_DEV:
                # times on the scalar field of PALLAS Params, forward
                plan = plans["fwd"]
                for m in (1, 4):
                    xm = x[:m].contiguous()
                    t = ntt_times(df, xm, plan)
                    bd, by = ntt_bound(m, n, log_n)
                    log(f"[ntt] n=2^{log_n} m={m}: {t['graph_ms']:.5f} ms "
                        f"per transform from a CUDA graph, "
                        f"{t['profiler_ms']:.5f} ms by the profiler, in "
                        f"{launches[log_n]} launches, "
                        f"{t['call_ms']:.4f} ms per wrapper call "
                        f"(bound {bd:.5f} ms by {by})")
                    key = f"n{log_n}_m{m}"
                    r.update({f"{k}_{key}": v for k, v in t.items()})
                    r[f"bound_ms_{key}"] = bd
                    if (log_n, m) == (16, 1):
                        pms = timed(lambda: ntt.ntt_many_plain(df, xm, plan),
                                    2)
                        r.update(ms=t["graph_ms"], call_ms=t["call_ms"],
                                 profiler_ms=t["profiler_ms"],
                                 plain_ms=pms, bound_ms=bd, bound_by=by,
                                 shape=[1, n, 16])
                        log(f"[ntt] n=2^{log_n} m=1: plain {pms:.3f} ms")
            del x
    torch.cuda.synchronize()
    r.update(mismatches=mism, max_abs_err=err)
    log(f"[ntt] mismatches {mism}, max abs error {err}; launches per "
        f"transform by log n {launches}")
    if mism:
        raise AssertionError(f"NTT kernel mismatches: {mism}")


def phase_ntt_main(results, shapes):
    """The main path's warm prove's transforms (from [main]), forward, on
    the PALLAS scalar field, each timed on its route at its (columns, n)
    from a CUDA graph: B7 below 2^16 (and by the profiler), against the
    plain version; the four-step from 2^16, against B7, with B7 timed
    beside it."""
    import torch
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import mxu_field as mxu
    from halo2_tpu_torch.ops import ntt
    dev = torch.device("cuda")
    df = FQ_DEV
    bad = 0
    for (route, m, n), count in sorted(shapes.items()):
        log_n = n.bit_length() - 1
        plan = ntt.make_plan(df, n, pow(df.spec.root_of_unity,
                                        1 << (df.spec.s - log_n),
                                        df.spec.modulus))
        x = rand_field(df, m * n, 40 + log_n, dev).view(m, n, 16)
        key = f"main_n{log_n}_m{m}"
        if route == "mxu":
            r = results["mxu"]
            bad += int((mxu.ntt_mxu_b(df, x, plan) !=
                        ntt.ntt_many(df, x, plan)).any(dim=-1).sum())
            four = graph_ms(lambda: mxu.ntt_mxu_b(df, x, plan), 10)
            b7 = graph_ms(lambda: ntt.ntt_many(df, x, plan), 10)
            npass = len(mxu.four_step_passes(m, n))
            k1 = four / npass
            bd, by = mxu_transform_bound(m, n)
            log(f"[ntt-main] {count}x four-step (m={m}, n=2^{log_n}): "
                f"{four:.5f} ms a transform from a CUDA graph in {npass} K1 "
                f"launches (bound {bd:.5f} ms by {by}), B7 {b7:.5f} ms")
            r.update({f"four_step_ms_{key}": four, f"b7_ms_{key}": b7,
                      f"ms_{key}": k1, f"bound_ms_{key}": bd})
            continue
        r = results["ntt"]
        bad += int((ntt.ntt_many(df, x, plan) !=
                    ntt.ntt_many_plain(df, x, plan)).any(dim=-1).sum())
        t = ntt_times(df, x, plan)
        bd, by = ntt_bound(m, n, log_n)
        log(f"[ntt-main] {count}x B7 (m={m}, n=2^{log_n}): "
            f"{t['graph_ms']:.5f} ms from a CUDA graph, "
            f"{t['profiler_ms']:.5f} ms by the profiler (bound {bd:.5f} ms "
            f"by {by})")
        r.update({f"{k}_{key}": v for k, v in t.items()})
        r[f"bound_ms_{key}"] = bd
    results["ntt"]["mismatches"] += bad
    if bad:
        raise AssertionError(f"NTT mismatches at the main path's shapes: "
                             f"{bad}")


def mxu_pass_bound(m, n, ps):
    """One K1 pass of a four-step transform of m columns of n: every
    element read and written once, its stages' twiddles read once (32
    bytes each), the packed diagonal table where the pass takes it; 96
    multiply-adds of reduction a butterfly of its stages, a Montgomery
    product an element for the diagonal (the tensor-core digit products
    not counted)."""
    from halo2_tpu_torch.ops.mxu_field import REDC_MULADDS
    tw = sum(1 << (ps.a + s - 1) for s in range(1, ps.cnt + 1)) * 32
    return bound_ms(2 * m * n * 64 + tw + (n * 32 if ps.diag else 0),
                    m * (n // 2) * ps.cnt * REDC_MULADDS
                    + (m * n * MONT_MULADDS if ps.diag else 0))


def mxu_transform_bound(m, n):
    """A four-step transform in K1's passes: the sum of its pass bounds
    (each pass moves every element once)."""
    from halo2_tpu_torch.ops import mxu_field as mxu
    bounds = [mxu_pass_bound(m, n, ps) for ps in mxu.four_step_passes(m, n)]
    return sum(b for b, _ in bounds), max(bounds)[1]


def mxu_pass_calls(df, m, n, plan):
    """K1's passes of a four-step transform of m columns of n, each alone
    on scratch buffers of the transform's shape: [(pass, a function
    running it, a function running its stages' digit products alone as
    float32 torch.bmm of [half, lanes, 32] @ [half, 32, 63] a stage)]."""
    import torch
    from halo2_tpu_torch.ops import mxu_field as mxu
    src = rand_field(df, m * n, 71, "cuda").view(m, n, 16)
    out = []
    for ps in mxu.four_step_passes(m, n):
        N, L = 1 << ps.log_n, ps.lanes
        a8 = torch.rand((N // 2) * L * 32, device="cuda")
        p8 = torch.empty((N // 2) * L * 63, device="cuda")
        mats = []
        for s in range(ps.a + 1, ps.a + ps.cnt + 1):
            half = 1 << (s - 1)
            lanes = (N >> s) * L
            mats.append((a8.view(half, lanes, 32),
                         torch.rand(half, 32, 63, device="cuda"),
                         p8.view(half, lanes, 63)))

        def run(ps=ps):
            mxu.run_passes(df, src, plan, (ps,))

        def bmm(mats=mats):
            for a, w, o in mats:
                torch.bmm(a, w, out=o)
        out.append((ps, run, bmm))
    return out


def phase_mxu(results):
    """[mxu] K1 (csrc/mxu_kernels.cu) against its plain version, bit for
    bit: products by 5 constants (p - 1, p - 2, 0, 1 and 2^254 - 1, whose
    8-bit digits are 0xFF but the top one) at 1, 15, 16, 17 and 2^12
    lanes a group, both fields; the four-step (ops/mxu_field.py::
    ntt_mxu_b, K1's passes) against B7 at n = 2^16, 2^17 and 2^20 with 1
    and 4 columns, forward and inverse, both fields, and against the
    plain four-step at 2^10 and 2^16, in the launches of the pass plan
    with no B1 launch and, by the profiler, no kernel but K1's. Times on
    the PALLAS scalar field, from CUDA graphs: each pass alone beside its
    bound, the four-step a transform beside B7's and beside the sum of
    its pass bounds, and each pass's digit products alone as float32
    torch.bmm with TF32 off (the yardstick)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV, ints_to_digits
    from halo2_tpu_torch.ops import field_kernels as fk
    from halo2_tpu_torch.ops import mxu_field as mxu
    from halo2_tpu_torch.ops import ntt
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    r = results["mxu"]
    mism, err = 0, 0
    for df in (FP_DEV, FQ_DEV):
        p = df.spec.modulus
        edge = [p - 1, p - 2, 0, 1, (1 << 254) - 1]
        consts = torch.from_numpy(ints_to_digits(
            [v * (1 << 256) % p for v in edge[:4]] + [edge[4]])).to(dev)
        for lanes in (1, 15, 16, 17, 1 << 12):
            x = rand_field(df, 5 * lanes, lanes, dev).view(5, lanes, 16)
            x[:, :1] = consts[4]                  # 0xFF bytes
            got = mxu.mul_const_grouped(df, x, consts)
            want = mxu.mul_const_grouped_plain(df, x, consts)
            bad = int((got != want).any(dim=-1).sum())
            mism += bad
            err = max(err, max_abs(got, want))
            if bad:
                log(f"[mxu] K1 field {df.field_id}, {lanes} lanes a group: "
                    f"{bad} mismatches")
        for log_n in (10, 16, 17, 20):
            n = 1 << log_n
            omega = pow(df.spec.root_of_unity, 1 << (df.spec.s - log_n), p)
            for w in (omega, pow(omega, p - 2, p)):
                plan = ntt.make_plan(df, n, w)
                for m in (1, 4):
                    x = rand_field(df, m * n, log_n + m, dev).view(m, n, 16)
                    mxu.ntt_mxu_b(df, x, plan)     # the plan's tables made
                    before, b1 = mxu.LAUNCHES["mxu"], fk.LAUNCHES["fmul"]
                    got = mxu.ntt_mxu_b(df, x, plan)
                    launched = mxu.LAUNCHES["mxu"] - before
                    if (launched != len(mxu.four_step_passes(m, n))
                            or launched > 4 or fk.LAUNCHES["fmul"] != b1):
                        raise AssertionError(
                            f"[mxu] {launched} K1 and "
                            f"{fk.LAUNCHES['fmul'] - b1} B1 launches for a "
                            f"transform of 2^{log_n}")
                    wants = [ntt.ntt_many(df, x, plan)] if log_n > 10 else []
                    if log_n <= 16 and m == 1:
                        wants.append(mxu.ntt_mxu_b_plain(df, x, plan))
                    for want in wants:
                        bad = int((got != want).any(dim=-1).sum())
                        mism += bad
                        err = max(err, max_abs(got, want))
                        if bad:
                            log(f"[mxu] four-step n=2^{log_n} m={m} field "
                                f"{df.field_id}: {bad} mismatches")
                    del got, wants, x
    r.update(mismatches=mism, max_abs_err=err)
    log(f"[mxu] K1 and the four-step: mismatches {mism}, max abs error "
        f"{err} (K1's products at 1, 15, 16, 17 and 4,096 lanes a group; "
        f"the four-step in its passes against B7 at 2^16, 2^17, 2^20 and "
        f"against the plain four-step at 2^10 and 2^16; no B1 launch)")
    if mism:
        raise AssertionError(f"[mxu] K1 mismatches: {mism}")
    df = FQ_DEV
    p = df.spec.modulus
    for log_n in (16, 17, 20):
        n = 1 << log_n
        plan = ntt.make_plan(df, n, pow(df.spec.root_of_unity,
                                        1 << (df.spec.s - log_n), p))
        for m in (1, 4):
            x = rand_field(df, m * n, 90 + log_n, dev).view(m, n, 16)
            four = graph_ms(lambda: mxu.ntt_mxu_b(df, x, plan), 10)
            b7 = graph_ms(lambda: ntt.ntt_many(df, x, plan), 10)
            passes = []
            for ps, run, bmm in mxu_pass_calls(df, m, n, plan):
                bd, by = mxu_pass_bound(m, n, ps)
                passes.append({"axis": ps.axis, "a": ps.a, "cnt": ps.cnt,
                               "ms": graph_ms(run, 10),
                               "library_ms": graph_ms(bmm, 10),
                               "bound_ms": bd, "bound_by": by})
            tb, tby = mxu_transform_bound(m, n)
            lib = sum(q["library_ms"] for q in passes)
            key = f"n{log_n}_m{m}"
            k1 = sum(q["ms"] for q in passes) / len(passes)
            r.update({f"ms_{key}": k1, f"four_step_ms_{key}": four,
                      f"b7_ms_{key}": b7, f"bound_ms_{key}": tb,
                      f"library_ms_{key}": lib, f"passes_{key}": passes})
            log(f"[mxu] n=2^{log_n} m={m}: four-step {four:.5f} ms a "
                f"transform in {len(passes)} K1 launches (bound {tb:.5f} ms "
                f"by {tby}, {100 * tb / four:.0f}%), B7 {b7:.5f} ms; "
                f"float32 bmm of the transform's digit products "
                f"{lib:.5f} ms; passes " + "; ".join(
                    f"axis {q['axis']} stages {q['a'] + 1}-"
                    f"{q['a'] + q['cnt']} {q['ms']:.5f} ms (bound "
                    f"{q['bound_ms']:.5f}, {100 * q['bound_ms'] / q['ms']:.0f}"
                    f"%; bmm {q['library_ms']:.5f})" for q in passes))
            if (log_n, m) == (16, 1):
                # no kernel but K1's inside a transform
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    mxu.ntt_mxu_b(df, x, plan)
                    torch.cuda.synchronize()
                names = {ev.key for ev in prof.key_averages()
                         if ev.device_type == DeviceType.CUDA}
                log(f"[mxu] kernels a transform by the profiler: {names}")
                if not names or any("mxu_pass" not in k for k in names):
                    raise AssertionError(f"[mxu] ntt_mxu_b ran {names}")
                xs = x.clone()
                t = time.perf_counter()
                mxu.ntt_mxu_b_plain(df, xs, plan)
                torch.cuda.synchronize()
                pms = (time.perf_counter() - t) * 1e3 / len(passes)
                r.update(ms=k1, call_ms=timed(
                    lambda: mxu.ntt_mxu_b(df, x, plan), 10) / len(passes),
                    plain_ms=pms, bound_ms=sum(
                        q["bound_ms"] for q in passes) / len(passes),
                    bound_by=passes[0]["bound_by"],
                    library_ms=lib / len(passes), shape=[1, n, 16],
                    kernels_a_transform=sorted(names))
                log(f"[mxu] n=2^16 m=1: the plain four-step {pms:.3f} ms a "
                    f"pass's share")
            del x


def phase_layout(results):
    """B8 (limbs-first [16, N]) beside B1 (element-major [N, 16]) on the
    same elements at N = 2^12 .. 2^20: both against the plain version,
    device time per launch against the same byte bound (two operands read
    and one result written, 192 B per element)."""
    import torch
    from halo2_tpu_torch.fields.device import FQ_DEV
    from halo2_tpu_torch.ops import field_kernels as fk
    dev = torch.device("cuda")
    df = FQ_DEV
    r = results["fmul_limbs_first"]
    mism, err = 0, 0
    for log_n in (12, 14, 16, 18, 20):
        N = 1 << log_n
        a = rand_field(df, N, 2 * log_n, dev)
        b = rand_field(df, N, 2 * log_n + 1, dev)
        a_t, b_t = a.T.contiguous(), b.T.contiguous()
        want = fk.fmul_plain(df, a, b)
        got_t = fk.fmul_limbs_first(df, a_t, b_t)
        got = fk.fmul(df, a, b)
        bad = (int((got_t.T != want).any(dim=-1).sum())
               + int((got != want).any(dim=-1).sum()))
        mism += bad
        err = max(err, max_abs(got_t.T, want), max_abs(got, want))
        ms_lf = device_ms(lambda: fk.fmul_limbs_first(df, a_t, b_t), 100,
                          "fmul_limbs_first_kernel")
        ms_em = device_ms(lambda: fk.fmul(df, a, b), 100, "fmul_kernel<")
        bd, by = bound_ms(N * 192, N * MONT_MULADDS)
        log(f"[layout] N=2^{log_n}: limbs-first (B8) {ms_lf:.5f} ms, "
            f"element-major (B1) {ms_em:.5f} ms on the device, "
            f"ratio {ms_lf / ms_em:.3f} (bound {bd:.5f} ms by {by}); "
            f"mismatches {bad}")
        r[f"ms_N{log_n}"], r[f"b1_ms_N{log_n}"] = ms_lf, ms_em
        r[f"bound_ms_N{log_n}"] = bd
        if log_n == 20:
            call_ms = timed(lambda: fk.fmul_limbs_first(df, a_t, b_t), 50)
            pms = timed(lambda: fk.fmul_limbs_first_plain(df, a_t, b_t), 2)
            r.update(ms=ms_lf, call_ms=call_ms, plain_ms=pms, bound_ms=bd,
                     bound_by=by, shape=[16, N])
    r.update(mismatches=mism, max_abs_err=err, launches=0)
    if mism:
        raise AssertionError(f"B8/B1 layout mismatches: {mism}")


def _lookup_run(tag, params, circuit, instances, seed, curve,
                ref_hash=None, golden=None, profile=False, widths=None):
    """keygen, a cold and a warm prove (equal bytes), verify, a corrupted
    proof rejected, the proof's sha256 against `ref_hash` or the golden
    file's; returns (vk, proof). With `widths` (an OffsetWidths), the warm
    prove runs inside it."""
    import torch
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                VerificationError)
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead
    t = time.perf_counter()
    vk = keygen_vk(params, circuit)
    pk_ = keygen_pk(params, vk, circuit)
    torch.cuda.synchronize()
    log(f"[lookup] {tag}: keygen {time.perf_counter() - t:.2f}s, "
        f"extended k {vk.domain.extended_k}")

    def prove():
        tw = TranscriptWrite(curve)
        pv.create_proof(params, pk_, [circuit] * len(instances), instances,
                        random.Random(seed), tw)
        return tw.finalize()

    proofs = []
    for label in ("cold", "warm"):
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        if label == "warm" and widths is not None:
            with widths:
                proofs.append(prove())
        else:
            proofs.append(prove())
        torch.cuda.synchronize()
        log(f"[lookup] {tag}: create_proof {label} "
            f"{time.perf_counter() - t:.3f}s, {len(proofs[-1])} bytes, "
            f"launches {diff_counts(before)}")
    log(f"[lookup] {tag}: warm phases " + json.dumps(
        {name: round(sec, 4) for name, sec in pv.LAST_PHASES}))
    t = time.perf_counter()
    verify_proof(params, vk, SingleVerifier(params), instances,
                 TranscriptRead(curve, proofs[1]))
    log(f"[lookup] {tag}: verify_proof {time.perf_counter() - t:.3f}s "
        f"(accepted)")
    bad = bytearray(proofs[1])
    bad[-64] ^= 1                      # the IPA's scalar c, off by one
    try:
        verify_proof(params, vk, SingleVerifier(params), instances,
                     TranscriptRead(curve, bytes(bad)))
    except VerificationError:
        log(f"[lookup] {tag}: corrupted proof rejected")
    else:
        raise AssertionError(f"{tag}: a corrupted proof was accepted")
    digest = hashlib.sha256(proofs[1]).hexdigest()
    want = ref_hash or hashlib.sha256(golden).hexdigest()
    log(f"[lookup] {tag}: proof sha256 {digest}")
    if proofs[0] != proofs[1] or digest != want:
        raise AssertionError(f"{tag}: proof hash {digest} != reference "
                             f"{want}")
    log(f"[lookup] {tag}: proof bytes equal the JAX reference's")
    if profile:
        profile_call("lookup", prove)
    return vk, proofs[1]


def phase_lookup(results, params_k, params_ref_k):
    """The lookup path: dev_lookup at k = K and REF_K, then plonk_api at
    K = 5 with two instances. Counts start at 0 just before and are read
    just after; every kernel of the path must have launched."""
    import os
    import torch
    from halo2_tpu_torch.bench_circuit import (DevLookupCircuit, PROOF_SEED,
                                               plonk_api_circuit_class,
                                               plonk_api_inputs, PLONK_API_K,
                                               PLONK_API_SEED)
    from halo2_tpu_torch.circuit import Circuit, Value
    from halo2_tpu_torch.curves.host import PALLAS, VESTA
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                VerificationError)
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.poly.polynomial import Rotation
    from halo2_tpu_torch.transcript import TranscriptRead
    reset_counts()
    widths = OffsetWidths()
    for k, params in ((K, params_k), (REF_K, params_ref_k)):
        _lookup_run(f"dev_lookup k={k}", params, DevLookupCircuit(), [[]],
                    PROOF_SEED, PALLAS,
                    ref_hash=REF_SHA256["dev-lookup", k], profile=True,
                    widths=widths if k == REF_K else None)
    launches = launch_counts()
    log(f"[lookup] launches over the dev_lookup proves {launches}")
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the lookup path not launched: "
                             f"{idle}")
    results["ntt"]["lookup_launches"] = launches["ntt"]

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    with open(os.path.join(golden, "plonk_api_tpu_proof.bin"), "rb") as fh:
        tpu_golden = fh.read()
    with open(os.path.join(golden, "plonk_api_proof.bin"), "rb") as fh:
        zcash_proof = fh.read()
    fs = VESTA.scalar
    cls = plonk_api_circuit_class(Circuit, Value, Rotation, fs)
    a, instance, table = plonk_api_inputs(fs)
    params = Params.new(VESTA, PLONK_API_K)
    vk, _ = _lookup_run("plonk_api K=5", params, cls(a, table),
                        [[[instance]], [[instance]]], PLONK_API_SEED, VESTA,
                        golden=tpu_golden)
    verify_proof(params, vk, SingleVerifier(params),
                 [[[instance]], [[instance]]],
                 TranscriptRead(VESTA, zcash_proof))
    try:
        verify_proof(params, vk, SingleVerifier(params),
                     [[[instance]], [[instance + 1]]],
                     TranscriptRead(VESTA, zcash_proof))
    except VerificationError:
        pass
    else:
        raise AssertionError("plonk_api: a wrong instance was accepted")
    torch.cuda.synchronize()
    log("[lookup] plonk_api: zcash/halo2's proof verifies, a wrong "
        "instance is rejected")
    return widths.seen


def _ladder_inputs(df, pts, L, gen, edge=True):
    """[48, L] projective points with Z != 1 (B4 sums of two random picks
    from pts) with identity lanes, and [L, 16] random 256-bit scalars
    whose first rows are 0, 1, q - 1 and 2^256 - 1 (q: the order of the
    points' group)."""
    import torch
    from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV, ints_to_digits
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = pts.device
    pick = torch.randint(pts.shape[1], (2, L), generator=gen, device=dev)
    g = pk.padd_flat(df, pts[:, pick[0]], pts[:, pick[1]])
    g[:, 5:L:97] = pk.ident_col(df, dev)[:, None]
    digits = torch.randint(0, 1 << 16, (L, 16), generator=gen, device=dev,
                           dtype=torch.int32)
    if edge:
        q = (FQ_DEV if df is FP_DEV else FP_DEV).spec.modulus
        digits[:4] = torch.from_numpy(ints_to_digits(
            [0, 1, q - 1, (1 << 256) - 1])).to(dev)
    return g, digits


def ladder_work(digits, nbits, L, fused):
    """(bytes, multiply-adds) the ladder needs on these inputs: each lane's
    point read and result written (and lo read and a second result written
    when fused), the scalar table read once; 8 products a doubling, 12 an
    add for each set bit this data has, 24 for the fused butterfly."""
    import torch
    from halo2_tpu_torch.ops import point_kernels as pk
    lanes = digits[torch.arange(L, device=digits.device) % digits.shape[0]]
    adds = int(pk.scalar_bits(lanes, nbits).sum())
    nbytes = L * (4 if fused else 2) * 192 + digits.shape[0] * 64
    prods = L * 8 * nbits + 12 * adds + (24 * L if fused else 0)
    return nbytes, prods * MONT_MULADDS


def phase_scalar_ladder(results, params, lanes=(1 << 13, 1 << 17)):
    """[scalar-ladder] The per-lane scalar-multiplication ladder, on both
    fields: against its plain version at 256 lanes (256 bits, one scalar
    a lane; 255 bits, a 16-row table read by lane % 16 with the fused
    butterfly), and against the B5/B4/torch.where loop at 2^13 lanes (one
    scalar a lane) and 2^17 lanes (a table of 2^16 rows with the fused
    butterfly, whose loop ends with B4 on lo + t and lo - t), with edge
    scalars and identity lanes. Then on the base field of the PALLAS
    Params, at the shapes the srs path gives it: the group-NTT stages of
    k=14 and k=18 (2^13 and 2^17 lanes, 255 bits, a table of half the
    lanes, fused) against the plain version, with device time from a CUDA
    graph and by the profiler beside the bound, the wrapper's time, the
    loop's time and the plain version's; and the 1/n scale of k=14 (2^14
    lanes, 255 bits, a table of one row) against the plain version and
    the loop."""
    import torch
    from halo2_tpu_torch.curves.device import pneg
    from halo2_tpu_torch.curves.host import VESTA
    from halo2_tpu_torch.curves.native import native_srs_g
    from halo2_tpu_torch.fields.device import FQ_DEV, ints_to_digits
    from halo2_tpu_torch.ops import point_kernels as pk
    dev = params.device
    gen = torch.Generator(device=dev).manual_seed(17)
    vesta = pk.points_to_proj(FQ_DEV, native_srs_g(
        VESTA, "chip-smoke-scalar-ladder", 1024), dev)
    loop_ladder = pk.scalar_mul_ladder_loop
    mism, err = 0, 0

    def check(tag, got, want):
        nonlocal mism, err
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        bad = sum(int((g != w).any(dim=0).sum()) for g, w in zip(got, want))
        mism += bad
        err = max([err] + [max_abs(g, w) for g, w in zip(got, want)])
        log(f"[scalar-ladder] {tag}: {bad} mismatches")

    def plain_timed(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pk.scalar_mul_ladder_plain(*args, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    for df, src in ((params.base_df, params.g_dev), (FQ_DEV, vesta)):
        f = df.field_id
        pts, digits = _ladder_inputs(df, src, 256, gen)
        lo, _ = _ladder_inputs(df, src, 256, gen, edge=False)
        check(f"field {f} L=256 256 bits, against the plain version",
              pk.scalar_mul_ladder_flat(df, pts, digits, 256),
              pk.scalar_mul_ladder_plain(df, pts, digits, 256))
        check(f"field {f} L=256 255 bits, table of 16, fused, against the "
              f"plain version",
              pk.scalar_mul_ladder_flat(df, pts, digits[:16], 255, lo=lo),
              pk.scalar_mul_ladder_plain(df, pts, digits[:16], 255, lo=lo))
        L = lanes[0]
        pts, digits = _ladder_inputs(df, src, L, gen)
        check(f"field {f} L={L} 256 bits, against the B5/B4/where loop",
              pk.scalar_mul_ladder_flat(df, pts, digits, 256),
              loop_ladder(df, pts, digits, 256))
        L = lanes[1]
        pts, digits = _ladder_inputs(df, src, L, gen)
        lo, _ = _ladder_inputs(df, src, L, gen, edge=False)
        table = digits[:L // 2]
        full = table[torch.arange(L, device=dev) % (L // 2)]
        t = loop_ladder(df, pts, full, 255)
        check(f"field {f} L={L} 255 bits, table of {L // 2}, fused, "
              f"against the B5/B4/where loop and B4",
              pk.scalar_mul_ladder_flat(df, pts, table, 255, lo=lo),
              (pk.padd_flat(df, lo, t), pk.padd_flat(df, lo, pneg(df, t))))
    torch.cuda.synchronize()
    r = results["scalar_mul_ladder"]
    df = params.base_df
    for L in lanes:
        pts, digits = _ladder_inputs(df, params.g_dev, L, gen, edge=False)
        lo, _ = _ladder_inputs(df, params.g_dev, L, gen, edge=False)
        table = digits[:L // 2]
        full = table[torch.arange(L, device=dev) % (L // 2)]
        ident = pk.ident_col(df, dev)[:, None].expand(48, L).contiguous()
        fn = lambda: pk.scalar_mul_ladder_flat(df, pts, table, 255, lo=lo)
        loop = lambda: (lambda t: (pk.padd_flat(df, lo, t), pk.padd_flat(
            df, lo, pneg(df, t))))(loop_ladder(df, pts, full, 255, ident))
        ms = device_ms(fn, 3, "scalar_mul_ladder_kernel")
        g_ms = graph_ms(fn, 3)
        call_ms = timed(fn, 3)
        loop_ms = timed(loop, 1)
        loop_dev = graph_ms(loop, 1)
        plain, pms = plain_timed(df, pts, table, 255, lo=lo)
        check(f"field {df.field_id} L={L} 255 bits, table of {L // 2}, "
              f"fused (a group-NTT stage), against the plain version",
              fn(), plain)
        del plain
        nbytes, muladds = ladder_work(table, 255, L, fused=True)
        bd, by = bound_ms(nbytes, muladds)
        log(f"[scalar-ladder] L={L} (a group-NTT stage, 255 bits, fused): "
            f"{g_ms:.5f} ms from a CUDA graph, {ms:.5f} ms by the profiler,"
            f" {call_ms:.4f} ms per wrapper call (bound {bd:.5f} ms by "
            f"{by}); the B5/B4/where loop and two B4 {loop_dev:.5f} ms "
            f"replayed from a CUDA graph, {loop_ms:.4f} ms per call with "
            f"its {2 * 255 + 3} launches; plain {pms:.3f} ms")
        r.update({f"ms_L{L}": g_ms, f"profiler_ms_L{L}": ms,
                  f"bound_ms_L{L}": bd, f"call_ms_L{L}": call_ms,
                  f"call_ms_loop_L{L}": loop_ms, f"ms_loop_L{L}": loop_dev,
                  f"plain_ms_L{L}": pms})
        if L == lanes[0]:
            r.update(ms=g_ms, call_ms=call_ms, plain_ms=pms, bound_ms=bd,
                     bound_by=by, shape=[48, L])
    # the 1/n scale of Params.new at k=14: every lane by one scalar
    L, q = 1 << K, params.scalar_df.spec.modulus
    pts, _ = _ladder_inputs(df, params.g_dev, L, gen, edge=False)
    scale = torch.from_numpy(ints_to_digits([pow(L, q - 2, q)])).to(dev)
    got = pk.scalar_mul_ladder_flat(df, pts, scale, 255)
    plain, pms = plain_timed(df, pts, scale, 255)
    tag = f"field {df.field_id} L={L} 255 bits, one scalar (the 1/n scale)"
    check(f"{tag}, against the plain version ({pms:.3f} ms)", got, plain)
    check(f"{tag}, against the B5/B4/where loop", got,
          loop_ladder(df, pts, scale.expand(L, -1), 255))
    r.update(mismatches=mism, max_abs_err=err)
    log(f"[scalar-ladder] mismatches {mism}")
    if mism:
        raise AssertionError(f"scalar_mul_ladder mismatches: {mism}")


def phase_srs(results, ks=(K, REF_K)):
    """[srs] Params.new(PALLAS, k, use_cache=False) on the card at k=14 and
    k=REF_K, counts set to 0 just before each and read just after: g from
    the native library, g_lagrange by the device group iNTT (the scalar
    ladder, one launch a stage and one for the 1/n scale). At k=14 its
    write() bytes must equal those of the same Params with g_lagrange
    from the native library's group iNTT (the route before, the oracle
    here), timed; at k=REF_K, where that iNTT takes minutes on the host,
    their sha256 must equal the JAX reference's (REF_PARAMS_SHA256). The
    native library's g and the device group iNTT timed apart."""
    import copy
    import torch
    from halo2_tpu_torch.curves import native
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.curves.device import batch_scalar_mul
    from halo2_tpu_torch.fields.device import ints_to_digits
    from halo2_tpu_torch.ops.ntt import group_ntt, make_plan
    from halo2_tpu_torch.ops.point_kernels import points_to_proj
    from halo2_tpu_torch.poly.commitment import Params
    fs = PALLAS.scalar
    r = results["scalar_mul_ladder"]
    for k in ks:
        n = 1 << k
        reset_counts()                    # the srs path's count starts
        torch.cuda.synchronize()
        t = time.perf_counter()
        params = Params.new(PALLAS, k, use_cache=False)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        launches = launch_counts()
        omega = pow(fs.root_of_unity, 1 << (fs.s - k), fs.modulus)
        omega_inv = pow(omega, fs.modulus - 2, fs.modulus)
        minv = pow(n, fs.modulus - 2, fs.modulus)
        native_gl, t_native = None, None
        if k not in REF_PARAMS_SHA256:
            t = time.perf_counter()
            native_gl = native.native_group_ntt(PALLAS, params.g, omega_inv,
                                                minv)
            t_native = time.perf_counter() - t
        t = time.perf_counter()
        native.native_srs_g(PALLAS, "Halo2-Parameters", n)
        t_g = time.perf_counter() - t
        # the host work around the transform: the plan's tables made and
        # uploaded (with the twiddles taken out of Montgomery form), and
        # g's upload as a [48, n] batch
        t = time.perf_counter()
        plan = make_plan(params.scalar_df, n, omega_inv)
        plan.on(params.device)
        plan.exponents(params.device)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t
        t = time.perf_counter()
        points_to_proj(params.base_df, params.g, params.device)
        torch.cuda.synchronize()
        t_proj = time.perf_counter() - t
        # the transform alone: group NTT and scale on the card, from the
        # device copy of g, its plan's tables made and uploaded before
        scale = torch.from_numpy(ints_to_digits([minv])).to(params.device)
        transform = lambda: batch_scalar_mul(
            params.base_df, group_ntt(params.base_df, params.g_dev, plan),
            scale, nbits=255)
        torch.cuda.synchronize()
        t = time.perf_counter()
        transform()
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t
        kern_dev = device_ms(transform, 1, "scalar_mul_ladder_kernel",
                             per_call=True) / 1e3
        if native_gl is None:
            got = hashlib.sha256(params.write()).hexdigest()
            same = got == REF_PARAMS_SHA256[k]
            oracle = f"the JAX reference's sha256 {REF_PARAMS_SHA256[k]}"
        else:
            oracle = copy.copy(params)
            oracle.g_lagrange = native_gl
            same = oracle.write() == params.write()
            oracle = "the native g_lagrange's"
        log(f"[srs] k={k}: Params.new(use_cache=False) {total:.3f}s; "
            f"launches {launches}")
        native_s = ("not run" if t_native is None else f"{t_native:.3f}s")
        log(f"[srs] k={k}: native_srs_g {t_g:.3f}s, native_group_ntt "
            f"{native_s}, device group iNTT and 1/n scale "
            f"{t_dev:.3f}s ({launches['scalar_mul_ladder']} ladder "
            f"launches, {kern_dev:.4f}s of ladder device time by the "
            f"profiler); the plan's tables {t_plan:.3f}s, g's upload "
            f"{t_proj:.3f}s; write() bytes equal {oracle}: {same}")
        if not same:
            raise AssertionError(f"k={k}: the device g_lagrange differs from "
                                 f"{oracle}")
        if launches["scalar_mul_ladder"] != k + 1:
            raise AssertionError(f"k={k}: {launches['scalar_mul_ladder']} "
                                 f"ladder launches, want {k + 1}")
        for name in ("scalar_mul_ladder", "padd", "pdouble", "fmul"):
            results[name][f"srs_launches_k{k}"] = launches[name]
        r.update({f"srs_params_new_s_k{k}": total,
                  f"srs_native_srs_g_s_k{k}": t_g,
                  f"srs_native_group_ntt_s_k{k}": t_native,
                  f"srs_device_group_intt_s_k{k}": t_dev,
                  f"srs_ladder_device_s_k{k}": kern_dev,
                  f"srs_plan_s_k{k}": t_plan, f"srs_g_upload_s_k{k}": t_proj})
        if k == ks[0]:
            r["launches"] = launches["scalar_mul_ladder"]
        del params, oracle, native_gl


def phase_verify(results, params, pk_, circuit, out):
    """[verify] The verification strategies on two k=14 BenchCircuit proofs
    (the main path's and one from another rng seed): AccumulatorStrategy,
    whose G (Guard.compute_g, a device MSM over the SRS g) must equal the
    native host MSM; BatchVerifier, True for the pair and False with one
    proof corrupted or one wrong instance; MSMAccumulator.eval's device
    branch (taken without the native library above 4096 terms) against
    the host one on a valid proof and a wrong instance. Counts set to 0
    just before and read just after."""
    import torch
    from halo2_tpu_torch.curves import native
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.verifier import (verify_proof,
                                                AccumulatorStrategy,
                                                BatchVerifier)
    from halo2_tpu_torch.poly.commitment import compute_s
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    vk = pk_.vk
    proofs = []
    for seed in (PROOF_SEED, 7):
        tw = TranscriptWrite(PALLAS)
        pv.create_proof(params, pk_, [circuit], [[[out]]],
                        random.Random(seed), tw)
        proofs.append(tw.finalize())
    reset_counts()                        # the verify path's count starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    acc = verify_proof(params, vk, AccumulatorStrategy(params), [[[out]]],
                       TranscriptRead(PALLAS, proofs[0]))
    torch.cuda.synchronize()
    t_acc = time.perf_counter() - t
    t = time.perf_counter()
    want = PALLAS.msm(compute_s(PALLAS.scalar, acc.u_packed, 1), params.g)
    t_host = time.perf_counter() - t
    log(f"[verify] AccumulatorStrategy {t_acc:.3f}s; its G (device MSM "
        f"over 2^{K} SRS points) equals the native MSM ({t_host:.3f}s): "
        f"{acc.g == want}")
    if acc.g != want:
        raise AssertionError("compute_g on the card != the native MSM")

    def batch(ps, outs):
        bv = BatchVerifier(params)
        for p, o in zip(ps, outs):
            bv.add_proof([[[o]]], p)
        return bv.finalize(vk)

    bad = bytearray(proofs[1])
    bad[-32] ^= 1                         # the IPA's f, still canonical
    verdicts = (batch(proofs, [out, out]), batch([proofs[0], bytes(bad)],
                                                 [out, out]),
                batch(proofs, [out, out + 1]))
    log(f"[verify] BatchVerifier: the pair {verdicts[0]}, with a corrupted "
        f"proof {verdicts[1]}, with a wrong instance {verdicts[2]}")
    if verdicts != (True, False, False):
        raise AssertionError(f"BatchVerifier verdicts {verdicts}")

    class Keep:
        def process(self, f):
            self.msm = f(params.empty_msm()).use_challenges()

    for o, valid in ((out, True), (out + 1, False)):
        keep = Keep()
        verify_proof(params, vk, keep, [[[o]]],
                     TranscriptRead(PALLAS, proofs[0]))
        host = keep.msm.clone().eval()
        real = native._load
        native._load = lambda: None        # the branch without the library
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            on_card = keep.msm.clone().eval()
            torch.cuda.synchronize()
            t_dev = time.perf_counter() - t
        finally:
            native._load = real
        what = "valid proof" if valid else "wrong instance"
        log(f"[verify] MSMAccumulator.eval, {what}: host {host}, device "
            f"branch {on_card} ({t_dev:.3f}s)")
        if host is not valid or on_card is not valid:
            raise AssertionError(f"eval verdicts host {host}, device "
                                 f"{on_card}, want {valid}")
    launches = launch_counts()
    log(f"[verify] launches {launches}")
    for name in ("pmixed_bucket_runs", "padd_masked", "fmul"):
        results[name]["verify_launches"] = launches[name]
    if not launches["pmixed_bucket_runs"]:
        raise AssertionError("no device MSM ran on the verify path")

class v1_timer:
    """Within the block, the host time of the V1 floor planner: each
    synthesize_v1 call (measurement pass, first fit and assignment pass;
    or the assignment pass alone when a plan is replayed) and each
    slot_in_biggest_advice_first call (the first fit alone), in seconds
    (a measurement hook around circuit/floor_planner_v1.py)."""

    def __enter__(self):
        from halo2_tpu_torch.circuit import floor_planner_v1 as v1
        self.synth, self.slot_in = [], []
        self.orig = (v1.synthesize_v1, v1.slot_in_biggest_advice_first)

        def hook(fn, into, label):
            def timed_call(*args, **kw):
                t = time.perf_counter()
                ret = fn(*args, **kw)
                into.append((label(kw), time.perf_counter() - t))
                return ret
            return timed_call

        v1.synthesize_v1 = hook(
            self.orig[0], self.synth,
            lambda kw: "replay" if kw.get("plan") is not None else "plan")
        v1.slot_in_biggest_advice_first = hook(self.orig[1], self.slot_in,
                                               lambda kw: "first fit")
        return self

    def __exit__(self, *exc):
        from halo2_tpu_torch.circuit import floor_planner_v1 as v1
        v1.synthesize_v1, v1.slot_in_biggest_advice_first = self.orig
        return False

    def take(self) -> str:
        text = ", ".join(f"{label} {sec:.2f}s"
                         for label, sec in self.synth + self.slot_in)
        self.synth.clear()
        self.slot_in.clear()
        return text or "none"


def phase_v1(results, params):
    """[v1] BenchCircuit at k=14 laid out by the V1 floor planner: keygen,
    a cold prove (which plans the layout again) and a warm one (which
    replays pk._synth_plan['v1']), verify, a wrong public input rejected,
    and the proof's sha256 against the JAX reference's. V1's planning is
    host time and is printed on lines of its own. Counts set to 0 just
    before and read just after; every kernel of the main path must
    launch."""
    import torch
    from halo2_tpu_torch.bench_circuit import (bench_circuit_class,
                                               regions_for_k, expected_output,
                                               SEED_A, PROOF_SEED)
    from halo2_tpu_torch.circuit import Circuit, Value
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                VerificationError)
    from halo2_tpu_torch.poly.polynomial import Rotation
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead
    fs = PALLAS.scalar
    regions = regions_for_k(K)
    out = expected_output(fs, SEED_A, regions)
    circuit = bench_circuit_class(Circuit, Value, Rotation, fs, "v1")(
        SEED_A, regions)
    reset_counts()                        # the V1 path's count starts
    with v1_timer() as planner:
        t = time.perf_counter()
        vk = keygen_vk(params, circuit)
        pk_ = keygen_pk(params, vk, circuit)
        torch.cuda.synchronize()
        log(f"[v1] k={K} regions={regions}: keygen "
            f"{time.perf_counter() - t:.2f}s")
        log(f"[v1] host planning in keygen: {planner.take()}")
        proofs = []
        for label in ("cold", "warm"):
            before = launch_counts()
            tw = TranscriptWrite(PALLAS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            pv.create_proof(params, pk_, [circuit], [[[out]]],
                            random.Random(PROOF_SEED), tw)
            torch.cuda.synchronize()
            proofs.append(tw.finalize())
            log(f"[v1] create_proof {label}: "
                f"{time.perf_counter() - t:.3f}s, {len(proofs[-1])} bytes, "
                f"launches {diff_counts(before)}")
            log(f"[v1] host planning in the {label} prove: {planner.take()}")
            log(f"[v1] {label} phases " + json.dumps(
                {name: round(sec, 4) for name, sec in pv.LAST_PHASES}))
    launches = launch_counts()
    log(f"[v1] launches in keygen and the two proves {launches}")
    for name in MAIN_PATH_KERNELS:
        results[name]["v1_launches"] = launches[name]
    verify_proof(params, vk, SingleVerifier(params), [[[out]]],
                 TranscriptRead(PALLAS, proofs[1]))
    try:
        verify_proof(params, vk, SingleVerifier(params), [[[out + 1]]],
                     TranscriptRead(PALLAS, proofs[1]))
    except VerificationError:
        log("[v1] proof verified; a wrong public input rejected")
    else:
        raise AssertionError("[v1] a wrong public input was accepted")
    digest = hashlib.sha256(proofs[1]).hexdigest()
    log(f"[v1] proof sha256 {digest}")
    if proofs[0] != proofs[1] or digest != REF_SHA256["bench-v1", K]:
        raise AssertionError(f"V1 proof hash {digest} != JAX reference "
                             f"{REF_SHA256['bench-v1', K]}")
    log("[v1] proof bytes equal the JAX reference's")
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the V1 path not launched: {idle}")


def _failures(errors) -> list:
    """(kind, location) of each failure, for the log and the checks."""
    out = []
    for e in errors:
        where = getattr(e, "location", None)
        if where is None:
            col = getattr(e, "column", None)
            where = (f"{col.column_type}[{col.index}] row "
                     f"{getattr(e, 'row', '?')}"
                     if col is not None else "")
        out.append((type(e).__name__, str(where)))
    return out


def phase_mock(results):
    """[mock] MockProver on BenchCircuit at k=14 and k=REF_K and on
    dev_lookup at k=14: the host verify() and the gate check on the card
    (verify_vectorized, kernel B1 and the field add/subtract) both find
    nothing; then one advice cell is changed after run, and the card's
    gate failures must equal the host checker's gate stream, field by
    field (gate, constraint, location, cell values); a wrong instance
    gives the reference's failure kinds; at k=REF_K the card's per-row
    zero flags equal the plain versions' on the CPU, bit for bit. Counts
    set to 0 just before and read just after."""
    from halo2_tpu_torch.bench_circuit import (BenchCircuit, DevLookupCircuit,
                                               regions_for_k, expected_output,
                                               SEED_A)
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.dev import MockProver
    fs = PALLAS.scalar
    reset_counts()                        # the mock prover's count starts
    cases = []
    for k in (K, REF_K):
        regions = regions_for_k(k)
        cases.append((f"bench k={k}", k, BenchCircuit(SEED_A, regions),
                      [[expected_output(fs, SEED_A, regions)]], regions))
    cases.append((f"dev_lookup k={K}", K, DevLookupCircuit(), [], None))
    for tag, k, circuit, instance, regions in cases:
        t = time.perf_counter()
        prover = MockProver.run(k, circuit, instance)
        t_run = time.perf_counter() - t
        t = time.perf_counter()
        host = prover.verify()
        t_verify = time.perf_counter() - t
        before = launch_counts()
        log(f"[mock] {tag}: run {t_run:.3f}s, verify {t_verify:.3f}s, "
            f"{len(prover.cs.gates)} gates; failures {len(host)}")
        card = _gate_check(f"mock {tag}", prover)
        diff = diff_counts(before)
        log(f"[mock] {tag}: B1 {diff['fmul']} launches, add/subtract "
            f"{diff['faddsub']}")
        if host or card:
            raise AssertionError(f"[mock] {tag}: the satisfied witness "
                                 f"fails: {host[:3]} {card[:3]}")
        if k == REF_K:
            for name in ("fmul", "faddsub"):
                results[name]["mock_launches"] = diff[name]
            _flags_check(f"mock {tag}", prover)
            profile_call("mock", prover.verify_vectorized,
                         what=f"verify_vectorized at k={k}")
        # one advice cell changed at a fixed row after run (out of
        # dev_lookup's table, off BenchCircuit's gate and copy)
        row = 1001
        cells = prover.advice[0]
        cells[row] = (cells[row] + 1000) % fs.modulus
        t = time.perf_counter()
        host = prover.verify()
        log(f"[mock] {tag}: advice[0][{row}] changed: verify "
            f"{time.perf_counter() - t:.3f}s {_failures(host)}")
        card = _gate_check(f"mock {tag}", prover)
        if not host:
            raise AssertionError(f"[mock] {tag}: the changed cell broke "
                                 f"nothing on the host")
        if regions is not None and not card:
            raise AssertionError(f"[mock] {tag}: the changed cell broke no "
                                 f"gate on the card")
        if regions is not None and k == K:
            # a wrong instance: the reference's MockProver reports the
            # copy of the last output row and of instance row 0
            bad = MockProver.run(k, circuit,
                                 [[(instance[0][0] + 1) % fs.modulus]])
            kinds = _failures(bad.verify())
            want = [("PermutationFailure", f"advice[0] row {2 * regions - 1}"),
                    ("PermutationFailure", "instance[0] row 0")]
            log(f"[mock] {tag}: wrong instance: {kinds}; card "
                f"{_failures(bad.verify_vectorized())}")
            if kinds != want or bad.verify_vectorized():
                raise AssertionError(f"[mock] {tag}: wrong instance gives "
                                     f"{kinds}, want {want}")
        del prover
    launches = launch_counts()
    log(f"[mock] launches {launches}")
    if not launches["fmul"] or not launches["faddsub"]:
        raise AssertionError("the mock prover's gate check launched no B1 "
                             "or add/subtract kernel")


class field_launches:
    """Within the block, the arguments of every launch of the field
    kernels (B1, the add/subtract): a measurement hook around
    ops/field_kernels.py's _launch. `graph_ms()` replays the kernel calls
    alone from a CUDA graph: their device time without the host's gaps
    and without the operand copies and output allocation of _launch,
    which are made before the capture (the replay is not counted)."""

    def __enter__(self):
        from halo2_tpu_torch.ops import field_kernels as fk
        self.calls = []
        self.orig = orig = fk._launch

        def recording(*args):
            self.calls.append(args)
            return orig(*args)

        fk._launch = recording
        return self

    def __exit__(self, *exc):
        from halo2_tpu_torch.ops import field_kernels as fk
        fk._launch = self.orig
        return False

    def graph_ms(self, reps: int = 10) -> float:
        import math
        import torch
        from halo2_tpu_torch.ops import cuda_build
        from halo2_tpu_torch.ops import field_kernels as fk
        lib = cuda_build.library("field_kernels")
        kernels = []
        for fn_name, _, df, a, b, *extra in self.calls:
            batch = tuple(torch.broadcast_shapes(a.shape[:-1],
                                                 b.shape[:-1]))
            n = math.prod(batch)
            if n:
                out = torch.empty(batch + (fk.NLIMBS,), dtype=torch.int32,
                                  device=a.device)
                (a_, ap), (b_, bp) = fk._fit(a, batch), fk._fit(b, batch)
                kernels.append((getattr(lib, fn_name), df.field_id, extra,
                                out, a_, b_, n, ap, bp))

        def replay():
            for fn, fid, extra, out, a_, b_, n, ap, bp in kernels:
                cuda_build.check(fn(fid, *extra, out.data_ptr(),
                                    a_.data_ptr(), b_.data_ptr(), n, ap, bp,
                                    cuda_build.stream_ptr(out.device)),
                                 "field kernel replay")
        return graph_ms(replay, reps)

    def summary(self) -> str:
        return (f"{len(self.calls)} field-kernel launches, device time "
                f"{self.graph_ms():.4f} ms replayed from a CUDA graph")


class path_calls:
    """Within each `with` block, the first call of every kernel wrapper
    for each signature (its tensors' shapes and dtypes, its other
    arguments but B3's roll distance and live lanes, a value like its
    operands'), with
    the operands and the result cloned, so that
    `check()` can hold the kernels against their plain versions at the
    shapes a path gave them, on the path's own data. The wrappers are
    patched where the path's modules call them; each call launches as
    before, once. Given `slice_lanes`, a call wider than twice that is
    recorded on a slice whose lanes depend only on their own operands (and
    the shared ones): the first and last `slice_lanes` lanes of B1, the
    add/subtract, B3 (its offset form by whole rows), B4 and both ladders,
    the first and last window rows of the bucket-run kernel, the first and
    last columns of B7 and of the four-step (K1), K2's first and last
    rows (its plain tape reads those rows of each column by index; the
    columns themselves are kept, not copied). Without it (the default)
    every call is recorded whole. `kernels` limits the recording to
    those kernels' sites."""

    # the kernels whose wrapper picks its form by lane count: the
    # threshold's name and the argument that holds the lanes
    FORMS = {"glv_ladder": ("kGlvLaneFrom", "t1", 1),
             "pmixed_bucket_runs": ("kBucketLaneFrom", "starts", 0)}

    def __init__(self, slice_lanes=None, kernels=None):
        self.calls = {}
        self.forms = {}                   # kernel -> {form: recorded calls}
        self.slice = slice_lanes
        self.sliced = 0
        self.kernels = kernels            # record only these (None: all)

    @staticmethod
    def _sites():
        from halo2_tpu_torch.curves import device as curves_device
        from halo2_tpu_torch.ops import field_kernels as fk
        from halo2_tpu_torch.ops import ipa_device
        from halo2_tpu_torch.ops import msm_pippenger as mp
        from halo2_tpu_torch.ops import ntt
        from halo2_tpu_torch.parallel import mesh
        from halo2_tpu_torch.plonk import prover
        from halo2_tpu_torch.poly import domain
        return (("field", fk, "_launch"), ("ntt", domain, "ntt_many"),
                ("mxu", domain, "ntt_mxu_b"),
                ("gate_chunk", prover, "run_chunk"),
                ("ntt", ntt, "ntt_many"), ("ntt", mesh, "ntt_many"),
                ("scalar_mul_ladder", ntt, "scalar_mul_ladder_flat"),
                ("scalar_mul_ladder", curves_device,
                 "scalar_mul_ladder_flat"),
                ("pmixed_bucket_runs", mp, "pmixed_bucket_runs"),
                # B3's lane, offset and index forms (the IPA's projective
                # commits take the index form)
                ("padd_masked", mp, "padd_masked_flat"),
                ("padd", mp, "padd_flat"), ("padd", curves_device,
                                            "padd_flat"),
                # the device IPA fold rounds: the GLV ladder and B4
                ("glv_ladder", ipa_device, "glv_ladder_flat"),
                ("padd", ipa_device, "padd_flat"))

    def __enter__(self):
        self.saved = []
        for kernel, module, attr in self._sites():
            if self.kernels is not None and kernel not in self.kernels:
                continue
            orig = getattr(module, attr)
            self.saved.append((module, attr, orig))
            setattr(module, attr, self._recording(kernel, orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self.saved):
            setattr(module, attr, orig)
        return False

    def _ends(self, L):
        """The first and last `slice` of L lanes (None: all of them)."""
        import torch
        if L <= 2 * self.slice:
            return None
        return torch.cat([torch.arange(self.slice),
                          torch.arange(L - self.slice, L)])

    def _sliced(self, kernel, a, out):
        """(arguments, result) of a call on the slice of its lanes that
        check() holds (see the class): views, cloned by the caller."""
        import torch
        from halo2_tpu_torch.ops import field_kernels as fk
        if self.slice is None:
            return a, out
        memo = {}

        def take(t, dim, sel):
            if t is None:
                return None
            key = (id(t), dim)
            if key not in memo:
                memo[key] = t.index_select(dim, sel.to(t.device))
            return memo[key]

        if kernel == "field":
            fn_name, counter, df, x, y, *extra = a
            batch = tuple(torch.broadcast_shapes(x.shape[:-1], y.shape[:-1]))
            sel = self._ends(math.prod(batch))
            if sel is None:
                return a, out
            (x_, xp), (y_, yp) = fk._fit(x, batch), fk._fit(y, batch)
            sel = sel.to(out.device)
            return ((fn_name, counter, df,
                     x_.reshape(-1, fk.NLIMBS)[sel % xp],
                     y_.reshape(-1, fk.NLIMBS)[sel % yp], *extra),
                    out.reshape(-1, fk.NLIMBS)[sel])
        a = dict(a)
        if kernel == "gate_chunk":
            # rows: the plain tape reads each query's rows by index
            sel = self._ends(a["n"])
            if sel is None:
                return a, out
            sel = sel.to(out.device)
            a["rows"] = sel
            if a["h_prev"] is not None:
                a["h_prev"] = a["h_prev"].index_select(0, sel)
            return a, out.index_select(0, sel)
        if kernel in ("ntt", "mxu"):
            m = a["x"].shape[0]
            if m <= 2:
                return a, out
            sel = torch.tensor([0, m - 1])
            a["x"] = take(a["x"], 0, sel)
            return a, take(out, 0, sel)
        if kernel == "pmixed_bucket_runs":
            G, BL = a["members"].shape[0], a["BL"]
            if G <= 2:
                return a, out
            L = G * BL
            sel = torch.cat([torch.arange(BL), torch.arange(L - BL, L)])
            a["members"] = take(a["members"], 0, torch.tensor([0, G - 1]))
            for name in ("starts", "counts"):
                a[name] = take(a[name], 0, sel)
            return a, take(out, 1, sel)
        lanes = {"padd": ("a", "b"), "glv_ladder": ("t1", "t2", "t12"),
                 "padd_masked": ("a",), "scalar_mul_ladder": ("pts", "lo")}
        first = lanes[kernel][0]
        L = a[first].shape[1]
        sel = self._ends(L)
        if kernel == "padd_masked":
            width = a.get("width")
            if width is not None:
                rows = L // width
                sel = (None if rows <= 2 else torch.cat(
                    [torch.arange(width), torch.arange(L - width, L)]))
            if sel is None:
                return a, out
            if a.get("idx") is None:
                a["b"] = take(a["b"], 1, sel)      # b[j(l)] in l's row
            for name in ("mask", "idx", "sign"):
                if a.get(name) is not None:
                    a[name] = take(a[name], 0, sel)
        if sel is None:
            return a, out
        for name in lanes[kernel]:
            a[name] = take(a.get(name), 1, sel)
        if kernel == "scalar_mul_ladder":
            # lane j of the slice reads row j of its own digit rows
            a["digits"] = take(a["digits"], 0, sel % a["digits"].shape[0])
        if isinstance(out, tuple):
            return a, tuple(take(o, 1, sel) for o in out)
        return a, take(out, 1, sel)

    def _recording(self, kernel, orig):
        import inspect
        import torch
        params = inspect.signature(orig)

        def sig(v):
            if isinstance(v, torch.Tensor):
                return tuple(v.shape), v.dtype
            if v is None or isinstance(v, (int, str)):
                return v
            return (type(v).__name__, getattr(v, "field_id", None),
                    getattr(v, "n", None))

        def clone(v, memo):
            if isinstance(v, list):       # K2's columns: kept, not copied
                return v
            if isinstance(v, torch.Tensor):
                if id(v) not in memo:     # an operand given twice, once
                    memo[id(v)] = v.clone()
                return memo[id(v)]
            if isinstance(v, tuple):
                return tuple(clone(x, memo) for x in v)
            return v

        def recording(*args, **kw):
            key = (kernel, tuple(map(sig, args)),
                   tuple((k, sig(v)) for k, v in sorted(kw.items())
                         if k not in ("shift", "live")))
            if kernel == "gate_chunk":
                # K2 updates h_prev in place: its value before the launch;
                # the columns are the prove's own and stay as they are
                bound = params.bind(*args, **kw)
                key += (id(bound.arguments["tape"]),)
                h = bound.arguments["h_prev"]
                before = None if h is None else h.clone()
            out = orig(*args, **kw)
            if key not in self.calls:
                if kernel == "field":
                    a, got = self._sliced(kernel, args, out)
                    k = {}
                else:
                    bound = params.bind(*args, **kw)
                    # B3's count of live lanes is the recorder's, not an
                    # operand of its plain version
                    bound.arguments.pop("live", None)
                    if kernel == "gate_chunk":
                        bound.arguments["h_prev"] = before
                    if kernel in self.FORMS:
                        name, arg, dim = self.FORMS[kernel]
                        form = form_picked(
                            name, bound.arguments[arg].shape[dim])
                        count = self.forms.setdefault(kernel, {})
                        count[form] = count.get(form, 0) + 1
                    k, got = self._sliced(kernel, bound.arguments, out)
                    a = ()
                self.sliced += got is not out
                memo = {}
                self.calls[key] = (clone(a, memo),
                                   {n: clone(v, memo) for n, v in k.items()},
                                   clone(got, {}))
            return out
        return recording

    def check(self, tag, results):
        """Every recorded call's result against its plain version on the
        same inputs, bit for bit. The ladder's calls of one field, bit
        count and form go to the plain version as one batch, each lane
        with its own table row: the plain ladder walks the bits a launch
        at a time, seconds a call whatever its width. Mismatches and the
        largest error join each kernel's in `results`."""
        import inspect
        import torch
        from halo2_tpu_torch.ops import field_kernels as fk
        from halo2_tpu_torch.ops import gate_kernels as gk
        from halo2_tpu_torch.ops import mxu_field as mxu
        from halo2_tpu_torch.ops import ntt
        from halo2_tpu_torch.ops import point_kernels as pk

        def field_plain(fn_name, counter, df, a, b, *extra):
            if fn_name == "h2t_fmul":
                return fk.fmul_plain(df, a, b)
            return (fk.fsub_plain if extra[0] else fk.fadd_plain)(df, a, b)

        plain = {"field": field_plain, "ntt": ntt.ntt_many_plain,
                 "mxu": mxu.ntt_mxu_b_plain,
                 "gate_chunk": gk.run_chunk_plain,
                 "pmixed_bucket_runs": pk.pmixed_bucket_runs_plain,
                 "padd_masked": pk.padd_masked_plain,
                 "padd": pk.padd_plain, "glv_ladder": pk.glv_ladder_plain}
        def nbytes(v):
            if isinstance(v, torch.Tensor):
                return v.numel() * v.element_size()
            if isinstance(v, (tuple, dict)):
                return sum(map(nbytes, v.values() if isinstance(v, dict)
                               else v))
            return 0

        log(f"[{tag}] {len(self.calls)} kernel calls recorded, "
            f"{nbytes(tuple(self.calls.values())) / 2**30:.3f} GiB; "
            + ("every one whole" if self.slice is None else
               f"{self.sliced} of them on a slice of their lanes (the first "
               f"and last {self.slice}; B3's offset form, the bucket-run "
               f"kernel and B7 their first and last rows or columns)"))
        self.sliced = 0
        pairs, ladders = [], {}
        for (kernel, *_), (args, kw, got) in self.calls.items():
            if kernel == "scalar_mul_ladder":
                a = inspect.signature(pk.scalar_mul_ladder_flat).bind(
                    *args, **kw)
                a.apply_defaults()
                a = a.arguments
                key = (a["df"].field_id, a["nbits"], a["lo"] is not None)
                ladders.setdefault(key, (a["df"], []))[1].append((a, got))
                continue
            name = args[1] if kernel == "field" else kernel
            pairs.append((name, lambda f=plain[kernel], a=args, k=kw:
                          f(*a, **k), got))
        for (_, nbits, fused), (df, group) in ladders.items():
            def merged(group=group, df=df, nbits=nbits, fused=fused):
                lanes = [torch.arange(a["pts"].shape[1], device=a["pts"]
                                      .device) % a["digits"].shape[0]
                         for a, _ in group]
                return pk.scalar_mul_ladder_plain(
                    df, torch.cat([a["pts"] for a, _ in group], 1),
                    torch.cat([a["digits"][r] for (a, _), r
                               in zip(group, lanes)]), nbits,
                    torch.cat([a["lo"] for a, _ in group], 1)
                    if fused else None)
            got = (tuple(torch.cat(g, 1) for g in zip(*(g for _, g in group)))
                   if fused else torch.cat([g for _, g in group], 1))
            pairs.append(("scalar_mul_ladder", merged, got))
        self.calls.clear()
        report = {}
        while pairs:
            name, fn, got = pairs.pop(0)
            t = time.perf_counter()
            want = fn()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            bad = sum(int((g != w).sum()) if g.shape == w.shape else g.numel()
                      for g, w in zip(got, want))
            err = max([0] + [max_abs(g, w) for g, w in zip(got, want)
                             if g.shape == w.shape and g.numel()])
            n, mism, s = report.get(name, (0, 0, 0.0))
            report[name] = (n + 1, mism + bad, s + time.perf_counter() - t)
            r = results[name]
            r[f"{tag}_plain_checks"] = n + 1
            r[f"{tag}_mismatches"] = mism + bad
            r[f"{tag}_max_abs_err"] = max(r.get(f"{tag}_max_abs_err", 0),
                                          err)
        for name, (n, mism, s) in report.items():
            forms = self.forms.get(name)
            if forms:
                results[name][f"{tag}_forms"] = forms
            log(f"[{tag}] {name}: {n} checks against the plain version at "
                f"the path's shapes, {mism} mismatching words, plain "
                f"{s:.3f}s" + (f"; forms launched {forms}" if forms else ""))
        self.forms = {}
        bad = {name: m for name, (_, m, _) in report.items() if m}
        if bad:
            raise AssertionError(f"[{tag}] kernels differ from their plain "
                                 f"versions at the path's shapes: {bad}")


def _flags_check(tag, prover):
    """The card's per-row zero flags of every constraint against the
    plain versions' on the CPU, bit for bit, with both times."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    flags = [ok.cpu() for *_, ok in prover.gate_zero_flags("cuda")]
    torch.cuda.synchronize()
    t_flags = time.perf_counter() - t
    t = time.perf_counter()
    plain = [ok for *_, ok in prover.gate_zero_flags("cpu")]
    t_plain = time.perf_counter() - t
    same = len(flags) == len(plain) and all(
        torch.equal(a, b) for a, b in zip(flags, plain))
    log(f"[{tag}] per-row zero flags of {len(flags)} constraints over "
        f"{prover.n} rows, card {t_flags:.3f}s, plain versions on the CPU "
        f"{t_plain:.3f}s: bit-equal {same}")
    if not same or not flags:
        raise AssertionError(f"[{tag}] the card's zero flags differ from "
                             f"the plain versions'")


def _gate_check(tag, prover):
    """The card's gate check (verify_vectorized) against the host
    checker's gate stream, field by field; wall time beside the device
    time of its field-kernel launches. Returns the failures."""
    import dataclasses
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    with field_launches() as ev:
        card = prover.verify_vectorized()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    gates = prover.verify(streams=("gates",))
    log(f"[{tag}] gate check on the card {wall:.4f}s wall, "
        f"{ev.summary()}; failures {_failures(card)}")
    if ([(type(e).__name__, dataclasses.astuple(e)) for e in card]
            != [(type(e).__name__, dataclasses.astuple(e)) for e in gates]):
        raise AssertionError(f"[{tag}] the card's gate failures {card[:3]} "
                             f"!= the host's {gates[:3]}")
    return card


def phase_gadgets(results, main_state):
    """[gadgets] the golden gadget circuits at K = 11 over VESTA Params
    made once on the card: every key equal to zcash/halo2's pinned text
    and every golden proof verified, a corrupted one rejected; four of
    them proved (cold, warm) against the JAX hashes. Counts set to 0
    just before Params.new and read after the last prove; every kernel
    of the path must launch. The first call of each kernel at each shape
    (Params.new, the keygens, the cold proves) is recorded and held
    against its plain version after the counts are read. Then
    BenchCircuit k=14 with the Poseidon transcript (the main path's keys)
    and the ecc_chip gate check, its per-row zero flags against the plain
    versions' on the CPU."""
    import os
    import torch
    from halo2_tpu_torch import gadget_circuits as gc
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS, VESTA
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.fields.host import FP
    from halo2_tpu_torch.gadgets.ecc.constants import fixed_base_constants
    from halo2_tpu_torch.gadgets.sinsemilla.primitive import sinsemilla_s
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                VerificationError)
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.transcript import (TranscriptWrite, TranscriptRead,
                                            PoseidonTranscriptWrite,
                                            PoseidonTranscriptRead)
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")

    def read(name, mode="r"):
        with open(os.path.join(golden, name), mode) as fh:
            return fh.read()

    ns = gc.port_namespace()
    # host work the circuits need before any synthesis: the fixed-base
    # tables (read from the repository's .fixed_base_cache) and the
    # 1,024-point S table (hash-to-curve), both cached for the process
    t = time.perf_counter()
    for base, nw in ((ns.PALLAS.generator, ns.NUM_WINDOWS),
                     (ns.PALLAS.generator, ns.NUM_WINDOWS_SHORT),
                     (ns.COMMIT_DOMAIN.R, ns.NUM_WINDOWS)):
        fixed_base_constants(base, nw)
    t_tables = time.perf_counter() - t
    t = time.perf_counter()
    s_table = [sinsemilla_s(j) for j in range(1024)]
    log(f"[gadgets] host tables: fixed-base constants {t_tables:.3f}s, "
        f"Sinsemilla S ({len(s_table)} points) "
        f"{time.perf_counter() - t:.3f}s")

    shapes = path_calls()
    reset_counts()                        # the gadgets path's count starts
    t = time.perf_counter()
    with shapes:
        params = Params.new(VESTA, gc.K, use_cache=False)
    torch.cuda.synchronize()
    log(f"[gadgets] Params.new(VESTA, {gc.K}) {time.perf_counter() - t:.3f}s,"
        f" launches {launch_counts()}")
    vks = {}
    for name in gc.GOLDEN:
        circuit = gc.golden_circuit(ns, name)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with shapes:
            vk = vks[name] = keygen_vk(params, circuit)
        torch.cuda.synchronize()
        t_key = time.perf_counter() - t
        if vk.pinned_text() + "\n" != read(f"vk_{name}.rdata"):
            raise AssertionError(f"[gadgets] {name}: the pinned key differs "
                                 f"from tests/golden/vk_{name}.rdata")
        t = time.perf_counter()
        verify_proof(params, vk, SingleVerifier(params), [[]],
                     TranscriptRead(VESTA, read(f"proof_{name}.bin", "rb")))
        log(f"[gadgets] {name}: degree {vk.cs.degree()}, extended k "
            f"{vk.domain.extended_k}: keygen_vk {t_key:.3f}s equals the "
            f"golden key; golden proof verified in "
            f"{time.perf_counter() - t:.3f}s")
    bad = bytearray(read("proof_ecc_chip.bin", "rb"))
    bad[-64] ^= 1                          # the IPA's scalar c, off by one
    try:
        verify_proof(params, vks["ecc_chip"], SingleVerifier(params), [[]],
                     TranscriptRead(VESTA, bytes(bad)))
    except VerificationError:
        log("[gadgets] corrupted ecc_chip proof rejected")
    else:
        raise AssertionError("[gadgets] a corrupted golden proof was "
                             "accepted")
    for name in gc.PROVED:
        circuit = gc.golden_circuit(ns, name)
        t = time.perf_counter()
        with shapes:
            pk_ = keygen_pk(params, vks[name], circuit)
        torch.cuda.synchronize()
        log(f"[gadgets] {name}: keygen_pk {time.perf_counter() - t:.3f}s")
        proofs = []
        for label in ("cold", "warm"):
            before = launch_counts()
            tw = TranscriptWrite(VESTA)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with shapes if label == "cold" else contextlib.nullcontext():
                pv.create_proof(params, pk_, [circuit], [[]],
                                random.Random(PROOF_SEED), tw)
            torch.cuda.synchronize()
            proofs.append(tw.finalize())
            log(f"[gadgets] {name}: create_proof {label} "
                f"{time.perf_counter() - t:.3f}s, {len(proofs[-1])} bytes, "
                f"launches {diff_counts(before)}")
        log(f"[gadgets] {name}: warm phases " + json.dumps(
            {phase: round(sec, 4) for phase, sec in pv.LAST_PHASES}))
        t = time.perf_counter()
        verify_proof(params, vks[name], SingleVerifier(params), [[]],
                     TranscriptRead(VESTA, proofs[1]))
        digest = hashlib.sha256(proofs[1]).hexdigest()
        log(f"[gadgets] {name}: verify_proof {time.perf_counter() - t:.3f}s "
            f"(accepted); proof sha256 {digest}")
        if proofs[0] != proofs[1] or digest != REF_SHA256[name, gc.K]:
            raise AssertionError(f"[gadgets] {name}: proof hash {digest} != "
                                 f"JAX reference {REF_SHA256[name, gc.K]}")
    launches = launch_counts()
    log(f"[gadgets] launches in Params.new, {len(gc.GOLDEN)} keygen_vk, "
        f"{len(gc.PROVED)} keygen_pk and {2 * len(gc.PROVED)} proves "
        f"{launches}")
    path = MAIN_PATH_KERNELS + ("scalar_mul_ladder",)
    for name in path:
        results[name]["gadgets_launches"] = launches[name]
    idle = [k for k in path if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels of the gadgets path not launched: "
                             f"{idle}")
    log(f"[gadgets] {len(gc.GOLDEN)} keys equal the golden keys and their "
        f"golden proofs verified; {len(gc.PROVED)} proofs equal the JAX "
        f"reference's")
    shapes.check("gadgets", results)
    del params, vks

    # BenchCircuit k=14 with the Poseidon transcript, on the main path's keys
    main_params, main_pk, circuit, out = main_state
    proofs = []
    for label in ("cold", "warm"):
        tw = PoseidonTranscriptWrite(PALLAS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pv.create_proof(main_params, main_pk, [circuit], [[[out]]],
                        random.Random(PROOF_SEED), tw)
        torch.cuda.synchronize()
        proofs.append(tw.finalize())
        log(f"[gadgets] bench k={K} Poseidon transcript: create_proof "
            f"{label} {time.perf_counter() - t:.3f}s")
    verify_proof(main_params, main_pk.vk, SingleVerifier(main_params),
                 [[[out]]], PoseidonTranscriptRead(PALLAS, proofs[1]))
    digest = hashlib.sha256(proofs[1]).hexdigest()
    log(f"[gadgets] bench k={K} Poseidon transcript: verified; proof sha256 "
        f"{digest}")
    if proofs[0] != proofs[1] or digest != REF_SHA256["bench-poseidon", K]:
        raise AssertionError(f"Poseidon-transcript proof hash {digest} != "
                             f"JAX reference "
                             f"{REF_SHA256['bench-poseidon', K]}")

    # the ecc_chip mock prover: the card's gate check against the host's
    t = time.perf_counter()
    prover = MockProver.run(gc.K, gc.golden_circuit(ns, "ecc_chip"), [],
                            fs=FP)
    t_run = time.perf_counter() - t
    t = time.perf_counter()
    host = prover.verify()
    log(f"[gadgets] ecc_chip MockProver: run {t_run:.3f}s, verify "
        f"{time.perf_counter() - t:.3f}s, {len(prover.cs.gates)} gates; "
        f"failures {len(host)}")
    if host or _gate_check("gadgets ecc_chip", prover):
        raise AssertionError("[gadgets] the satisfied ecc_chip witness fails")
    _flags_check("gadgets ecc_chip", prover)
    # one advice cell changed: the first assigned cell of column 0
    cells = prover.advice[0]
    row = next(r for r, v in enumerate(cells) if isinstance(v, int) and v)
    cells[row] = (cells[row] + 1) % FP.modulus
    if not _gate_check("gadgets ecc_chip", prover):
        raise AssertionError(f"[gadgets] changing advice[0][{row}] broke no "
                             f"gate on the card")


def sass_opcodes(so: str, key: str) -> dict:
    """Opcode counts (IMAD.WIDE.U32, IMAD.HI.U32, ...) in the SASS of each
    function of the built library at `so` whose name holds `key`
    (cuobjdump beside nvcc; {} where it is missing)."""
    import os
    import re
    from collections import Counter
    from halo2_tpu_torch.ops import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m.group(1), Counter()) \
                if key in m.group(1) else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,6}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if cur is not None and m:
            cur[m.group(1)] += 1
    return counts


def phase_peak():
    """[peak] The card's rate of 32-bit integer multiply-adds, which sets
    the "operations" bound (MULADD_PER_S): independent chains of IMAD,
    IMAD.HI and IMAD.WIDE (a 64-bit result, two 32-bit words) on every
    SM, timed with CUDA events, beside an FFMA chain as the control (its
    rate is the card's published 32-bit float rate over two); the SM
    clock and the SASS of the chains, and B1's multiply-add count per
    product from its SASS. Fails when the integer rate exceeds the bound's
    constant by more than 10%: the bound would then not be one."""
    import torch
    from halo2_tpu_torch.ops import cuda_build
    lib = cuda_build.library("peak_kernels")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chains = lib.h2t_peak_chains()
    blocks, threads, iters = 8 * sms, 256, 1 << 14
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = cuda_build.stream_ptr(out.device)

    def clock(what):
        smi = subprocess.run(
            ["nvidia-smi", f"--query-gpu={what}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.stdout else "?"

    rates = {}
    for mode, name, words in ((0, "IMAD", 1), (1, "IMAD.HI", 1),
                              (2, "IMAD.WIDE", 2), (3, "FFMA", 1)):
        def launch(mode=mode):
            cuda_build.check(lib.h2t_peak(mode, out.data_ptr(), iters,
                                          0x9E3779B1, 12345, blocks, threads,
                                          stream), "peak")
        ms = timed(launch, 20)
        ops = blocks * threads * iters * chains
        rates[name] = ops * words / (ms * 1e-3)
        log(f"[peak] {name}: {ops} instructions in {ms:.4f} ms, "
            f"{rates[name]:.4e} 32-bit results/s "
            f"({rates[name] / sms / 1e9:.2f} per SM per ns)")
    log(f"[peak] SM clock under load {clock('clocks.sm')}, max "
        f"{clock('clocks.max.sm')}; {sms} SMs")
    for fn, ops in sass_opcodes(cuda_build._so_path("peak_kernels"),
                                "peak").items():
        top = {k: v for k, v in ops.items() if k.startswith(("IMAD", "FFMA"))}
        log(f"[peak] SASS {fn}: {top}")
    for fn, ops in sass_opcodes(cuda_build._so_path("field_kernels"),
                                "fmul_kernel").items():
        imad = {k: v for k, v in ops.items() if k.startswith("IMAD")}
        log(f"[peak] SASS {fn}: {sum(imad.values())} instructions on the "
            f"IMAD pipe a product, moves and carries among them {imad} "
            f"(the bound counts {MONT_MULADDS} multiply-add words)")
    best = max(rates[n] for n in ("IMAD", "IMAD.HI", "IMAD.WIDE"))
    log(f"[peak] integer multiply-adds {best:.4e}/s against MULADD_PER_S "
        f"{MULADD_PER_S:.4e} ({best / MULADD_PER_S:.3f}); FFMA "
        f"{rates['FFMA']:.4e}/s ({2 * rates['FFMA'] / 1e12:.1f} TFLOP/s)")
    if best > 1.1 * MULADD_PER_S:
        raise AssertionError(f"the card's integer multiply-add rate "
                             f"{best:.4e}/s exceeds MULADD_PER_S")


class phase_launches:
    """Within the block, the launches of each kernel in each prover phase
    and the phase's peak of allocated card memory: a measurement hook
    around the end of each of PhaseTimer's laps (which drains the card
    first). The block's value is the list of (phase, {kernel: launches},
    peak GiB)."""

    def __enter__(self):
        import torch
        from halo2_tpu_torch import tracing
        self.orig = orig = tracing.PhaseTimer._end
        phases, last = [], [launch_counts()]
        torch.cuda.reset_peak_memory_stats()

        def end(timer):
            name = timer._name
            now_t = orig(timer)
            if name is not None:
                now = launch_counts()
                phases.append((name, {k: v - last[0][k]
                                      for k, v in now.items()
                                      if v != last[0][k]},
                               torch.cuda.max_memory_allocated() / 2**30))
                torch.cuda.reset_peak_memory_stats()
                last[0] = now
            return now_t

        tracing.PhaseTimer._end = end
        return phases

    def __exit__(self, *exc):
        from halo2_tpu_torch import tracing
        tracing.PhaseTimer._end = self.orig
        return False


def _instance_partner(prover, row: int):
    """(column, row) of the advice cell copied to instance row `row`: the
    next advice cell on the instance cell's permutation cycle."""
    perm = prover.permutation
    c = next(i for i, col in enumerate(perm.columns)
             if col.column_type == "instance")
    r = row
    for _ in range(perm.n * len(perm.columns)):
        c, r = int(perm.map_col[c, r]), int(perm.map_row[c, r])
        if perm.columns[c].column_type == "advice":
            return perm.columns[c], r
    raise AssertionError(f"instance row {row} is copied from no advice cell")


def phase_sha256(results):
    """[sha256] SHA-256 (halo2_tpu_torch/sha256_circuits.py). The circuit
    writer's check on the card: the bit-decomposition chip's
    CompressCircuit at K = 14 (the digest of "abc", against compress_host)
    through verify_vectorized, its per-row zero flags against the plain
    versions' on the CPU, a wrong output word (its advice cell) reported
    by the card and a wrong instance by the permutation stream; Table16's
    two-block circuit at K = 17 through verify_vectorized, its field
    kernels' calls held against the plain versions on lane slices
    (path_calls; the plain flags of 20 degree-9 gates over 2^17 rows would
    take minutes). Then halo2's bench circuit (Table16, 31 words, k = 17,
    PALLAS): Params.new uncached, keygen_vk and keygen_pk, a cold prove
    with the debug checks on (sanity=True) and a warm one, the launches
    of each prover phase, card memory, SingleVerifier and BatchVerifier,
    a corrupted proof rejected, the proof's sha256 against the JAX
    reference's (reference_proof_hash.py --circuit sha256) and the cold
    and warm bytes equal; the first call of every kernel at each shape of
    Params.new, the keygens and the cold prove held against its plain
    version (path_calls); a profiled warm prove. Counts set to 0 just
    before each path and read just after."""
    import torch
    from halo2_tpu_torch import sha256_circuits as sc
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.gadgets.sha256 import IV, compress_host, sha256_host
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                BatchVerifier,
                                                VerificationError)
    from halo2_tpu_torch.poly.commitment import Params
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead
    ns = sc.port_namespace()

    # the bit-decomposition chip at K = 14
    want = compress_host(list(IV), sc.ABC_BLOCK)
    if b"".join(w.to_bytes(4, "big") for w in want) != sha256_host(b"abc"):
        raise AssertionError("compress_host of the 'abc' block is not FIPS")
    reset_counts()                        # the mock prover's count starts
    t = time.perf_counter()
    prover = MockProver.run(sc.K_COMPRESS, ns.classes.Compress(sc.ABC_BLOCK),
                            [want], fs=ns.FQ)
    t_run = time.perf_counter() - t
    t = time.perf_counter()
    perm = prover.verify(streams=("permutation",))
    log(f"[sha256] CompressCircuit K={sc.K_COMPRESS}: MockProver.run "
        f"{t_run:.3f}s, {len(prover.cs.gates)} gates, degree "
        f"{prover.cs.degree()}; permutation stream "
        f"{time.perf_counter() - t:.3f}s, failures {len(perm)}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with field_launches() as ev:
        card = prover.verify_vectorized()
        torch.cuda.synchronize()
    log(f"[sha256] CompressCircuit gate check on the card "
        f"{time.perf_counter() - t:.4f}s wall, {ev.summary()}; failures "
        f"{_failures(card)}")
    del ev
    if perm or card:
        raise AssertionError(f"[sha256] the chip's compression of 'abc' "
                             f"fails: {perm[:3]} {card[:3]}")
    _flags_check("sha256 compress", prover)
    col, row = _instance_partner(prover, 0)
    prover.advice[col.index][row] ^= 1    # a wrong output word
    bad = prover.verify_vectorized()
    log(f"[sha256] output word 0 (advice[{col.index}][{row}]) off by one: "
        f"the card reports {len(bad)} failures {_failures(bad)[:3]}")
    if not bad:
        raise AssertionError("[sha256] a wrong output word passed the card's "
                             "gate check")
    wrong = MockProver.run(sc.K_COMPRESS, ns.classes.Compress(sc.ABC_BLOCK),
                           [[want[0] ^ 1] + want[1:]], fs=ns.FQ)
    kinds = _failures(wrong.verify(streams=("permutation",)))
    log(f"[sha256] wrong instance word: permutation stream {kinds}")
    if not kinds:
        raise AssertionError("[sha256] a wrong instance word was accepted")
    del prover, wrong

    # Table16's two-block circuit at K = 17
    circuit = sc.table16_circuit(ns, "two_block")
    t = time.perf_counter()
    prover = MockProver.run(sc.K_TABLE16, circuit, [])
    t_run = time.perf_counter() - t
    digest_ok = circuit.digest_out == sc.chained_rounds(
        sc.table16_words("two_block"))
    calls = path_calls(slice_lanes=1024)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with calls, field_launches() as ev:
        card = prover.verify_vectorized()
        torch.cuda.synchronize()
    log(f"[sha256] Table16 two blocks, K={sc.K_TABLE16}: MockProver.run "
        f"{t_run:.3f}s, {len(prover.cs.gates)} gates, degree "
        f"{prover.cs.degree()}, digest equals the raw rounds' {digest_ok}; "
        f"gate check on the card {time.perf_counter() - t:.4f}s wall, "
        f"{ev.summary()}; failures {_failures(card)}")
    launches = launch_counts()
    log(f"[sha256] mock prover launches {launches}")
    if card or not digest_ok:
        raise AssertionError(f"[sha256] Table16 two blocks fails: "
                             f"{card[:3]}, digest {digest_ok}")
    if not launches["fmul"] or not launches["faddsub"]:
        raise AssertionError("[sha256] the gate check launched no B1 or "
                             "add/subtract kernel")
    calls.check("sha256_mock", results)
    del prover, circuit, calls, ev        # ev holds every launch's operands

    # the bench circuit, proved
    circuit = sc.table16_circuit(ns, "bench")
    shapes = path_calls(slice_lanes=1024)
    reset_counts()                        # the SHA-256 path's count starts
    torch.cuda.synchronize()
    t = time.perf_counter()
    with shapes:
        params = Params.new(PALLAS, sc.K_TABLE16, use_cache=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with shapes:
        vk = keygen_vk(params, circuit)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with shapes:
        pk_ = keygen_pk(params, vk, circuit)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"[sha256] bench k={sc.K_TABLE16}: Params.new(use_cache=False) "
        f"{t1 - t:.3f}s, keygen_vk {t2 - t1:.3f}s, keygen_pk {t3 - t2:.3f}s;"
        f" {vk.cs.num_advice_columns} advice columns, degree "
        f"{vk.cs.degree()}, extended k {vk.domain.extended_k}; launches "
        f"{launch_counts()}")
    proofs, peak = [], 0.0
    for label in ("cold", "warm"):
        before = launch_counts()
        tw = TranscriptWrite(PALLAS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with (shapes if label == "cold" else contextlib.nullcontext()), \
                phase_launches() as per_phase, ntt_shapes() as transforms:
            pv.create_proof(params, pk_, [circuit], [[]],
                            random.Random(PROOF_SEED), tw,
                            sanity=label == "cold")
        torch.cuda.synchronize()
        proofs.append(tw.finalize())
        k1 = diff_counts(before)["mxu"]
        if k1 != k1_launches(transforms):
            raise AssertionError(f"[sha256] {k1} K1 launches, the pass "
                                 f"plans make {k1_launches(transforms)}")
        peak = max([peak] + [gib for *_, gib in per_phase])
        log(f"[sha256] create_proof {label}"
            f"{' (debug checks on)' if label == 'cold' else ''}: "
            f"{time.perf_counter() - t:.3f}s, {len(proofs[-1])} bytes, "
            f"launches {diff_counts(before)}")
    results["mxu"]["launches_warm_prove_sha256"] = k1
    log(f"[sha256] K1 launches a warm prove: {k1} for "
        f"{sum(transforms.values())} four-step transforms {dict(transforms)}")
    log(f"[sha256] card memory: max allocated {peak:.3f} GiB over the two "
        f"proves (each phase's peak beside its launches)")
    log("[sha256] warm phases " + json.dumps(
        {name: round(sec, 4) for name, sec in pv.LAST_PHASES}))
    for name, counts, gib in per_phase:
        log(f"[sha256] warm {name}: launches {counts}, peak {gib:.3f} GiB")
    h_build = next(c for name, c, _ in per_phase if name == "h terms build")
    log(f"[sha256] h terms build: {h_build.get('fmul', 0)} B1 and "
        f"{h_build.get('faddsub', 0)} add/subtract launches")
    t = time.perf_counter()
    verify_proof(params, vk, SingleVerifier(params), [[]],
                 TranscriptRead(PALLAS, proofs[1]))
    t_single = time.perf_counter() - t
    bv = BatchVerifier(params)
    bv.add_proof([[]], proofs[1])
    t = time.perf_counter()
    batch = bv.finalize(vk)
    log(f"[sha256] SingleVerifier {t_single:.3f}s (accepted), BatchVerifier "
        f"{time.perf_counter() - t:.3f}s: {batch}")
    if batch is not True:
        raise AssertionError("[sha256] BatchVerifier rejected the proof")
    corrupted = bytearray(proofs[1])
    corrupted[-64] ^= 1                   # the IPA's scalar c, off by one
    try:
        verify_proof(params, vk, SingleVerifier(params), [[]],
                     TranscriptRead(PALLAS, bytes(corrupted)))
    except VerificationError:
        log("[sha256] corrupted proof rejected")
    else:
        raise AssertionError("[sha256] a corrupted proof was accepted")
    digest = hashlib.sha256(proofs[1]).hexdigest()
    log(f"[sha256] proof sha256 {digest}")
    if proofs[0] != proofs[1]:
        raise AssertionError("[sha256] cold and warm proofs differ")
    launches = launch_counts()
    # k = 17: every transform is of 2^17 or 2^20, so K1's and no B7's
    path = tuple(k for k in MAIN_PATH_KERNELS if k != "ntt") + (
        "mxu", "padd", "glv_ladder", "scalar_mul_ladder")
    for name in path + ("ntt",):
        results[name]["sha256_launches"] = launches[name]
    log(f"[sha256] launches in Params.new, the keygens, the two proves and "
        f"the verifiers {launches}")
    idle = [k for k in path if launches[k] == 0]
    if launches["ntt"]:
        raise AssertionError(f"[sha256] {launches['ntt']} B7 launches: "
                             f"every transform at k = 17 is of 2^16 or more")
    if idle:
        raise AssertionError(f"kernels of the SHA-256 path not launched: "
                             f"{idle}")
    shapes.check("sha256", results)
    del shapes
    phase_gate_chunks(results, params, pk_, circuit, digest,
                      dict(pv.LAST_PHASES)["h terms build"], h_build)
    profile_call("sha256", lambda: pv.create_proof(
        params, pk_, [circuit], [[]], random.Random(PROOF_SEED),
        TranscriptWrite(PALLAS)))
    if digest != REF_SHA256["sha256", sc.K_TABLE16]:
        raise AssertionError(f"[sha256] proof hash {digest} != JAX reference "
                             f"{REF_SHA256['sha256', sc.K_TABLE16]}")
    log("[sha256] proof bytes equal the JAX reference's")


def phase_gate_chunks(results, params, pk_, circuit, digest, eager_s,
                      eager_launches):
    """[sha256] the gate-chunk branch on the bench circuit (k = 17): for
    the whole gate set as one chunk and for chunks of 400 nodes, a first
    prove with K2's calls recorded (path_calls, rows sliced) and a warm
    prove timed, each byte-equal to the eager one (`digest`); `h terms
    build`'s time and launches beside the eager fold's. Counts set to 0
    just before the proves and read just after. Then K2 alone on the
    whole gate set at the extended domain's rows, from a CUDA graph,
    beside its bound and the plain tape's time on 2^16 of the rows."""
    import torch
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.ops import gate_kernels as gk
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.transcript import TranscriptWrite
    cs = pk_.vk.cs
    whole = sum(pv._expr_nodes(e) for g in cs.gates for e in g.polys)
    r = results["gate_chunk"]
    log(f"[sha256] eager h terms build {eager_s:.4f}s, launches "
        f"{eager_launches}")
    r["eager_h_build_s"] = eager_s
    reset_counts()                        # the gate-chunk path's count
    calls = path_calls(slice_lanes=1024, kernels=("gate_chunk",))
    for nodes in (whole, 400):
        for label in ("first", "warm"):
            tw = TranscriptWrite(PALLAS)
            before = launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with (calls if label == "first" else contextlib.nullcontext()), \
                    phase_launches() as per_phase:
                pv.create_proof(params, pk_, [circuit], [[]],
                                random.Random(PROOF_SEED), tw,
                                h_chunk_nodes=nodes)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = hashlib.sha256(tw.finalize()).hexdigest()
            if got != digest:
                raise AssertionError(f"[sha256] the proof with h_chunk_nodes="
                                     f"{nodes} hashes to {got}, not {digest}")
        h = dict(pv.LAST_PHASES)["h terms build"]
        hl = next(c for name, c, _ in per_phase if name == "h terms build")
        tapes = pk_._h_gate_tapes[nodes]
        log(f"[sha256] h_chunk_nodes={nodes}: {len(tapes)} chunks, at most "
            f"{max(t.n_slots for t in tapes)} slots; warm prove {wall:.3f}s "
            f"(byte-equal); h terms build {h:.4f}s (eager {eager_s:.4f}s), "
            f"launches {hl} (eager {eager_launches})")
        r[f"chunked_h_build_s_{nodes}"] = h
        r[f"chunked_h_build_launches_{nodes}"] = hl
        r[f"chunked_warm_prove_s_{nodes}"] = wall
    launches = launch_counts()
    r["launches"] = launches["gate_chunk"]
    log(f"[sha256] launches in the four gate-chunk proves {launches}")
    if launches["gate_chunk"] != 2 * (1 + len(pk_._h_gate_tapes[400])):
        raise AssertionError(f"[sha256] {launches['gate_chunk']} K2 launches"
                             f" in the gate-chunk proves")
    calls.check("sha256_chunks", results)
    del calls
    # K2 alone: the whole gate set on random columns of the path's shape
    n = pk_.vk.domain.extended_n
    df = params.scalar_df
    tape = pk_._h_gate_tapes[whole][0]
    dev = torch.device("cuda")
    cols = [[rand_field(df, n, 200 + 10 * kind + i, dev) for i in range(c)]
            for kind, c in enumerate((cs.num_advice_columns,
                                      cs.num_fixed_columns,
                                      cs.num_instance_columns))]
    y_m = df.scalar(0x1234567, dev)
    fn = lambda: gk.run_chunk(df, tape, None, *cols, 8, y_m, y_m, n)
    ms = graph_ms(fn, 5)
    call = timed(fn, 5)
    rows = torch.arange(1 << 16, device=dev)
    t = time.perf_counter()
    gk.run_chunk_plain(df, tape, None, *cols, 8, y_m, y_m, n, rows=rows)
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t) * 1e3
    queried = {x for op, _, x, _ in tape.code
               if (op & gk.OP_MASK) == gk.OP_QUERY}
    flags = {name: sum(bool(op & f) for op, *_ in tape.code)
             for name, f in (("keep", gk.OPF_KEEP),
                             ("x_last", gk.OPF_X_LAST),
                             ("y_last", gk.OPF_Y_LAST))}
    bd, by = bound_ms((len(queried) + 1) * n * 64,
                      tape.muls() * n * MONT_MULADDS)
    r.update(ms=ms, call_ms=call, plain_ms=pms, plain_rows=1 << 16,
             bound_ms=bd, bound_by=by, shape=[n, 16],
             instructions=len(tape.code), slots=tape.n_slots,
             columns_queried=len(queried), products_a_row=tape.muls(),
             register_flags=flags)
    r["mismatches"] = r.get("sha256_chunks_mismatches", 0)
    r["max_abs_err"] = r.get("sha256_chunks_max_abs_err", 0)
    log(f"[sha256] K2, the whole gate set ({len(tape.code)} instructions, "
        f"{tape.n_slots} slots, {len(queried)} columns queried, "
        f"{tape.muls()} products a row; register flags {flags}) at {n} "
        f"rows: {ms:.4f} ms from a "
        f"CUDA graph, {call:.4f} ms a wrapper call (bound {bd:.4f} ms by "
        f"{by}, {100 * bd / ms:.0f}%); the plain tape on 2^16 rows "
        f"{pms:.1f} ms")


# [mesh]: the spawned worlds share the one card over gloo; each rank
# proves BenchCircuit at k = K cold and warm, holds a 2^16-column sharded
# NTT and a k = K sharded commit to their single-device results, and the
# world of 2 also proves dev_lookup at k = K
MESH_WORLDS = (2, 4)
MESH_TIMEOUT_S = 240


def _mesh_tasks(world: int) -> list:
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    tasks = [("bench", "prove", dict(circuit="bench", k=K, seed=PROOF_SEED,
                                     reps=2)),
             ("ntt", "ntt", dict(log_n=16, seed=1)),
             ("commit", "commit", dict(k=K, seed=3, blind=5))]
    if world == 2:
        tasks.append(("lookup", "prove", dict(circuit="dev_lookup", k=K,
                                              seed=PROOF_SEED)))
    return tasks


def _mesh_memory(pk_bytes, peak, start, staged, local) -> dict:
    """A rank's memory figures of a warm mesh prove: its proving key's
    bytes, the peak of allocated card memory in the prove and the part of
    it above what the process held when the prove began (the prove's own
    working set; the absolute peak also counts whatever else the process
    holds), and the bytes staged through host memory."""
    return {"pk_bytes": pk_bytes, "peak_bytes": peak,
            "prove_peak_bytes": peak - start, "staged_bytes": staged,
            "local": local}


def _mesh_memory_text(mem, ref=None) -> str:
    share = (lambda k: f" ({mem[k] / ref[k]:.4f} of world 1's)"
             if ref else "")
    return (f"holds its rows {mem['local']}; pk {mem['pk_bytes']} bytes"
            f"{share('pk_bytes')}; the warm prove's peak of allocated card "
            f"memory {mem['peak_bytes']} bytes, {mem['prove_peak_bytes']} "
            f"above its start{share('prove_peak_bytes')}; staged "
            f"{mem['staged_bytes']} bytes")


def _pk_bytes(pk) -> int:
    """Bytes of storage of the proving-key tensors the prover re-lays."""
    from halo2_tpu_torch.parallel import programs
    return sum(v for _, v in programs.pk_rows(pk).values())


def _mesh_rank(tasks):
    """One rank of a spawned world (chip_smoke.py is its main module): the
    tasks of parallel/programs.py on the card, every kernel call they
    make recorded (path_calls, lane slices of 1,024) and held against its
    plain version after them; a mismatch fails the rank."""
    from collections import defaultdict
    from halo2_tpu_torch.parallel import programs
    with path_calls(slice_lanes=1024) as calls:
        out = programs.run(None, tasks)
    report, tag = defaultdict(dict), f"mesh rank {out['rank']}"
    calls.check(tag, report)
    out["plain_checks"] = {name: {k[len(tag) + 1:]: v for k, v in r.items()}
                           for name, r in report.items()}
    return out


def phase_mesh(results):
    """[mesh] The multi-device layer (halo2_tpu_torch/parallel/) at k = K.
    A world of one rank over NCCL, in this process: BenchCircuit proved
    cold and warm under ProverMesh(make_mesh()) against the JAX hash,
    SingleVerifier and BatchVerifier, the sharded commit, NTT and scan
    counted, every kernel call of the path held against its plain version
    (path_calls, whole), counts set to 0 just before and read just
    after; the group destroyed. Then spawned worlds of 2 and 4 ranks on
    the one card over gloo (every exchange staged through host memory):
    each rank's proofs hash to the same reference, its sharded NTT of a
    2^16 column and sharded k = K commit equal the single-device ones,
    its path's kernel calls equal their plain versions; the world of 2
    also proves dev_lookup at k = K against its JAX hash. Every rank of
    every world holds its rows: its proving key's bytes, its peak of
    allocated card memory in the warm prove and the bytes it staged
    through host memory then are printed. Ranks that share a card compete
    for it: their times show no speedup and claim none."""
    import torch
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS as curve
    from halo2_tpu_torch.parallel import ProverMesh, make_mesh, programs
    from halo2_tpu_torch.parallel import mesh as mesh_mod
    from halo2_tpu_torch.parallel.launch import run_ranks, world_of_one
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.plonk.verifier import (verify_proof, SingleVerifier,
                                                BatchVerifier)
    from halo2_tpu_torch.transcript import TranscriptWrite, TranscriptRead

    want = REF_SHA256["bench", K]
    for key in mesh_mod.COUNTS:
        mesh_mod.COUNTS[key] = 0
    with world_of_one("nccl", MESH_TIMEOUT_S):
        mesh = make_mesh()
        params, vk, pk_, circuit, inst = programs.keys_for("bench", K,
                                                           mesh.device)
        reset_counts()                    # the mesh path's count starts
        proofs = []
        with path_calls() as calls:
            for label in ("cold", "warm"):
                before = launch_counts()
                staged = mesh_mod.COUNTS["staged_bytes"]
                tw = TranscriptWrite(curve)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                t = time.perf_counter()
                with ProverMesh(mesh):
                    pv.create_proof(params, pk_, [circuit], inst,
                                    random.Random(PROOF_SEED), tw)
                torch.cuda.synchronize()
                proofs.append(tw.finalize())
                log(f"[mesh] world 1 (nccl, {mesh.device}): create_proof "
                    f"{label} {time.perf_counter() - t:.3f}s")
        warm = diff_counts(before)
        launches = launch_counts()
        counts = dict(mesh_mod.COUNTS)
        mem1 = _mesh_memory(
            _pk_bytes(pk_), torch.cuda.max_memory_allocated(), start,
            counts["staged_bytes"] - staged, pk_._rows.local)
    log(f"[mesh] world 1: launches {launches} (the warm prove {warm}); "
        f"mesh counts {counts}")
    log(f"[mesh] world 1 rank 0: {_mesh_memory_text(mem1)}")
    for name in MAIN_PATH_KERNELS:
        results[name]["mesh_launches_d1"] = warm[name]
    idle = [k for k in MAIN_PATH_KERNELS if launches[k] == 0]
    idle += [k for k in ("sharded_msm", "sharded_ntt",
                         "sharded_inclusive_product", "sharded_batch_inv")
             if counts[k] == 0]
    if idle:
        raise AssertionError(f"not run on the mesh path: {idle}")
    verify_proof(params, vk, SingleVerifier(params), inst,
                 TranscriptRead(curve, proofs[1]))
    bv = BatchVerifier(params)
    for p in proofs:
        bv.add_proof(inst, p)
    if not bv.finalize(vk):
        raise AssertionError("BatchVerifier rejected the mesh proofs")
    digests = {hashlib.sha256(p).hexdigest() for p in proofs}
    log(f"[mesh] world 1: verified (SingleVerifier, BatchVerifier); proof "
        f"sha256 {sorted(digests)}")
    if digests != {want}:
        raise AssertionError(f"world 1 mesh proofs {digests} != JAX {want}")
    calls.check("mesh", results)

    for world in MESH_WORLDS:
        t = time.perf_counter()
        ranks = run_ranks(_mesh_rank, world, "gloo", MESH_TIMEOUT_S,
                          _mesh_tasks(world))
        log(f"[mesh] world {world} (gloo, one card): "
            f"{time.perf_counter() - t:.1f}s with the spawn")
        for r in ranks:
            b = r["bench"]
            mem = _mesh_memory(sum(v for _, v in b["pk_rows"].values()),
                               b["peak_bytes"], b["start_bytes"],
                               b["staged_bytes"], b["local"])
            log(f"[mesh] world {world} rank {r['rank']}: "
                f"{_mesh_memory_text(mem, mem1)}")
            if not mem["local"]:
                raise AssertionError(f"world {world} rank {r['rank']} kept "
                                     f"whole tensors at k={K}")
            hashes = {hashlib.sha256(p).hexdigest() for p in b["proofs"]}
            log(f"[mesh] world {world} rank {r['rank']} ({r['backend']}, "
                f"{r['device']}): create_proof cold {b['times'][0]:.3f}s, "
                f"warm {b['times'][1]:.3f}s; staged {r['staged_bytes']} "
                f"bytes; warm launches {b['launches']}; mesh counts "
                f"{b['counts']}; ntt 2^16 equal {r['ntt']['single']}; "
                f"commit equal {r['commit']['mesh'] == r['commit']['single']}"
                f"; plain checks {r['plain_checks']}")
            if hashes != {want}:
                raise AssertionError(f"world {world} rank {r['rank']}: "
                                     f"{hashes} != JAX {want}")
            if not (r["ntt"]["single"]
                    and r["commit"]["mesh"] == r["commit"]["single"]):
                raise AssertionError(f"world {world} rank {r['rank']}: the "
                                     f"sharded NTT or commit differs")
            if r["staged_bytes"] == 0:
                raise AssertionError("gloo on the card staged nothing")
            if world == 2:
                lk = hashlib.sha256(r["lookup"]["proofs"][0]).hexdigest()
                log(f"[mesh] world 2 rank {r['rank']}: dev_lookup k={K} "
                    f"{r['lookup']['times'][0]:.3f}s, sha256 {lk}")
                if lk != REF_SHA256["dev-lookup", K]:
                    raise AssertionError(f"world 2 dev_lookup {lk}")
        first = ranks[0]
        for name in MAIN_PATH_KERNELS + ("padd",):
            results[name][f"mesh_launches_d{world}"] = \
                first["bench"]["launches"][name]
        outs = {r["ntt"]["out"].tobytes() for r in ranks}
        if len(outs) != 1:
            raise AssertionError(f"world {world}: ranks gathered different "
                                 f"NTTs")
    log("[mesh] every rank's proof equals the JAX reference's")


def run_phase(phase, *args):
    t = time.perf_counter()
    ret = phase(*args)
    log(f"[time] {phase.__name__} {time.perf_counter() - t:.1f}s")
    return ret


def kernel_records() -> tuple:
    """(results, paths): each kernel's record (route, source, the TPU
    kernel it replaces; the phases add its numbers) and the path whose
    launches its `launches` counts."""
    src = "halo2_tpu_torch/csrc/"
    results = {
        "fmul": {"route": "cuda", "source": src + "field_kernels.cu",
                 "replaces": "halo2_tpu/ops/pallas_field.py:30"},
        "faddsub": {"route": "cuda", "source": src + "field_kernels.cu",
                    "replaces": "halo2_tpu/fields/device.py:335 (jnp; "
                                "no Pallas kernel)"},
        "pmixed_masked": {"route": "cuda", "source": src + "point_kernels.cu",
                          "replaces": "halo2_tpu/ops/pallas_point.py:297"},
        "pmixed_bucket_runs": {"route": "cuda",
                               "source": src + "point_kernels.cu",
                               "replaces": "halo2_tpu/ops/pallas_point.py:297"
                                           " (B2 run round by round, "
                                           "msm_pallas.py:327-397)"},
        "padd_masked": {"route": "cuda", "source": src + "point_kernels.cu",
                        "replaces": "halo2_tpu/ops/pallas_point.py:281"},
        "padd": {"route": "cuda", "source": src + "point_kernels.cu",
                 "replaces": "halo2_tpu/ops/pallas_point.py:266"},
        "pdouble": {"route": "cuda", "source": src + "point_kernels.cu",
                    "replaces": "halo2_tpu/ops/pallas_point.py:274"},
        "pdouble_masked": {"route": "cuda",
                           "source": src + "point_kernels.cu",
                           "replaces": "halo2_tpu/ops/pallas_point.py:330"},
        "glv_ladder": {"route": "cuda", "source": src + "point_kernels.cu",
                       "replaces": "halo2_tpu/ops/ipa_device.py:219 "
                                   "(fori_loop of pallas_point.py:274 "
                                   "and :281)"},
        "scalar_mul_ladder": {"route": "cuda",
                              "source": src + "point_kernels.cu",
                              "replaces": "halo2_tpu/curves/device.py:151 "
                                          "(batch_scalar_mul's fori_loop "
                                          "of jnp pdouble, padd, pselect; "
                                          "no Pallas kernel)"},
        "ntt": {"route": "cuda", "source": src + "ntt_kernels.cu",
                "replaces": "halo2_tpu/ops/pallas_field.py:169"},
        "fmul_limbs_first": {"route": "cuda",
                             "source": src + "field_kernels.cu",
                             "replaces": "scripts/bench_fmul3d.py:29"},
        "mxu": {"route": "cuda", "source": src + "mxu_kernels.cu",
                "replaces": "halo2_tpu/ops/mxu_field.py:98 (mul_const_"
                            "grouped, an XLA dot_general on the MXU, and "
                            "the butterfly around it, :175-194; no Pallas "
                            "kernel)"},
        "gate_chunk": {"route": "cuda", "source": src + "gate_kernels.cu",
                       "replaces": "halo2_tpu/plonk/prover.py:220-255 (a "
                                   "jitted gate chunk; no Pallas kernel)"},
    }
    paths = {name: "main" for name in MAIN_PATH_KERNELS}
    paths.update(padd="ipa", glv_ladder="ipa", scalar_mul_ladder="srs",
                 mxu="ref-k", gate_chunk="sha256",
                 pdouble=None,
                 pdouble_masked=None, fmul_limbs_first=None,
                 pmixed_masked=None)
    return results, paths


def main() -> int:
    try:
        import torch
    except ImportError:
        print("PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    try:
        import halo2_tpu_torch  # noqa: F401
    except ImportError:
        print("halo2_tpu_torch not found: run from the repository root",
              file=sys.stderr)
        return 2
    global HBM_BYTES_PER_S, MULADD_PER_S, MONT_MULADDS, bound_ms
    from halo2_tpu_torch.parallel.profiling import (
        HBM_BYTES_PER_S, MULADD_PER_S, MONT_MULADDS, bound_ms)
    results, paths = kernel_records()
    t_all = time.perf_counter()
    phase_card()
    run_phase(phase_build)
    run_phase(phase_peak)
    run_phase(phase_field, results)
    run_phase(phase_ntt, results)
    run_phase(phase_mxu, results)
    run_phase(phase_layout, results)
    *state, shapes = run_phase(phase_main_path, results)
    run_phase(phase_ntt_main, results, shapes)
    run_phase(phase_points, results, state[0])
    run_phase(phase_add_double, results, state[0])
    run_phase(phase_ladder, results, state[0])
    run_phase(phase_scalar_ladder, results, state[0])
    run_phase(phase_commit, state[0])
    run_phase(phase_horner, state[0], results)
    run_phase(phase_profile, *state)
    run_phase(phase_ipa, results, *state)
    run_phase(phase_verify, results, *state)
    run_phase(phase_v1, results, state[0])
    run_phase(phase_mock, results)
    run_phase(phase_gadgets, results, state)
    run_phase(phase_sha256, results)
    params_ref_k = run_phase(phase_reference_k, results)
    run_phase(phase_bucket, results, state[0], params_ref_k)
    widths = run_phase(phase_lookup, results, state[0], params_ref_k)
    del params_ref_k
    run_phase(phase_b3_widths, results, state[0], widths)
    run_phase(phase_srs, results)
    run_phase(phase_mesh, results)
    kernels = [{"name": name, "route": r["route"], "source": r["source"],
                "replaces": r["replaces"], "path": paths[name],
                "launches": r["launches"],
                "max_abs_err": r["max_abs_err"],
                "mismatches": r["mismatches"], "ms": r["ms"],
                "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"),
                "shape": r["shape"],
                **{k: v for k, v in r.items() if k.startswith(
                    ("ms_", "bound_ms_", "call_ms_", "b1_ms_", "lookup_",
                     "graph_ms", "profiler_ms", "srs_", "verify_", "v1_",
                     "mock_", "gadgets_", "sha256_", "mesh_",
                     "launches_offset_", "forms", "form_", "horner_",
                     "four_step_", "b7_ms_", "library_ms_", "eager_",
                     "chunked_", "plain_rows", "ipa_", "passes_",
                     "launches_warm_", "kernels_a_", "register_",
                     "instructions", "slots", "columns_", "products_"))}}
               for name, r in results.items()]
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
