#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (halo2_tpu_torch) on one NVIDIA GPU.

Phases (any failure exits non-zero):
  1. the card's name and power limit, torch and CUDA versions;
  2. build every CUDA kernel from csrc/ (one nvcc per source, in parallel);
  3. kernel B1 (Montgomery multiply) and the field add/sub kernel against
     their plain PyTorch versions, bit-exact, 2^20 operands + edges, both
     fields;
  4. kernels B2 (masked mixed add) and B3 (masked complete add) against
     their plain versions, bit-exact, at the lane count of a k=14 commit,
     with random masks and signs and identity-coded bases;
  5. k=14 commits (random, all-zero, all-equal columns) against the native
     host MSM, exact affine equality;
  6. the main path at k=14: Params.new, keygen_vk, keygen_pk, create_proof
     twice (cold, warm), verify_proof, a wrong public input rejected, and
     the proof's sha256 against the JAX reference's recorded hash;
  7. the warm k=14 prove once more under torch.profiler: device time by
     kernel and the device's busy share of the wall time;
  8. BenchCircuit proved at 2^REF_K rows, the largest size the JAX
     reference was run at, and its proof's sha256 against that run's;
  9. a `kernels` JSON line: launches on the main path, mismatches, each
     kernel's device time per launch (torch.profiler) beside its bound,
     the wrapper's time per call (CUDA events) and the plain version's;
and, last, {"ok": true, "device": {...}}.

Run from the repository root: python3 chip_smoke.py
"""
from __future__ import annotations

import hashlib
import json
import random
import subprocess
import sys
import time

K = 14
# sha256 of the JAX reference's BenchCircuit proof at 2^k rows, witness
# SEED_A and rng seed PROOF_SEED (python reference_proof_hash.py --k k,
# on a CPU); REF_K is the largest k that run was made at
REF_SHA256 = {
    14: "d74239f9d0320f99b2fc80c89ab5df1ad8a8d2588dc7541eb6017078e986a12f",
    18: "87c0cff028bdb678cd0b99461464b033d82e345153d261b8573b55c145515abe",
}
REF_K = 18

# the card's peaks (H100 SXM at 700 W)
HBM_BYTES_PER_S = 3.35e12
# 67 TFLOP/s of 32-bit non-tensor work = 33.5e12 multiply-adds/s; each
# 32x32->64 product counts as two 32-bit multiply-adds (low and high word)
MULADD_PER_S = 33.5e12
MONT_MULADDS = 2 * 112      # 64 products for a*b + 48 for the reduction


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls, CUDA events, after a warm-up:
    the wall time of the calls on the stream, host work between launches
    included."""
    import torch
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


def device_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time per launch of the CUDA kernel `kernel` over `reps`
    calls of fn, from torch.profiler: the kernel alone, without the
    wrapper's host work between launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            total += _device_us(ev)
            count += ev.count
    if count == 0:
        raise RuntimeError(f"the profiler saw no launch of {kernel}")
    return total / count / 1e3


def max_abs(got, want) -> int:
    """Largest digit difference (0 when bit-exact)."""
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def bound_ms(nbytes: float, muladds: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = muladds / MULADD_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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


def rand_field(df, n, rng, device):
    import torch
    from halo2_tpu_torch.fields.device import ints_to_digits
    p = df.spec.modulus
    vals = [rng.randrange(p) for _ in range(n - 3)] + [0, 1, p - 1]
    vals = [v * (1 << 256) % p for v in vals]
    return torch.from_numpy(ints_to_digits(vals)).to(device)


def phase_field(results):
    import torch
    from halo2_tpu_torch.fields.device import FP_DEV, FQ_DEV
    from halo2_tpu_torch.ops import field_kernels as fk
    dev = torch.device("cuda")
    rng = random.Random(11)
    n = 1 << 20
    mism = {"fmul": 0, "faddsub": 0}
    err = {"fmul": 0, "faddsub": 0}
    for df in (FP_DEV, FQ_DEV):
        a = rand_field(df, n, rng, dev)
        b = rand_field(df, n, rng, dev)
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
    a = rand_field(df, N, rng, dev)
    b = rand_field(df, N, rng, dev)
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
        ms = device_ms(fn, 50, name + "_kernel")
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

    for d in (fk.LAUNCHES, pk.LAUNCHES):   # the main path's count starts
        for key in d:
            d[key] = 0
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
        pv.create_proof(params, pk_, [circuit], [[[out]]],
                        random.Random(PROOF_SEED), tw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        proofs.append(tw.finalize())
        per_prove = {k: v - before[k] for k, v in launch_counts().items()}
        log(f"[main] create_proof {label}: {times[-1]:.3f}s, "
            f"{len(proofs[-1])} bytes, launches {per_prove}")
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
    for name in results:
        results[name]["launches"] = launches[name]
    if proofs[0] != proofs[1]:
        raise AssertionError("cold and warm proofs differ")
    digest = hashlib.sha256(proofs[1]).hexdigest()
    log(f"[main] proof sha256 {digest}")
    if digest != REF_SHA256[K]:
        raise AssertionError(f"proof hash {digest} != JAX reference "
                             f"{REF_SHA256[K]}")
    log("[main] proof bytes equal the JAX reference's")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return params, pk_, circuit, out


def launch_counts() -> dict:
    from halo2_tpu_torch.ops import field_kernels as fk
    from halo2_tpu_torch.ops import point_kernels as pk
    return {**fk.LAUNCHES, **pk.LAUNCHES}


def phase_profile(params, pk_, circuit, out):
    """One more warm prove under torch.profiler: device time by kernel and
    the busy share of the wall time. Reports "not measured" where the
    profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    from halo2_tpu_torch.bench_circuit import PROOF_SEED
    from halo2_tpu_torch.curves.host import PALLAS
    from halo2_tpu_torch.plonk import prover as pv
    from halo2_tpu_torch.transcript import TranscriptWrite
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pv.create_proof(params, pk_, [circuit], [[[out]]],
                        random.Random(PROOF_SEED), TranscriptWrite(PALLAS))
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
        log(f"[profile] warm prove {wall:.3f}s; device time not measured "
            f"(the profiler saw no device activity)")
        return
    log(f"[profile] warm prove {wall:.3f}s wall, device busy {busy:.4f}s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for dev_us, count, key in rows[:12]:
        log(f"[profile]   {dev_us / 1e3:9.3f} ms {count:6d}x {key[:90]}")


def phase_reference_k():
    """BenchCircuit at 2^REF_K rows: keygen and one proof, whose bytes
    must hash to the JAX reference's."""
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
    vk = keygen_vk(params, circuit)
    pk_ = keygen_pk(params, vk, circuit)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tw = TranscriptWrite(PALLAS)
    pv.create_proof(params, pk_, [circuit], [[[out]]],
                    random.Random(PROOF_SEED), tw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    digest = hashlib.sha256(tw.finalize()).hexdigest()
    log(f"[ref-k] k={REF_K} regions={regions}: Params.new {t1 - t0:.2f}s, "
        f"keygen {t2 - t1:.2f}s, create_proof {t3 - t2:.3f}s")
    log("[ref-k] phases " + json.dumps(
        {name: round(s, 4) for name, s in pv.LAST_PHASES}))
    log(f"[ref-k] proof sha256 {digest}")
    if digest != REF_SHA256[REF_K]:
        raise AssertionError(f"k={REF_K} proof hash {digest} != JAX "
                             f"reference {REF_SHA256[REF_K]}")
    log(f"[ref-k] proof bytes equal the JAX reference's at k={REF_K}")


def run_phase(phase, *args):
    t = time.perf_counter()
    ret = phase(*args)
    log(f"[time] {phase.__name__} {time.perf_counter() - t:.1f}s")
    return ret


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
    src = "halo2_tpu_torch/csrc/"
    results = {
        "fmul": {"route": "cuda", "source": src + "field_kernels.cu",
                 "replaces": "halo2_tpu/ops/pallas_field.py:30"},
        "faddsub": {"route": "cuda", "source": src + "field_kernels.cu",
                    "replaces": "halo2_tpu/fields/device.py:335 (jnp; "
                                "no Pallas kernel)"},
        "pmixed_masked": {"route": "cuda", "source": src + "point_kernels.cu",
                          "replaces": "halo2_tpu/ops/pallas_point.py:297"},
        "padd_masked": {"route": "cuda", "source": src + "point_kernels.cu",
                        "replaces": "halo2_tpu/ops/pallas_point.py:281"},
    }
    t_all = time.perf_counter()
    phase_card()
    run_phase(phase_build)
    run_phase(phase_field, results)
    state = run_phase(phase_main_path, results)
    run_phase(phase_points, results, state[0])
    run_phase(phase_commit, state[0])
    run_phase(phase_profile, *state)
    run_phase(phase_reference_k)
    kernels = [{"name": name, "route": r["route"], "source": r["source"],
                "replaces": r["replaces"], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"],
                "mismatches": r["mismatches"], "ms": r["ms"],
                "call_ms": r["call_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "shape": r["shape"]}
               for name, r in results.items()]
    log(f"[total] {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
