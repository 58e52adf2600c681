"""Record the JAX reference's proof hash for chip_smoke.py.

Proves a circuit of halo2_tpu_torch/bench_circuit.py with the JAX
package halo2_tpu at 2^k rows over PALLAS Params, at the fixed witness
and RNG seed that chip_smoke.py uses, and prints the sha256 of the proof
bytes: BenchCircuit (`--circuit bench`, witness SEED_A) or halo2's
dev_lookup circuit (`--circuit dev-lookup`, an 8-bit table and 2^10
looked-up rows); or, at K = 11 over VESTA Params, a golden gadget
circuit of halo2_tpu_torch/gadget_circuits.py built from the JAX
package's gadgets (`--circuit ecc|sinsemilla|merkle|lookup-range-check`:
ecc_chip, sinsemilla_chip, merkle_chip, lookup_range_check; `--k` does
not apply); or halo2's SHA-256 bench circuit of
halo2_tpu_torch/sha256_circuits.py (`--circuit sha256`: Table16 hashing
31 words, at k = 17 over PALLAS Params; `--k` does not apply); or,
with `--circuit params`, no proof: the sha256 of
`Params.new(PALLAS, k, use_cache=False).write()`, the bytes of g, its
Lagrange basis (the native library's group iNTT), w and u. It lives
outside halo2_tpu_torch because it imports the reference, which the port
never does. Run on a CPU, from the repository root:

    JAX_PLATFORMS=cpu python reference_proof_hash.py --circuit bench --k 14
    JAX_PLATFORMS=cpu python reference_proof_hash.py \
        --circuit dev-lookup --k 14
    JAX_PLATFORMS=cpu python reference_proof_hash.py \
        --circuit bench --planner v1 --k 14
    JAX_PLATFORMS=cpu python reference_proof_hash.py \
        --circuit bench --transcript poseidon --k 14
    JAX_PLATFORMS=cpu python reference_proof_hash.py --circuit ecc
    JAX_PLATFORMS=cpu python reference_proof_hash.py --circuit sinsemilla
    JAX_PLATFORMS=cpu python reference_proof_hash.py --circuit merkle
    JAX_PLATFORMS=cpu python reference_proof_hash.py \
        --circuit lookup-range-check
    JAX_PLATFORMS=cpu python reference_proof_hash.py --circuit sha256
    JAX_PLATFORMS=cpu python reference_proof_hash.py --circuit params --k 18

On an 8-core CPU `--circuit sha256` takes about 68 minutes (4,068 s:
Params.new and the circuit 61 s, the keygens 23 s, the prove 3,983 s).

`--planner v1` lays BenchCircuit out with the V1 floor planner (the
default is the simple planner); it applies to `--circuit bench` only.
`--transcript poseidon` proves with the algebraic (Poseidon) transcript
instead of Blake2b; it applies to `--circuit bench` only.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import random
import time

from halo2_tpu_torch.bench_circuit import (bench_circuit_class,
                                           dev_lookup_circuit_class,
                                           regions_for_k, expected_output,
                                           SEED_A, PROOF_SEED)
from halo2_tpu_torch import gadget_circuits, sha256_circuits

# --circuit -> the golden gadget circuit it proves
GADGETS = {"ecc": "ecc_chip", "sinsemilla": "sinsemilla_chip",
           "merkle": "merkle_chip", "lookup-range-check": "lookup_range_check"}


def reference_namespace(module=gadget_circuits):
    """The classes of gadget_circuits (or sha256_circuits) from the JAX
    package."""
    import importlib
    return module.namespace(
        lambda mod: importlib.import_module(f"halo2_tpu.{mod}"))


def reference_circuit(name: str, k: int, planner: str = "simple"):
    """(curve, k, circuit, instances, description) of `--circuit name`,
    built from the JAX package's classes."""
    from halo2_tpu.curves import PALLAS, VESTA
    from halo2_tpu.poly.polynomial import Rotation
    from halo2_tpu.circuit import Circuit, Value

    fs = PALLAS.scalar
    if name in GADGETS:
        circuit = gadget_circuits.golden_circuit(reference_namespace(),
                                                 GADGETS[name])
        return VESTA, gadget_circuits.K, circuit, [[]], GADGETS[name]
    if name == "sha256":
        circuit = sha256_circuits.table16_circuit(
            reference_namespace(sha256_circuits), "bench")
        return (PALLAS, sha256_circuits.K_TABLE16, circuit, [[]],
                f"table16 words={sha256_circuits.BENCH_WORDS}")
    if name == "bench":
        regions = regions_for_k(k)
        circuit = bench_circuit_class(Circuit, Value, Rotation, fs,
                                      planner)(SEED_A, regions)
        return (PALLAS, k, circuit,
                [[[expected_output(fs, SEED_A, regions)]]],
                f"regions={regions} planner={planner}")
    circuit = dev_lookup_circuit_class(Circuit, Value, Rotation, fs)()
    return (PALLAS, k, circuit, [[]],
            f"table_bits={circuit.table_bits} rows={circuit.rows}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--circuit",
                    choices=("bench", "dev-lookup", "sha256", "params",
                             *GADGETS),
                    default="bench")
    ap.add_argument("--k", type=int, default=14)
    ap.add_argument("--planner", choices=("simple", "v1"),
                    default="simple")
    ap.add_argument("--transcript", choices=("blake2b", "poseidon"),
                    default="blake2b")
    args = ap.parse_args()
    if args.planner != "simple" and args.circuit != "bench":
        ap.error("--planner applies to --circuit bench only")
    if args.transcript != "blake2b" and args.circuit != "bench":
        ap.error("--transcript applies to --circuit bench only")
    # commit on the reference's exact host MSM: the group elements, hence
    # the proof bytes, are the same as through its device Pippenger. The
    # reference reads this when halo2_tpu.ops.msm is first imported.
    os.environ.setdefault("HALO2_TPU_HOST_MSM_THRESHOLD", str(1 << 30))
    from halo2_tpu.transcript import TranscriptWrite, PoseidonTranscriptWrite
    from halo2_tpu.poly import Params
    from halo2_tpu.plonk import keygen_vk, keygen_pk, create_proof

    t0 = time.perf_counter()
    if args.circuit == "params":
        from halo2_tpu.curves import PALLAS
        data = Params.new(PALLAS, args.k, use_cache=False).write()
        print(f"params k={args.k} bytes={len(data)} "
              f"seconds={time.perf_counter() - t0:.1f}")
        print(hashlib.sha256(data).hexdigest())
        return
    curve, k, circuit, instances, what = reference_circuit(
        args.circuit, args.k, args.planner)
    if args.circuit == "bench":
        what += f" transcript={args.transcript}"
    writer = (PoseidonTranscriptWrite if args.transcript == "poseidon"
              else TranscriptWrite)
    params = Params.new(curve, k, use_cache=False)
    t1 = time.perf_counter()
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    t2 = time.perf_counter()
    tw = writer(curve)
    create_proof(params, pk, [circuit], instances,
                 random.Random(PROOF_SEED), tw)
    proof = tw.finalize()
    t3 = time.perf_counter()
    print(f"circuit={args.circuit} k={k} {what} "
          f"proof_bytes={len(proof)} seconds={t3 - t0:.1f} "
          f"(Params.new and the circuit {t1 - t0:.1f}, keygens "
          f"{t2 - t1:.1f}, prove {t3 - t2:.1f})")
    print(hashlib.sha256(proof).hexdigest())


if __name__ == "__main__":
    main()
