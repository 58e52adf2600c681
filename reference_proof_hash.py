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
not apply). It lives outside halo2_tpu_torch because it imports the
reference, which the port never does. Run on a CPU, from the repository
root:

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
from halo2_tpu_torch import gadget_circuits

# --circuit -> the golden gadget circuit it proves
GADGETS = {"ecc": "ecc_chip", "sinsemilla": "sinsemilla_chip",
           "merkle": "merkle_chip", "lookup-range-check": "lookup_range_check"}


def reference_namespace():
    """gadget_circuits' classes from the JAX package."""
    import importlib
    return gadget_circuits.namespace(
        lambda mod: importlib.import_module(f"halo2_tpu.{mod}"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--circuit",
                    choices=("bench", "dev-lookup", *GADGETS),
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
    from halo2_tpu.curves import PALLAS, VESTA
    from halo2_tpu.transcript import TranscriptWrite, PoseidonTranscriptWrite
    from halo2_tpu.poly import Params
    from halo2_tpu.poly.polynomial import Rotation
    from halo2_tpu.circuit import Circuit, Value
    from halo2_tpu.plonk import keygen_vk, keygen_pk, create_proof

    t0 = time.perf_counter()
    fs = PALLAS.scalar
    curve, k = PALLAS, args.k
    writer = (PoseidonTranscriptWrite if args.transcript == "poseidon"
              else TranscriptWrite)
    if args.circuit in GADGETS:
        curve, k = VESTA, gadget_circuits.K
        circuit = gadget_circuits.golden_circuit(reference_namespace(),
                                                 GADGETS[args.circuit])
        instances = [[]]
        what = GADGETS[args.circuit]
    elif args.circuit == "bench":
        regions = regions_for_k(args.k)
        circuit = bench_circuit_class(Circuit, Value, Rotation, fs,
                                      args.planner)(SEED_A, regions)
        instances = [[[expected_output(fs, SEED_A, regions)]]]
        what = (f"regions={regions} planner={args.planner} "
                f"transcript={args.transcript}")
    else:
        circuit = dev_lookup_circuit_class(Circuit, Value, Rotation, fs)()
        instances = [[]]
        what = f"table_bits={circuit.table_bits} rows={circuit.rows}"
    params = Params.new(curve, k, use_cache=False)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    tw = writer(curve)
    create_proof(params, pk, [circuit], instances,
                 random.Random(PROOF_SEED), tw)
    proof = tw.finalize()
    print(f"circuit={args.circuit} k={k} {what} "
          f"proof_bytes={len(proof)} seconds={time.perf_counter() - t0:.1f}")
    print(hashlib.sha256(proof).hexdigest())


if __name__ == "__main__":
    main()
