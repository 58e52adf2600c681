"""Time warm BenchCircuit proves of the port at 2^k rows on the GPU.

Imports halo2_tpu_torch from the current directory, so the same script
times two checkouts in turns, for example a parent commit unpacked with
`git archive` and the working tree, in one call on one card:

    (cd parent && python3 ../prove_times.py parent)
    python3 prove_times.py change

Prints one JSON line: the label, the wall time of each warm prove (the
first prove is cold and not counted), their median, the median of the
phases that hold the domain transforms, and the last prove's phases.
"""
import json
import os
import random
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from halo2_tpu_torch.bench_circuit import (BenchCircuit, regions_for_k,  # noqa: E402
                                           expected_output, SEED_A,
                                           PROOF_SEED)
from halo2_tpu_torch.curves.host import PALLAS  # noqa: E402
from halo2_tpu_torch.plonk import prover as pv  # noqa: E402
from halo2_tpu_torch.plonk.keygen import keygen_vk, keygen_pk  # noqa: E402
from halo2_tpu_torch.poly.commitment import Params  # noqa: E402
from halo2_tpu_torch.transcript import TranscriptWrite  # noqa: E402

K = 14
PROVES = 8
TRANSFORM_PHASES = ("advice: ntt+extend", "instance commit+ntt")


def main() -> None:
    label = sys.argv[1]
    regions = regions_for_k(K)
    out = expected_output(PALLAS.scalar, SEED_A, regions)
    circuit = BenchCircuit(SEED_A, regions)
    params = Params.new(PALLAS, K)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    times, ntt_s = [], []
    for i in range(PROVES):
        tw = TranscriptWrite(PALLAS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pv.create_proof(params, pk, [circuit], [[[out]]],
                        random.Random(PROOF_SEED), tw)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
            phases = dict(pv.LAST_PHASES)
            ntt_s.append(sum(phases.get(n, 0) for n in TRANSFORM_PHASES))
    print(json.dumps({
        "label": label, "times": times, "median": statistics.median(times),
        "ntt_phases_median": statistics.median(ntt_s),
        "phases": {n: round(s, 4) for n, s in pv.LAST_PHASES}}), flush=True)


if __name__ == "__main__":
    main()
