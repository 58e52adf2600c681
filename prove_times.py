"""Time warm BenchCircuit proves of the port at 2^k rows on the GPU.

Imports halo2_tpu_torch from the current directory, so the same script
times two checkouts in turns, for example a parent commit unpacked with
`git archive` and the working tree, in one call on one card:

    (cd parent && python3 ../prove_times.py parent)
    python3 prove_times.py change

A second argument is the IPA schedule's native_ipa_threshold (0 runs
every IPA round on the card; the default schedule when it is left out).

Prints one JSON line: the label, the threshold, the wall time of each
warm prove (the first prove is cold and not counted), their median, the
medians of the phases that hold the domain transforms and of the IPA
open (`multiopen+ipa`), the median of every phase, and the last prove's
phases.
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
IPA_PHASE = "multiopen+ipa"


def main() -> None:
    label = sys.argv[1]
    threshold = int(sys.argv[2]) if len(sys.argv) > 2 else None
    kw = {} if threshold is None else {"native_ipa_threshold": threshold}
    regions = regions_for_k(K)
    out = expected_output(PALLAS.scalar, SEED_A, regions)
    circuit = BenchCircuit(SEED_A, regions)
    params = Params.new(PALLAS, K)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, vk, circuit)
    times, ntt_s, ipa_s, per_phase = [], [], [], {}
    for i in range(PROVES):
        tw = TranscriptWrite(PALLAS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pv.create_proof(params, pk, [circuit], [[[out]]],
                        random.Random(PROOF_SEED), tw, **kw)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t)
            phases = dict(pv.LAST_PHASES)
            ntt_s.append(sum(phases.get(n, 0) for n in TRANSFORM_PHASES))
            ipa_s.append(phases[IPA_PHASE])
            for name, sec in phases.items():
                per_phase.setdefault(name, []).append(sec)
    print(json.dumps({
        "label": label, "native_ipa_threshold": threshold, "times": times,
        "median": statistics.median(times),
        "ntt_phases_median": statistics.median(ntt_s),
        "ipa_phase_median": statistics.median(ipa_s),
        "phase_medians": {n: round(statistics.median(v), 4)
                          for n, v in per_phase.items()},
        "phases": {n: round(s, 4) for n, s in pv.LAST_PHASES}}), flush=True)


if __name__ == "__main__":
    main()
