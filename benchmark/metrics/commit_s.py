"""commit_s: seconds a proof spends committing to and transforming the
instance and advice columns: the prover's laps named below, averaged over
the window's proofs."""
from benchmark.trace import per_phase

PHASES = {"instance commit+ntt", "advice: commit", "advice: ntt+extend"}


def read(run):
    return per_phase(run["laps"], PHASES)
