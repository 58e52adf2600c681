"""synthesis_s: seconds a proof spends in host synthesis, the prover's
`advice: synthesis` lap, averaged over the window's proofs."""
from benchmark.trace import per_phase


def read(run):
    return per_phase(run["laps"], {"advice: synthesis"})
