"""arguments_s: seconds a proof spends in the lookup, permutation and
vanishing arguments and the evaluations: the prover's laps named below,
averaged over the window's proofs."""
from benchmark.trace import per_phase

PHASES = {"lookup permuted", "permutation z", "lookup products",
          "vanishing random", "h terms build",
          "vanishing construct (h commit)", "evals"}


def read(run):
    return per_phase(run["laps"], PHASES)
