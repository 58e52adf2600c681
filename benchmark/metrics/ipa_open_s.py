"""ipa_open_s: seconds a proof spends in the multiopen and the IPA
opening, the prover's `multiopen+ipa` lap, averaged over the window's
proofs."""
from benchmark.trace import per_phase


def read(run):
    return per_phase(run["laps"], {"multiopen+ipa"})
