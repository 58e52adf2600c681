"""powers_misses: `powers` tables built a proof, the counter `powers.miss`
(a table asked for and not in the cache), averaged over the window's
untraced proofs (the program's records, benchmark/program_spans.py)."""
from benchmark.program_spans import counter, untraced


def read(run):
    return counter(untraced(run), "powers.miss")
