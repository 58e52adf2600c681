"""powers_s: seconds a proof building `powers` tables on the host on a
cache miss, their upload included: the spans `powers.build` of every
phase, averaged over the window's untraced proofs (the program's
records, benchmark/program_spans.py)."""
from benchmark.program_spans import span_seconds, untraced


def read(run):
    return span_seconds(untraced(run), "powers.build")
