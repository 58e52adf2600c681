"""multiopen_kate_s: seconds a proof in the multiopen's chained Kate
divisions and their x2 fold, `powers` tables included: the span
`multiopen.kate`, averaged over the window's untraced proofs (the
program's records, benchmark/program_spans.py)."""
from benchmark.program_spans import span_seconds, untraced


def read(run):
    return span_seconds(untraced(run), "multiopen.kate")
