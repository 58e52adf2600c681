"""h2d_mib: MiB a proof copied from host memory to the card, the counter
`h2d.bytes` (every named upload site), averaged over the window's
untraced proofs (the program's records, benchmark/program_spans.py)."""
from benchmark.program_spans import counter, untraced


def read(run):
    value = counter(untraced(run), "h2d.bytes")
    return None if value is None else value / 2 ** 20
