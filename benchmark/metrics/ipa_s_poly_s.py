"""ipa_s_poly_s: seconds a proof drawing the IPA's random polynomial S,
its value at x3, its upload and its commit: the span `ipa.s_poly`,
averaged over the window's untraced proofs (the program's records,
benchmark/program_spans.py)."""
from benchmark.program_spans import span_seconds, untraced


def read(run):
    return span_seconds(untraced(run), "ipa.s_poly")
