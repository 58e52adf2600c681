"""ipa_native_s: seconds a proof in the IPA open's native host rounds,
the span `ipa.native` (the native session's start, every round and fold,
final_c), averaged over the window's untraced proofs (the program's
records, benchmark/program_spans.py)."""
from benchmark.program_spans import span_seconds, untraced


def read(run):
    return span_seconds(untraced(run), "ipa.native")
