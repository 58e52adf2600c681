"""keygen_layout_s: seconds of the cell's keygen in its host layout: the
synthesis of the witness-free circuit, the selectors' compression and
the fixed columns' values, the span `keygen.layout` of keygen_vk and
keygen_pk (the program's record, benchmark/program_spans.py)."""
from benchmark.program_spans import keygen, span_seconds


def read(run):
    rec = keygen()
    return None if rec is None else span_seconds([rec], "keygen.layout")
