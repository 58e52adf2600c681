"""The program's own records of a --trace 1 run's proofs
(halo2_tpu_torch/tracing.py), for the per-layer metrics that read its
spans and counters.

The recorder keeps the last proofs' records in tracing.PROOFS, oldest
first. After the window the ring ends with the window's proofs: the
traced ones (run["trace"]["proofs"] of them), then the untraced ones,
whose laps the lap metrics average (len(run["laps"]) of them). Where the
program has no recorder, or the ring holds too few records, these give
None, so that a reader never reads another proof's record.
"""
from __future__ import annotations

import importlib


def tracing():
    """The program's recorder module, or None where it has none."""
    try:
        return importlib.import_module("halo2_tpu_torch.tracing")
    except ImportError:
        return None


def untraced(run) -> list | None:
    """The records of the window's untraced proofs, oldest first."""
    t = tracing()
    n = len(run["laps"])
    if t is None or n == 0 or len(t.PROOFS) < n:
        return None
    return list(t.PROOFS)[-n:]


def traced(run) -> list | None:
    """The records of the window's traced proofs, oldest first."""
    t = tracing()
    if t is None or not run["trace"]:
        return None
    n, p = len(run["laps"]), run["trace"]["proofs"]
    if p == 0 or len(t.PROOFS) < n + p:
        return None
    return list(t.PROOFS)[-n - p:-n] if n else list(t.PROOFS)[-p:]


def keygen():
    """The record of the cell's keygen_vk and keygen_pk."""
    t = tracing()
    return None if t is None else t.LAST_KEYGEN


def span_seconds(records, name: str) -> float | None:
    """Inclusive seconds of the spans `name` a record, averaged over the
    records; None where none has such a span."""
    if not records or not any(s.name == name for r in records
                              for s in r.spans):
        return None
    return sum(r.seconds(name) for r in records) / len(records)


def counter(records, name: str) -> float | None:
    """The counter `name` a record, averaged over the records; None where
    none counted it."""
    if not records or not any(name in r.counters for r in records):
        return None
    return sum(r.counters.get(name, 0) for r in records) / len(records)
