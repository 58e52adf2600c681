"""Synthesis tracing: per-region spans + per-assignment events.

Analogue of the reference's TracingFloorPlanner / TracingAssignment /
TracingLayouter (halo2_proofs/src/dev/tfp.rs:78-478), which wrap any
floor planner and emit `tracing` spans for every region and debug events
for every assignment during keygen and proving.

TPU-native shape: synthesis is dispatched through
`halo2_tpu_torch.circuit.synthesize_circuit`, so tracing interposes on the
*Assignment sink* rather than the planner type. Attach with

    events = attach_tracing(circuit)          # or pass your own list
    keygen_vk(params, circuit)                # or MockProver / prove
    # events now holds RegionSpan records (+ python logging at DEBUG)

Every sink call is forwarded unchanged — layout, vk, and proof bytes are
identical with tracing attached (the wrapper adds observation only).

Copied from halo2_tpu/dev/tfp.py: the port keeps its own copy of every
host module it needs and imports nothing of halo2_tpu.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field

logger = logging.getLogger("halo2_tpu_torch.tfp")


@dataclass
class RegionSpan:
    """One enter/exit region span with aggregate assignment counts
    (tfp.rs emits a span per region and an event per assignment)."""
    name: str
    index: int
    advice: int = 0
    fixed: int = 0
    selectors: int = 0
    copies: int = 0
    fills: int = 0
    namespaces: list = field(default_factory=list)

    def total(self) -> int:
        return (self.advice + self.fixed + self.selectors + self.copies
                + self.fills)


class TracingAssignment:
    """Forwarding Assignment sink that records RegionSpans and logs every
    call at DEBUG (dev/tfp.rs:229-478). Works over any sink (keygen
    Assembly, prover WitnessCollection, MockProver) including the batch
    extension methods, which count one event per stamped row."""

    def __init__(self, inner, events: list | None = None):
        self.inner = inner
        self.events: list[RegionSpan] = [] if events is None else events
        self._current: RegionSpan | None = None
        self._region_counter = 0
        self._ns_stack: list[str] = []

    # anything not intercepted (usable_rows, k, advice arrays, batch
    # capability probes via hasattr) resolves on the wrapped sink
    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _bump(self, kind: str, count: int = 1):
        if self._current is not None:
            setattr(self._current, kind,
                    getattr(self._current, kind) + count)

    # ---- region spans ----
    def enter_region(self, name):
        span = RegionSpan(name=str(name), index=self._region_counter,
                          namespaces=list(self._ns_stack))
        self._region_counter += 1
        self._current = span
        self.events.append(span)
        logger.debug("enter_region name=%s index=%d", span.name, span.index)
        return self.inner.enter_region(name)

    def exit_region(self):
        if self._current is not None:
            logger.debug("exit_region name=%s assignments=%d",
                         self._current.name, self._current.total())
        self._current = None
        return self.inner.exit_region()

    # ---- assignments ----
    def enable_selector(self, annotation, selector, row):
        logger.debug("enable_selector %s row=%d", annotation, row)
        self._bump("selectors")
        return self.inner.enable_selector(annotation, selector, row)

    def assign_advice(self, annotation, column, row, to):
        logger.debug("assign_advice %s col=%s row=%d",
                     annotation, column, row)
        self._bump("advice")
        return self.inner.assign_advice(annotation, column, row, to)

    def assign_fixed(self, annotation, column, row, to):
        logger.debug("assign_fixed %s col=%s row=%d",
                     annotation, column, row)
        self._bump("fixed")
        return self.inner.assign_fixed(annotation, column, row, to)

    def copy(self, left_column, left_row, right_column, right_row):
        logger.debug("copy (%s,%d) <-> (%s,%d)",
                     left_column, left_row, right_column, right_row)
        self._bump("copies")
        return self.inner.copy(left_column, left_row,
                               right_column, right_row)

    def fill_from_row(self, column, row, to):
        logger.debug("fill_from_row col=%s from=%d", column, row)
        self._bump("fills")
        return self.inner.fill_from_row(column, row, to)

    def query_instance(self, column, row):
        logger.debug("query_instance col=%s row=%d", column, row)
        return self.inner.query_instance(column, row)

    # ---- namespaces (tfp.rs:452-466) ----
    def push_namespace(self, name):
        self._ns_stack.append(str(name))
        logger.debug("push_namespace %s", name)
        return self.inner.push_namespace(name)

    def pop_namespace(self, gadget_name=None):
        if self._ns_stack:
            self._ns_stack.pop()
        logger.debug("pop_namespace %s", gadget_name)
        return self.inner.pop_namespace(gadget_name)


class TracingBatchAssignment(TracingAssignment):
    """TracingAssignment over a sink that implements the batch synthesis
    extension. A separate subclass so `hasattr(sink, 'assign_advice_batch')`
    capability probes in SingleChipLayouter stay truthful when the
    wrapped sink has no batch methods."""

    # ---- batch synthesis extension (one event per stamped row) ----
    def assign_advice_batch(self, annotation, column, rows, values):
        logger.debug("assign_advice_batch %s col=%s rows=%d",
                     annotation, column, len(rows))
        self._bump("advice", len(rows))
        return self.inner.assign_advice_batch(annotation, column, rows,
                                              values)

    def assign_fixed_batch(self, annotation, column, rows, values):
        logger.debug("assign_fixed_batch %s col=%s rows=%d",
                     annotation, column, len(rows))
        self._bump("fixed", len(rows))
        return self.inner.assign_fixed_batch(annotation, column, rows,
                                             values)

    def enable_selector_batch(self, annotation, selector, rows):
        logger.debug("enable_selector_batch %s rows=%d",
                     annotation, len(rows))
        self._bump("selectors", len(rows))
        return self.inner.enable_selector_batch(annotation, selector, rows)

    def copy_batch(self, col_a, rows_a, col_b, rows_b):
        logger.debug("copy_batch %s<->%s rows=%d", col_a, col_b,
                     len(rows_a))
        self._bump("copies", len(rows_a))
        return self.inner.copy_batch(col_a, rows_a, col_b, rows_b)


def wrap_sink(inner, events: list | None = None) -> TracingAssignment:
    """Wrap an Assignment sink in the tracing variant matching its
    capabilities."""
    cls = (TracingBatchAssignment
           if hasattr(inner, "assign_advice_batch") else TracingAssignment)
    return cls(inner, events)


def attach_tracing(circuit, events: list | None = None) -> list:
    """Mark `circuit` so every synthesis of it (keygen, witness
    collection, MockProver) runs through a TracingAssignment; returns the
    shared events list that successive runs append RegionSpans to."""
    if events is None:
        events = []
    circuit._tfp_events = events
    return events


def detach_tracing(circuit) -> None:
    if hasattr(circuit, "_tfp_events"):
        del circuit._tfp_events
