"""The port's one recorder: each proof's synced phase laps, its nested
host spans, its counters and its kernel launches with their work.

`record(kind)` opens a record for an entry point: create_proof opens a
"proof" record on entry and closes it in a `finally`, so a proof that
raises still leaves one; the last 64 are in PROOFS, oldest first.
keygen_vk and keygen_pk write one "keygen" record, LAST_KEYGEN (keygen_pk
of the vk that keygen_vk just made adds to it), and Params.new writes
LAST_PARAMS. Inside a record, on its thread:

  PhaseTimer     the prover's laps: each phase starts with a sync of the
                 card (torch.cuda.synchronize), so a phase owns the
                 kernels it launched; `laps` [(name, seconds)]
  span(name)     a nested host span, no sync: name, parent, start and end
                 (time.perf_counter_ns); its self time is its duration
                 less its children's
  count(name, n) a counter; h2d(site, nbytes) and upload(site, x,
                 device) count host-to-device bytes as "h2d.bytes" and
                 "h2d.bytes.<site>"
  launch(kernel, lanes, nbytes, muladds)
                 one kernel launch, called by the ops/ wrappers: it
                 increments the wrapper module's LAUNCHES and adds the
                 launch's lanes, bytes and multiply-adds to the record

A record keeps only numbers and names, never a tensor. Outside a record
span, count and h2d do nothing, and launch only increments LAUNCHES.
While a torch.profiler records, every phase and span also opens a range
"halo2.<name>" in its trace (a FUNCTION-scope record function: a
`record_function` range is user scope, and Kineto draws a user range
over its kernels on the card's timeline too, which a reader of device
intervals takes for device work), on the clock of the card's events.
With no profiler recording that costs one flag test a span.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

RING = 64
PROOFS: collections.deque = collections.deque(maxlen=RING)
LAST_KEYGEN = None
LAST_PARAMS = None

_ids = itertools.count(1)
_local = threading.local()        # .records: this thread's open records
_LAUNCH_COUNTERS: dict = {}       # kernel -> the LAUNCHES dict that holds it


class Span:
    """One host span; times in perf_counter_ns, parent an index into its
    record's spans (None at the top)."""
    __slots__ = ("name", "parent", "start", "end", "children_ns")

    def __init__(self, name: str, parent, start: int):
        self.name = name
        self.parent = parent
        self.start = start
        self.end = None
        self.children_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def self_seconds(self) -> float:
        return (self.end - self.start - self.children_ns) * 1e-9


class Record:
    """What one proof, keygen or Params.new left: its id (shared by all
    its spans), laps, spans, counters and per-kernel launches, lanes,
    bytes and multiply-adds."""

    def __init__(self, kind: str):
        self.kind = kind
        self.id = next(_ids)
        self.start = time.perf_counter_ns()
        self.end = None
        self.laps: list = []         # [(name, seconds)], the synced phases
        self.lap_bounds: list = []   # [(name, start_ns, end_ns)]
        self.spans: list = []
        self.counters: dict = collections.Counter()
        # kernel -> [launches, lanes, bytes, multiply-adds]
        self.kernels: dict = {}
        self.error = None            # the exception's class name, if any
        self._open: list = []        # indices of the open spans
        self._phase_rf = None        # the open phase's profiler range

    def seconds(self, name: str) -> float:
        """Inclusive seconds of every span of that name."""
        return sum(s.seconds for s in self.spans if s.name == name)


def current():
    """This thread's innermost open record, or None."""
    records = getattr(_local, "records", None)
    return records[-1] if records else None


class record:
    """`with record(kind):` opens a record on this thread (nested inside
    any open one, which sees none of its spans) and files it on exit,
    raised or not: "proof" into PROOFS, "keygen" as LAST_KEYGEN,
    "params" as LAST_PARAMS. `reuse` continues that record instead of
    opening a new one (keygen_pk after its keygen_vk)."""

    def __init__(self, kind: str, reuse: Record | None = None):
        self.rec = reuse if reuse is not None else Record(kind)

    def __enter__(self) -> Record:
        records = getattr(_local, "records", None)
        if records is None:
            records = _local.records = []
        records.append(self.rec)
        return self.rec

    def __exit__(self, exc_type, exc, tb):
        global LAST_KEYGEN, LAST_PARAMS
        rec = self.rec
        _local.records.remove(rec)
        rec.end = time.perf_counter_ns()
        if exc_type is not None:
            rec.error = exc_type.__name__
        if rec._phase_rf is not None:     # a phase the proof raised in
            rec._phase_rf.__exit__(None, None, None)
            rec._phase_rf = None
        if rec.kind == "proof":
            PROOFS.append(rec)
        elif rec.kind == "keygen":
            LAST_KEYGEN = rec
        elif rec.kind == "params":
            LAST_PARAMS = rec
        return False


def _range(name: str):
    """An open profiler range "halo2.<name>" where a profiler records,
    else None."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = torch._C._profiler._RecordFunctionFast("halo2." + name)
    rf.__enter__()
    return rf


class span:
    """`with span(name):` a host span in this thread's open record (none
    outside one), and a profiler range while a profiler records."""
    __slots__ = ("name", "rec", "index", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = rec = current()
        self.rf = _range(self.name)
        if rec is not None:
            self.index = len(rec.spans)
            rec.spans.append(Span(self.name, rec._open[-1] if rec._open
                                  else None, time.perf_counter_ns()))
            rec._open.append(self.index)
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        if rec is not None:
            s = rec.spans[self.index]
            s.end = time.perf_counter_ns()
            rec._open.pop()
            if s.parent is not None:
                rec.spans[s.parent].children_ns += s.end - s.start
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def count(name: str, n: int = 1) -> None:
    rec = current()
    if rec is not None:
        rec.counters[name] += n


def h2d(site: str, nbytes: int) -> None:
    """nbytes copied from host memory to the Params device at `site` (on
    a CPU device the bytes such a copy would move)."""
    rec = current()
    if rec is not None:
        rec.counters["h2d.bytes"] += nbytes
        rec.counters["h2d.bytes." + site] += nbytes


def upload(site: str, x: torch.Tensor, device) -> torch.Tensor:
    """x.to(device), its bytes counted at `site` (h2d)."""
    h2d(site, x.nbytes)
    return x.to(device)


def launch_counters(*kernels: str) -> dict:
    """A wrapper module's LAUNCHES dict, {kernel: 0}, which launch()
    increments."""
    counters = dict.fromkeys(kernels, 0)
    for k in kernels:
        _LAUNCH_COUNTERS[k] = counters
    return counters


def launch(kernel: str, lanes: int, nbytes: int, muladds: int) -> None:
    """One launch of `kernel` over `lanes` lanes or elements, moving
    nbytes (each input read once, each output written once) and issuing
    muladds 32-bit multiply-adds of the operation's formula."""
    _LAUNCH_COUNTERS[kernel][kernel] += 1
    rec = current()
    if rec is not None:
        k = rec.kernels.get(kernel)
        if k is None:
            k = rec.kernels[kernel] = [0, 0, 0, 0]
        k[0] += 1
        k[1] += lanes
        k[2] += nbytes
        k[3] += muladds


class PhaseTimer:
    """The prover's synced laps. phase(name) drains the card's queue
    (torch.cuda.synchronize), closes the phase before it and starts
    `name`; close() ends the last. Each phase is also a profiler range
    while a profiler records. `laps` keeps (name, seconds)."""

    def __init__(self, device):
        self.device = device
        self.rec = current()
        self.laps: list = []
        self._name = None
        self._t = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _end(self) -> int:
        self._sync()
        now = time.perf_counter_ns()
        if self._name is not None:
            self.laps.append((self._name, (now - self._t) * 1e-9))
            rec = self.rec
            if rec is not None:
                rec.laps.append(self.laps[-1])
                rec.lap_bounds.append((self._name, self._t, now))
                if rec._phase_rf is not None:
                    rec._phase_rf.__exit__(None, None, None)
                    rec._phase_rf = None
        return now

    def phase(self, name: str) -> None:
        self._t = self._end()
        self._name = name
        if self.rec is not None:
            self.rec._phase_rf = _range(name)

    def close(self) -> None:
        self._end()
        self._name = None
