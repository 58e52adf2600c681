"""The reduction from a profiler trace and the prover's phase laps to the
numbers that the per-layer metrics read.

Times are seconds. A device interval is (name, start, end); a proof is
(start, end) on the same clock, with its laps [(phase, seconds)] in the
order the prover took them (its PhaseTimer syncs the card at each lap, so
a phase owns the kernels it launched).
"""
from __future__ import annotations

import re

COPY_PREFIXES = ("Memcpy", "Memset")


def base_name(name: str) -> str:
    """A kernel's name without 'void ', template arguments or argument
    list: 'void ns::k<4>(int*)' -> 'ns::k'."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()


def short_name(name: str) -> str:
    """The last component of a base name: 'ns::k' -> 'k'."""
    return base_name(name).rsplit("::", 1)[-1]


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and merged."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def clip(intervals, start: float, end: float) -> list[tuple[float, float]]:
    return [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]


def gaps(busy, start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of [start, end] that no interval of `busy` (merged)
    covers."""
    out, cur = [], start
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < end:
        out.append((cur, end))
    return out


def lap_bounds(start: float, laps) -> list[tuple[str, float, float]]:
    out, t = [], start
    for name, seconds in laps:
        out.append((name, t, t + seconds))
        t += seconds
    return out


def reduce(proofs, laps, device) -> dict:
    """proofs: [(start, end)] of the traced proofs; laps: each one's
    laps; device: [(name, start, end)] of everything the profiler saw on
    the card. Returns the traced window's totals."""
    window_start, window_end = proofs[0][0], proofs[-1][1]
    inside = [(n, s, e) for n, s, e in device if e > window_start
              and s < window_end]
    busy = union(clip([(s, e) for _, s, e in inside], window_start,
                      window_end))
    by_name: dict[str, float] = {}
    launches = 0
    for name, s, e in inside:
        key = base_name(name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
        launches += is_kernel(name)
    idle: dict[str, float] = {}
    for (p_start, p_end), proof_laps in zip(proofs, laps):
        bounds = lap_bounds(p_start, proof_laps)
        for g_start, g_end in gaps(clip(busy, p_start, p_end), p_start, p_end):
            for name, l_start, l_end in bounds:
                overlap = min(g_end, l_end) - max(g_start, l_start)
                if overlap > 0:
                    idle[name] = idle.get(name, 0.0) + overlap
            outside = (g_end - g_start) - sum(
                max(0.0, min(g_end, le) - max(g_start, ls))
                for _, ls, le in bounds)
            if outside > 1e-9:
                idle["(between phases)"] = idle.get("(between phases)", 0.0) + outside
    return {
        "proofs": len(proofs),
        "window_s": window_end - window_start,
        "busy_s": sum(e - s for s, e in busy),
        "launches": launches,
        "device_seconds": by_name,
        "idle_by_phase": idle,
    }


def per_phase(laps, names) -> float | None:
    """Seconds a proof spent in the named phases, averaged over proofs
    (None when no proof has any of them)."""
    if not laps:
        return None
    totals = [sum(s for n, s in proof if n in names) for proof in laps]
    if not any(n in names for proof in laps for n, _ in proof):
        return None
    return sum(totals) / len(totals)


def top(d: dict, count: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:count]]
