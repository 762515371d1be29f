"""The benchmark's arithmetic over the program's own record of spans and
counters (posetraj_torch.utils.profiling.TIMER), shared by the per-layer
readers with source program_span: the program keeps the record, and how a
metric is computed from it lives here, beside the readers.

A span's host interval and the profiler's device operations are on one
clock (time.time_ns()), so the device's idle time inside spans is their
intervals' union less the operations' union over it.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple


def record():
    """The program's record, or None where the program keeps none (a
    checkout from before its spans)."""
    try:
        from posetraj_torch.utils.profiling import TIMER
    except ImportError:
        return None
    return TIMER


def per(timer, counter: str, value: Optional[float]) -> Optional[float]:
    """value over the program's counter (None where either is missing)."""
    n = timer.counts.get(counter)
    return None if not n or value is None else value / n


def device_ms(timer, names: Iterable[str]) -> Optional[float]:
    """The device milliseconds of the spans of these names, summed (None
    where there is none)."""
    names = set(names)
    times = [s.device_ms for s in timer.record() if s.name in names and s.device_ms is not None]
    return sum(times) if times else None


def idle_ms(timer, names: Iterable[str], busy: Sequence[Tuple[int, int]],
            window: Optional[Tuple[int, int]] = None) -> float:
    """Milliseconds inside the spans of these names (their host intervals'
    union, cut to `window`) that no interval of `busy`, the device's
    operations as (start, end) ns, covers."""
    names = set(names)
    lo, hi = window or (-(2**63), 2**63)
    spans = union((max(s.start_ns, lo), min(s.end_ns, hi)) for s in timer.record() if s.name in names)
    covered, ops, j = 0, union(busy), 0
    for a, b in spans:
        while j < len(ops) and ops[j][1] <= a:
            j += 1
        k = j
        while k < len(ops) and ops[k][0] < b:
            covered += min(b, ops[k][1]) - max(a, ops[k][0])
            k += 1
    return (sum(b - a for a, b in spans) - covered) / 1e6


def window_idle_ms(timer, run, names: Iterable[str], counter: str) -> Optional[float]:
    """The device's idle time inside the spans of these names over the
    traced window, per the program's counter (None without a trace)."""
    t = run.trace_summary
    if t is None:
        return None
    return per(timer, counter, idle_ms(timer, names, [(s, e) for _, s, e in t.ops], t.window))


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint intervals covering the same points; empty ones dropped."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
