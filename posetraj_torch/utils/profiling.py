"""Tracing and per-stage timing (port of posetraj_tpu/utils/profiling.py).

`trace(log_dir)` records a torch.profiler trace (host and, where a card is
present, CUDA activity) and writes it into `log_dir` as a Chrome trace,
viewable in Perfetto or chrome://tracing.

`StageTimer` accumulates named stages. On the card a stage is a pair of CUDA
events recorded on the current stream at its start and end, so nothing
synchronises inside or between stages: work queued asynchronously is
charged to the stage that queued it, as the JAX version's
`block_until_ready` on the stage's outputs does, without a host sync per
stage. `report()` and `as_dict()` wait for the recorded events once and add
up their elapsed times. On the CPU a stage is `time.perf_counter` around the
block.

The program's own spans and counters go into one StageTimer, `TIMER`,
through `span(name, device)` and `count(name, n)`, and only while a torch
profiler records (`torch.profiler.profile`, `trace()`): with none running a
span costs one check of the profiler's state and records nothing. A span
records its name, its parent, an id shared by every span of one request or
micro-step (the outermost span's), its host start and end from
`time.time_ns()` (the clock of the profiler's events) and, for a span on a
CUDA device, a CUDA event pair resolved to milliseconds when read; it also
opens `torch.profiler.record_function(name)`, so it shows in the trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from posetraj_torch.core.init import resolve_device

# True while a torch profiler records; the one check a span makes when none does.
_profiling = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("/tmp/trace") as prof: run()`: profiles the block with
    torch.profiler (CPU activity, and CUDA activity where a card is
    present) and on exit writes `log_dir/trace-<pid>-<n>.json`, a Chrome
    trace; `prof.trace_path` is that file. `TIMER` starts the block empty;
    on exit `prof.totals` holds its seconds by span (device time for a
    device span) and `prof.counts` its counters."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    TIMER.reset()
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.totals, prof.counts = TIMER.as_dict(), dict(TIMER.counts)
        n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace-{os.getpid()}-")])
        prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(prof.trace_path)


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span. `parent` indexes the enclosing span in
    `StageTimer.spans` (None at the top); `id` is the outermost span's, so
    every span of one request or micro-step shares it. Host times are
    `time.time_ns()`. `device_ms`: a device span's time, from its CUDA events
    once resolved, or its host time on the CPU; None for a host span."""

    name: str
    parent: Optional[int]
    id: int
    start_ns: int
    end_ns: int = 0
    device_ms: Optional[float] = None


class StageTimer:
    """Accumulating named-stage timer.

        timer = StageTimer()              # on the card; StageTimer("cpu")
        with timer.stage("encode"):
            latents = encode(...)
        print(timer.report())

    `outputs=` (or `box["outputs"]` set inside the block) is accepted for
    the JAX version's signature; on the card the end event already follows
    the stage's work on the stream, and the CPU runs synchronously, so it
    is not needed. Work a stage queues on another stream is charged to it
    only if the current stream waits for that stream before the stage
    ends.

    `counts` holds the stages' calls and the counters of `count()`;
    `span()` records the program's spans (module docstring) into `spans`
    alone, so the program's record (`TIMER`, which runs no stage) counts
    only its counters. Past MAX_PENDING CUDA event pairs waiting to be
    read, those the device has passed are read without a sync."""

    MAX_PENDING = 256

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        self._open: List[int] = []  # indices in `spans` of the spans entered and not left
        self._ids = itertools.count()
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event, Optional[Span]]] = []

    def reset(self) -> None:
        """Drop everything recorded (between spans: trace() resets before its profiler starts)."""
        self.totals.clear()
        self.counts.clear()
        self.spans, self._open, self._pending = [], [], []

    @contextlib.contextmanager
    def stage(self, name: str, outputs=None):
        box = {"outputs": outputs}
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield box
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._add_pending(name, start, end, None)
                self.counts[name] += 1
            return
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @property
    def depth(self) -> int:
        """The number of spans entered and not yet left."""
        return len(self._open)

    def span(self, name: str, device=False) -> "_Recording":
        """A context recording one span into this timer, profiler or not
        (the module's `span()` checks first)."""
        return _Recording(self, name, device)

    def _add_pending(self, name: str, start, end, span: Optional[Span]) -> None:
        self._pending.append((name, start, end, span))
        if len(self._pending) > self.MAX_PENDING:
            self._resolve(wait=False)

    def _resolve(self, wait: bool = True) -> None:
        """Move the recorded event pairs into the totals (seconds) and their
        spans: every pair, waiting for each end event, or (wait=False) those
        whose end event the device has passed."""
        keep = []
        for entry in self._pending:
            name, start, end, span = entry
            if wait:
                end.synchronize()
            elif not end.query():
                keep.append(entry)
                continue
            ms = start.elapsed_time(end)
            self.totals[name] += ms / 1e3
            if span is not None:
                span.device_ms = ms
        self._pending = keep

    def report(self) -> str:
        self._resolve()
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts.get(name) or sum(s.name == name for s in self.spans)
            t = self.totals[name]
            lines.append(f"{name}: total {t:.3f}s x{n} (avg {t / n:.4f}s)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        self._resolve()
        return dict(self.totals)

    def record(self) -> List[Span]:
        """The spans, every device span's events read (waiting for those the
        device has not passed)."""
        self._resolve()
        return self.spans


class _Recording:
    """One span being recorded (StageTimer.span)."""

    __slots__ = ("timer", "name", "device", "span", "rf", "start")

    def __init__(self, timer: StageTimer, name: str, device):
        self.timer, self.name, self.device = timer, name, device

    def __enter__(self) -> Span:
        t = self.timer
        parent = t._open[-1] if t._open else None
        self.span = Span(self.name, parent, t.spans[parent].id if parent is not None else next(t._ids),
                         time.time_ns())
        t._open.append(len(t.spans))
        t.spans.append(self.span)
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = None
        if self.device is not False and torch.device(self.device).type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        return self.span

    def __exit__(self, *exc) -> None:
        t, s = self.timer, self.span
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            t._add_pending(s.name, self.start, end, s)
        self.rf.__exit__(*exc)
        s.end_ns = time.time_ns()
        t._open.pop()
        if self.start is None:
            host_s = (s.end_ns - s.start_ns) / 1e9
            t.totals[s.name] += host_s
            if self.device is not False:  # on the CPU the device's time is the host's
                s.device_ms = host_s * 1e3


TIMER = StageTimer("cpu")  # the program's spans and counters
_OFF = contextlib.nullcontext()


def span(name: str, device=False):
    """`with span("posetraj/clip", device=dev): ...`: records a span into
    `TIMER` while a torch profiler records, and does nothing otherwise.
    device: False for a host span; else the torch.device the span's work
    runs on, timed by CUDA events on the current stream on a CUDA device (on
    the CPU by the host's clock). Never inside code a CUDA graph captures."""
    if not _profiling():
        return _OFF
    return TIMER.span(name, device)


def count(name: str, n: int = 1) -> None:
    """Adds n to `TIMER.counts[name]` while a torch profiler records."""
    if _profiling():
        TIMER.counts[name] += n
