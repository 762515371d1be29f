"""Tracing and per-stage timing (port of posetraj_tpu/utils/profiling.py).

`trace(log_dir)` records a torch.profiler trace (host and, where a card is
present, CUDA activity) and writes it into `log_dir` as a Chrome trace,
viewable in Perfetto or chrome://tracing.

`StageTimer` accumulates named stages. On the card a stage is a pair of CUDA
events recorded on the current stream at its start and end, so nothing
synchronises inside or between stages: work queued asynchronously is
charged to the stage that queued it, as the JAX version's
`block_until_ready` on the stage's outputs does, without a host sync per
stage. `report()` and `as_dict()` synchronise once and add up the events'
elapsed times. On the CPU a stage is `time.perf_counter` around the block.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from posetraj_torch.core.init import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace("/tmp/trace") as prof: run()`: profiles the block with
    torch.profiler (CPU activity, and CUDA activity where a card is
    present) and on exit writes `log_dir/trace-<pid>-<n>.json`, a Chrome
    trace; `prof.trace_path` is that file."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace-{os.getpid()}-")])
        prof.trace_path = os.path.join(log_dir, f"trace-{os.getpid()}-{n}.json")
        prof.export_chrome_trace(prof.trace_path)


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
    ends."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

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
                self._pending.append((name, start, end))
                self.counts[name] += 1
            return
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def _collect(self) -> None:
        """Synchronise once and move the recorded events into the totals
        (seconds)."""
        if not self._pending:
            return
        torch.cuda.synchronize(self.device)
        for name, start, end in self._pending:
            self.totals[name] += start.elapsed_time(end) / 1e3
        self._pending = []

    def report(self) -> str:
        self._collect()
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            t = self.totals[name]
            lines.append(f"{name}: total {t:.3f}s x{n} (avg {t / n:.4f}s)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        self._collect()
        return dict(self.totals)
