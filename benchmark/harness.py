"""What every cell's run shares: the run's record, CUDA-event spans around
the program's functions, the traced window and its reduction, the
per-layer readers, and the result line.

A driver (benchmark/drivers/<kind>.py) fills a `Run`: the set-up and
window times, the units of work finished, the end-to-end values, the spans
and, under --trace 1, the reduced trace; then the numbers compared with the
reference and their limits. run.py turns the record into the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

from benchmark.config import ROOT

METRICS_DIR = ROOT / "benchmark" / "metrics"


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    cfg: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float  # host clock at the process's start
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # videos or optimizer steps finished in the window
    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, Tuple[float, str]] = dataclasses.field(default_factory=dict)
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)  # ms by span, over the window
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)  # the program's kernel launches in the window
    trace_summary: Optional["TraceSummary"] = None
    memory_peak_bytes: int = 0
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)  # set-up's parts, host seconds
    checks: List[Check] = dataclasses.field(default_factory=list)

    def phase(self, name: str) -> None:
        """Marks the end of a part of the set-up: the host seconds since the last mark."""
        import time

        self.phases[name] = time.perf_counter() - self.t0 - sum(self.phases.values())

    def check(self, name: str, value: float) -> None:
        self.checks.append(Check(name, float(value), float(self.limits[name])))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """torch.cuda.max_memory_allocated over the process (0 off the card)."""
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


class Spans:
    """CUDA events around functions of the program's modules, which the run
    replaces by wrappers from here (the benchmark's own spans: the program
    keeps none). Active only while `active`; `on_call(args, kwargs)` and
    `on_return(output)` see every call, active or not. `totals()`
    synchronises once and returns milliseconds by span."""

    def __init__(self):
        self.active = False
        self._pending = []
        self._undo = []

    def wrap(self, module, attr: str, name: str, on_call: Optional[Callable] = None,
             on_return: Optional[Callable] = None) -> None:
        import torch

        orig = getattr(module, attr)

        def wrapper(*args, **kwargs):
            if on_call is not None:
                on_call(args, kwargs)
            if not self.active:
                out = orig(*args, **kwargs)
            else:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                with torch.profiler.record_function(f"bench/{name}"):
                    out = orig(*args, **kwargs)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._pending.append((name, start, end))
            if on_return is not None:
                on_return(out)
            return out

        setattr(module, attr, wrapper)
        self._undo.append((module, attr, orig))

    def restore(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo = []

    def totals(self) -> Dict[str, float]:
        if not self._pending:
            return {}
        import torch

        torch.cuda.synchronize()
        out: Dict[str, float] = defaultdict(float)
        for name, start, end in self._pending:
            out[name] += start.elapsed_time(end)
        self._pending = []
        return dict(out)


@dataclasses.dataclass
class TraceSummary:
    """The traced window reduced: device operations (name, start, end in
    ns), the window's bounds on the same clock, and the idle gaps labelled by
    what the host was doing."""

    ops: List[Tuple[str, int, int]]
    window: Tuple[int, int]
    busy_s: float
    idle_gaps: List[Tuple[str, float]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def device_s(self, key: str) -> Tuple[float, int]:
        """Seconds and count of the device operations whose name holds key."""
        hits = [e - s for n, s, e in self.ops if key in n]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by[name] += (e - s) / 1e9
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


WINDOW_SPAN = "bench/window"


@contextlib.contextmanager
def traced(enabled: bool):
    """The window under torch.profiler (host and device activity), kept in
    memory; yields a one-item list that holds the TraceSummary after the
    block. The caller marks the window with record_function(WINDOW_SPAN)."""
    box: list = []
    if not enabled:
        yield box
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield box
    finally:
        torch.cuda.synchronize()
        prof.stop()
    box.append(reduce_trace(prof.profiler.kineto_results.events()))


def reduce_trace(events) -> TraceSummary:
    """Busy time (the union of device operations inside the window) and the
    ten longest idle gaps, each labelled by the benchmark span and the
    innermost host operation running at its middle."""
    from torch.autograd import DeviceType

    ops, host, window = [], [], None
    for ev in events:
        s, d = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():  # a span's mirror on the device's timeline, not an operation
                ops.append((ev.name(), s, s + d))
        elif ev.name() == WINDOW_SPAN:
            window = (s, s + d)
        else:
            host.append((ev.name(), s, s + d))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = window
    ops = sorted(((n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi), key=lambda o: o[1])
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for _, s, e in ops:
        if s > cur_e:
            gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s = s
        elif cur_s is None:
            cur_s = s
        cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for a, b in gaps:
        mid = (a + b) // 2
        inside = [(s, n) for n, s, e in host if s <= mid < e]
        spans = [n for s, n in sorted(inside) if n.startswith("bench/")]
        ops_in = [n for s, n in sorted(inside) if not n.startswith("bench/")]
        label = " / ".join(x for x in (spans[-1] if spans else "", ops_in[-1] if ops_in else "") if x)
        labelled.append((label or "host outside any operation", (b - a) / 1e9))
    return TraceSummary(ops=ops, window=window, busy_s=busy / 1e9, idle_gaps=labelled)


def reader(name: str):
    """The per-layer metric's reader, benchmark/metrics/<name>.py: a
    function read(run) -> value, or None where it finds nothing to read."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, kind: str) -> List[dict]:
    """The end-to-end ("end_to_end") or per-layer ("per_layer") metrics the
    cell reports: an end-to-end metric that lists it or lists no cells, a
    per-layer metric that lists it (each lists its cells)."""
    if kind == "end_to_end":
        return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]
