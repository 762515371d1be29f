"""The program's spans and counters (posetraj_torch/utils/profiling.py) on
the CPU: with no profiler a request and a micro-step record nothing; under
torch.profiler they record the span tree of the pipeline's call and of
Trainer.step, one id a request or micro-step, the eager steps' counters, and
host intervals on the clock of the profiler's own events; the pending CUDA
events stay bounded; trace() starts the record empty and leaves its totals;
chip_smoke's profiles count the kernels and not the spans' mirrors on the
device's timeline. ModelBundle.tiny at 64x64, 2 frames, 2 steps, one
pipeline and one trainer for the file.

The card's counterparts (graph replays, CUDA-event times, the mirrors a
real profile holds) are test_cuda_spans_and_counters and
test_cuda_smoke_profile_counts_kernels_not_spans in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from posetraj_torch.utils import profiling

STEPS = 2
REQUEST = ["posetraj/request", "posetraj/prepare", "posetraj/prepare", "posetraj/clip", "posetraj/vae_encode",
           "posetraj/hint", "posetraj/decode", "posetraj/output"]
MICRO_STEP = ["posetraj/micro_step", "posetraj/train/prepare"]


@pytest.fixture(scope="module")
def params():
    from posetraj_torch.pipeline import ModelBundle, init_params

    return ModelBundle.tiny(), init_params(ModelBundle.tiny(), seed=3, device="cpu")


@pytest.fixture(scope="module")
def pipe(params):
    from posetraj_torch.pipeline import SVDControlNetPipeline

    return SVDControlNetPipeline(params[1], params[0], device="cpu")


@pytest.fixture(scope="module")
def trainer(params):
    """Every micro-step ends its window (accumulation 1), so one micro-step
    shows the sync step too."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import Trainer

    bundle, p = params
    return Trainer(bundle, TrainConfig(num_frames=2, height=64, width=64, gradient_accumulation_steps=1),
                   {k: p[k] for k in ("unet", "vae", "clip")}, p["controlnet"], device="cpu")


def _request(pipe):
    rng = np.random.RandomState(0)
    image, control = rng.rand(1, 64, 64, 3).astype(np.float32), rng.rand(1, 2, 64, 64, 3).astype(np.float32)
    return pipe(image, control, height=64, width=64, num_frames=2, num_inference_steps=STEPS, seed=1)


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"pixel_values": (rng.rand(1, 2, 64, 64, 3) * 2 - 1).astype(np.float32),
            "trajectories": (rng.rand(1, 2, 64, 64, 3) * 2 - 1).astype(np.float32),
            "motion_values": np.full((1,), 127.0, np.float32)}


@pytest.fixture(scope="module")
def recorded(pipe, trainer):
    """One request and one micro-step under the profiler: (the spans, the
    counts, the profiler's events by name)."""
    profiling.TIMER.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _request(pipe)
        trainer.step(_batch(0))
    spans, counts = list(profiling.TIMER.spans), dict(profiling.TIMER.counts)
    profiling.TIMER.reset()
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return spans, counts, events


def test_nothing_recorded_without_a_profiler(pipe, trainer):
    profiling.TIMER.reset()
    _request(pipe)
    trainer.step(_batch(1))
    assert not profiling.TIMER.spans and not profiling.TIMER.counts and not profiling.TIMER.totals
    with profiling.span("x", device=torch.device("cpu")):
        profiling.count("y")
    assert not profiling.TIMER.spans and not profiling.TIMER.counts and profiling.TIMER.depth == 0


def test_span_tree_ids_and_counters(recorded):
    spans, counts, _ = recorded
    tree = [(s.name, None if s.parent is None else spans[s.parent].name) for s in spans]
    request = [(n, None if i == 0 else REQUEST[0]) for i, n in enumerate(REQUEST)]
    micro_step = [(MICRO_STEP[0], None), (MICRO_STEP[1], MICRO_STEP[0]), ("posetraj/train/sync", MICRO_STEP[0])]
    assert tree == request + micro_step
    ids = [s.id for s in spans]
    assert ids == [ids[0]] * len(REQUEST) + [ids[-1]] * len(micro_step) and ids[0] != ids[-1]
    assert counts == {"requests": 1, "denoise.eager_steps": STEPS, "micro_steps": 1, "opt_steps": 1}
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        device = s.name in ("posetraj/clip", "posetraj/vae_encode", "posetraj/hint", "posetraj/decode",
                            "posetraj/train/sync")
        assert (s.device_ms is not None) == device
        if device:  # on the CPU the device's time is the host's
            assert s.device_ms == pytest.approx((s.end_ns - s.start_ns) / 1e6)
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_spans_on_the_profilers_clock(recorded):
    """Each span's host interval matches its record_function event within 1 ms."""
    spans, _, events = recorded
    for name in sorted({s.name for s in spans}):
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        for (a, b), (c, d) in zip(mine, theirs):
            assert abs(a - c) < 1e6 and abs(b - d) < 1e6, (name, a - c, b - d)


class _Event:
    """A CUDA event's stand-in: the device has passed it once `done`."""

    done = True

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_pending_events_stay_bounded(monkeypatch):
    """Past MAX_PENDING, the pairs the device has passed are read without a
    sync; the rest wait for the read."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    timer, cuda = profiling.TIMER, torch.device("cuda")
    timer.reset()
    most = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3 * timer.MAX_PENDING):
            with profiling.span("d", device=cuda):
                pass
            most = max(most, len(timer._pending))
    assert most <= timer.MAX_PENDING and len(timer._pending) < timer.MAX_PENDING
    monkeypatch.setattr(_Event, "done", False)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(timer.MAX_PENDING):
            with profiling.span("d", device=cuda):
                pass
    assert len(timer._pending) > timer.MAX_PENDING
    spans = timer.record()
    assert len(spans) == 4 * timer.MAX_PENDING and not timer._pending
    assert all(s.device_ms == 1.0 for s in spans)
    timer.reset()


def test_trace_starts_empty_and_leaves_the_totals(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("stale")
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("outer"):
            with profiling.span("inner", device=torch.device("cpu")):
                profiling.count("things", 3)
    assert set(prof.totals) == {"outer", "inner"} and prof.totals["outer"] >= prof.totals["inner"] > 0
    assert prof.counts == {"things": 3}
    profiling.TIMER.reset()


class _Kineto:
    """A profiler event's stand-in, as `prof.events()` gives it."""

    def __init__(self, name, cuda, annotation=False):
        self.name, self.is_user_annotation = name, annotation
        self.device_type = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
        self.device_time_total = 1000.0


def test_smoke_profile_counts_kernels_not_span_mirrors(monkeypatch):
    """chip_smoke's profiles (profile_step, _profiled) count the device's
    kernels: not the spin kernels, not host events, and not the mirrors
    of the program's spans on the device's timeline, which would count a
    replayed step's time again."""
    import chip_smoke

    events = [_Kineto("posetraj/denoise/replay", True, True), _Kineto("posetraj/request", True, True),
              _Kineto("void gn_apply<...>", True), _Kineto("mlp_gemm_kernel", True),
              _Kineto("void spin_kernel(long)", True), _Kineto("posetraj/denoise/replay", False),
              _Kineto("aten::mm", False)]

    class _Prof:
        def __init__(self, *a, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    assert [ev.name for ev in chip_smoke.device_kernels(torch, _Prof())] == ["void gn_apply<...>", "mlp_gemm_kernel"]
    monkeypatch.setattr(torch.profiler, "profile", _Prof)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _, groups = chip_smoke.profile_step(torch, lambda: None)
    assert sum(n for _, n in groups.values()) == 2 and sum(ms for ms, _ in groups.values()) == 2.0
