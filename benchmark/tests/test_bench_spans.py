"""The readers of the program's spans and counters (benchmark/metrics/*.py
with source program_span that read posetraj_torch.utils.profiling.TIMER
through benchmark/program_spans.py) on a synthetic record and trace whose
values are known by hand; each returns None on an empty record and where
the program keeps no record; program_spans.idle_ms on overlapping spans
and a window."""

import sys
import types
from types import SimpleNamespace

import pytest

from benchmark import harness, program_spans
from posetraj_torch.utils import profiling
from posetraj_torch.utils.profiling import Span

MS = 1_000_000
NEW = ["io_idle_ms.video", "encode_ms.video", "decode_ms.video", "replay_step_ms.video", "graph_replay_pct.video",
       "launch_idle_ms.train", "sync_step_ms.train", "graph_replay_pct.train"]


def _span(name, start_ms, end_ms, device_ms=None, parent=None):
    return Span(name, parent, 0, start_ms * MS, end_ms * MS, device_ms)


@pytest.fixture
def record():
    """Two requests and four micro-steps (two optimizer steps) in a window
    [0, 1000) ms; the device busy over [5, 8), [95, 300), [402, 500),
    [505, 506) and [900, 1000) ms."""
    t = profiling.TIMER
    t.reset()
    t.spans = [
        # request 1: prepare [0, 10) holds 3 ms of device work; output [90, 100) 5 ms
        _span("posetraj/prepare", 0, 10), _span("posetraj/clip", 10, 20, 4.0),
        _span("posetraj/vae_encode", 20, 30, 6.0),
        _span("posetraj/denoise/replay", 30, 80, 40.0), _span("posetraj/decode", 80, 90, 9.0),
        _span("posetraj/output", 90, 100),
        # request 2: a second prepare nested in the first (counted once), [400, 420): 2 ms idle;
        # output [500, 510): 9 ms idle
        _span("posetraj/prepare", 400, 420), _span("posetraj/prepare", 405, 410, parent=6),
        _span("posetraj/clip", 420, 430, 5.0), _span("posetraj/vae_encode", 430, 440, 5.0),
        _span("posetraj/denoise/replay", 440, 490, 60.0), _span("posetraj/decode", 490, 500, 11.0),
        _span("posetraj/output", 500, 510),
        # training: prepare, load and launch of four micro-steps; the last runs past the window's end
        _span("posetraj/train/prepare", 600, 610), _span("posetraj/train/load", 610, 612),
        _span("posetraj/train/launch", 612, 620), _span("posetraj/train/sync", 620, 650, 30.0),
        _span("posetraj/train/launch", 700, 704), _span("posetraj/train/launch", 800, 801),
        _span("posetraj/train/launch", 899, 1100), _span("posetraj/train/sync", 1100, 1150, 34.0),
    ]
    t.counts.update({"requests": 2, "denoise.replays": 50, "denoise.eager_steps": 0, "micro_steps": 4,
                     "train.replays": 3, "opt_steps": 2})
    ops = [("k", a * MS, b * MS) for a, b in ((5, 8), (95, 300), (402, 500), (505, 506), (900, 1000))]
    trace = harness.TraceSummary(ops=ops, window=(0, 1000 * MS), busy_s=0.0, idle_gaps=[])
    yield SimpleNamespace(trace_summary=trace)
    t.reset()


# prepare [0, 10) less [5, 8): 7; output [90, 100) less [95, 100): 5; prepare [400, 420) less
# [402, 420): 2; output [500, 510) less [505, 506): 9. 23 ms over 2 requests.
# launch path: [600, 620) all idle 20, [700, 704) 4, [800, 801) 1, [899, 1000) less [900, 1000): 1.
EXPECTED = {"io_idle_ms.video": 23.0 / 2, "encode_ms.video": 20.0 / 2, "decode_ms.video": 20.0 / 2,
            "replay_step_ms.video": 100.0 / 50, "graph_replay_pct.video": 100.0,
            "launch_idle_ms.train": 26.0 / 4, "sync_step_ms.train": 64.0 / 2, "graph_replay_pct.train": 75.0}


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_known_record(record, name):
    assert harness.reader(name)(record) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_on_an_empty_record(name):
    profiling.TIMER.reset()
    trace = harness.TraceSummary(ops=[("k", 0, MS)], window=(0, 2 * MS), busy_s=0.001, idle_gaps=[])
    assert harness.reader(name)(SimpleNamespace(trace_summary=trace)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_where_the_program_keeps_no_record(monkeypatch, name):
    """As on a program from before its spans: the module has no TIMER."""
    monkeypatch.setitem(sys.modules, "posetraj_torch.utils.profiling", types.ModuleType("profiling"))
    assert harness.reader(name)(SimpleNamespace(trace_summary=None)) is None


def test_every_new_metric_is_declared_and_reads_the_program():
    import json

    from benchmark.config import ROOT

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in manifest["per_layer"]}
    for name in NEW:
        assert declared[name]["source"] == "program_span"
        assert declared[name]["moves"] == ("s_per_video" if name.endswith(".video") else "s_per_opt_step")


def test_idle_ms_inside_spans():
    timer = profiling.StageTimer("cpu")
    timer.spans = [_span("a", 0, 10), _span("a", 5, 15), _span("a", 20, 30), _span("b", 0, 40)]
    busy = [(2 * MS, 4 * MS), (3 * MS, 6 * MS), (14 * MS, 22 * MS), (29 * MS, 40 * MS)]
    # [0, 15) less [2, 6) and [14, 15): 10; [20, 30) less [20, 22) and [29, 30): 7
    assert program_spans.idle_ms(timer, ["a"], busy) == pytest.approx(17.0)
    assert program_spans.idle_ms(timer, ["a"], busy, window=(5 * MS, 25 * MS)) == pytest.approx(8.0 + 3.0)
    assert program_spans.idle_ms(timer, ["c"], busy) == 0.0
