"""The micro-steps run as replays of the captured graph, %: the program's
counters train.replays over micro_steps."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    n = None if t is None else t.counts.get("micro_steps")
    return 100.0 * t.counts.get("train.replays", 0) / n if n else None
