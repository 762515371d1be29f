"""The denoise steps run as replays of the captured graph, %: the
program's counters denoise.replays over denoise.replays plus
denoise.eager_steps (the eager loop's steps and the eager step before each
capture)."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    replays, eager = t.counts.get("denoise.replays", 0), t.counts.get("denoise.eager_steps", 0)
    return 100.0 * replays / (replays + eager) if replays + eager else None
