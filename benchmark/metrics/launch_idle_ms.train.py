"""The device's idle time inside a micro-step's launch path, ms per
micro-step: the program's spans posetraj/train/prepare (the batch on the
card, the draws), posetraj/train/load (into the graph's buffers) and
posetraj/train/launch (the graph's replay call), their host intervals less
the union of the traced window's device operations over them, over the
program's count of micro-steps."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    names = ("posetraj/train/prepare", "posetraj/train/load", "posetraj/train/launch")
    return program_spans.window_idle_ms(t, run, names, "micro_steps")
