"""The device's idle time inside the request's host stages, ms per video:
the program's spans posetraj/prepare (the inputs made and copied to the
card) and posetraj/output (the frames copied back, numpy), their host
intervals less the union of the traced window's device operations over
them, over the program's count of requests."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    return program_spans.window_idle_ms(t, run, ("posetraj/prepare", "posetraj/output"), "requests")
