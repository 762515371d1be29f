"""One replayed denoise step, ms: the program's device span
posetraj/denoise/replay around the loop of graph replays (CUDA events; the
hint encoder and the load into the graph's buffers left out), over the
program's count of replays, denoise.replays."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    return program_spans.per(t, "denoise.replays", program_spans.device_ms(t, ("posetraj/denoise/replay",)))
