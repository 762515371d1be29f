"""The chunked VAE decode of a video, ms: the program's device span
posetraj/decode (CUDA events), over the program's count of requests."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    return program_spans.per(t, "requests", program_spans.device_ms(t, ("posetraj/decode",)))
