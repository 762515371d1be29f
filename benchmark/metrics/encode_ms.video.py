"""CLIP and the VAE encode of a video, ms: the program's device spans
posetraj/clip and posetraj/vae_encode (CUDA events), over the program's
count of requests."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    return program_spans.per(t, "requests", program_spans.device_ms(t, ("posetraj/clip", "posetraj/vae_encode")))
