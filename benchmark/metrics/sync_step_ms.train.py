"""The update at a window's end (mean, clip, AdamW, EMA), ms: the program's
device span posetraj/train/sync around sync_step (CUDA events), over the
program's count of optimizer steps, opt_steps."""

from benchmark import program_spans


def read(run):
    t = program_spans.record()
    if t is None:
        return None
    return program_spans.per(t, "opt_steps", program_spans.device_ms(t, ("posetraj/train/sync",)))
