"""The update at a window's end (mean, clip, AdamW, EMA: the trainer
module's sync_step), ms: CUDA events around it (a benchmark span), per
optimizer step of the traced window."""


def read(run):
    total = run.spans.get("sync")
    if not run.units or total is None:
        return None
    return total / run.units
