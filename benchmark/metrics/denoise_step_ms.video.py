"""One denoise step (ControlNet then UNet on the CFG batch, the Euler
update), ms: CUDA events around the pipeline module's denoise (a benchmark
span, the hint encoder included), over the traced window's steps."""


def read(run):
    total = run.spans.get("denoise")
    if not run.units or total is None:
        return None
    return total / (run.units * run.traffic["steps"])
