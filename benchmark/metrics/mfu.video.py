"""The model's operations per video (the float32 reference counted on meta
tensors: CLIP, VAE encode, hint, every step, decode) over the traced
window's time per video and the bf16 dense peak, %."""

from benchmark import work


def read(run):
    if not run.units or not run.window_s:
        return None
    return 100.0 * work.video_flops(run.cfg, run.traffic) * run.units / run.window_s / work.PEAK_BF16
