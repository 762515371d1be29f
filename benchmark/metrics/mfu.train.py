"""The micro-steps' operations per optimizer step (the float32 reference's
loss and backward counted on meta tensors, no recompute) over the traced
window's time per optimizer step and the bf16 dense peak, %."""

from benchmark import work


def read(run):
    if not run.units or not run.window_s:
        return None
    flops = work.micro_step_flops(run.cfg, run.traffic) * run.cfg["train"]["gradient_accumulation_steps"]
    return 100.0 * flops * run.units / run.window_s / work.PEAK_BF16
