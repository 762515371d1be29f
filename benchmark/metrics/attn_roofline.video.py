"""Kernel C's attention core (the shared flash forward, hopper_flash_fwd,
one a spatial self-attention) against its roofline over the traced
window, %."""

from benchmark import work


def read(run):
    return work.roofline_share(run, "attn", "hopper_flash_fwd", "qkvt", 1)
