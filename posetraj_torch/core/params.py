"""Parameter-tree utilities: counting, EMA. A tree is nested dicts and
lists of tensors, as core/init.py makes them."""

from __future__ import annotations

from typing import Iterator

import torch


def leaves(tree) -> Iterator[torch.Tensor]:
    """Every tensor of a tree, depth first, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


@torch.no_grad()
def ema_update(ema, new, decay: float) -> None:
    """ema := decay * ema + (1 - decay) * new, in place, leaf by leaf (the
    diffusers EMAModel step). In place so that the shadow copy costs no
    second buffer."""
    for e, p in zip(leaves(ema), leaves(new)):
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


def ema_decay_schedule(optimization_step: int, max_decay: float = 0.9999) -> float:
    """diffusers EMAModel.get_decay without warmup: min(max_decay,
    (1 + s) / (10 + s)) with s = optimization_step - 1, and 0.0 on the first
    update (the shadow becomes the params). `optimization_step` counts
    completed optimizer updates from 1."""
    step = max(optimization_step - 1, 0)
    if step <= 0:
        return 0.0
    return min((1.0 + step) / (10.0 + step), max_decay)
