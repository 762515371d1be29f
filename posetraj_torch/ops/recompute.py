"""The backward of a kernel whose gradient is its plain version's.

The JAX package gives each fused Pallas sub-layer a `custom_vjp` whose
backward re-runs the reference formulation and takes its vjp
(pallas_qkvt._asl_bwd, pallas_temporal._tas_bwd, pallas_mlp and
pallas_groupnorm alike). `recompute_vjp` is that backward for a
`torch.autograd.Function`: the forward launches the kernel and saves only
its inputs; the backward recomputes the plain function under grad mode and
differentiates it with respect to the inputs that need a gradient.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def recompute_vjp(fn: Callable, inputs: Sequence, needs: Sequence[bool], grad_out: torch.Tensor) -> tuple:
    """Gradients of fn(*inputs) against `grad_out`, one per input: a tensor
    where `needs` is true, else None. Non-tensor inputs pass through."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) else t for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        wrt = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
