"""Fast deterministic nonzero parameter fill for benchmarks (port of
posetraj_tpu/tools/fill.py).

Benchmarks need nonzero weights (zero weights would flatter any
data-dependent fast path) but not distinct values per leaf: dense matmul and
convolution timing does not depend on the values. The periodic pattern
sin(arange(4096)) * 0.02 is cast to the target dtype once, tiled on the
device to the largest leaf, and every leaf is the first `size` elements of
it, reshaped: each leaf equals the JAX version's leaf of the same shape bit
for bit.

Unlike the JAX version, leaves of one shape are not aliased to one tensor.
JAX arrays are immutable, so sharing one array between leaves there only
saves transfers; here the optimizer updates the trainable leaves in place,
and a tensor shared by several leaves would be updated several times a
step. Every leaf is its own copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from posetraj_torch.core.init import resolve_device
from posetraj_torch.core.params import cast_like, leaves, tree_map

PERIOD = 4096


def fill_params(tree, dtype: torch.dtype, device=None):
    """Every leaf of `tree` (tensors of any device, `meta` included: only
    shapes are read) replaced by a deterministic small-magnitude nonzero
    tensor of its shape in `dtype` on `device` (default: each leaf's own
    device; for a `meta` leaf the card, as every entry point's default, and
    an error without one unless device="cpu" is passed). 4-D leaves keep
    core/init.py's channels-last memory format. See the module docstring."""
    all_leaves = list(leaves(tree))
    if not all_leaves:
        return tree
    pattern = torch.from_numpy(np.sin(np.arange(PERIOD, dtype=np.float32)) * np.float32(0.02)).to(dtype)
    max_size = max(t.numel() for t in all_leaves)
    bufs = {}

    def buf(dev: torch.device) -> torch.Tensor:
        if dev not in bufs:
            bufs[dev] = pattern.to(dev).repeat(-(-max_size // PERIOD))
        return bufs[dev]

    def fill(t: torch.Tensor) -> torch.Tensor:
        dev = resolve_device(device) if device is not None or t.device.type == "meta" else t.device
        x = buf(dev)[: math.prod(t.shape)].reshape(t.shape)
        return x.clone(memory_format=torch.channels_last if x.ndim == 4 else torch.contiguous_format)

    return tree_map(fill, tree)


def fill_like(template, dtype: torch.dtype, device=None):
    """fill_params in `dtype`, each leaf then cast back to its template's
    dtype: a template from pipeline.init_params(device="meta") filled in the
    compute dtype keeps the layout the models expect (norms and the VAE
    encoder float32)."""
    return cast_like(fill_params(template, dtype, device), template)
