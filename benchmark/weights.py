"""Seeded weights on the device, in bulk.

The program's parameter tree gives only the shapes, dtypes and memory
layouts (its `init_params(device="meta")`). Every leaf becomes a view into
one flat buffer per dtype, filled by one uniform draw from a generator on
the device; the leaves are then scaled in a few foreach calls:

- a weight with two or more axes, and its bias: U(-1/sqrt(fan_in), +),
  PyTorch's layer default. The ControlNet's zero convolutions get it too,
  so that its residuals reach the output the comparison judges;
- a norm's scale 1 + U(-0.1, 0.1) and shift U(-0.1, 0.1), so that a norm
  whose affine is dropped shows;
- any other vector (CLIP's class embedding, the blend factors):
  U(-1/sqrt(size), +).

The values are whatever the dtype holds, and the reference reads the same
tensors upcast to float32. `refill(seed)` draws anew into the same
buffers, so a captured CUDA graph that holds their addresses stays valid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.tree import tree_map


# Elements of one uniform draw: a float32 temporary of 512 MB.
PIECE = 1 << 27
# Each leaf starts on a 512-byte boundary of its buffer, as an allocation
# of its own would (the program's kernels take 16-byte aligned pointers).
ALIGN_BYTES = 512


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for stream `tag` of the run's --seed."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def walk(tree, path=()):
    """(path, leaf) of every tensor of a tree, in the order of `tree.leaves`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (str(i),))
    else:
        yield path, tree


def _scale(path, leaf, siblings) -> tuple:
    """(multiplier, offset) that map U(-1, 1) onto this leaf's range."""
    name, parent = path[-1], path[-2] if len(path) > 1 else ""
    if "norm" in parent:
        return (0.1, 1.0) if name == "weight" else (0.1, 0.0)
    if leaf.ndim >= 2:
        return 1.0 / math.sqrt(math.prod(leaf.shape[1:])), 0.0
    w = siblings.get("weight")
    if name == "bias" and w is not None and w.ndim >= 2:
        return 1.0 / math.sqrt(math.prod(w.shape[1:])), 0.0
    return 1.0 / math.sqrt(leaf.numel()), 0.0


class Weights:
    """The weight tree of one run: `tree` (nested dicts of tensors shaped and
    laid out as the template's leaves), made on `device` from `seed`."""

    def __init__(self, template: dict, seed: int, device):
        self.device = torch.device(device)
        items = list(walk(template))
        parents = {}
        for path, leaf in items:
            parents.setdefault(path[:-1], {})[path[-1]] = leaf
        self.buffers = {}
        starts, sizes = [], {}
        for _, leaf in items:
            step = ALIGN_BYTES // leaf.element_size()
            starts.append(sizes.get(leaf.dtype, 0))
            sizes[leaf.dtype] = starts[-1] + -(-leaf.numel() // step) * step
        for dt, n in sizes.items():
            self.buffers[dt] = torch.empty(n, dtype=dt, device=self.device)
        views, self._groups = [], {}
        for (path, leaf), off in zip(items, starts):
            view = self.buffers[leaf.dtype].as_strided(leaf.shape, leaf.stride(), off)
            views.append(view)
            key = (leaf.dtype, *_scale(path, leaf, parents[path[:-1]]))
            self._groups.setdefault(key, []).append(view)
        it = iter(views)
        self.tree = tree_map(lambda _: next(it), template)
        self.refill(seed)

    @torch.no_grad()
    def refill(self, seed: int) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(seed, "weights"))
        for dt in sorted(self.buffers, key=str):
            buf = self.buffers[dt]
            for i in range(0, buf.numel(), PIECE):
                piece = buf[i:i + PIECE]
                piece.copy_(torch.rand(piece.numel(), generator=gen, device=self.device))
            buf.mul_(2.0).sub_(1.0)
        for (dt, mult, offset), views in self._groups.items():
            torch._foreach_mul_(views, mult)
            if offset:
                torch._foreach_add_(views, offset)

