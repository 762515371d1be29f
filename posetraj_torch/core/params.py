"""Parameter-tree utilities: counting, casting, flattening, EMA. A tree is
nested dicts and lists of tensors, as core/init.py makes them."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

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


def chunks(tensors, limit: int) -> Iterator[list]:
    """Consecutive groups of `tensors` of at most `limit` elements each (a
    larger tensor alone)."""
    group, n = [], 0
    for t in tensors:
        if group and n + t.numel() > limit:
            yield group
            group, n = [], 0
        group.append(t)
        n += t.numel()
    if group:
        yield group


def count_params(tree) -> int:
    return sum(t.numel() for t in leaves(tree))


def tree_map(fn: Callable, tree):
    """The tree with every leaf replaced by fn(leaf); a tuple becomes a list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cast(tree, dtype: torch.dtype):
    """The tree with every leaf converted to `dtype`."""
    return tree_map(lambda t: t.to(dtype), tree)


def cast_like(tree, like):
    """The tree with each leaf converted to the dtype of its counterpart in
    `like`, a tree of the same structure whose leaves are tensors or
    dtypes (e.g. float32 masters back to the layout core/init.py makes:
    norms float32, the rest the compute dtype)."""
    if isinstance(tree, dict):
        return {k: cast_like(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_like(v, w) for v, w in zip(tree, like)]
    return tree.to(getattr(like, "dtype", like))


def flatten_dict(tree, prefix: str = "", sep: str = ".") -> Dict[str, torch.Tensor]:
    """Nested dict/list -> {"a.0.c": leaf}, for checkpoints and audits."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flatten_dict(v, key, sep))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: Dict[str, torch.Tensor], sep: str = ".") -> Dict:
    """Inverse of flatten_dict: a node whose keys are all digits becomes a
    list."""
    out: Dict = {}
    for key, v in flat.items():
        parts = key.split(sep)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(out)


@torch.no_grad()
def ema_update(ema, new, decay: float) -> None:
    """ema := decay * ema + (1 - decay) * new, in place (the diffusers
    EMAModel step), with foreach ops. In place so that the shadow copy costs
    no second buffer."""
    ema, new = list(leaves(ema)), [p.to(e.dtype) for e, p in zip(leaves(ema), leaves(new))]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, new, alpha=1.0 - decay)


def ema_decay_schedule(optimization_step: int, max_decay: float = 0.9999) -> float:
    """diffusers EMAModel.get_decay without warmup: min(max_decay,
    (1 + s) / (10 + s)) with s = optimization_step - 1, and 0.0 on the first
    update (the shadow becomes the params). `optimization_step` counts
    completed optimizer updates from 1."""
    step = max(optimization_step - 1, 0)
    if step <= 0:
        return 0.0
    return min((1.0 + step) / (10.0 + step), max_decay)


def param_audit(tree, trainable_fn: Optional[Callable[[str], bool]] = None) -> str:
    """One line a leaf, sorted by name: "train " or "frozen", the dotted
    name, the shape and the dtype (the reference's rec_para.txt). The dtype
    is written as numpy names it ("float32", "bfloat16")."""
    lines = []
    for name, leaf in sorted(flatten_dict(tree).items()):
        tag = "train " if (trainable_fn(name) if trainable_fn else True) else "frozen"
        lines.append(f"{tag} {name} {tuple(leaf.shape)} {str(leaf.dtype).removeprefix('torch.')}")
    return "\n".join(lines)
