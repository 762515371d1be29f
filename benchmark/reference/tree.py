"""Nested dicts and lists of tensors: the weight trees both sides read."""

from __future__ import annotations


def leaves(tree):
    """Every tensor of a tree, depth first, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
