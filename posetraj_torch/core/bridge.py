"""Turn a JAX-package parameter tree (nested dicts/lists with numpy or JAX
array leaves) into the port's parameters.

Layout changes, made once here rather than on every call:
  * linear `kernel` (in, out)            -> `weight` (out, in)
  * conv `kernel` HWIO (kh, kw, in, out) -> `weight` OIHW, channels-last memory
  * temporal conv (kf, 1, 1, in, out)    -> `weight` (out, in, kf, 1, 1)
  * norm `scale`/`bias`                  -> `weight`/`bias`, kept float32
  * a self-attention (`attn1`) gets `wqkv` = [Wq|Wk|Wv] stacked on the output
    axis, (3C, C), in place of to_q/to_k/to_v. The JAX model concatenates
    them on every call and leaves XLA to hoist it; eager PyTorch would redo
    it every step.
Every other floating leaf is cast to `dtype`.

Only the port's tests import the JAX package; this module takes plain arrays
and imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from posetraj_torch.core.init import prepare_conv_weight


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _layer(node: dict, device, dtype) -> dict:
    k = np.asarray(node["kernel"], np.float32)
    if k.ndim == 2:
        w = k.T
    elif k.ndim == 4:
        w = k.transpose(3, 2, 0, 1)
    elif k.ndim == 5:
        w = k.transpose(4, 3, 0, 1, 2)
    else:
        raise ValueError(f"unexpected kernel rank {k.ndim}")
    out = {"weight": prepare_conv_weight(_tensor(w, device, dtype))}
    if "bias" in node:
        out["bias"] = _tensor(node["bias"], device, dtype)
    return out


def _self_attention(node: dict, device, dtype) -> dict:
    if any("bias" in node[n] for n in ("to_q", "to_k", "to_v")):
        raise ValueError("self-attention projections are bias-free in SVD")
    wqkv = np.concatenate(
        [np.asarray(node[n]["kernel"], np.float32).T for n in ("to_q", "to_k", "to_v")], axis=0
    )
    return {"wqkv": _tensor(wqkv, device, dtype), "to_out": _layer(node["to_out"], device, dtype)}


def params_from_jax(tree, device="cpu", dtype: torch.dtype = torch.float32):
    """Convert one JAX parameter tree; see the module docstring."""

    def walk(node, key=None):
        if isinstance(node, dict):
            if "kernel" in node:
                return _layer(node, device, dtype)
            if "scale" in node:
                return {
                    "weight": _tensor(node["scale"], device, torch.float32),
                    "bias": _tensor(node["bias"], device, torch.float32),
                }
            if key == "attn1":
                return _self_attention(node, device, dtype)
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if key == "mix_factor":
            return _tensor(node, device, torch.float32)
        return _tensor(node, device, dtype)

    return walk(tree)
