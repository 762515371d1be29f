"""Plain scaled-dot-product attention with a float32 softmax.

Port of posetraj_tpu/ops/attention.py:_xla_attention, the path CLIP (S=257)
and the VAE's single-head attention (head_dim 512) take in the JAX package
too. The spatial and temporal transformer sub-layers have their own kernels
(ops/qkvt.py, ops/temporal.py).
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, S, N, H) attention: float32 logits and softmax, probabilities cast
    back to q's dtype for the PV product."""
    logits = torch.einsum("bqnh,bknh->bnqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bnqk,bknh->bqnh", probs.to(q.dtype), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over flat (B, S, D) q and (B, S_kv, D) k/v."""
    b, sq, d = q.shape
    skv = k.shape[1]
    hd = d // num_heads
    if scale is None:
        scale = hd**-0.5
    out = dot_product_attention(
        q.reshape(b, sq, num_heads, hd), k.reshape(b, skv, num_heads, hd),
        v.reshape(b, skv, num_heads, hd), scale,
    )
    return out.reshape(b, sq, d)
