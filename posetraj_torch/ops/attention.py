"""Multi-head attention: the JAX package's dispatch (ops/attention.py:66-137).

On the card, long sequences (S >= 512, at least as many keys as queries,
head_dim 64 or 128) go to kernel 5, the differentiable flash attention of
ops/flash.py; that is the path the training backward of kernel C takes.
Everything else, and every CPU tensor, takes the plain float32-softmax
`dot_product_attention` (port of _xla_attention): CLIP (S = 257), the VAE's
single-head attention (head_dim 512) and cross-attention (one key). The
spatial and temporal sub-layers' forwards have their own kernels
(ops/qkvt.py, ops/temporal.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from posetraj_torch.ops import flash


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
    qh, kh, vh = (t.reshape(b, t.shape[1], num_heads, hd) for t in (q, k, v))
    if flash.flash_applicable(q, skv, hd):
        out = flash.flash_attention(qh, kh, vh, scale)
    else:
        out = dot_product_attention(qh, kh, vh, scale)
    return out.reshape(b, sq, d)
