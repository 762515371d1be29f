"""Multi-head attention: the JAX package's dispatch (ops/attention.py:32-137).

On the card, long sequences (S >= 512, at least as many keys as queries,
head_dim 64 or 128) go to the flash kernels of ops/flash.py, by the two
routes of the JAX custom_vjp (flash_attention_diff): where a gradient is
needed (grad mode on and q, k or v requires grad), kernel 5's
differentiable FlashAttention, the path the training backward of kernel C
takes; otherwise kernel 7, the forward-only flash attention, which the
un-fused spatial self-attention takes (KernelConfig.qkvt_attn off).
`self_attention_qkv` sends a packed projection with head_dim 128 to kernel 6.
Everything else, and every CPU tensor, takes the plain float32-softmax
`dot_product_attention` (port of _xla_attention): CLIP (S = 257), the VAE's
single-head attention (head_dim 512), cross-attention (one key) and S < 512.
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


def self_attention_qkv(qkv: torch.Tensor, num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention on the packed projection (B, S, 3C) laid out
    [q | k | v] -> (B, S, C). Kernel 6 where it applies; otherwise the q, k,
    v views of the split go to attention(), where kernel 7 reads them in
    place."""
    c = qkv.shape[-1] // 3
    if scale is None:
        scale = (c // num_heads) ** -0.5
    if flash.flash_qkv_applicable(qkv, num_heads):
        return flash.flash_attention_qkv(qkv, num_heads, scale)
    q, k, v = qkv.split(c, dim=-1)
    return attention(q, k, v, num_heads, scale)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over flat (B, S, D) q and (B, S_kv, D) k/v."""
    b, sq, d = q.shape
    skv = k.shape[1]
    hd = d // num_heads
    if scale is None:
        scale = hd**-0.5
    qh, kh, vh = (t.reshape(b, t.shape[1], num_heads, hd) for t in (q, k, v))
    if not flash.flash_applicable(q, skv, hd):
        out = dot_product_attention(qh, kh, vh, scale)
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = flash.flash_attention(qh, kh, vh, scale)
    else:
        out = flash.flash_attention_tq(qh, kh, vh, scale)
    return out.reshape(b, sq, d)
