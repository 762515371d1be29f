"""Kernel D: the temporal (frame-axis) self-attention sub-layer
x + to_out(frame_attention(LN(x))) over x (B, F, S, C).

Port of posetraj_tpu/ops/pallas_temporal.py:temporal_attn_sublayer. The
CUDA kernel is posetraj_torch/csrc/temporal.cu (LN+QKV GEMM, per-pixel frame
attention, out-proj GEMM with the residual); `temporal_attn_sublayer_plain`
is the same function in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posetraj_torch.ops import _native

NAME = "temporal"
HEAD_DIM = 64
MAX_FRAMES = 32


def frame_attention(q, k, v, num_heads: int) -> torch.Tensor:
    """Attention over the frame axis of (B, F, S, C) q and (B, F_kv, S, C)
    k/v: float32 logits (B, N, Fq, Fk, S) and softmax over Fk, probabilities
    cast to q's dtype (models/transformer._frame_axis_attention)."""
    b, f, s, c = q.shape
    fk = k.shape[1]
    hd = c // num_heads
    q5 = q.reshape(b, f, s, num_heads, hd)
    k5 = k.reshape(b, fk, s, num_heads, hd)
    v5 = v.reshape(b, fk, s, num_heads, hd)
    logits = torch.einsum("bqsnh,bksnh->bnqks", q5.float(), k5.float())
    probs = torch.softmax(logits * hd**-0.5, dim=3)
    out = torch.einsum("bnqks,bksnh->bqsnh", probs.to(q.dtype), v5)
    return out.reshape(b, f, s, c)


def temporal_attn_sublayer_plain(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Reference formulation (pallas_temporal._ref_temporal_sublayer)."""
    c = x.shape[-1]
    h = F.layer_norm(x.float(), (c,), ln_w.float(), ln_b.float(), eps).to(x.dtype)
    q, k, v = F.linear(h, wqkv).chunk(3, dim=-1)
    return x + F.linear(frame_attention(q, k, v, num_heads), wo, bo)


def temporal_attn_sublayer(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x (B, F, S, C); wqkv (3C, C) = [Wq; Wk; Wv]; wo (C, C); bo (C,).
    CPU tensor: the plain version. CUDA tensor: kernel D, or an error."""
    if not x.is_cuda:
        return temporal_attn_sublayer_plain(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)
    return temporal_attn_sublayer_kernel(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)


def temporal_attn_sublayer_kernel(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    b, f, s, c = x.shape
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"temporal kernel: head_dim must be {HEAD_DIM} (C={c}, heads={num_heads})")
    if f > MAX_FRAMES:
        raise ValueError(f"temporal kernel: at most {MAX_FRAMES} frames, got {f}")
    if wqkv.shape != (3 * c, c) or wo.shape != (c, c) or bo.shape != (c,):
        raise ValueError("temporal kernel: weight shapes do not match")
    _native.check_dtype("temporal_attn_sublayer", torch.bfloat16, x=x, wqkv=wqkv, wo=wo, bo=bo)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _native.check_cuda("temporal_attn_sublayer", x=x, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, wo=wo, bo=bo)
    qkv = torch.empty((b, f, s, 3 * c), device=x.device, dtype=x.dtype)
    o = torch.empty_like(x)
    stats = torch.empty((b * f * s, 2), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_temporal_sublayer",
        [P, P, P, P, P, P, P, P, P, P, L, I, L, I, I, Fl, Fl],
        _native.ptr(x), _native.ptr(ln_w), _native.ptr(ln_b), _native.ptr(wqkv), _native.ptr(wo),
        _native.ptr(bo), _native.ptr(qkv), _native.ptr(o), _native.ptr(stats), _native.ptr(out),
        b, f, s, c, num_heads, float(eps), float(HEAD_DIM**-0.5),
    )
    return out
