"""Kernel C: the spatial self-attention sub-layer x + to_out(MHA(LN(x))).

Port of posetraj_tpu/ops/pallas_qkvt.py:attn_sublayer. The CUDA kernel is
posetraj_torch/csrc/qkvt.cu (LN+QKV GEMM, flash attention, out-proj GEMM
with the residual); `attn_sublayer_plain` is the same function in plain
PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posetraj_torch.ops import _native
from posetraj_torch.ops.attention import attention

NAME = "qkvt"
HEAD_DIM = 64

# The plain version materialises (batch, heads, S, S) float32 logits; it
# walks the batch in chunks that keep them near this many bytes.
_PLAIN_LOGIT_BYTES = 2 << 30


def attn_sublayer_plain(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Reference formulation (pallas_qkvt._ref_attn_sublayer): LN in float32
    cast to x.dtype, fused QKV projection, float32-softmax attention,
    out-projection plus bias plus residual, in x.dtype."""
    b, s, c = x.shape
    per_sample = num_heads * s * s * 4
    chunk = max(1, _PLAIN_LOGIT_BYTES // per_sample)
    outs = []
    for i in range(0, b, chunk):
        xc = x[i : i + chunk]
        h = F.layer_norm(xc.float(), (c,), ln_w.float(), ln_b.float(), eps).to(x.dtype)
        q, k, v = F.linear(h, wqkv).chunk(3, dim=-1)
        outs.append(xc + F.linear(attention(q, k, v, num_heads), wo, bo))
    return torch.cat(outs, dim=0)


def attn_sublayer(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x (B, S, C); wqkv (3C, C) = [Wq; Wk; Wv]; wo (C, C); bo (C,); ln
    (C,). CPU tensor: the plain version. CUDA tensor: kernel C, or an error."""
    if not x.is_cuda:
        return attn_sublayer_plain(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)
    return attn_sublayer_kernel(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)


def attn_sublayer_kernel(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    b, s, c = x.shape
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"attn_sublayer kernel: head_dim must be {HEAD_DIM} (C={c}, heads={num_heads})")
    if wqkv.shape != (3 * c, c) or wo.shape != (c, c) or bo.shape != (c,):
        raise ValueError("attn_sublayer kernel: weight shapes do not match")
    _native.check_dtype("attn_sublayer", torch.bfloat16, x=x, wqkv=wqkv, wo=wo, bo=bo)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _native.check_cuda("attn_sublayer", x=x, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, wo=wo, bo=bo)
    qkv = torch.empty((3, b, num_heads, s, HEAD_DIM), device=x.device, dtype=x.dtype)
    o = torch.empty_like(x)
    stats = torch.empty((b * s, 2), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_attn_sublayer",
        [P, P, P, P, P, P, P, P, P, P, L, L, I, I, Fl, Fl],
        _native.ptr(x), _native.ptr(ln_w), _native.ptr(ln_b), _native.ptr(wqkv), _native.ptr(wo),
        _native.ptr(bo), _native.ptr(qkv), _native.ptr(o), _native.ptr(stats), _native.ptr(out),
        b, s, c, num_heads, float(eps), float(HEAD_DIM**-0.5),
    )
    return out
