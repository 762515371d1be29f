"""Kernel C: the spatial self-attention sub-layer x + to_out(MHA(LN(x))).

Port of posetraj_tpu/ops/pallas_qkvt.py:attn_sublayer. The CUDA kernel is
posetraj_torch/csrc/qkvt.cu (the LayerNorm pre-pass, the QKV GEMM, flash
attention, the out-proj GEMM with the residual; both GEMMs are
csrc/gemm.cuh's, counted under `gemm` as well); `attn_sublayer_plain` is the same function in plain
PyTorch, attention included. `AttnSublayer` is its custom_vjp
(_asl_fwd/_asl_bwd): the forward runs the kernel on the card and saves its
inputs, the backward recomputes `attn_sublayer_ref`, whose attention()
reaches kernel 5 on the card. `attn_sublayer_applicable` is the dispatch
gate of models/transformer.basic_transformer_block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posetraj_torch.configs import kernel_config
from posetraj_torch.ops import _native, gemm
from posetraj_torch.ops.attention import attention, dot_product_attention
from posetraj_torch.ops.recompute import recompute_vjp

NAME = "qkvt"
HEAD_DIM = 64

# The plain version materialises (batch, heads, S, S) float32 logits; it
# walks the batch in chunks that keep them near this many bytes.
_PLAIN_LOGIT_BYTES = 2 << 30


def attn_sublayer_applicable(x: torch.Tensor, num_heads: int, wqkv=None, wo=None) -> bool:
    """The JAX gate (pallas_qkvt.attn_sublayer_applicable): KernelConfig.qkvt_attn,
    within kernel C's own limits (x (B, S, C), head_dim 64, C <= gemm.MAX_K,
    wqkv (3C, C) and wo (C, C) where given) instead of the TPU's rules on S
    and its tiles."""
    if not kernel_config().qkvt_attn or x.ndim != 3 or num_heads <= 0:
        return False
    c = x.shape[-1]
    return (c == num_heads * HEAD_DIM and c <= gemm.MAX_K and (wqkv is None or tuple(wqkv.shape) == (3 * c, c))
            and (wo is None or tuple(wo.shape) == (c, c)))


def _sublayer(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float, attend) -> torch.Tensor:
    """LN in float32 cast to x.dtype, fused QKV projection, attend(q, k, v,
    num_heads) over flat (B, S, C), out-projection plus bias plus residual."""
    c = x.shape[-1]
    h = F.layer_norm(x.float(), (c,), ln_w.float(), ln_b.float(), eps).to(x.dtype)
    q, k, v = F.linear(h, wqkv).chunk(3, dim=-1)
    return x + F.linear(attend(q, k, v, num_heads), wo, bo)


def _plain_attention(q, k, v, num_heads: int) -> torch.Tensor:
    b, s, c = q.shape
    hd = c // num_heads
    qh, kh, vh = (t.reshape(b, s, num_heads, hd) for t in (q, k, v))
    return dot_product_attention(qh, kh, vh, hd**-0.5).reshape(b, s, c)


def attn_sublayer_ref(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Reference formulation (pallas_qkvt._ref_attn_sublayer) through
    attention(): kernel 5 on the card for S >= 512, float32-softmax
    attention otherwise. The backward of kernel C recomputes it."""
    return _sublayer(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps, attention)


def attn_sublayer_plain(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The same function in plain PyTorch at every S (dot_product_attention,
    never kernel 5), over chunks of the batch, so that the (batch, heads, S,
    S) float32 logits stay near _PLAIN_LOGIT_BYTES."""
    b, s, _ = x.shape
    chunk = max(1, _PLAIN_LOGIT_BYTES // (num_heads * s * s * 4))
    outs = [_sublayer(x[i : i + chunk], ln_w, ln_b, wqkv, wo, bo, num_heads, eps, _plain_attention)
            for i in range(0, b, chunk)]
    return torch.cat(outs, dim=0)


class AttnSublayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, wo, bo)
        ctx.static = (num_heads, eps)
        run = attn_sublayer_kernel if x.is_cuda else attn_sublayer_plain
        return run(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)

    @staticmethod
    def backward(ctx, grad):
        num_heads, eps = ctx.static
        fn = lambda *a: attn_sublayer_ref(*a, num_heads, eps)
        return recompute_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:6], grad) + (None, None)


def attn_sublayer(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x (B, S, C); wqkv (3C, C) = [Wq; Wk; Wv]; wo (C, C); bo (C,); ln
    (C,). CPU tensor: the plain version. CUDA tensor: kernel C, or an error.
    Differentiable in every tensor argument."""
    return AttnSublayer.apply(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)


def attn_sublayer_kernel(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    b, s, c = x.shape
    if c != num_heads * HEAD_DIM or c > gemm.MAX_K:
        raise ValueError(f"attn_sublayer kernel: head_dim must be {HEAD_DIM} and C <= {gemm.MAX_K} (C={c}, "
                         f"heads={num_heads})")
    if wqkv.shape != (3 * c, c) or wo.shape != (c, c) or bo.shape != (c,):
        raise ValueError("attn_sublayer kernel: weight shapes do not match")
    _native.check_dtype("attn_sublayer", torch.bfloat16, x=x, wqkv=wqkv, wo=wo, bo=bo)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _native.check_cuda("attn_sublayer", x=x, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, wo=wo, bo=bo)
    qkv = torch.empty((3, b, num_heads, s, HEAD_DIM), device=x.device, dtype=x.dtype)
    o = torch.empty_like(x)  # LN(x), then the attention's output
    out = torch.empty_like(x)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_attn_sublayer",
        [P, P, P, P, P, P, P, P, P, L, L, I, I, Fl, Fl],
        _native.ptr(x), _native.ptr(ln_w), _native.ptr(ln_b), _native.ptr(wqkv), _native.ptr(wo),
        _native.ptr(bo), _native.ptr(qkv), _native.ptr(o), _native.ptr(out),
        b, s, c, num_heads, float(eps), float(HEAD_DIM**-0.5), also=((gemm.COUNT, 2),),
    )
    return out
