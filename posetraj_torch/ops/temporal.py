"""Kernel D: the temporal (frame-axis) self-attention sub-layer
x + to_out(frame_attention(LN(x))) over x (B, F, S, C).

Port of posetraj_tpu/ops/pallas_temporal.py:temporal_attn_sublayer. The
CUDA kernel is posetraj_torch/csrc/temporal.cu (the LayerNorm pre-pass, the
QKV GEMM, per-pixel frame attention on mma.sync fed by TMA, the out-proj
GEMM with the residual; both GEMMs are csrc/gemm.cuh's, counted under `gemm`
as well, the frame attention under `frame_attn`); `temporal_attn_sublayer_plain`
is the same function in plain PyTorch. `frame_attention_kernel` launches
the frame attention alone on a QKV scratch, beside its plain version
`frame_attention`. `TemporalAttnSublayer` is its
custom_vjp (_tas_fwd/_tas_bwd): kernel forward, plain recompute backward.
`temporal_attn_sublayer_applicable` is the dispatch gate of
models/transformer.temporal_basic_transformer_block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posetraj_torch.configs import kernel_config
from posetraj_torch.ops import _native, gemm
from posetraj_torch.ops.recompute import recompute_vjp

NAME = "temporal"
CORE = "frame_attn"
HEAD_DIM = 64
# The frame kernel holds one pixel's frames in one 16-row mma tile; the JAX
# gate declines F > 16 too (pallas_temporal.temporal_attn_sublayer_applicable).
MAX_FRAMES = 16


def temporal_attn_sublayer_applicable(x: torch.Tensor, num_heads: int, wqkv=None, wo=None) -> bool:
    """The JAX gate (pallas_temporal.temporal_attn_sublayer_applicable):
    KernelConfig.temporal_attn, within kernel D's own limits (x (B, F, S, C),
    F <= 16, head_dim 64, C <= gemm.MAX_K, wqkv (3C, C) and wo (C, C) where
    given) instead of the TPU's rules on S and its tiles."""
    if not kernel_config().temporal_attn or x.ndim != 4 or num_heads <= 0:
        return False
    f, c = x.shape[1], x.shape[-1]
    return (1 <= f <= MAX_FRAMES and c == num_heads * HEAD_DIM and c <= gemm.MAX_K
            and (wqkv is None or tuple(wqkv.shape) == (3 * c, c)) and (wo is None or tuple(wo.shape) == (c, c)))


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


class TemporalAttnSublayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float):
        ctx.save_for_backward(x, ln_w, ln_b, wqkv, wo, bo)
        ctx.static = (num_heads, eps)
        run = temporal_attn_sublayer_kernel if x.is_cuda else temporal_attn_sublayer_plain
        return run(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)

    @staticmethod
    def backward(ctx, grad):
        num_heads, eps = ctx.static
        fn = lambda *a: temporal_attn_sublayer_plain(*a, num_heads, eps)
        return recompute_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:6], grad) + (None, None)


def temporal_attn_sublayer(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x (B, F, S, C); wqkv (3C, C) = [Wq; Wk; Wv]; wo (C, C); bo (C,).
    CPU tensor: the plain version. CUDA tensor: kernel D, or an error.
    Differentiable in every tensor argument."""
    return TemporalAttnSublayer.apply(x, ln_w, ln_b, wqkv, wo, bo, num_heads, eps)


def temporal_attn_sublayer_kernel(x, ln_w, ln_b, wqkv, wo, bo, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    b, f, s, c = x.shape
    if c != num_heads * HEAD_DIM or c > gemm.MAX_K:
        raise ValueError(f"temporal kernel: head_dim must be {HEAD_DIM} and C <= {gemm.MAX_K} (C={c}, "
                         f"heads={num_heads})")
    if f > MAX_FRAMES:
        raise ValueError(f"temporal kernel: at most {MAX_FRAMES} frames, got {f}")
    if wqkv.shape != (3 * c, c) or wo.shape != (c, c) or bo.shape != (c,):
        raise ValueError("temporal kernel: weight shapes do not match")
    _native.check_dtype("temporal_attn_sublayer", torch.bfloat16, x=x, wqkv=wqkv, wo=wo, bo=bo)
    ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _native.check_cuda("temporal_attn_sublayer", x=x, ln_w=ln_w, ln_b=ln_b, wqkv=wqkv, wo=wo, bo=bo)
    qkv = torch.empty((b, f, s, 3 * c), device=x.device, dtype=x.dtype)
    o = torch.empty_like(x)  # LN(x), then the frame attention's output
    out = torch.empty_like(x)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_temporal_sublayer",
        [P, P, P, P, P, P, P, P, P, L, I, L, I, I, Fl, Fl],
        _native.ptr(x), _native.ptr(ln_w), _native.ptr(ln_b), _native.ptr(wqkv), _native.ptr(wo),
        _native.ptr(bo), _native.ptr(qkv), _native.ptr(o), _native.ptr(out),
        b, f, s, c, num_heads, float(eps), float(HEAD_DIM**-0.5), also=((gemm.COUNT, 2), (CORE, 1)),
    )
    return out


def frame_attention_kernel(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Frame attention of kernel D alone: qkv (B, F, S, 3C) laid out
    [q | k | v] as D's QKV GEMM writes it -> o (B, F, S, C), the function
    frame_attention(*qkv.chunk(3, -1), num_heads) computes. CUDA only."""
    b, f, s, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c != num_heads * HEAD_DIM or not 1 <= f <= MAX_FRAMES:
        raise ValueError(f"frame attention kernel: head_dim {HEAD_DIM} and 1 <= F <= {MAX_FRAMES} (F={f}, "
                         f"3C={c3}, heads={num_heads})")
    _native.check_dtype("frame_attention", torch.bfloat16, qkv=qkv)
    _native.check_cuda("frame_attention", qkv=qkv)
    o = torch.empty((b, f, s, c), device=qkv.device, dtype=qkv.dtype)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(NAME, "pt_frame_attention", [P, P, L, I, L, I, I, Fl], _native.ptr(qkv), _native.ptr(o), b, f, s, c,
                 num_heads, float(HEAD_DIM**-0.5), count=CORE)
    return o
