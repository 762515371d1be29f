"""Kernel 5: differentiable flash attention with a base-2 log-sum-exp.

Port of posetraj_tpu/ops/pallas_attention.py:flash_attention_diff: the
forward `_flash_fwd_lse` and the backward `_flash_bwd` (its dq and dk/dv
kernels). The CUDA kernels are posetraj_torch/csrc/flash.cu;
`flash_fwd_plain` and `flash_bwd_plain` are the same formulas in plain
PyTorch, in float32. `FlashAttention` is the `torch.autograd.Function`:
kernels for CUDA tensors, the plain versions for CPU tensors.

Layout: head-folded q (BN, Sq, d), k and v (BN, Skv, d), d in {64, 128};
lse (BN, Sq) float32 in the base-2 domain of the logits scaled by
scale * log2(e), lse = m + log2(sum exp2(s - m)).
"""

from __future__ import annotations

import torch

from posetraj_torch.ops import _native

NAME = "flash"
HEAD_DIMS = (64, 128)
LOG2E = 1.4426950408889634

# The plain versions materialise (folds, Sq, Skv) float32 logits; they walk
# the folds in chunks that keep each near this many bytes.
_PLAIN_LOGIT_BYTES = 1 << 30


def _chunks(bn: int, sq: int, skv: int):
    step = max(1, _PLAIN_LOGIT_BYTES // (sq * skv * 4))
    return [slice(i, min(i + step, bn)) for i in range(0, bn, step)]


def flash_fwd_plain(q, k, v, scale: float):
    """(o in q's dtype, lse float32) from float32 logits and softmax."""
    c = scale * LOG2E
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    for sl in _chunks(*q.shape[:2], k.shape[1]):
        s = torch.matmul(q[sl].float(), k[sl].float().transpose(1, 2)) * c
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o[sl] = (torch.matmul(p, v[sl].float()) / l).to(q.dtype)
        lse[sl] = (m + torch.log2(l))[..., 0]
    return o, lse


def flash_bwd_plain(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) in q's dtype: p = exp2(s * scale * log2e - lse),
    ds = p * (do v^T - rowsum(o * do)), dq = ds k * scale,
    dk = ds^T q * scale, dv = p^T do, all in float32."""
    c = scale * LOG2E
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for sl in _chunks(*q.shape[:2], k.shape[1]):
        qf, kf, vf, dof = q[sl].float(), k[sl].float(), v[sl].float(), do[sl].float()
        delta = (o[sl].float() * dof).sum(dim=-1, keepdim=True)
        p = torch.exp2(torch.matmul(qf, kf.transpose(1, 2)) * c - lse[sl, :, None])
        ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta)
        dq[sl] = (torch.matmul(ds, kf) * scale).to(q.dtype)
        dk[sl] = (torch.matmul(ds.transpose(1, 2), qf) * scale).to(k.dtype)
        dv[sl] = torch.matmul(p.transpose(1, 2), dof).to(v.dtype)
    return dq, dk, dv


def _check(name, q, k, v, *more):
    bn, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != bn or k.shape[2] != d or sq < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    _native.check_dtype(name, torch.bfloat16, q=q, k=k, v=v, **{f"arg{i}": t for i, t in enumerate(more)})


def flash_fwd_kernel(q, k, v, scale: float):
    """Kernel 5 forward on the card: (o bf16, lse float32)."""
    _check("flash_fwd", q, k, v)
    _native.check_cuda("flash_fwd", q=q, k=k, v=v)
    bn, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bn, sq), device=q.device, dtype=torch.float32)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_flash_fwd", [P, P, P, P, P, L, L, L, I, Fl],
        _native.ptr(q), _native.ptr(k), _native.ptr(v), _native.ptr(o), _native.ptr(lse),
        bn, sq, k.shape[1], d, float(scale), count="flash_fwd",
    )
    return o, lse


def flash_bwd_kernel(q, k, v, o, lse, do, scale: float):
    """Kernel 5 backward on the card (delta, dq, dk/dv in three launches of
    one call): (dq, dk, dv) bf16."""
    _check("flash_bwd", q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError("flash_bwd: o, do, lse do not match q")
    _native.check_cuda("flash_bwd", q=q, k=k, v=v, o=o, lse=lse, do=do)
    bn, sq, d = q.shape
    delta = torch.empty((bn, sq), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_flash_bwd", [P, P, P, P, P, P, P, P, P, P, L, L, L, I, Fl],
        *(_native.ptr(t) for t in (q, k, v, o, do, lse, delta, dq, dk, dv)),
        bn, sq, k.shape[1], d, float(scale), count="flash_bwd",
    )
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T * scale) v over head-folded (BN, S, d) tensors; the
    forward saves o and the base-2 lse, the backward recomputes the
    probabilities blockwise (flash_attention_diff's custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = (flash_fwd_kernel if q.is_cuda else flash_fwd_plain)(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_bwd_kernel if q.is_cuda else flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_applicable(q: torch.Tensor, skv: int, head_dim: int) -> bool:
    """The JAX dispatch rule (ops/attention.py:97-105) on the card: long
    query sequences (>= 512), at least as many keys as queries, head_dim
    64 or 128. CLIP (S = 257), the VAE (head_dim 512) and cross-attention
    (one key) are not taken."""
    return q.is_cuda and q.shape[1] >= 512 and skv >= q.shape[1] and head_dim in HEAD_DIMS


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """(B, Sq, N, H) q and (B, Skv, N, H) k/v -> (B, Sq, N, H) through
    FlashAttention, heads folded into the batch."""
    b, sq, n, h = q.shape
    skv = k.shape[1]

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * n, x.shape[1], h).contiguous()

    o = FlashAttention.apply(fold(q), fold(k), fold(v), float(scale))
    return o.reshape(b, n, sq, h).permute(0, 2, 1, 3)
