"""Kernels 5, 6 and 7: flash attention over bf16 operands, head_dim 64 or
128. The CUDA kernels are posetraj_torch/csrc/flash.cu; its forward is the
port's one flash-attention forward (csrc/flash_fwd.cuh, which kernel C
launches too), reading its operands through TMA tensor maps built from
their (batch, head, row) strides (`tma_operand` describes them), and serves
all three.

* Kernel 5, port of posetraj_tpu/ops/pallas_attention.py:flash_attention_diff:
  the forward `_flash_fwd_lse` and the backward `_flash_bwd` (its dq and dk/dv
  kernels) over head-folded q (BN, Sq, d), k and v (BN, Skv, d).
  `flash_fwd_plain` and `flash_bwd_plain` are the same formulas in plain
  PyTorch, in float32; `FlashAttention` is the `torch.autograd.Function`.
  lse (BN, Sq) is float32 in the base-2 domain of the logits scaled by
  scale * log2(e), lse = m + log2(sum exp2(s - m)). Counted as `flash_fwd`
  and `flash_bwd`.
* Kernel 6, port of flash_attention_qkv (`_flash_qkv_fwd_impl`): attention
  straight out of the packed (B, S, 3C) [q | k | v] projection, o (B, S, C)
  and lse (B, N, S); `FlashAttentionQKV` is its custom_vjp, whose backward is
  kernel 5's (`_fa_qkv_bwd`). Plain version `flash_qkv_plain`. Counted as
  `flash_qkv`.
* Kernel 7, port of the forward-only flash_attention_tq and flash_attention:
  (B, Sq, N, H) q and (B, Skv, N, H) k, v read in place, o (B, Sq, N, H), no
  lse. Plain version `flash_attention_tq_plain`. Counted as `flash_tq`.

Each wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from posetraj_torch.ops import _native

NAME = "flash"
HEAD_DIMS = (64, 128)
FWD_ROWS = 128  # rows of a q, k or v box of the forward (flash_fwd.cuh FwdTile)
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


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, S, N, H) -> contiguous head-folded (B*N, S, H)."""
    b, s, n, h = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * n, s, h).contiguous()


def _unfold(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*N, S, H) -> a (B, S, N, H) view."""
    bn, s, h = x.shape
    return x.reshape(b, bn // b, s, h).permute(0, 2, 1, 3)


def _check(name, q, k, v, *more):
    bn, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != bn or k.shape[2] != d or sq < 1 or k.shape[1] < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    _native.check_dtype(name, torch.bfloat16, q=q, k=k, v=v, **{f"arg{i}": t for i, t in enumerate(more)})


class TmaOperand(NamedTuple):
    """The rank-4 TMA tensor map the forward builds for one (B, S, N, d)
    bf16 operand: dims innermost first (d, S, N, B), the byte strides of S,
    N and B, the box (64 columns, `rows` rows of one head of one batch), and
    the view's byte offset in its storage."""

    dims: Tuple[int, int, int, int]
    strides: Tuple[int, int, int]
    box: Tuple[int, int, int, int]
    offset: int


def tma_operand(t: torch.Tensor, rows: int, name: str = "flash") -> TmaOperand:
    """Describe a (B, S, N, d) view as the forward's tensor map. Raises
    ValueError unless d is contiguous and the base address and every
    stride are multiples of 16 bytes, as TMA requires. S keeps its own
    axis, so a box that runs past S is zero-filled inside its (batch, head)
    and never reads the next one's rows."""
    b, s, n, d = t.shape
    es = t.element_size()
    strides = (t.stride(1) * es, t.stride(2) * es, t.stride(0) * es)
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head_dim axis must be contiguous, strides {t.stride()}")
    if t.data_ptr() % 16 or any(x % 16 for x in strides):
        raise ValueError(f"{name}: base address {t.data_ptr():#x} and byte strides {strides} must be multiples of 16 "
                         "(TMA)")
    return TmaOperand((d, s, n, b), strides, (64, rows, 1, 1), t.storage_offset() * es)


def _launch_fwd(q, k, v, scale: float, lse: bool, count: str):
    """The strided forward on (B, Sq, N, H) q and (B, Skv, N, H) k, v views
    (last axis contiguous, 16-byte aligned): o (B, Sq, N, H) bf16 and, if
    asked, lse (B*N, Sq) float32."""
    b, sq, n, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{count}: head_dim must be one of {HEAD_DIMS}, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (n, d) or sq < 1 or skv < 1:
        raise ValueError(f"{count}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    _native.check_dtype(count, torch.bfloat16, q=q, k=k, v=v)
    _native.check_cuda(count, strided=True, q=q, k=k, v=v)
    for t in (q, k, v):
        tma_operand(t, FWD_ROWS, count)
    o = torch.empty((b, sq, n, d), device=q.device, dtype=q.dtype)
    out_lse = torch.empty((b * n, sq), device=q.device, dtype=torch.float32) if lse else None
    P, I, L, Fl, LP = _native.P, _native.I, _native.L, _native.Fl, _native.LP
    strides = [_native.longs(t.stride(0), t.stride(2), t.stride(1)) for t in (q, k, v, o)]
    _native.call(
        NAME, "pt_flash_fwd", [P, P, P, P, P, L, I, L, L, I, Fl, LP, LP, LP, LP],
        _native.ptr(q), _native.ptr(k), _native.ptr(v), _native.ptr(o), _native.ptr(out_lse),
        b, n, sq, skv, d, float(scale), *strides, count=count,
    )
    return o, out_lse


def flash_fwd_kernel(q, k, v, scale: float):
    """Kernel 5 forward on the card, head-folded (BN, S, d): (o bf16, lse
    float32)."""
    o, lse = _launch_fwd(q[:, :, None], k[:, :, None], v[:, :, None], scale, True, "flash_fwd")
    return o[:, :, 0], lse


def flash_bwd_kernel(q, k, v, o, lse, do, scale: float):
    """Kernel 5 backward on the card (delta and the padded lse, dk/dv, dq in
    three launches of one call): (dq, dk, dv) bf16."""
    _check("flash_bwd", q, k, v, o, do)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2] or lse.dtype != torch.float32:
        raise ValueError("flash_bwd: o, do, lse do not match q")
    _native.check_cuda("flash_bwd", q=q, k=k, v=v, o=o, lse=lse, do=do)
    bn, sq, d = q.shape
    # lse and delta, each padded to whole 128-query blocks.
    stats = torch.empty((2, bn, -(-sq // 128) * 128), device=q.device, dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_flash_bwd", [P, P, P, P, P, P, P, P, P, P, L, L, L, I, Fl],
        *(_native.ptr(t) for t in (q, k, v, o, do, lse, stats, dq, dk, dv)),
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
    """The JAX dispatch rule (ops/attention.py:97-105) on the card, for
    kernels 5 and 7: long query sequences (>= 512), at least as many keys as
    queries, head_dim 64 or 128. CLIP (S = 257), the VAE (head_dim 512) and
    cross-attention (one key) are not taken."""
    return q.is_cuda and q.shape[1] >= 512 and skv >= q.shape[1] and head_dim in HEAD_DIMS


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """(B, Sq, N, H) q and (B, Skv, N, H) k/v -> (B, Sq, N, H) through
    FlashAttention (kernel 5), heads folded into the batch."""
    o = FlashAttention.apply(_fold(q), _fold(k), _fold(v), float(scale))
    return _unfold(o, q.shape[0])


# ---------------------------------------------------------------------------
# Kernel 7: forward-only flash attention
# ---------------------------------------------------------------------------


def flash_attention_tq_plain(q, k, v, scale: float) -> torch.Tensor:
    """(B, Sq, N, H) q, (B, Skv, N, H) k/v -> (B, Sq, N, H) in q's dtype,
    from float32 logits and softmax."""
    o, _ = flash_fwd_plain(_fold(q), _fold(k), _fold(v), scale)
    return _unfold(o, q.shape[0])


def flash_attention_tq(q, k, v, scale: float) -> torch.Tensor:
    """Forward-only attention over (B, Sq, N, H) q and (B, Skv, N, H) k/v;
    Skv may differ from Sq. CPU tensor: the plain version. CUDA tensor:
    kernel 7, which reads strided views (the split of a packed projection)
    in place, or an error. Not differentiable: a gradient goes through
    FlashAttention."""
    if not q.is_cuda:
        return flash_attention_tq_plain(q, k, v, scale)
    o, _ = _launch_fwd(q, k, v, scale, False, "flash_tq")
    return o


# ---------------------------------------------------------------------------
# Kernel 6: attention straight out of the packed QKV projection
# ---------------------------------------------------------------------------


def _unpack(qkv: torch.Tensor, num_heads: int):
    """(B, S, 3C) -> q, k, v as (B, S, N, H) views."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    return tuple(t.unflatten(-1, (num_heads, c // num_heads)) for t in qkv.split(c, dim=-1))


def flash_qkv_plain(qkv, num_heads: int, scale: float):
    """(o (B, S, C) in qkv's dtype, lse (B, N, S) float32) of the packed
    (B, S, 3C) [q | k | v] projection, through flash_fwd_plain."""
    b, s, _ = qkv.shape
    o, lse = flash_fwd_plain(*(_fold(t) for t in _unpack(qkv, num_heads)), scale)
    return _unfold(o, b).reshape(b, s, -1), lse.reshape(b, num_heads, s)


def flash_qkv_kernel(qkv, num_heads: int, scale: float):
    """Kernel 6 on the card: (o (B, S, C) bf16, lse (B, N, S) float32)."""
    b, s, c3 = qkv.shape
    if c3 % (3 * num_heads):
        raise ValueError(f"flash_qkv: {c3} channels do not split into q, k, v of {num_heads} heads")
    _native.check_cuda("flash_qkv", qkv=qkv)
    o, lse = _launch_fwd(*_unpack(qkv, num_heads), scale, True, "flash_qkv")
    return o.reshape(b, s, c3 // 3), lse.reshape(b, num_heads, s)


class FlashAttentionQKV(torch.autograd.Function):
    """flash_attention_qkv's custom_vjp: the forward saves (qkv, o, lse);
    the backward unpacks q, k, v, runs kernel 5's backward with lse folded
    to (B*N, S) and concatenates dq, dk, dv (_fa_qkv_bwd)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, scale: float):
        o, lse = (flash_qkv_kernel if qkv.is_cuda else flash_qkv_plain)(qkv, num_heads, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.static = (num_heads, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        num_heads, scale = ctx.static
        b, s, _ = qkv.shape
        fold = lambda t: _fold(t.unflatten(-1, (num_heads, -1)))
        bwd = flash_bwd_kernel if qkv.is_cuda else flash_bwd_plain
        grads = bwd(*(_fold(t) for t in _unpack(qkv, num_heads)), fold(o), lse.reshape(b * num_heads, s),
                    fold(do), scale)
        return torch.cat([_unfold(g, b).reshape(b, s, -1) for g in grads], dim=-1), None, None


def flash_attention_qkv(qkv, num_heads: int, scale: float) -> torch.Tensor:
    """Self-attention on the packed (B, S, 3C) projection -> (B, S, C).
    CPU tensor: the plain version. CUDA tensor: kernel 6, or an error.
    Differentiable in qkv."""
    return FlashAttentionQKV.apply(qkv, num_heads, float(scale))


def flash_qkv_applicable(qkv: torch.Tensor, num_heads: int) -> bool:
    """The JAX dispatch rule of self_attention_qkv (ops/attention.py:51-57)
    on the card: S >= 512 and head_dim 128. The port masks a ragged S, so
    the TPU's block-divisibility rule (qkv_blocks) is not copied."""
    return qkv.is_cuda and qkv.shape[1] >= 512 and qkv.shape[-1] == 3 * 128 * num_heads
