"""Spatial + temporal transformer blocks and the TransformerSpatioTemporalModel
(diffusers 0.24.0 attention.py / transformer_temporal.py).

Shapes: spatial tokens (B*F, H*W, C); temporal blocks work on (B, F, S, C)
without the (B*S, F, C) transpose. The sub-layers follow the JAX package's
dispatch under the active KernelConfig (configs.kernel_config):
  * spatial self-attention: kernel C (ops/qkvt.attn_sublayer) where its
    gate (qkvt.attn_sublayer_applicable: qkvt_attn, head_dim 64) and the
    block's `backend` allow it; else LayerNorm + attention_module (the packed
    projection, ops/attention.self_attention_qkv: kernel 7, or 6 at head_dim
    128)
  * temporal self-attention: kernel D (ops/temporal.temporal_attn_sublayer)
    where its gate (temporal.temporal_attn_sublayer_applicable:
    temporal_attn, head_dim 64, F <= 16) allows it; else LayerNorm +
    _frame_axis_attention
  * every GEGLU feed-forward: kernel B (ops/mlp.geglu_mlp) with the
    LayerNorm, residual and addend folded in under fused_ff_ln; else a
    standalone LayerNorm and kernel B without it; plain GEGLU when fused_ff
    is off or kernel B's gate declines
  * every standalone LayerNorm: kernel 8 under fused_ln (ops/primitives.layer_norm)

Quirk Q7 (diffusers 0.24.0): the temporal cross-attention context is built
sequence-major while the hidden rows are batch-major, so for the CFG batch of
2 the cond/uncond contexts interleave across pixels; reproduced here.

Under sharded serving (parallel/spmd.py) kernels C and D decline, spatial
self-attention gathers K/V over sp, and the Q7 index uses global batch rows
and pixel positions; over a ("data", "model") mesh (parallel/mesh.py) it
uses the global batch's rows and table (mesh.global_batch_rows).
"""

from __future__ import annotations

from typing import Optional

import torch

from posetraj_torch.configs import kernel_config
from posetraj_torch.core.init import Init
from posetraj_torch.models.embeddings import (
    init_timestep_embedding,
    sinusoidal_timestep_embedding,
    timestep_embedding,
)
from posetraj_torch.models.resnet import alpha_blend
from posetraj_torch.ops import mlp, qkvt, temporal
from posetraj_torch.ops.attention import attention, self_attention_qkv
from posetraj_torch.ops.primitives import geglu, group_norm_silu, layer_norm, linear
from posetraj_torch.parallel import mesh, spmd


def init_attention(ini: Init, query_dim: int, heads: int, cross_attention_dim: Optional[int] = None) -> dict:
    """Self-attention: fused `wqkv` (3C, C), bias-free, + to_out. Cross-
    attention: to_q/to_k/to_v (bias-free) + to_out."""
    if cross_attention_dim is None:
        return {"wqkv": ini.uniform((3 * query_dim, query_dim), query_dim), "to_out": ini.linear(query_dim, query_dim)}
    return {
        "to_q": ini.linear(query_dim, query_dim, bias=False),
        "to_k": ini.linear(cross_attention_dim, query_dim, bias=False),
        "to_v": ini.linear(cross_attention_dim, query_dim, bias=False),
        "to_out": ini.linear(query_dim, query_dim),
    }


def attention_module(params: dict, x: torch.Tensor, num_heads: int, compute_dtype=None) -> torch.Tensor:
    """Self-attention of (B, S, C) x: the packed projection x Wqkv^T (a
    plain matmul, as the JAX package leaves it to XLA), self_attention_qkv,
    to_out. Where the spatial context shards the tokens, the split q, k, v
    go to attention(), which all-gathers k and v over sp."""
    dt = compute_dtype or x.dtype
    qkv = linear({"weight": params["wqkv"]}, x, dt)
    ctx = spmd.current()
    if ctx is not None and ctx.tokens_sharded(x.shape[1]):
        q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
        out = attention(q, k, v, num_heads, gather_kv=ctx)
    else:
        out = self_attention_qkv(qkv, num_heads)
    return linear(params["to_out"], out, compute_dtype)


def cross_attention(params: dict, x: torch.Tensor, context: torch.Tensor, num_heads: int,
                    compute_dtype=None) -> torch.Tensor:
    """Cross-attention of (B, S, C) x over (B, S_kv, C_kv) context. With one
    key (the CLIP embedding) softmax is identically 1: the output is
    to_out(to_v(context)), returned as (B, 1, C) for the caller to broadcast."""
    if context.shape[1] == 1:
        return linear(params["to_out"], linear(params["to_v"], context, compute_dtype), compute_dtype)
    q = linear(params["to_q"], x, compute_dtype)
    k = linear(params["to_k"], context, compute_dtype)
    v = linear(params["to_v"], context, compute_dtype)
    return linear(params["to_out"], attention(q, k, v, num_heads), compute_dtype)


def init_feed_forward(ini: Init, dim: int, mult: int = 4) -> dict:
    inner = dim * mult
    return {"proj_in": ini.linear(dim, inner * 2), "proj_out": ini.linear(inner, dim)}


def feed_forward(params: dict, x: torch.Tensor, norm: dict, add: Optional[torch.Tensor] = None,
                 compute_dtype=None) -> torch.Tensor:
    """The pre-norm GEGLU FF sub-layer xa + ff(LN(xa)), xa = x [+ add]. add:
    a broadcast vector; under fused_ff_ln kernel B folds its residual add,
    canonicalised to (G, S_a, C): axes before its last size-1 axis are
    groups, axes after it the shared inner extent ((B*F, 1, C) -> (G, 1, C);
    (B, 1, S, C) -> (B, S, C)). Elsewhere it is added explicitly."""
    dt = compute_dtype or x.dtype
    c = x.shape[-1]
    w1, w2 = params["proj_in"]["weight"], params["proj_out"]["weight"]
    if mlp.geglu_applicable(w1, w2):
        args = (w1.to(dt), params["proj_in"]["bias"].to(dt), w2.to(dt), params["proj_out"]["bias"].to(dt))
        if kernel_config().fused_ff_ln:
            add3 = None
            if add is not None:
                ones = [i for i, d in enumerate(add.shape[:-1]) if d == 1]
                cut = ones[-1] if ones else add.ndim - 1
                g = 1
                for d in add.shape[:cut]:
                    g *= d
                add3 = add.reshape(g, -1, c).to(dt).contiguous()
            out = mlp.geglu_mlp(x.reshape(-1, c).to(dt), *args, norm["weight"], norm["bias"], 1e-5, residual=True,
                                add=add3)
            return out.reshape(x.shape)
        if add is not None:
            x = x + add.to(x.dtype)
        h = layer_norm(norm, x.reshape(-1, c).to(dt)).to(dt)
        return x + mlp.geglu_mlp(h, *args).reshape(x.shape)
    if add is not None:
        x = x + add.to(x.dtype)
    out = linear(params["proj_out"], geglu(params["proj_in"], layer_norm(norm, x), compute_dtype), compute_dtype)
    return x + out


def init_basic_transformer_block(ini: Init, dim: int, num_heads: int, cross_attention_dim: Optional[int]) -> dict:
    p = {
        "norm1": ini.norm(dim),
        "attn1": init_attention(ini, dim, num_heads),
        "norm3": ini.norm(dim),
        "ff": init_feed_forward(ini, dim),
    }
    if cross_attention_dim is not None:
        p["norm2"] = ini.norm(dim)
        p["attn2"] = init_attention(ini, dim, num_heads, cross_attention_dim)
    return p


def basic_transformer_block(params: dict, x: torch.Tensor, num_heads: int, context: Optional[torch.Tensor] = None,
                            backend: str = "auto", compute_dtype=None) -> torch.Tensor:
    """(B*F, S, C) -> same: self-attention sub-layer, cross-attention, FF
    sub-layer. backend "xla" keeps the self-attention off kernel C (the JAX
    package's name for its plain path, which the temp hint encoder asks
    for); "auto" lets the gate decide."""
    if backend not in ("auto", "xla"):
        raise ValueError(f"basic_transformer_block: backend must be 'auto' or 'xla', got {backend!r}")
    dt = compute_dtype or x.dtype
    a1 = params["attn1"]
    # Sharded serving gathers K/V inside attention(): kernel C declines
    # under an active spatial context, as in the JAX package.
    if (backend == "auto" and spmd.current() is None
            and qkvt.attn_sublayer_applicable(x, num_heads, a1["wqkv"], a1["to_out"]["weight"])):
        x = qkvt.attn_sublayer(
            x.to(dt).contiguous(), params["norm1"]["weight"], params["norm1"]["bias"], a1["wqkv"].to(dt),
            a1["to_out"]["weight"].to(dt), a1["to_out"]["bias"].to(dt), num_heads,
        )
    else:
        x = x + attention_module(a1, layer_norm(params["norm1"], x), num_heads, compute_dtype)
    add = None
    if "attn2" in params:
        # A cross-attention over one context token never reads its queries:
        # norm2 is computed only for a longer context.
        h = x if context.shape[1] == 1 else layer_norm(params["norm2"], x)
        att = cross_attention(params["attn2"], h, context, num_heads, compute_dtype)
        if att.shape != x.shape:
            add = att  # single-token broadcast (B*F, 1, C), folded into the FF
        else:
            x = x + att
    return feed_forward(params["ff"], x, params["norm3"], add, compute_dtype)


def init_temporal_basic_transformer_block(ini: Init, dim: int, num_heads: int,
                                          cross_attention_dim: Optional[int]) -> dict:
    p = {
        "norm_in": ini.norm(dim),
        "ff_in": init_feed_forward(ini, dim),
        "norm1": ini.norm(dim),
        "attn1": init_attention(ini, dim, num_heads),
        "norm3": ini.norm(dim),
        "ff": init_feed_forward(ini, dim),
    }
    if cross_attention_dim is not None:
        p["norm2"] = ini.norm(dim)
        p["attn2"] = init_attention(ini, dim, num_heads, cross_attention_dim)
    return p


def _frame_axis_attention(params: dict, x: torch.Tensor, num_heads: int, compute_dtype=None) -> torch.Tensor:
    """Self-attention over the frame axis of (B, F, S, C) x, per pixel: the
    packed projection, split, ops/temporal.frame_attention, to_out (the JAX
    package's _frame_axis_attention; plain PyTorch, as it is XLA there)."""
    dt = compute_dtype or x.dtype
    q, k, v = linear({"weight": params["wqkv"]}, x, dt).chunk(3, dim=-1)
    return linear(params["to_out"], temporal.frame_attention(q, k, v, num_heads), compute_dtype)


def frame_cross_attention(params: dict, x: torch.Tensor, context: torch.Tensor, num_heads: int,
                          compute_dtype=None) -> torch.Tensor:
    """Cross-attention over the frame axis: x (B, F, S, C), context (B, F_kv,
    S, C_kv) per pixel. With a single context frame (the per-pixel CLIP
    token) softmax is identically 1: returns to_out(to_v(context)),
    (B, 1, S, C), for the caller to broadcast over frames."""
    if context.shape[1] == 1:
        return linear(params["to_out"], linear(params["to_v"], context, compute_dtype), compute_dtype)
    q = linear(params["to_q"], x, compute_dtype)
    k = linear(params["to_k"], context, compute_dtype)
    v = linear(params["to_v"], context, compute_dtype)
    return linear(params["to_out"], temporal.frame_attention(q, k, v, num_heads), compute_dtype)


def temporal_basic_transformer_block(params: dict, x: torch.Tensor, num_frames: int, num_heads: int,
                                     context: Optional[torch.Tensor] = None, compute_dtype=None,
                                     add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B*F, S, C) -> same, computed in the (B, F, S, C) layout.
    context: per-pixel cross context (B, F_kv, S, C_kv). add: (B*F, 1, C)
    frame-position embedding, folded into ff_in's kernel."""
    dt = compute_dtype or x.dtype
    bf, s, c = x.shape
    b = bf // num_frames
    x = x.reshape(b, num_frames, s, c)
    x = feed_forward(params["ff_in"], x, params["norm_in"],
                     add.reshape(b, num_frames, 1, c) if add is not None else None, compute_dtype)
    a1 = params["attn1"]
    if spmd.current() is None and temporal.temporal_attn_sublayer_applicable(x, num_heads, a1["wqkv"],
                                                                              a1["to_out"]["weight"]):
        x = temporal.temporal_attn_sublayer(
            x.to(dt).contiguous(), params["norm1"]["weight"], params["norm1"]["bias"], a1["wqkv"].to(dt),
            a1["to_out"]["weight"].to(dt), a1["to_out"]["bias"].to(dt), num_heads,
        )
    else:
        x = x + _frame_axis_attention(a1, layer_norm(params["norm1"], x), num_heads, compute_dtype)
    add = None
    if "attn2" in params:
        h = x if context.shape[1] == 1 else layer_norm(params["norm2"], x)  # see basic_transformer_block
        att = frame_cross_attention(params["attn2"], h, context, num_heads, compute_dtype)
        if att.shape != x.shape:
            add = att  # (B, 1, S, C), folded into the FF
        else:
            x = x + att
    x = feed_forward(params["ff"], x, params["norm3"], add, compute_dtype)
    return x.reshape(bf, s, c)


def init_transformer_spatio_temporal(ini: Init, in_channels: int, num_heads: int, num_layers: int,
                                     cross_attention_dim: Optional[int]) -> dict:
    return {
        "norm": ini.norm(in_channels),
        "proj_in": ini.linear(in_channels, in_channels),
        "blocks": [init_basic_transformer_block(ini, in_channels, num_heads, cross_attention_dim)
                   for _ in range(num_layers)],
        "temporal_blocks": [init_temporal_basic_transformer_block(ini, in_channels, num_heads, cross_attention_dim)
                            for _ in range(num_layers)],
        "time_pos_embed": init_timestep_embedding(ini, in_channels, in_channels * 4, out_dim=in_channels),
        "time_mixer": ini.mix_factor(0.5),
        "proj_out": ini.linear(in_channels, in_channels),
    }


def transformer_spatio_temporal(params: dict, x: torch.Tensor, context: torch.Tensor, num_frames: int,
                                num_heads: int, image_only_indicator: Optional[torch.Tensor] = None,
                                fidelity_time_context_order: bool = True, compute_dtype=None) -> torch.Tensor:
    """x (B*F, H, W, C); context (B*F, 1, cross_dim). norm -> proj_in ->
    [spatial block -> temporal block (+ frame-position embedding) ->
    AlphaBlender] x L -> proj_out -> + residual."""
    bf, hh, ww, c = x.shape
    b = bf // num_frames
    s = hh * ww
    ctx_first = context.reshape(b, num_frames, -1, context.shape[-1])[:, 0]  # (B, 1, D)
    if fidelity_time_context_order:
        # Q7: pixel (b, s) reads context row (b*S + s) % B. Under sharded
        # serving the batch rows (cfg) and the pixels (sp) are blocks of
        # global extents: the index takes global batch rows and pixel
        # positions, and the table is the (B, 1, D) rows of every cfg rank.
        ctx_sp = spmd.current()
        sp_here = ctx_sp is not None and ctx_sp.w_sharded_at(hh)
        table, b_ids, b_glob = ctx_first, torch.arange(b, device=x.device), b
        rows = mesh.batch_rows()
        if rows is not None:  # this rank's rows of a batch split over a mesh's "data" axis
            table, b_ids, b_glob = rows.table.to(ctx_first.dtype), rows.rows, rows.table.shape[0]
        col, w_glob = torch.arange(ww, device=x.device), ww
        if ctx_sp is not None and ctx_sp.cfg_size > 1:
            table = spmd.all_gather_cfg(ctx_first, ctx_sp)
            b_ids, b_glob = b_ids + ctx_sp.mesh.cfg_rank * b, b * ctx_sp.cfg_size
        if sp_here:
            col, w_glob = col + ctx_sp.mesh.sp_rank * ww, ww * ctx_sp.sp_size
        s_glob = (torch.arange(hh, device=x.device)[:, None] * w_glob + col[None, :]).reshape(-1)  # (S,)
        time_context = table[(b_ids[:, None] * (hh * w_glob) + s_glob[None, :]) % b_glob]  # (B, S, 1, D)
        time_context = time_context.permute(0, 2, 1, 3)  # (B, 1, S, D)
    else:
        time_context = ctx_first[:, :, None, :].expand(b, 1, s, ctx_first.shape[-1])

    residual = x
    h = group_norm_silu(params["norm"], x, eps=1e-6, act=False)
    h = linear(params["proj_in"], h.reshape(bf, s, c), compute_dtype)

    frame_ids = torch.arange(num_frames, dtype=torch.float32, device=x.device).repeat(b)
    t_emb = sinusoidal_timestep_embedding(frame_ids, c)
    emb = timestep_embedding(params["time_pos_embed"], t_emb.to(h.dtype), compute_dtype)[:, None, :]

    for block_p, tblock_p in zip(params["blocks"], params["temporal_blocks"]):
        h = basic_transformer_block(block_p, h, num_heads, context=context, compute_dtype=compute_dtype)
        h_mix = temporal_basic_transformer_block(tblock_p, h, num_frames, num_heads, context=time_context,
                                                 compute_dtype=compute_dtype, add=emb)
        h = alpha_blend(params["time_mixer"], h, h_mix, image_only_indicator, merge_strategy="learned_with_images")

    h = linear(params["proj_out"], h, compute_dtype)
    return h.reshape(bf, hh, ww, c) + residual
