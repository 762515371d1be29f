"""UNetSpatioTemporalConditionControlNet: the SVD video UNet that consumes
ControlNet residuals, channels-last (diffusers 0.24.0 semantics).

Quirk Q1: the reference merges ControlNet residuals into the skip tuple
INSIDE the down-block loop; since `zip` truncates to the current tuple
length, residual k is re-added once per remaining down block.
`cfg.fidelity_residual_in_loop=True` reproduces it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from posetraj_torch.configs import UNetConfig
from posetraj_torch.core.init import Init
from posetraj_torch.models.blocks import down_block, init_down_block, init_mid_block, init_up_block, mid_block, up_block
from posetraj_torch.models.embeddings import (
    init_timestep_embedding,
    sinusoidal_timestep_embedding,
    timestep_embedding,
)
from posetraj_torch.ops.primitives import conv2d, group_norm_silu


def init_unet(ini: Init, cfg: UNetConfig) -> dict:
    n = cfg.num_levels
    boc = cfg.block_out_channels
    p: dict = {
        "conv_in": ini.conv(cfg.in_channels, boc[0], 3, 3),
        "time_embedding": init_timestep_embedding(ini, boc[0], cfg.time_embed_dim),
        "add_embedding": init_timestep_embedding(ini, cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim),
        "down_blocks": [],
        "up_blocks": [],
    }
    out_ch = boc[0]
    for i in range(n):
        in_ch, out_ch = out_ch, boc[i]
        p["down_blocks"].append(init_down_block(
            ini, in_ch, out_ch, cfg.time_embed_dim, cfg.layers_per_block, cfg.cross_attention_levels[i],
            cfg.num_attention_heads[i], cfg.transformer_layers_per_block, cfg.cross_attention_dim,
            add_downsample=(i != n - 1),
        ))
    p["mid_block"] = init_mid_block(ini, boc[-1], cfg.time_embed_dim, cfg.num_attention_heads[-1],
                                    cfg.transformer_layers_per_block, cfg.cross_attention_dim)
    rev_boc = list(reversed(boc))
    rev_heads = list(reversed(cfg.num_attention_heads))
    rev_cross = list(reversed(cfg.cross_attention_levels))
    out_ch = rev_boc[0]
    for i in range(n):
        prev_out, out_ch = out_ch, rev_boc[i]
        in_ch = rev_boc[min(i + 1, n - 1)]
        p["up_blocks"].append(init_up_block(
            ini, in_ch, prev_out, out_ch, cfg.time_embed_dim, cfg.layers_per_block + 1, rev_cross[i],
            rev_heads[i], cfg.transformer_layers_per_block, cfg.cross_attention_dim, add_upsample=(i != n - 1),
        ))
    p["conv_norm_out"] = ini.norm(boc[0])
    p["conv_out"] = ini.conv(boc[0], cfg.out_channels, 3, 3)
    return p


def compute_embeddings(params: dict, cfg: UNetConfig, timestep, added_time_ids: torch.Tensor, batch_size: int,
                       num_frames: int, compute_dtype) -> torch.Tensor:
    """Time + added-condition embedding, repeated per frame: (B*F, temb_dim)."""
    device = added_time_ids.device
    timesteps = torch.as_tensor(timestep, dtype=torch.float32, device=device).reshape(-1).expand(batch_size)
    t_emb = sinusoidal_timestep_embedding(timesteps, cfg.block_out_channels[0])
    emb = timestep_embedding(params["time_embedding"], t_emb.to(compute_dtype), compute_dtype)
    time_embeds = sinusoidal_timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
    time_embeds = time_embeds.reshape(batch_size, -1)
    emb = emb + timestep_embedding(params["add_embedding"], time_embeds.to(compute_dtype), compute_dtype)
    return emb.repeat_interleave(num_frames, dim=0)


def unet_forward(params: dict, cfg: UNetConfig, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                 added_time_ids: torch.Tensor, down_block_residuals: Optional[Tuple[torch.Tensor, ...]] = None,
                 mid_block_residual: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """sample (B, F, H, W, 8) channels-last (noisy latents ++ image latents);
    encoder_hidden_states (B, 1, cross_dim); added_time_ids (B, 3).
    Returns (B, F, H, W, out_channels)."""
    b, f, h, w, _ = sample.shape
    emb = compute_embeddings(params, cfg, timestep, added_time_ids, b, f, compute_dtype)
    context = encoder_hidden_states.to(compute_dtype).repeat_interleave(f, dim=0)
    x = conv2d(params["conv_in"], sample.reshape(b * f, h, w, sample.shape[-1]).to(compute_dtype),
               compute_dtype=compute_dtype)
    indicator = torch.zeros((b, f), dtype=torch.float32, device=sample.device)

    skips: Tuple[torch.Tensor, ...] = (x,)
    for i, db_params in enumerate(params["down_blocks"]):
        x, new_skips = down_block(db_params, x, emb, context if cfg.cross_attention_levels[i] else None, f,
                                  cfg.num_attention_heads[i], indicator, compute_dtype=compute_dtype)
        skips = skips + new_skips
        if down_block_residuals is not None and cfg.fidelity_residual_in_loop:
            skips = tuple(s + r.to(s.dtype) for s, r in zip(skips, down_block_residuals))
    if down_block_residuals is not None and not cfg.fidelity_residual_in_loop:
        skips = tuple(s + r.to(s.dtype) for s, r in zip(skips, down_block_residuals))

    x = mid_block(params["mid_block"], x, emb, context, f, cfg.num_attention_heads[-1], indicator,
                  compute_dtype=compute_dtype)
    if mid_block_residual is not None:
        x = x + mid_block_residual.to(x.dtype)

    rev_heads = list(reversed(cfg.num_attention_heads))
    rev_cross = list(reversed(cfg.cross_attention_levels))
    n_res = cfg.layers_per_block + 1
    for i, ub_params in enumerate(params["up_blocks"]):
        block_skips, skips = skips[-n_res:], skips[:-n_res]
        x = up_block(ub_params, x, block_skips, emb, context if rev_cross[i] else None, f, rev_heads[i], indicator,
                     compute_dtype=compute_dtype)

    x = group_norm_silu(params["conv_norm_out"], x, eps=1e-5)
    x = conv2d(params["conv_out"], x, compute_dtype=compute_dtype)
    return x.reshape(b, f, h, w, cfg.out_channels)
