"""Trajectory ControlNet (base hint variant): UNet-encoder copy + hint conv
encoder + zero-conv residual heads (controlnet_sdv.py of the reference)."""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch

from posetraj_torch.configs import ControlNetConfig, HintEncoderConfig
from posetraj_torch.core.init import Init
from posetraj_torch.models.blocks import down_block, init_down_block, init_mid_block, mid_block
from posetraj_torch.models.embeddings import init_timestep_embedding
from posetraj_torch.models.unet import compute_embeddings
from posetraj_torch.ops.primitives import conv2d, silu


def init_hint_encoder(ini: Init, cfg: HintEncoderConfig) -> dict:
    """conv_in + interleaved [3x3 conv, 3x3 stride-2 conv] + zero conv_out:
    downsamples H x W by 8 to the latent resolution."""
    if cfg.variant != "base":
        raise ValueError(f"hint variant {cfg.variant!r}: only 'base' is ported")
    boc = cfg.block_out_channels
    stack = {"conv_in": ini.conv(cfg.conditioning_channels, boc[0], 3, 3), "blocks": []}
    for i in range(len(boc) - 1):
        stack["blocks"].append(ini.conv(boc[i], boc[i], 3, 3))
        stack["blocks"].append(ini.conv(boc[i], boc[i + 1], 3, 3))
    stack["conv_out"] = ini.zero_conv(boc[-1], cfg.embedding_channels, 3, 3)
    return {"stack": stack}


def hint_encoder(params: dict, cfg: HintEncoderConfig, cond: torch.Tensor, num_frames: int,
                 compute_dtype=None) -> torch.Tensor:
    """cond (B, F, H, W, 3) control video -> (B*F, H/8, W/8, C_embed); SiLU
    after every conv except the zero conv_out."""
    if cfg.variant != "base":
        raise ValueError(f"hint variant {cfg.variant!r}: only 'base' is ported")
    b, f, hh, ww, c = cond.shape
    p = params["stack"]
    h = silu(conv2d(p["conv_in"], cond.reshape(b * f, hh, ww, c), compute_dtype=compute_dtype))
    for i, block in enumerate(p["blocks"]):
        stride = 2 if i % 2 == 1 else 1
        h = silu(conv2d(block, h, stride=stride, padding=((1, 1), (1, 1)), compute_dtype=compute_dtype))
    return conv2d(p["conv_out"], h, compute_dtype=compute_dtype)


def init_controlnet(ini: Init, cfg: ControlNetConfig) -> dict:
    u = cfg.unet
    n = u.num_levels
    boc = u.block_out_channels
    p: dict = {
        "conv_in": ini.conv(u.in_channels, boc[0], 3, 3),
        "time_embedding": init_timestep_embedding(ini, boc[0], u.time_embed_dim),
        "add_embedding": init_timestep_embedding(ini, u.projection_class_embeddings_input_dim, u.time_embed_dim),
        "controlnet_cond_embedding": init_hint_encoder(ini, cfg.hint),
        "down_blocks": [],
        "controlnet_down_blocks": [ini.zero_conv(boc[0], boc[0], 1, 1)],
    }
    out_ch = boc[0]
    for i in range(n):
        in_ch, out_ch = out_ch, boc[i]
        is_final = i == n - 1
        p["down_blocks"].append(init_down_block(
            ini, in_ch, out_ch, u.time_embed_dim, u.layers_per_block, u.cross_attention_levels[i],
            u.num_attention_heads[i], u.transformer_layers_per_block, u.cross_attention_dim,
            add_downsample=not is_final,
        ))
        for _ in range(u.layers_per_block):
            p["controlnet_down_blocks"].append(ini.zero_conv(out_ch, out_ch, 1, 1))
        if not is_final:
            p["controlnet_down_blocks"].append(ini.zero_conv(out_ch, out_ch, 1, 1))
    p["controlnet_mid_block"] = ini.zero_conv(boc[-1], boc[-1], 1, 1)
    p["mid_block"] = init_mid_block(ini, boc[-1], u.time_embed_dim, u.num_attention_heads[-1],
                                    u.transformer_layers_per_block, u.cross_attention_dim)
    return p


def controlnet_from_unet(controlnet_params: dict, unet_params: dict) -> dict:
    """Copy the encoder weights of a UNet (ControlNetSDVModel.from_unet):
    conv_in, time/add embeddings, down blocks, mid block."""
    p = dict(controlnet_params)
    for name in ("conv_in", "time_embedding", "add_embedding", "down_blocks", "mid_block"):
        p[name] = copy.deepcopy(unet_params[name])
    return p


def controlnet_forward(params: dict, cfg: ControlNetConfig, sample: torch.Tensor, timestep,
                       encoder_hidden_states: torch.Tensor, added_time_ids: torch.Tensor,
                       controlnet_cond: Optional[torch.Tensor] = None, conditioning_scale: float = 1.0,
                       compute_dtype=torch.bfloat16,
                       hint_embedding: Optional[torch.Tensor] = None) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Returns (down_block_residuals (12 for the 4-level config),
    mid_block_residual), each scaled by conditioning_scale. `hint_embedding`
    skips the hint conv stack: the sampling loop computes it once."""
    u = cfg.unet
    b, f, h, w, _ = sample.shape
    emb = compute_embeddings(params, u, timestep, added_time_ids, b, f, compute_dtype)
    context = encoder_hidden_states.to(compute_dtype).repeat_interleave(f, dim=0)
    x = conv2d(params["conv_in"], sample.reshape(b * f, h, w, sample.shape[-1]).to(compute_dtype),
               compute_dtype=compute_dtype)
    if hint_embedding is not None:
        x = x + hint_embedding.to(x.dtype)
    elif controlnet_cond is not None:
        x = x + hint_encoder(params["controlnet_cond_embedding"], cfg.hint, controlnet_cond.to(compute_dtype), f,
                             compute_dtype)
    indicator = torch.zeros((b, f), dtype=torch.float32, device=sample.device)
    skips: Tuple[torch.Tensor, ...] = (x,)
    for i, db_params in enumerate(params["down_blocks"]):
        x, new_skips = down_block(db_params, x, emb, context if u.cross_attention_levels[i] else None, f,
                                  u.num_attention_heads[i], indicator, compute_dtype=compute_dtype)
        skips = skips + new_skips
    x = mid_block(params["mid_block"], x, emb, context, f, u.num_attention_heads[-1], indicator,
                  compute_dtype=compute_dtype)
    down = tuple(conv2d(zc, s, compute_dtype=compute_dtype) * conditioning_scale
                 for zc, s in zip(params["controlnet_down_blocks"], skips))
    mid = conv2d(params["controlnet_mid_block"], x, compute_dtype=compute_dtype) * conditioning_scale
    return down, mid
