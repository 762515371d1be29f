"""SVD UNet blocks: CrossAttn/plain down blocks, mid block, up blocks
(diffusers 0.24.0 unet_3d_blocks.py). GroupNorm epsilons follow 0.24.0:
CrossAttnDownBlockSpatioTemporal hardcodes 1e-6, the plain down block and
the mid block 1e-5, and both up-block types land on their 1e-6 default.

All blocks work on fused-frame tensors (B*F, H, W, C) with temb
(B*F, temb_dim) and CLIP context (B*F, 1, cross_dim).

`remat_units=True` checkpoints each (resnet, transformer) unit with
torch.utils.checkpoint (non-reentrant): its activations are recomputed in
the backward instead of kept. The unit boundaries coincide with the skips,
which the backward keeps anyway (the JAX package's unit-granularity remat,
models/blocks.py:80-90, 151-153, 226-234).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from posetraj_torch.core.init import Init
from posetraj_torch.models.resnet import init_spatio_temporal_res_block, spatio_temporal_res_block
from posetraj_torch.models.transformer import init_transformer_spatio_temporal, transformer_spatio_temporal
from posetraj_torch.ops.primitives import downsample_2x, upsample_nearest_2x

CROSS_ATTN_EPS = 1e-6
PLAIN_EPS = 1e-5


def maybe_checkpoint(fn, enabled: bool):
    """fn, or fn run under a non-reentrant checkpoint. The units draw no
    random numbers, so the RNG state is not saved."""
    if not enabled:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def init_down_block(ini: Init, in_channels: int, out_channels: int, temb_channels: int, num_layers: int,
                    has_cross_attention: bool, num_heads: int, transformer_layers: int,
                    cross_attention_dim: int, add_downsample: bool) -> dict:
    p: dict = {"resnets": []}
    if has_cross_attention:
        p["attentions"] = []
    for i in range(num_layers):
        cin = in_channels if i == 0 else out_channels
        p["resnets"].append(init_spatio_temporal_res_block(ini, cin, out_channels, temb_channels))
        if has_cross_attention:
            p["attentions"].append(init_transformer_spatio_temporal(
                ini, out_channels, num_heads, transformer_layers, cross_attention_dim))
    if add_downsample:
        p["downsampler"] = ini.conv(out_channels, out_channels, 3, 3)
    return p


def down_block(params: dict, x: torch.Tensor, temb: torch.Tensor, context: Optional[torch.Tensor],
               num_frames: int, num_heads: int, image_only_indicator: Optional[torch.Tensor],
               fidelity_time_context_order: bool = True,
               compute_dtype=None, remat_units: bool = False) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    has_attn = "attentions" in params
    eps = CROSS_ATTN_EPS if has_attn else PLAIN_EPS
    skips: List[torch.Tensor] = []
    for i, res_p in enumerate(params["resnets"]):
        attn_p = params["attentions"][i] if has_attn else None

        def unit(xx, tt, cc, res_p=res_p, attn_p=attn_p):
            xx = spatio_temporal_res_block(res_p, xx, tt, num_frames, image_only_indicator, eps=eps,
                                           compute_dtype=compute_dtype)
            if attn_p is not None:
                xx = transformer_spatio_temporal(attn_p, xx, cc, num_frames, num_heads, image_only_indicator,
                                                 fidelity_time_context_order, compute_dtype)
            return xx

        x = maybe_checkpoint(unit, remat_units)(x, temb, context)
        skips.append(x)
    if "downsampler" in params:
        x = downsample_2x(params["downsampler"], x, compute_dtype=compute_dtype)
        skips.append(x)
    return x, tuple(skips)


def init_mid_block(ini: Init, channels: int, temb_channels: int, num_heads: int, transformer_layers: int,
                   cross_attention_dim: int) -> dict:
    return {
        "resnets": [
            init_spatio_temporal_res_block(ini, channels, channels, temb_channels),
            init_spatio_temporal_res_block(ini, channels, channels, temb_channels),
        ],
        "attentions": [
            init_transformer_spatio_temporal(ini, channels, num_heads, transformer_layers, cross_attention_dim)
        ],
    }


def mid_block(params: dict, x: torch.Tensor, temb: torch.Tensor, context: torch.Tensor, num_frames: int,
              num_heads: int, image_only_indicator: Optional[torch.Tensor],
              fidelity_time_context_order: bool = True, compute_dtype=None,
              remat_units: bool = False) -> torch.Tensor:
    def unit1(xx, tt, cc):
        xx = spatio_temporal_res_block(params["resnets"][0], xx, tt, num_frames, image_only_indicator,
                                       eps=PLAIN_EPS, compute_dtype=compute_dtype)
        return transformer_spatio_temporal(params["attentions"][0], xx, cc, num_frames, num_heads,
                                           image_only_indicator, fidelity_time_context_order, compute_dtype)

    def unit2(xx, tt):
        return spatio_temporal_res_block(params["resnets"][1], xx, tt, num_frames, image_only_indicator,
                                         eps=PLAIN_EPS, compute_dtype=compute_dtype)

    x = maybe_checkpoint(unit1, remat_units)(x, temb, context)
    return maybe_checkpoint(unit2, remat_units)(x, temb)


def init_up_block(ini: Init, in_channels: int, prev_output_channel: int, out_channels: int, temb_channels: int,
                  num_layers: int, has_cross_attention: bool, num_heads: int, transformer_layers: int,
                  cross_attention_dim: int, add_upsample: bool) -> dict:
    p: dict = {"resnets": []}
    if has_cross_attention:
        p["attentions"] = []
    for i in range(num_layers):
        res_skip = in_channels if (i == num_layers - 1) else out_channels
        res_in = prev_output_channel if i == 0 else out_channels
        p["resnets"].append(init_spatio_temporal_res_block(ini, res_in + res_skip, out_channels, temb_channels))
        if has_cross_attention:
            p["attentions"].append(init_transformer_spatio_temporal(
                ini, out_channels, num_heads, transformer_layers, cross_attention_dim))
    if add_upsample:
        p["upsampler"] = ini.conv(out_channels, out_channels, 3, 3)
    return p


def up_block(params: dict, x: torch.Tensor, skips: Tuple[torch.Tensor, ...], temb: torch.Tensor,
             context: Optional[torch.Tensor], num_frames: int, num_heads: int,
             image_only_indicator: Optional[torch.Tensor], fidelity_time_context_order: bool = True,
             compute_dtype=None, remat_units: bool = False) -> torch.Tensor:
    """`skips` holds this block's residuals, consumed last-first."""
    has_attn = "attentions" in params
    skips = list(skips)
    for i, res_p in enumerate(params["resnets"]):
        attn_p = params["attentions"][i] if has_attn else None

        def unit(xx, sk, tt, cc, res_p=res_p, attn_p=attn_p):
            xx = torch.cat([xx, sk.to(xx.dtype)], dim=-1)
            xx = spatio_temporal_res_block(res_p, xx, tt, num_frames, image_only_indicator, eps=CROSS_ATTN_EPS,
                                           compute_dtype=compute_dtype)
            if attn_p is not None:
                xx = transformer_spatio_temporal(attn_p, xx, cc, num_frames, num_heads, image_only_indicator,
                                                 fidelity_time_context_order, compute_dtype)
            return xx

        x = maybe_checkpoint(unit, remat_units)(x, skips.pop(), temb, context)
    if "upsampler" in params:
        x = upsample_nearest_2x(params["upsampler"], x, compute_dtype=compute_dtype)
    return x
