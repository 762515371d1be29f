"""Residual blocks: spatial 2D, temporal (frame-axis conv), and the blended
spatio-temporal block with AlphaBlender (diffusers 0.24.0 resnet.py).
Layout: spatial (N, H, W, C); temporal (B, F, H, W, C)."""

from __future__ import annotations

from typing import Optional

import torch

from posetraj_torch.core.init import Init
from posetraj_torch.ops.primitives import conv2d, conv3d_temporal, group_norm_silu, linear, silu


def init_resnet_block_2d(ini: Init, in_channels: int, out_channels: int, temb_channels: Optional[int]) -> dict:
    p = {
        "norm1": ini.norm(in_channels),
        "conv1": ini.conv(in_channels, out_channels, 3, 3),
        "norm2": ini.norm(out_channels),
        "conv2": ini.conv(out_channels, out_channels, 3, 3),
    }
    if temb_channels:
        p["time_emb_proj"] = ini.linear(temb_channels, out_channels)
    if in_channels != out_channels:
        p["conv_shortcut"] = ini.conv(in_channels, out_channels, 1, 1)
    return p


def resnet_block_2d(params: dict, x: torch.Tensor, temb: Optional[torch.Tensor] = None, eps: float = 1e-5,
                    compute_dtype=None) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, C_out); temb (N, temb_dim). The (N, C)
    time-embedding broadcast is folded into norm2's kernel."""
    h = group_norm_silu(params["norm1"], x, eps=eps)
    h = conv2d(params["conv1"], h, compute_dtype=compute_dtype)
    t = None
    if temb is not None and "time_emb_proj" in params:
        t = linear(params["time_emb_proj"], silu(temb), compute_dtype)
    h = group_norm_silu(params["norm2"], h, eps=eps, add=t)
    h = conv2d(params["conv2"], h, compute_dtype=compute_dtype)
    if "conv_shortcut" in params:
        x = conv2d(params["conv_shortcut"], x, compute_dtype=compute_dtype)
    return x + h


def init_temporal_resnet_block(ini: Init, in_channels: int, out_channels: int,
                               temb_channels: Optional[int]) -> dict:
    p = {
        "norm1": ini.norm(in_channels),
        "conv1": ini.conv(in_channels, out_channels, 3, 1, 1),
        "norm2": ini.norm(out_channels),
        "conv2": ini.conv(out_channels, out_channels, 3, 1, 1),
    }
    if temb_channels:
        p["time_emb_proj"] = ini.linear(temb_channels, out_channels)
    if in_channels != out_channels:
        p["conv_shortcut"] = ini.conv(in_channels, out_channels, 1, 1, 1)
    return p


def temporal_resnet_block(params: dict, x: torch.Tensor, temb: Optional[torch.Tensor] = None, eps: float = 1e-6,
                          compute_dtype=None) -> torch.Tensor:
    """(B, F, H, W, C) -> same; temb (B, F, temb_dim) added per frame. The
    norm statistics span the whole video (torch GroupNorm on (B, C, F, H, W))."""
    h = group_norm_silu(params["norm1"], x, eps=eps)
    h = conv3d_temporal(params["conv1"], h, compute_dtype=compute_dtype)
    t = None
    if temb is not None and "time_emb_proj" in params:
        t = linear(params["time_emb_proj"], silu(temb), compute_dtype)
    h = group_norm_silu(params["norm2"], h, eps=eps, add=t)
    h = conv3d_temporal(params["conv2"], h, compute_dtype=compute_dtype)
    if "conv_shortcut" in params:
        x = conv3d_temporal(params["conv_shortcut"], x, compute_dtype=compute_dtype)
    return x + h


def alpha_blend(params: dict, x_spatial: torch.Tensor, x_temporal: torch.Tensor,
                image_only_indicator: Optional[torch.Tensor], merge_strategy: str = "learned_with_images",
                switch_spatial_to_temporal_mix: bool = False) -> torch.Tensor:
    """diffusers AlphaBlender: alpha weights the spatial branch (flipped for
    the VAE decoder). image_only_indicator (B, F): zeros for video."""
    mix = params["mix_factor"].float()
    if merge_strategy == "learned" or image_only_indicator is None:
        alpha = torch.sigmoid(mix)[0]
    elif merge_strategy == "learned_with_images":
        alpha_bf = torch.where(image_only_indicator.bool(), torch.ones_like(image_only_indicator),
                               torch.sigmoid(mix)[0].expand_as(image_only_indicator))
        if x_spatial.ndim == 5:
            alpha = alpha_bf[:, :, None, None, None]
        elif x_spatial.ndim == 3:
            alpha = alpha_bf.reshape(-1)[:, None, None]
        else:
            raise ValueError(f"unsupported ndim {x_spatial.ndim}")
    else:
        raise ValueError(merge_strategy)
    alpha = alpha.to(x_spatial.dtype)
    if switch_spatial_to_temporal_mix:
        alpha = 1.0 - alpha
    return alpha * x_spatial + (1.0 - alpha) * x_temporal


def init_spatio_temporal_res_block(ini: Init, in_channels: int, out_channels: int, temb_channels: Optional[int],
                                   merge_factor: float = 0.5) -> dict:
    return {
        "spatial_res_block": init_resnet_block_2d(ini, in_channels, out_channels, temb_channels),
        "temporal_res_block": init_temporal_resnet_block(ini, out_channels, out_channels, temb_channels),
        "time_mixer": ini.mix_factor(merge_factor),
    }


def spatio_temporal_res_block(params: dict, x: torch.Tensor, temb: Optional[torch.Tensor], num_frames: int,
                              image_only_indicator: Optional[torch.Tensor] = None, eps: float = 1e-5,
                              temporal_eps: Optional[float] = None, merge_strategy: str = "learned_with_images",
                              switch_spatial_to_temporal_mix: bool = False, compute_dtype=None) -> torch.Tensor:
    """(B*F, H, W, C) -> (B*F, H, W, C_out): spatial ResBlock, temporal
    ResBlock over frames, AlphaBlender. temb (B*F, temb_dim) or None."""
    h_spatial = resnet_block_2d(params["spatial_res_block"], x, temb, eps=eps, compute_dtype=compute_dtype)
    bf, hh, ww, c = h_spatial.shape
    b = bf // num_frames
    h5 = h_spatial.reshape(b, num_frames, hh, ww, c)
    temb5 = temb.reshape(b, num_frames, -1) if temb is not None else None
    h_temporal = temporal_resnet_block(
        params["temporal_res_block"], h5, temb5, eps=temporal_eps if temporal_eps is not None else eps,
        compute_dtype=compute_dtype,
    )
    out = alpha_blend(params["time_mixer"], h5, h_temporal, image_only_indicator, merge_strategy,
                      switch_spatial_to_temporal_mix)
    return out.reshape(bf, hh, ww, c)
