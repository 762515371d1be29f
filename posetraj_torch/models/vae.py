"""AutoencoderKLTemporalDecoder: SD 2D encoder + SVD temporal-conv decoder
(diffusers 0.24.0 autoencoder_kl_temporal_decoder.py). Encoder per frame;
the decoder mixes frames through SpatioTemporalResBlocks (merge "learned",
switch_spatial_to_temporal_mix) and a final (3,1,1) temporal conv. Norm eps
1e-6 except the decoder's temporal resnets (1e-5)."""

from __future__ import annotations

from typing import Tuple

import torch

from posetraj_torch.configs import VAEConfig
from posetraj_torch.core.init import Init
from posetraj_torch.models.resnet import (
    init_resnet_block_2d,
    init_spatio_temporal_res_block,
    resnet_block_2d,
    spatio_temporal_res_block,
)
from posetraj_torch.ops.attention import attention
from posetraj_torch.ops.primitives import (
    conv2d,
    conv3d_temporal,
    downsample_2x,
    group_norm,
    group_norm_silu,
    linear,
    upsample_nearest_2x,
)


def init_vae_attention(ini: Init, channels: int) -> dict:
    return {
        "group_norm": ini.norm(channels),
        "to_q": ini.linear(channels, channels),
        "to_k": ini.linear(channels, channels),
        "to_v": ini.linear(channels, channels),
        "to_out": ini.linear(channels, channels),
    }


def vae_attention(params: dict, x: torch.Tensor, eps: float = 1e-6, compute_dtype=None) -> torch.Tensor:
    """Single-head self-attention with residual over (N, H, W, C)."""
    n, h, w, c = x.shape
    hflat = group_norm(params["group_norm"], x, eps=eps).reshape(n, h * w, c)
    q = linear(params["to_q"], hflat, compute_dtype)
    k = linear(params["to_k"], hflat, compute_dtype)
    v = linear(params["to_v"], hflat, compute_dtype)
    out = linear(params["to_out"], attention(q, k, v, num_heads=1), compute_dtype)
    return out.reshape(n, h, w, c) + x


def init_encoder(ini: Init, cfg: VAEConfig) -> dict:
    boc = cfg.block_out_channels
    n = len(boc)
    p: dict = {"conv_in": ini.conv(cfg.in_channels, boc[0], 3, 3), "down_blocks": []}
    out_ch = boc[0]
    for i in range(n):
        in_ch, out_ch = out_ch, boc[i]
        block = {"resnets": [init_resnet_block_2d(ini, in_ch if j == 0 else out_ch, out_ch, None)
                             for j in range(cfg.layers_per_block)]}
        if i != n - 1:
            block["downsampler"] = ini.conv(out_ch, out_ch, 3, 3)
        p["down_blocks"].append(block)
    p["mid_block"] = {
        "resnets": [init_resnet_block_2d(ini, boc[-1], boc[-1], None),
                    init_resnet_block_2d(ini, boc[-1], boc[-1], None)],
        "attention": init_vae_attention(ini, boc[-1]),
    }
    p["conv_norm_out"] = ini.norm(boc[-1])
    p["conv_out"] = ini.conv(boc[-1], 2 * cfg.latent_channels, 3, 3)
    p["quant_conv"] = ini.conv(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1, 1)
    return p


def encode(params: dict, cfg: VAEConfig, x: torch.Tensor,
           compute_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) in [-1, 1] -> (mean, logvar), each (N, H/8, W/8, 4)."""
    h = conv2d(params["conv_in"], x.to(compute_dtype), compute_dtype=compute_dtype)
    for block in params["down_blocks"]:
        for res_p in block["resnets"]:
            h = resnet_block_2d(res_p, h, None, eps=cfg.eps, compute_dtype=compute_dtype)
        if "downsampler" in block:
            h = downsample_2x(block["downsampler"], h, asymmetric_pad=True, compute_dtype=compute_dtype)
    mb = params["mid_block"]
    h = resnet_block_2d(mb["resnets"][0], h, None, eps=cfg.eps, compute_dtype=compute_dtype)
    h = vae_attention(mb["attention"], h, eps=cfg.eps, compute_dtype=compute_dtype)
    h = resnet_block_2d(mb["resnets"][1], h, None, eps=cfg.eps, compute_dtype=compute_dtype)
    h = group_norm_silu(params["conv_norm_out"], h, eps=cfg.eps)
    h = conv2d(params["conv_out"], h, compute_dtype=compute_dtype)
    moments = conv2d(params["quant_conv"], h, compute_dtype=compute_dtype)
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, eps=None) -> torch.Tensor:
    """DiagonalGaussianDistribution.sample() given a standard-normal draw
    `eps` of mean's shape, or .mode() (the mean) for eps=None."""
    if eps is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)


def init_temporal_decoder(ini: Init, cfg: VAEConfig) -> dict:
    boc = cfg.block_out_channels
    n = len(boc)
    p: dict = {"conv_in": ini.conv(cfg.latent_channels, boc[-1], 3, 3)}
    p["mid_block"] = {
        "resnets": [init_spatio_temporal_res_block(ini, boc[-1], boc[-1], None, merge_factor=0.0)
                    for _ in range(cfg.layers_per_block)],
        "attention": init_vae_attention(ini, boc[-1]),
    }
    p["up_blocks"] = []
    rev = list(reversed(boc))
    out_ch = rev[0]
    for i in range(n):
        in_ch, out_ch = out_ch, rev[i]
        block = {"resnets": [init_spatio_temporal_res_block(ini, in_ch if j == 0 else out_ch, out_ch, None,
                                                            merge_factor=0.0)
                             for j in range(cfg.layers_per_block + 1)]}
        if i != n - 1:
            block["upsampler"] = ini.conv(out_ch, out_ch, 3, 3)
        p["up_blocks"].append(block)
    p["conv_norm_out"] = ini.norm(boc[0])
    p["conv_out"] = ini.conv(boc[0], cfg.out_channels, 3, 3)
    p["time_conv_out"] = ini.conv(cfg.out_channels, cfg.out_channels, 3, 1, 1)
    return p


def _decoder_res_block(params, x, num_frames, indicator, cfg, compute_dtype):
    return spatio_temporal_res_block(params, x, None, num_frames, indicator, eps=cfg.eps, temporal_eps=1e-5,
                                     merge_strategy="learned", switch_spatial_to_temporal_mix=True,
                                     compute_dtype=compute_dtype)


def decode(params: dict, cfg: VAEConfig, z: torch.Tensor, num_frames: int,
           compute_dtype=torch.float32) -> torch.Tensor:
    """(B*F, h, w, 4) latents, already divided by scaling_factor ->
    (B*F, H, W, 3)."""
    bf = z.shape[0]
    b = bf // num_frames
    indicator = torch.zeros((b, num_frames), dtype=torch.float32, device=z.device)
    h = conv2d(params["conv_in"], z.to(compute_dtype), compute_dtype=compute_dtype)
    mb = params["mid_block"]
    h = _decoder_res_block(mb["resnets"][0], h, num_frames, indicator, cfg, compute_dtype)
    # MidBlockTemporalDecoder: `for resnet, attn in zip(resnets[1:], attentions)`
    # yields at most one (attention -> resnet) pair, none at layers_per_block=1.
    for res_p in mb["resnets"][1:2]:
        h = vae_attention(mb["attention"], h, eps=cfg.eps, compute_dtype=compute_dtype)
        h = _decoder_res_block(res_p, h, num_frames, indicator, cfg, compute_dtype)
    for block in params["up_blocks"]:
        for res_p in block["resnets"]:
            h = _decoder_res_block(res_p, h, num_frames, indicator, cfg, compute_dtype)
        if "upsampler" in block:
            h = upsample_nearest_2x(block["upsampler"], h, compute_dtype=compute_dtype)
    h = group_norm_silu(params["conv_norm_out"], h, eps=cfg.eps)
    h = conv2d(params["conv_out"], h, compute_dtype=compute_dtype)
    hh, ww, cc = h.shape[1:]
    h5 = conv3d_temporal(params["time_conv_out"], h.reshape(b, num_frames, hh, ww, cc), compute_dtype=compute_dtype)
    return h5.reshape(bf, hh, ww, cc)


def init_vae(ini_encoder: Init, ini_decoder: Init, cfg: VAEConfig) -> dict:
    """The encoder runs in float32 (the pipeline's encode upcast) and may
    take its own Init in float32; the decoder runs in the compute dtype."""
    return {"encoder": init_encoder(ini_encoder, cfg), "decoder": init_temporal_decoder(ini_decoder, cfg)}
