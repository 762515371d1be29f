"""Timestep / added-condition embeddings (diffusers 0.24.0 embeddings.py with
flip_sin_to_cos=True, downscale_freq_shift=0, the SVD configuration)."""

from __future__ import annotations

import math

import torch

from posetraj_torch.core.init import Init
from posetraj_torch.ops.primitives import linear, silu


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    """(B,) -> (B, dim), always float32."""
    half_dim = dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def init_timestep_embedding(ini: Init, in_dim: int, time_embed_dim: int, out_dim: int | None = None) -> dict:
    """diffusers TimestepEmbedding: linear -> silu -> linear."""
    return {
        "linear_1": ini.linear(in_dim, time_embed_dim),
        "linear_2": ini.linear(time_embed_dim, out_dim or time_embed_dim),
    }


def timestep_embedding(params: dict, sample: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    return linear(params["linear_2"], silu(linear(params["linear_1"], sample, compute_dtype)), compute_dtype)
