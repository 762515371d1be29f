"""CLIP ViT-H/14 vision tower + visual projection (transformers
CLIPVisionModelWithProjection, laion ViT-H config): the frozen image
conditioner. Its attention (S=257) and GELU MLP are plain PyTorch, as the
JAX package leaves them to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posetraj_torch.configs import CLIPVisionConfig
from posetraj_torch.core.init import Init
from posetraj_torch.ops.attention import attention
from posetraj_torch.ops.primitives import gelu, layer_norm, linear


def init_clip_vision(ini: Init, cfg: CLIPVisionConfig) -> dict:
    d = cfg.hidden_size
    num_patches = (cfg.image_size // cfg.patch_size) ** 2
    p: dict = {
        "class_embedding": ini.normal((d,), 0.02),
        "patch_embedding": ini.conv(3, d, cfg.patch_size, cfg.patch_size, bias=False),
        "position_embedding": ini.normal((num_patches + 1, d), 0.02),
        "pre_layernorm": ini.norm(d),
        "layers": [],
        "post_layernorm": ini.norm(d),
        "visual_projection": ini.linear(d, cfg.projection_dim, bias=False),
    }
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "layer_norm1": ini.norm(d),
            "q_proj": ini.linear(d, d),
            "k_proj": ini.linear(d, d),
            "v_proj": ini.linear(d, d),
            "out_proj": ini.linear(d, d),
            "layer_norm2": ini.norm(d),
            "fc1": ini.linear(d, cfg.intermediate_size),
            "fc2": ini.linear(cfg.intermediate_size, d),
        })
    return p


def _encoder_layer(p: dict, x: torch.Tensor, cfg: CLIPVisionConfig, compute_dtype) -> torch.Tensor:
    h = layer_norm(p["layer_norm1"], x, eps=cfg.layer_norm_eps)
    q = linear(p["q_proj"], h, compute_dtype)
    k = linear(p["k_proj"], h, compute_dtype)
    v = linear(p["v_proj"], h, compute_dtype)
    x = x + linear(p["out_proj"], attention(q, k, v, cfg.num_heads), compute_dtype)
    h = layer_norm(p["layer_norm2"], x, eps=cfg.layer_norm_eps)
    return x + linear(p["fc2"], gelu(linear(p["fc1"], h, compute_dtype)), compute_dtype)


def clip_image_embeds(params: dict, cfg: CLIPVisionConfig, pixel_values: torch.Tensor,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, 224, 224, 3) pixels -> (B, projection_dim) image_embeds."""
    b = pixel_values.shape[0]
    x = pixel_values.to(compute_dtype).permute(0, 3, 1, 2)
    patches = F.conv2d(x, params["patch_embedding"]["weight"].to(compute_dtype), stride=cfg.patch_size)
    patches = patches.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden_size)
    cls = params["class_embedding"].to(compute_dtype)[None, None, :].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, patches], dim=1) + params["position_embedding"].to(compute_dtype)[None]
    x = layer_norm(params["pre_layernorm"], x, eps=cfg.layer_norm_eps)
    for layer in params["layers"]:
        x = _encoder_layer(layer, x, cfg, compute_dtype)
    pooled = layer_norm(params["post_layernorm"], x[:, 0, :], eps=cfg.layer_norm_eps)
    return linear(params["visual_projection"], pooled, compute_dtype)


def clip_preprocess(images: torch.Tensor, cfg: CLIPVisionConfig) -> torch.Tensor:
    """Normalise [0, 1] RGB (B, H, W, 3) with the CLIP mean/std."""
    mean = torch.tensor(cfg.image_mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(cfg.image_std, dtype=images.dtype, device=images.device)
    return (images - mean) / std
