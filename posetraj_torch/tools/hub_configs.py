"""Checkpoint config.json handling, with `from_pretrained` semantics (port of
posetraj_tpu/tools/hub_configs.py).

The reference never relies on diffusers/transformers class defaults: every
model is loaded with `from_pretrained` (train_svd_traj_blender_14.py:866-898,
run_inference_vipseg_json_repro.py:335-338), which overrides class defaults
with the checkpoint's ``config.json``. Architecture constants that do not
change parameter shapes (e.g. ``num_attention_heads``: the head count only
re-partitions the same QKV matrices) are invisible to the shape-strict weight
converter, so they must come from the checkpoint config, never be assumed.

This module provides:

  * ``EXPECTED``: the recorded contents of the relevant config.json files of
    ``stabilityai/stable-video-diffusion-img2vid`` (the checkpoint the
    reference trains against), the source the dataclass defaults in
    ``posetraj_torch/configs.py`` are pinned to; the JAX package's table,
    copied unchanged.
  * ``unet_config_from_json`` / ``vae_config_from_json`` /
    ``clip_config_from_json`` / ``scheduler_config_from_json``: the port's
    typed configs built from a checkpoint's config.json dict, as
    ``from_pretrained`` builds them.
  * ``verify_against_expected``: every divergence of a checkpoint's
    config.json files from ``EXPECTED`` (run it on a freshly downloaded
    checkpoint; tools/parity_gate.py does).

    python -m posetraj_torch.tools.hub_configs /path/to/svd-checkpoint
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from posetraj_torch.configs import (
    CLIPVisionConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
)

# ---------------------------------------------------------------------------
# Recorded config.json contents (stabilityai/stable-video-diffusion-img2vid).
# Keys irrelevant to the math (private "_" keys, library bookkeeping) omitted.
# ---------------------------------------------------------------------------

EXPECTED: Dict[str, Dict[str, Any]] = {
    # unet/config.json — note num_attention_heads [5, 10, 20, 20]: head_dim 64
    # at every level. The diffusers CLASS default is (5, 10, 10, 20)
    # (unet_spatio_temporal_condition_controlnet.py:93) but the checkpoint
    # overrides it; generation with the class default would be silently wrong.
    "unet": {
        "addition_time_embed_dim": 256,
        "block_out_channels": [320, 640, 1280, 1280],
        "cross_attention_dim": 1024,
        "down_block_types": [
            "CrossAttnDownBlockSpatioTemporal",
            "CrossAttnDownBlockSpatioTemporal",
            "CrossAttnDownBlockSpatioTemporal",
            "DownBlockSpatioTemporal",
        ],
        "in_channels": 8,
        "layers_per_block": 2,
        "num_attention_heads": [5, 10, 20, 20],
        "num_frames": 14,
        "out_channels": 4,
        "projection_class_embeddings_input_dim": 768,
        "sample_size": 96,
        "transformer_layers_per_block": 1,
        "up_block_types": [
            "UpBlockSpatioTemporal",
            "CrossAttnUpBlockSpatioTemporal",
            "CrossAttnUpBlockSpatioTemporal",
            "CrossAttnUpBlockSpatioTemporal",
        ],
    },
    # vae/config.json (AutoencoderKLTemporalDecoder)
    "vae": {
        "block_out_channels": [128, 256, 512, 512],
        "down_block_types": [
            "DownEncoderBlock2D",
            "DownEncoderBlock2D",
            "DownEncoderBlock2D",
            "DownEncoderBlock2D",
        ],
        "force_upcast": True,
        "in_channels": 3,
        "latent_channels": 4,
        "layers_per_block": 2,
        "out_channels": 3,
        "sample_size": 768,
        "scaling_factor": 0.18215,
    },
    # image_encoder/config.json (CLIPVisionModelWithProjection, laion ViT-H/14)
    "image_encoder": {
        "attention_dropout": 0.0,
        "hidden_act": "gelu",
        "hidden_size": 1280,
        "image_size": 224,
        "initializer_factor": 1.0,
        "initializer_range": 0.02,
        "intermediate_size": 5120,
        "layer_norm_eps": 1e-05,
        "model_type": "clip_vision_model",
        "num_attention_heads": 16,
        "num_channels": 3,
        "num_hidden_layers": 32,
        "patch_size": 14,
        "projection_dim": 1024,
    },
    # feature_extractor/preprocessor_config.json
    "feature_extractor": {
        "image_mean": [0.48145466, 0.4578275, 0.40821073],
        "image_std": [0.26862954, 0.26130258, 0.27577711],
        "crop_size": {"height": 224, "width": 224},
        "size": {"shortest_edge": 224},
    },
    # scheduler/scheduler_config.json (EulerDiscreteScheduler, SVD flavor)
    "scheduler": {
        "beta_end": 0.012,
        "beta_schedule": "scaled_linear",
        "beta_start": 0.00085,
        "interpolation_type": "linear",
        "num_train_timesteps": 1000,
        "prediction_type": "v_prediction",
        "sigma_max": 700.0,
        "sigma_min": 0.002,
        "steps_offset": 1,
        "timestep_spacing": "leading",
        "timestep_type": "continuous",
        "trained_betas": None,
        "use_karras_sigmas": True,
    },
}


def load_config_json(checkpoint_dir: str, subfolder: str) -> Dict[str, Any]:
    """Read ``<checkpoint_dir>/<subfolder>/config.json`` (preprocessor_config
    for the feature extractor), mirroring diffusers' layout."""
    name = {
        "feature_extractor": "preprocessor_config.json",
        "scheduler": "scheduler_config.json",
    }.get(subfolder, "config.json")
    path = os.path.join(checkpoint_dir, subfolder, name)
    with open(path) as f:
        return json.load(f)


def _tup(x) -> Tuple:
    return tuple(x) if isinstance(x, (list, tuple)) else x


def unet_config_from_json(cfg: Dict[str, Any]) -> UNetConfig:
    """UNetConfig from a checkpoint's unet/config.json (checkpoint wins over
    class defaults, as in diffusers from_pretrained)."""
    down = cfg.get("down_block_types", EXPECTED["unet"]["down_block_types"])
    heads = cfg.get("num_attention_heads", EXPECTED["unet"]["num_attention_heads"])
    if not isinstance(heads, (list, tuple)):
        heads = [heads] * len(down)
    return UNetConfig(
        in_channels=cfg.get("in_channels", 8),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=_tup(cfg.get("block_out_channels", (320, 640, 1280, 1280))),
        cross_attention_levels=tuple(t.startswith("CrossAttn") for t in down),
        layers_per_block=cfg.get("layers_per_block", 2),
        transformer_layers_per_block=cfg.get("transformer_layers_per_block", 1),
        num_attention_heads=_tup(heads),
        cross_attention_dim=cfg.get("cross_attention_dim", 1024),
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
        projection_class_embeddings_input_dim=cfg.get(
            "projection_class_embeddings_input_dim", 768
        ),
        num_frames=cfg.get("num_frames", 14),
    )


def vae_config_from_json(cfg: Dict[str, Any]) -> VAEConfig:
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=_tup(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def clip_config_from_json(cfg: Dict[str, Any]) -> CLIPVisionConfig:
    return CLIPVisionConfig(
        image_size=cfg.get("image_size", 224),
        patch_size=cfg.get("patch_size", 14),
        hidden_size=cfg.get("hidden_size", 1280),
        num_layers=cfg.get("num_hidden_layers", 32),
        num_heads=cfg.get("num_attention_heads", 16),
        intermediate_size=cfg.get("intermediate_size", 5120),
        projection_dim=cfg.get("projection_dim", 1024),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
    )


def scheduler_config_from_json(cfg: Dict[str, Any]) -> SchedulerConfig:
    return SchedulerConfig(
        num_train_timesteps=cfg.get("num_train_timesteps", 1000),
        beta_start=cfg.get("beta_start", 0.00085),
        beta_end=cfg.get("beta_end", 0.012),
        beta_schedule=cfg.get("beta_schedule", "scaled_linear"),
        prediction_type=cfg.get("prediction_type", "v_prediction"),
        timestep_type=cfg.get("timestep_type", "continuous"),
        timestep_spacing=cfg.get("timestep_spacing", "leading"),
        interpolation_type=cfg.get("interpolation_type", "linear"),
        use_karras_sigmas=cfg.get("use_karras_sigmas", True),
        sigma_min=cfg.get("sigma_min", 0.002),
        sigma_max=cfg.get("sigma_max", 700.0),
    )


def verify_against_expected(
    checkpoint_dir: str, subfolders: Optional[List[str]] = None
) -> List[str]:
    """Diff a real checkpoint's config.json files against EXPECTED.

    Returns a list of human-readable divergence strings (empty = all
    recorded constants confirmed). Every divergence found must be fixed in
    both EXPECTED and configs.py — run this before any parity work with a
    freshly downloaded checkpoint.
    """
    problems: List[str] = []
    for sub in subfolders or list(EXPECTED):
        try:
            actual = load_config_json(checkpoint_dir, sub)
        except FileNotFoundError:
            problems.append(f"{sub}: config.json not found under {checkpoint_dir}")
            continue
        for key, want in EXPECTED[sub].items():
            got = actual.get(key, "<missing>")
            norm = lambda v: list(v) if isinstance(v, tuple) else v
            if norm(got) != norm(want):
                problems.append(f"{sub}.{key}: checkpoint={got!r} recorded={want!r}")
    return problems


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=verify_against_expected.__doc__)
    ap.add_argument("checkpoint_dir", help="local SVD checkpoint directory")
    args = ap.parse_args()
    issues = verify_against_expected(args.checkpoint_dir)
    if issues:
        print("DIVERGENCES FOUND:")
        for line in issues:
            print(" -", line)
        raise SystemExit(1)
    print("all recorded config constants confirmed against", args.checkpoint_dir)
