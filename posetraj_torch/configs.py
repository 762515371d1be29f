"""Typed configuration for the PyTorch port.

The port's own copies of the model, scheduler and pipeline configurations,
with the same fields, defaults and `tiny()` constructors as the JAX package's
`configs.py`. Frozen dataclasses, so a configuration is hashable and safe to
share between calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SVD spatio-temporal UNet that consumes ControlNet residuals
    (diffusers 0.24.0 block semantics)."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    # CrossAttn blocks at levels 0-2, a plain block at level 3.
    cross_attention_levels: Tuple[bool, ...] = (True, True, True, False)
    layers_per_block: int = 2
    transformer_layers_per_block: int = 1
    # The released SVD img2vid checkpoints ship [5, 10, 20, 20] (head_dim 64
    # at every level), not the diffusers class default (5, 10, 10, 20).
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    num_frames: int = 14
    resnet_eps: float = 1e-5
    # Quirk Q1: the reference re-adds ControlNet residual k on every later
    # down-block iteration (the merge sits inside the block loop). Trained
    # checkpoints bake this in, so it defaults on.
    fidelity_residual_in_loop: bool = True

    @property
    def num_levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def tiny(cls) -> "UNetConfig":
        """Small config for tests: same topology, tiny widths."""
        return cls(
            block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 4, 4, 4),
            cross_attention_dim=16,
            addition_time_embed_dim=8,
            projection_class_embeddings_input_dim=24,
            num_frames=2,
        )


@dataclasses.dataclass(frozen=True)
class HintEncoderConfig:
    """Trajectory hint conv encoder. The port has the "base" variant only:
    conv_in -> [3x3 conv, 3x3 stride-2 conv] x 3 -> zero conv_out."""

    variant: str = "base"
    conditioning_channels: int = 3
    block_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    embedding_channels: int = 320  # == UNet block_out_channels[0]


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """Trajectory ControlNet: UNet encoder copy + hint encoder + zero convs."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    hint: HintEncoderConfig = dataclasses.field(default_factory=HintEncoderConfig)

    @classmethod
    def tiny(cls) -> "ControlNetConfig":
        u = UNetConfig.tiny()
        return cls(
            unet=u,
            hint=HintEncoderConfig(
                block_out_channels=(4, 8, 8, 16),
                embedding_channels=u.block_out_channels[0],
            ),
        )


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKLTemporalDecoder: 2D encoder + temporal-conv decoder."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215
    eps: float = 1e-6

    @property
    def scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        return cls(block_out_channels=(8, 16, 16, 16), layers_per_block=1)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT-H/14 image encoder with projection (laion2B), frozen."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(
            image_size=28,
            patch_size=14,
            hidden_size=32,
            num_layers=2,
            num_heads=2,
            intermediate_size=64,
            projection_dim=16,
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Euler-Discrete scheduler with the "karras fix", pinned to the SVD
    checkpoint's scheduler_config.json (v_prediction, continuous timesteps,
    Karras sigmas, "leading" spacing)."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"
    timestep_type: str = "continuous"
    timestep_spacing: str = "leading"
    steps_offset: int = 1
    interpolation_type: str = "linear"
    use_karras_sigmas: bool = True
    sigma_min: Optional[float] = 0.002
    sigma_max: Optional[float] = 700.0
    rho: float = 7.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end img2vid sampling configuration."""

    height: int = 576
    width: int = 1024
    num_frames: int = 14
    num_inference_steps: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    controlnet_cond_scale: float = 1.0
    decode_chunk_size: int = 8
    # Quirk Q3: the reference overrides user fps/motion args with hard-coded
    # (fps=6, motion=128, aug=0.02) right before the denoise loop.
    fidelity_time_ids_override: bool = True
