"""Typed configuration for the PyTorch port.

The port's own copies of the model, scheduler and pipeline configurations,
with the same fields, defaults and `tiny()` constructors as the JAX package's
`configs.py`, and of its kernel-dispatch switches (`KernelConfig`). Frozen
dataclasses, so a configuration is hashable and safe to share between calls.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Which hand-written kernels the model layer may dispatch to: the same
    eight switches, defaults and POSETRAJ_* variables as the JAX package's
    KernelConfig. A True means "may dispatch"; each site's gate also checks
    the device and the shape. Scope an explicit config with `use_kernels()`
    (`ModelBundle.kernels` inside `generate()`); outside any scope,
    `from_env()` seeds it. The environment is read here and nowhere in ops/.
    """

    qkvt_attn: bool = True        # spatial self-attention sub-layer (kernel C)
    temporal_attn: bool = True    # temporal self-attention sub-layer (kernel D)
    fused_ff: bool = True         # GEGLU MLP (kernel B)
    fused_ff_wide: bool = True    # ...including K > 640 (the 1280-wide levels)
    fused_ff_ln: bool = True      # fold the pre-FF LayerNorm into kernel B
    fused_groupnorm: bool = True  # GroupNorm(+SiLU) (kernel A); >= 2^28 elements take it anyway
    fused_ln: bool = False        # standalone row LayerNorm (kernel 8)
    # A TPU softmax lever: the JAX kernels may skip the running max, which
    # changes nothing while the logits stay in range. It selects nothing on
    # the card, where every attention kernel subtracts the running max; the
    # field is kept so that one config means the same in both packages.
    attn_no_max: bool = True

    @classmethod
    def from_env(cls) -> "KernelConfig":
        """POSETRAJ_<NAME>=0 turns a switch off, any other value on; unset
        keeps the default (so POSETRAJ_FUSED_LN=1 opts in)."""
        kw = {}
        for field in dataclasses.fields(cls):
            v = os.environ.get(f"POSETRAJ_{field.name.upper()}")
            if v is not None:
                kw[field.name] = v != "0"
        return cls(**kw)


_ACTIVE_KERNELS: Optional[KernelConfig] = None


def kernel_config() -> KernelConfig:
    """The innermost `use_kernels()` scope's config, else
    `KernelConfig.from_env()` read now."""
    return _ACTIVE_KERNELS if _ACTIVE_KERNELS is not None else KernelConfig.from_env()


class use_kernels:
    """Context manager that makes `cfg` the active KernelConfig;
    `use_kernels(None)` keeps the enclosing scope (or the environment)."""

    def __init__(self, cfg: Optional[KernelConfig]):
        self._cfg = cfg
        self._prev: Optional[KernelConfig] = None

    def __enter__(self):
        global _ACTIVE_KERNELS
        self._prev = _ACTIVE_KERNELS
        if self._cfg is not None:
            _ACTIVE_KERNELS = self._cfg
        return self._cfg

    def __exit__(self, *exc):
        global _ACTIVE_KERNELS
        _ACTIVE_KERNELS = self._prev
        return False


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


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    """EDM training-noise distribution and loss weighting (the reference's
    constants: sigma_data 0.5, sigma in [0.002, 700], image_d 64, noise_d
    32/64)."""

    sigma_data: float = 0.5
    min_value: float = 0.002
    max_value: float = 700.0
    image_d: int = 64
    noise_d_low: int = 32
    noise_d_high: int = 64


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """EDM ControlNet training (stage-1 pretrain / stage-2 finetune).

    Defaults mirror the reference's start_pretrain.sh: lr 1e-5 with 500
    warmup steps, per-device batch 1, gradient accumulation 2, conditioning
    dropout 0.1, EMA, the auxiliary single-frame spatial loss x0.5, gradient
    checkpointing per (resnet, transformer) unit, 14 frames at 320x576.

    Not in the port yet: `grads_bf16`, `adam_mu_bf16`, `grad_accum_dtype`
    (memory options) and `encode_outside_step`. Setting any of them raises
    NotImplementedError in the trainer.
    """

    learning_rate: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    adam_mu_bf16: bool = False
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 2
    per_device_batch_size: int = 1
    num_frames: int = 14
    height: int = 320
    width: int = 576
    conditioning_dropout_prob: float = 0.1
    noise_aug_strength: float = 0.02
    use_spatial_loss: bool = True
    spatial_loss_weight: float = 0.5
    use_ema: bool = True
    ema_decay: float = 0.9999
    gradient_checkpointing: bool = True
    # "unit" checkpoints each (resnet, transformer) unit inside the blocks,
    # "block" whole blocks; the numbers are the same either way.
    remat_granularity: str = "unit"
    seed: int = 23123134
    cam_mask_ratio: float = 0.5
    cam_norm: bool = False
    checkpointing_steps: int = 10000
    checkpoints_total_limit: int = 2
    lr_warmup_steps: int = 500
    lr_scheduler: str = "constant"
    grad_accum_dtype: Optional[str] = None
    grads_bf16: bool = False
    encode_outside_step: bool = False
