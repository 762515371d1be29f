"""End-to-end trajectory-conditioned img2vid sampling (the reference's
StableVideoDiffusionPipelineControlNet): CLIP image embedding, float32 VAE
encode, the hint encoder once, Euler-Karras steps of ControlNet -> UNet on a
CFG-doubled batch, and a chunked VAE decode.

Quirks preserved: Q2 per-frame guidance linspace(min -> max, num_frames);
Q3 added_time_ids hard-coded to (fps=6, motion=128, aug=0.02); Q8 the
antialias-resized [0, 1] image goes to CLIP without mean/std normalisation.
All Gaussian draws can be injected through `noises=` for parity tests.

Entry points run on `cuda` unless the caller passes `device="cpu"`. The
compute dtype is an argument: by default bf16 on the card and float32 on the
CPU, as the JAX package picks by backend. `generate()` runs under the
bundle's KernelConfig (`ModelBundle.kernels`; None takes the POSETRAJ_*
variables, read when the call starts).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from posetraj_torch.configs import (
    CLIPVisionConfig,
    ControlNetConfig,
    KernelConfig,
    PipelineConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
    use_kernels,
)
from posetraj_torch.core.init import default_compute_dtype, make_init, resolve_device
from posetraj_torch.diffusion.euler_karras import euler_step, make_schedule
from posetraj_torch.models import clip as clip_m
from posetraj_torch.models import controlnet as cn
from posetraj_torch.models import unet as unet_m
from posetraj_torch.models import vae as vae_m
from posetraj_torch.ops.primitives import set_float32_precision
from posetraj_torch.ops.resize import resize_antialias


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Model configs for one pipeline instance."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    controlnet: ControlNetConfig = dataclasses.field(default_factory=ControlNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    clip: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    fidelity_clip_unnormalized: bool = True  # Q8
    # Kernel dispatch switches for every call made under this bundle;
    # None = the POSETRAJ_* variables (KernelConfig.from_env).
    kernels: Optional[KernelConfig] = None

    @classmethod
    def tiny(cls) -> "ModelBundle":
        return cls(unet=UNetConfig.tiny(), controlnet=ControlNetConfig.tiny(), vae=VAEConfig.tiny(),
                   clip=CLIPVisionConfig.tiny())


def resolve_kernels(bundle: ModelBundle) -> ModelBundle:
    """The bundle with its KernelConfig pinned: None becomes
    KernelConfig.from_env() read now; an explicit config passes through."""
    if bundle.kernels is None:
        return dataclasses.replace(bundle, kernels=KernelConfig.from_env())
    return bundle


def init_params(bundle: ModelBundle, seed: int = 0, device=None, compute_dtype=None) -> Dict:
    """Random parameters for every model of the bundle, made on the device
    from `seed`: torch-default fan-in uniform weights, zero ControlNet heads,
    the ControlNet's encoder copied from the UNet (ControlNetSDVModel.from_unet).
    The VAE encoder is float32; everything else the compute dtype."""
    device = resolve_device(device)
    dt = compute_dtype or default_compute_dtype(device)
    ini = make_init(seed, device, dt)
    unet = unet_m.init_unet(ini, bundle.unet)
    controlnet = cn.controlnet_from_unet(cn.init_controlnet(ini, bundle.controlnet), unet)
    return {
        "unet": unet,
        "controlnet": controlnet,
        "vae": vae_m.init_vae(make_init(seed + 1, device, torch.float32), ini, bundle.vae),
        "clip": clip_m.init_clip_vision(ini, bundle.clip),
    }


def encode_image_clip(params: Dict, bundle: ModelBundle, image: torch.Tensor, compute_dtype) -> torch.Tensor:
    """[0, 1] RGB (B, H, W, 3) -> CFG-stacked CLIP embeddings (2B, 1, D):
    zeros (uncond) first, then cond."""
    resized = resize_antialias(image.float(), (bundle.clip.image_size, bundle.clip.image_size))
    if not bundle.fidelity_clip_unnormalized:
        resized = clip_m.clip_preprocess(resized, bundle.clip)
    emb = clip_m.clip_image_embeds(params["clip"], bundle.clip, resized, compute_dtype)
    emb = emb[:, None, :].to(compute_dtype)
    return torch.cat([torch.zeros_like(emb), emb], dim=0)


def encode_image_vae(params: Dict, bundle: ModelBundle, image: torch.Tensor, noise: torch.Tensor,
                     noise_aug_strength: float) -> torch.Tensor:
    """[-1, 1] image (B, H, W, 3) + noise-aug -> CFG-stacked cond latents
    (2B, h, w, 4): zeros first, then the .mode() latents, float32 encode."""
    mean, _ = vae_m.encode(params["vae"]["encoder"], bundle.vae, image + noise_aug_strength * noise,
                           compute_dtype=torch.float32)
    return torch.cat([torch.zeros_like(mean), mean], dim=0)


def added_time_ids_inference(pcfg: PipelineConfig) -> np.ndarray:
    """(1, 3) in the inference order [fps, motion_bucket, noise_aug] (Q3)."""
    if pcfg.fidelity_time_ids_override:
        return np.asarray([[6.0, 128.0, 0.02]], np.float32)
    return np.asarray([[pcfg.fps - 1, pcfg.motion_bucket_id, pcfg.noise_aug_strength]], np.float32)


def denoise(params: Dict, bundle: ModelBundle, pcfg: PipelineConfig, latents: torch.Tensor,
            image_latents: torch.Tensor, clip_embeddings: torch.Tensor, control_video: torch.Tensor,
            added_time_ids: torch.Tensor, sigmas: torch.Tensor, timesteps: torch.Tensor,
            guidance_scale: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The sampling loop as a plain Python loop over the sigma ladder.
    latents (B, F, h, w, 4) float32; image_latents (2B, h, w, 4);
    control_video (2B, F, H, W, 3) in [-1, 1]; guidance_scale (F,)."""
    b, f = latents.shape[:2]
    dt = compute_dtype
    img_lat = image_latents[:, None].expand(-1, f, -1, -1, -1).to(dt)
    gs = guidance_scale.reshape(1, f, 1, 1, 1).float()
    # The hint embedding depends only on the control video: computed once.
    hint = cn.hint_encoder(params["controlnet"]["controlnet_cond_embedding"], bundle.controlnet.hint,
                           control_video.to(dt), f, dt)
    lat = latents.float()
    for i in range(timesteps.shape[0]):
        sigma, sigma_next, t = sigmas[i], sigmas[i + 1], timesteps[i]
        lat_in = (torch.cat([lat, lat], dim=0) / torch.sqrt(sigma**2 + 1.0)).to(dt)
        lat_in = torch.cat([lat_in, img_lat], dim=-1)
        down_res, mid_res = cn.controlnet_forward(
            params["controlnet"], bundle.controlnet, lat_in, t, clip_embeddings, added_time_ids,
            conditioning_scale=pcfg.controlnet_cond_scale, compute_dtype=dt, hint_embedding=hint,
        )
        noise_pred = unet_m.unet_forward(params["unet"], bundle.unet, lat_in, t, clip_embeddings, added_time_ids,
                                         down_res, mid_res, compute_dtype=dt).float()
        uncond, cond = noise_pred[:b], noise_pred[b:]
        noise_pred = uncond + gs * (cond - uncond)
        lat, _ = euler_step(noise_pred, lat, sigma, sigma_next, bundle.scheduler.prediction_type)
        lat = lat.float()
    return lat


def decode_latents(params: Dict, bundle: ModelBundle, latents: torch.Tensor, decode_chunk_size: int,
                   compute_dtype) -> torch.Tensor:
    """(B, F, h, w, 4) -> (B, F, H, W, 3) float32 in [-1, 1]; frames decoded
    in chunks of `decode_chunk_size`, each chunk one video to the decoder."""
    b, f = latents.shape[:2]
    flat = latents.reshape(b * f, *latents.shape[2:]) / bundle.vae.scaling_factor
    outs = []
    for i in range(0, b * f, decode_chunk_size):
        chunk = flat[i : i + decode_chunk_size]
        outs.append(vae_m.decode(params["vae"]["decoder"], bundle.vae, chunk, chunk.shape[0], compute_dtype).float())
    frames = torch.cat(outs, dim=0)
    return frames.reshape(b, f, *frames.shape[1:])


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device=device, dtype=dtype)


@torch.inference_mode()
def generate(params: Dict, bundle: ModelBundle, pcfg: PipelineConfig, image, control_video, noises: Dict,
             added_time_ids, sigmas, timesteps, num_frames: int, output_latent: bool = False, device=None,
             compute_dtype=None) -> torch.Tensor:
    """Full image -> video program.

    image (B, H, W, 3) in [0, 1]; control_video (B, F, H, W, 3) in [0, 1];
    noises {"latents": (B, F, h, w, 4), "image_aug": (B, H, W, 3)} standard
    normal. Returns (B, F, H, W, 3) float32 in [0, 1], or the final latents
    (B, F, h, w, 4) if output_latent. `params` must already be on `device`.
    Runs under the bundle's KernelConfig (resolve_kernels)."""
    with use_kernels(resolve_kernels(bundle).kernels):
        device = resolve_device(device)
        if device.type == "cuda":
            set_float32_precision()
        dt = compute_dtype or default_compute_dtype(device)
        image = _as_tensor(image, device)
        control_video = _as_tensor(control_video, device)
        sigmas = _as_tensor(sigmas, device)
        timesteps = _as_tensor(timesteps, device)
        time_ids = _as_tensor(added_time_ids, device)

        clip_emb = encode_image_clip(params, bundle, image, dt)
        image_latents = encode_image_vae(params, bundle, image * 2.0 - 1.0, _as_tensor(noises["image_aug"], device),
                                         pcfg.noise_aug_strength)
        init_sigma = sigmas[0] if bundle.scheduler.timestep_spacing in ("linspace", "trailing") \
            else torch.sqrt(sigmas[0] ** 2 + 1.0)
        latents = _as_tensor(noises["latents"], device) * init_sigma
        control = (control_video * 2.0 - 1.0).to(dt)
        control = torch.cat([control, control], dim=0)
        guidance = torch.linspace(pcfg.min_guidance_scale, pcfg.max_guidance_scale, num_frames, device=device)
        time_ids = torch.cat([time_ids, time_ids], dim=0)
        latents = denoise(params, bundle, pcfg, latents, image_latents, clip_emb, control, time_ids, sigmas, timesteps,
                          guidance, dt)
        if output_latent:
            return latents
        frames = decode_latents(params, bundle, latents, pcfg.decode_chunk_size, dt)
        return (frames / 2.0 + 0.5).clamp(0.0, 1.0)


class SVDControlNetPipeline:
    """User-facing wrapper mirroring the reference __call__ surface.
    params: {"unet", "controlnet", "vae": {"encoder", "decoder"}, "clip"},
    already on `device`."""

    def __init__(self, params: Dict, bundle: ModelBundle = ModelBundle(), device=None, compute_dtype=None):
        self.device = resolve_device(device)
        self.params = params
        self.bundle = bundle
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)

    def __call__(self, image, controlnet_condition, height: int = 576, width: int = 1024, num_frames: int = 14,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0, max_guidance_scale: float = 3.0,
                 fps: int = 7, motion_bucket_id: int = 127, noise_aug_strength: float = 0.02,
                 controlnet_cond_scale: float = 1.0, decode_chunk_size: Optional[int] = None, seed: int = 0,
                 noises: Optional[Dict] = None, output_type: str = "np"):
        pcfg = PipelineConfig(
            height=height, width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
            min_guidance_scale=min_guidance_scale, max_guidance_scale=max_guidance_scale, fps=fps,
            motion_bucket_id=motion_bucket_id, noise_aug_strength=noise_aug_strength,
            controlnet_cond_scale=controlnet_cond_scale, decode_chunk_size=decode_chunk_size or num_frames,
        )
        image = _to_float_array(image)
        control = _to_float_array(controlnet_condition)
        if control.ndim == 4:
            control = control[None]
        b = image.shape[0]
        sf = self.bundle.vae.scale_factor
        lat_shape = (b, num_frames, height // sf, width // sf, self.bundle.vae.latent_channels)
        if noises is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            noises = {
                "latents": torch.randn(lat_shape, generator=gen, device=self.device),
                "image_aug": torch.randn(image.shape, generator=gen, device=self.device),
            }
        sched = make_schedule(self.bundle.scheduler, num_inference_steps)
        time_ids = np.tile(added_time_ids_inference(pcfg), (b, 1))
        frames = generate(self.params, self.bundle, pcfg, image, control, noises, time_ids, sched.sigmas,
                          sched.timesteps, num_frames, output_latent=(output_type == "latent"),
                          device=self.device, compute_dtype=self.compute_dtype)
        return frames.cpu().numpy()


def _to_float_array(x) -> np.ndarray:
    """PIL image / list of PIL / numpy -> float32 [0, 1] channels-last with a batch dim."""
    try:
        from PIL import Image

        if isinstance(x, Image.Image):
            x = np.asarray(x, np.float32)[None] / 255.0
        elif isinstance(x, (list, tuple)) and x and isinstance(x[0], Image.Image):
            x = np.stack([np.asarray(im, np.float32) for im in x]) / 255.0
    except ImportError:
        pass
    x = np.asarray(x, np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    if x.ndim == 3:
        x = x[None]
    return x
