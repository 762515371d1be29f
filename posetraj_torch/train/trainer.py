"""EDM ControlNet trainer: the loss, the train step with gradient
accumulation and EMA, and the `Trainer` entry point (port of
posetraj_tpu/train/trainer.py, single device). Only the ControlNet trains;
the UNet, the VAE and CLIP are frozen.

Training math (the reference's train_svd_traj_blender_14.py:1204-1384):
  * VAE-encode the frames with .sample(), times scaling_factor
  * sigma ~ rand_cosine_interpolated, one per sample
  * one Gaussian noise drives both the 0.02 cond-image augmentation and the
    EDM noising
  * cond latents = frame 0 of the lightly noised latents / scaling_factor
  * timestep = 0.25 log sigma; input / sqrt(sigma^2 + 1)
  * CLIP embedding of frame 0 with the TRAIN-path normalisation quirk
  * added_time_ids in the TRAIN order [fps, noise_aug, motion]
  * conditioning dropout: p < 2g zeroes CLIP, g <= p < 3g the cond latents
  * EDM reconstruction target = clean latents, w = (1 + s^2) / s^2
  * auxiliary single-frame spatial loss x0.5
  * EMA of the ControlNet parameters on gradient-sync steps

Randomness: the JAX step splits one key into five draws. Here
`draw_step_randoms` makes the same five draws from a torch.Generator and
the loss takes them as a dict, so a test can hand in JAX's draws.

Precision: the ControlNet keeps float32 master weights and casts each to
the compute dtype where it is used, so the bf16 gradient of every use flows
back into the float32 master through that cast. The optimizer is AdamW in
float32 with linear warmup; gradients of the micro-steps are summed in the
masters' .grad, and on every sync step their mean is clipped to
max_grad_norm and applied (optax.MultiSteps over clip_by_global_norm and
adamw in the JAX package). Like optax's schedule, the warmup starts from a
learning rate of 0 on the first update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from posetraj_torch.configs import EDMConfig, KernelConfig, TrainConfig, use_kernels
from posetraj_torch.core.init import default_compute_dtype, resolve_device
from posetraj_torch.core.params import ema_decay_schedule, ema_update, leaves
from posetraj_torch.diffusion.edm import edm_loss_weight, edm_scalings, rand_cosine_interpolated
from posetraj_torch.models import clip as clip_m
from posetraj_torch.models import controlnet as cn
from posetraj_torch.models import unet as unet_m
from posetraj_torch.models import vae as vae_m
from posetraj_torch.ops.primitives import set_float32_precision
from posetraj_torch.ops.resize import resize_antialias
from posetraj_torch.pipeline.svd_controlnet import resolve_kernels


def encode_image_clip_train(params: Dict, bundle, frame0_m11: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Training-path CLIP embedding of the first frame, (B, 1, D). The
    reference's *2-1 / +1/2 wrap around the antialiased resize cancels, so
    the [-1, 1] pixels are resized and then normalised with the CLIP
    mean/std as if they were [0, 1] (a quirk distinct from inference)."""
    size = bundle.clip.image_size
    resized = resize_antialias(frame0_m11.float(), (size, size))
    normalized = clip_m.clip_preprocess(resized, bundle.clip)
    return clip_m.clip_image_embeds(params["clip"], bundle.clip, normalized, compute_dtype)[:, None, :]


def added_time_ids_train(motion_values: torch.Tensor, fps: float = 6.0, noise_aug: float = 0.02) -> torch.Tensor:
    """(B, 3) in the TRAIN order [fps, noise_aug, motion]; inference uses
    [fps, motion, noise_aug]."""
    b = motion_values.shape[0]
    fixed = torch.tensor([fps, noise_aug], dtype=torch.float32, device=motion_values.device).expand(b, 2)
    return torch.cat([fixed, motion_values.reshape(b, 1).float()], dim=1)


@torch.no_grad()
def _vae_encode_frames(frozen_params: Dict, bundle, pixel_values: torch.Tensor, vae_eps: torch.Tensor) -> torch.Tensor:
    """Frozen float32 VAE encode of every frame, two frames at a time (the
    peak is one chunk's conv temporaries), .sample() with the standard-normal
    draw vae_eps (B*F, h, w, 4), times scaling_factor -> (B, F, h, w, 4)."""
    b, f = pixel_values.shape[:2]
    frames = pixel_values.reshape(b * f, *pixel_values.shape[2:]).float()
    chunk = 2 if (b * f) % 2 == 0 and b * f > 2 else b * f
    means, logvars = [], []
    for i in range(0, b * f, chunk):
        m, lv = vae_m.encode(frozen_params["vae"]["encoder"], bundle.vae, frames[i : i + chunk],
                             compute_dtype=torch.float32)
        means.append(m)
        logvars.append(lv)
    lat = vae_m.sample_latent(torch.cat(means), torch.cat(logvars), vae_eps) * bundle.vae.scaling_factor
    return lat.reshape(b, f, *lat.shape[1:])


def draw_step_randoms(generator: torch.Generator, batch_size: int, num_frames: int, latent_shape,
                      device=None) -> Dict[str, torch.Tensor]:
    """The five draws of one step (the JAX step's k_vae, k_sigma, k_noise,
    k_drop, k_frame): vae_eps (B*F, h, w, c) and noise (B, F, h, w, c)
    standard normal, u_sigma and drop_p (B,) uniform, frame_idx (1,) in
    [0, F). latent_shape = (h, w, c)."""
    b, f = batch_size, num_frames
    kw = dict(generator=generator, device=device)
    return {
        "vae_eps": torch.randn((b * f, *latent_shape), **kw),
        "u_sigma": torch.rand((b,), **kw),
        "noise": torch.randn((b, f, *latent_shape), **kw),
        "drop_p": torch.rand((b,), **kw),
        "frame_idx": torch.randint(0, f, (1,), **kw),
    }


def _remat_mode(tcfg: TrainConfig):
    """False | True | "unit" for the unet/controlnet `remat` argument."""
    if not tcfg.gradient_checkpointing:
        return False
    return "unit" if tcfg.remat_granularity == "unit" else True


def edm_training_loss(controlnet_params: Dict, frozen_params: Dict, bundle, tcfg: TrainConfig,
                      batch: Dict[str, torch.Tensor], randoms: Dict[str, torch.Tensor], compute_dtype):
    """One EDM denoising-MSE step over a batch: (loss, metrics).

    batch: pixel_values (B, F, H, W, 3) and trajectories (B, F, H, W, 3) in
    [-1, 1]; motion_values (B,). randoms: draw_step_randoms' dict."""
    u, c = bundle.unet, bundle.controlnet
    pixel_values = batch["pixel_values"]
    b, f = pixel_values.shape[:2]
    latents = _vae_encode_frames(frozen_params, bundle, pixel_values, randoms["vae_eps"])

    noise = randoms["noise"].float()
    sigmas = rand_cosine_interpolated(randoms["u_sigma"], EDMConfig())
    sig = sigmas.reshape(b, 1, 1, 1, 1)
    cond_latents = (latents + noise * tcfg.noise_aug_strength)[:, 0] / bundle.vae.scaling_factor
    noisy_latents = latents + noise * sig
    timesteps = 0.25 * torch.log(sigmas)
    c_in, c_out, c_skip = edm_scalings(sig)
    inp = noisy_latents * c_in

    with torch.no_grad():
        clip_emb = encode_image_clip_train(frozen_params, bundle, pixel_values[:, 0], compute_dtype)
    time_ids = added_time_ids_train(batch["motion_values"], noise_aug=tcfg.noise_aug_strength)

    if tcfg.conditioning_dropout_prob:
        g = tcfg.conditioning_dropout_prob
        p = randoms["drop_p"]
        clip_emb = torch.where((p < 2 * g).reshape(b, 1, 1), 0.0, clip_emb)
        image_keep = 1.0 - ((p >= g) & (p < 3 * g)).to(cond_latents.dtype)
        cond_latents = cond_latents * image_keep.reshape(b, 1, 1, 1)

    cond_rep = cond_latents[:, None].expand(b, f, *cond_latents.shape[1:])
    inp8 = torch.cat([inp, cond_rep], dim=-1)  # (B, F, h, w, 8)

    remat = _remat_mode(tcfg)
    down_res, mid_res = cn.controlnet_forward(
        controlnet_params, c, inp8, timesteps, clip_emb, time_ids, controlnet_cond=batch["trajectories"],
        compute_dtype=compute_dtype, remat=remat,
    )
    model_pred = unet_m.unet_forward(frozen_params["unet"], u, inp8, timesteps, clip_emb, time_ids, down_res,
                                     mid_res, compute_dtype=compute_dtype, remat=remat).float()
    denoised = model_pred * c_out + c_skip * noisy_latents
    w = edm_loss_weight(sig)
    loss = (w * (denoised - latents) ** 2).reshape(b, -1).mean(dim=1).mean()
    metrics = {"loss_video": loss.detach(), "sigma_mean": sigmas.mean()}

    if tcfg.use_spatial_loss:
        # One random frame through the UNet again with its slice of the
        # residuals, x0.5; the frame axis is sliced per sample.
        idx = randoms["frame_idx"].reshape(1)

        def frame(t):
            return t.reshape(b, f, *t.shape[1:]).index_select(1, idx)[:, 0]

        pred_sp = unet_m.unet_forward(
            frozen_params["unet"], u, inp8.index_select(1, idx), timesteps, clip_emb, time_ids,
            tuple(frame(r) for r in down_res), frame(mid_res), compute_dtype=compute_dtype,
        ).float()[:, 0]
        denoised_sp = pred_sp * c_out[:, 0] + c_skip[:, 0] * noisy_latents.index_select(1, idx)[:, 0]
        tgt_sp = latents.index_select(1, idx)[:, 0]
        loss_sp = (w[:, 0] * (denoised_sp - tgt_sp) ** 2).reshape(b, -1).mean(dim=1).mean()
        loss = loss + tcfg.spatial_loss_weight * loss_sp
        metrics["loss_spatial"] = loss_sp.detach()

    metrics["loss"] = loss.detach()
    return loss, metrics


def _check_supported(tcfg: TrainConfig) -> None:
    for name, off in (("grads_bf16", False), ("adam_mu_bf16", False), ("grad_accum_dtype", None),
                      ("encode_outside_step", False)):
        if getattr(tcfg, name) != off:
            raise NotImplementedError(f"TrainConfig.{name} is not in the port yet")
    if tcfg.lr_scheduler != "constant":
        raise NotImplementedError(tcfg.lr_scheduler)


def make_optimizer(tcfg: TrainConfig, params):
    """AdamW (float32 moments) with linear warmup to a constant learning
    rate: (optimizer, scheduler). The schedule's first value is 0, as
    optax.linear_schedule's at count 0."""
    _check_supported(tcfg)
    opt = torch.optim.AdamW(list(params), lr=tcfg.learning_rate, betas=(tcfg.adam_beta1, tcfg.adam_beta2),
                            eps=tcfg.adam_epsilon, weight_decay=tcfg.adam_weight_decay)
    warmup = tcfg.lr_warmup_steps
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, n / warmup) if warmup > 0 else 1.0)
    return opt, sched


@dataclasses.dataclass
class TrainState:
    """`step` counts micro-steps. The ControlNet's float32 masters carry the
    summed micro-gradients in .grad between sync steps."""

    step: int
    controlnet_params: Dict
    ema_params: Optional[Dict]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


def apply_micro_grads(state: TrainState, tcfg: TrainConfig, grads) -> None:
    """Sums one micro-step's gradients (in the order of leaves(params)) into
    the masters' .grad; on every gradient_accumulation_steps-th call, the
    mean is clipped and applied, and the EMA steps (decay 0 on the first
    update, then diffusers' warmup ramp): optax.MultiSteps over
    make_optimizer's chain, then the JAX step's EMA. Updates `state` in
    place."""
    masters = list(leaves(state.controlnet_params))
    with torch.no_grad():
        for p, g in zip(masters, grads):
            if p.grad is None:
                p.grad = g
            else:
                p.grad.add_(g)
    state.step += 1
    accum = tcfg.gradient_accumulation_steps
    if state.step % accum == 0:
        with torch.no_grad():
            for p in masters:
                p.grad.div_(accum)
        torch.nn.utils.clip_grad_norm_(masters, tcfg.max_grad_norm)
        state.optimizer.step()
        state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)
        if state.ema_params is not None:
            ema_update(state.ema_params, state.controlnet_params,
                       ema_decay_schedule(state.step // accum, tcfg.ema_decay))


def train_step(state: TrainState, frozen_params: Dict, bundle, tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
               randoms: Dict[str, torch.Tensor], compute_dtype) -> Dict[str, torch.Tensor]:
    """One micro-step: loss and ControlNet gradients, then apply_micro_grads.
    Updates `state` in place; returns metrics with grad_norm, the global norm
    of this micro-step's gradient."""
    masters = list(leaves(state.controlnet_params))
    loss, metrics = edm_training_loss(state.controlnet_params, frozen_params, bundle, tcfg, batch, randoms,
                                      compute_dtype)
    grads = torch.autograd.grad(loss, masters, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(masters, grads)]
    metrics["grad_norm"] = global_norm(grads)
    apply_micro_grads(state, tcfg, grads)
    return metrics


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


class Trainer:
    """Single-device training entry point: `Trainer(bundle, tcfg, frozen_params,
    controlnet_params)`, then `.step(batch)` per micro-step.

    frozen_params {"unet", "vae", "clip"} and controlnet_params are on
    `device` already (core/init.py, pipeline.init_params); the ControlNet is
    copied into float32 masters (and an EMA copy), the frozen weights are
    used as given. Runs on `cuda` unless device="cpu". The step's random
    draws come from a generator seeded with tcfg.seed. The bundle's
    KernelConfig is pinned here (resolve_kernels) and scopes every step;
    only the default one is in the port yet (kernel 8 has no backward, and
    training under the un-fused switches is not ported)."""

    def __init__(self, bundle, tcfg: TrainConfig, frozen_params: Dict, controlnet_params: Dict, mesh=None,
                 device=None, compute_dtype=None):
        if mesh is not None:
            raise NotImplementedError("Trainer(mesh=...): the parallel layer is not in the port yet")
        _check_supported(tcfg)
        self.device = resolve_device(device)
        bundle = resolve_kernels(bundle)
        if bundle.kernels != KernelConfig():
            raise NotImplementedError(f"Trainer under {bundle.kernels}: only the default KernelConfig is in the "
                                      "port yet")
        if self.device.type == "cuda":
            set_float32_precision()
        self.bundle = bundle
        self.tcfg = tcfg
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        # The step never runs the VAE decoder; it stays out of the trainer.
        self.frozen_params = {k: v for k, v in frozen_params.items() if k != "vae"}
        self.frozen_params["vae"] = {"encoder": frozen_params["vae"]["encoder"]}
        for t in leaves(self.frozen_params):
            t.requires_grad_(False)
        params = _map(controlnet_params, lambda t: t.detach().to(torch.float32, copy=True).requires_grad_(True))
        ema = _map(params, lambda t: t.detach().clone()) if tcfg.use_ema else None
        opt, sched = make_optimizer(tcfg, leaves(params))
        self.state = TrainState(step=0, controlnet_params=params, ema_params=ema, optimizer=opt, scheduler=sched)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tcfg.seed)

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v).to(self.device, torch.float32) for k, v in batch.items()}
        b, f, hh, ww = batch["pixel_values"].shape[:4]
        sf = self.bundle.vae.scale_factor
        randoms = draw_step_randoms(self.generator, b, f, (hh // sf, ww // sf, self.bundle.vae.latent_channels),
                                    self.device)
        with use_kernels(self.bundle.kernels):
            return train_step(self.state, self.frozen_params, self.bundle, self.tcfg, batch, randoms,
                              self.compute_dtype)
