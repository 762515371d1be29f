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
  * the hint variant's conditions from the batch: bbox_trajectories,
    cam_parameter (absent: a zero camera), rot_id; the entity variant's
    map is not a batch key, so its step raises, as the JAX step does
  * EDM reconstruction target = clean latents, w = (1 + s^2) / s^2
  * auxiliary single-frame spatial loss x0.5
  * EMA of the ControlNet parameters on gradient-sync steps

Randomness: the JAX step splits one key into five draws. Here
`draw_step_randoms` makes the same five draws from a torch.Generator and
the loss takes them as a dict, so a test can hand in JAX's draws.

Precision: the ControlNet keeps float32 master weights and casts each to
the compute dtype where it is used, so the bf16 gradient of every use flows
back into the float32 master through that cast. The micro-gradients are
summed into one accumulator a leaf (TrainState.grad_acc); on every sync
step their mean is clipped to max_grad_norm, AdamW applies it with linear
warmup, and the accumulator is zeroed (optax.MultiSteps over
clip_by_global_norm and adamw in the JAX package). Like optax's schedule,
the warmup starts from a learning rate of 0 on the first update.

The memory options of TrainConfig, as the JAX package defines them:
  * grads_bf16: the loss is differentiated against bf16 copies of the
    masters (TrainState.loss_params), so the gradients are bf16
  * adam_mu_bf16: both Adam moments stored in bf16, updated in float32
    (AdamWBF16, the JAX package's _scale_by_adam_bf16)
  * grad_accum_dtype (with accumulation > 1): the accumulator stored in
    that dtype, each micro-gradient summed in float32 and rounded once,
    the float32 mean taken at the sync step (_multi_steps_acc)
  * encode_outside_step: the frozen VAE and CLIP encodes run before the
    step, with the step's own VAE draw, and hand it latents and clip_emb;
    the step keeps only the UNet (make_encode_conditioning)

On the card `Trainer.step` replays the micro-step (loss, backward and the
accumulation) from one captured CUDA graph (`MicroStepGraph`), the
counterpart of the JAX package's jitted step; the sync step's clip, AdamW
and EMA run eagerly, with foreach ops. `Trainer.step_eager` and the CPU run
the same micro-step from the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from posetraj_torch.configs import EDMConfig, TrainConfig, kernel_config, use_kernels
from posetraj_torch.core.init import default_compute_dtype, device_constant, resolve_device
from posetraj_torch.core.params import ema_decay_schedule, ema_update, leaves, tree_map
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
    fixed = device_constant((fps, noise_aug), torch.float32, motion_values.device).expand(b, 2)
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


@torch.no_grad()
def encode_conditioning(enc_params: Dict, bundle, pixel_values: torch.Tensor, vae_eps: torch.Tensor,
                        compute_dtype) -> Dict[str, torch.Tensor]:
    """The frozen encodes of one step on their own (encode_outside_step, the
    JAX make_encode_conditioning): {"latents", "clip_emb"} from the VAE
    encoder and CLIP in `enc_params`, with the step's VAE draw, so the step
    that takes them computes what the fused step computes."""
    return {"latents": _vae_encode_frames(enc_params, bundle, pixel_values, vae_eps),
            "clip_emb": encode_image_clip_train(enc_params, bundle, pixel_values[:, 0], compute_dtype)}


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
    [-1, 1]; motion_values (B,); the hint variant's bbox_trajectories
    (B, F, H, W, 3) in [-1, 1], cam_parameter (B, F, 12), rot_id (B,)
    integer; latents (B, F, h, w, 4) and clip_emb (B, 1, D) where the frozen
    encodes ran outside the step (encode_conditioning). randoms:
    draw_step_randoms' dict."""
    u, c = bundle.unet, bundle.controlnet
    pixel_values = batch["pixel_values"]
    b, f = pixel_values.shape[:2]
    if "latents" in batch:
        latents = batch["latents"]
    else:
        latents = _vae_encode_frames(frozen_params, bundle, pixel_values, randoms["vae_eps"])

    noise = randoms["noise"].float()
    sigmas = rand_cosine_interpolated(randoms["u_sigma"], EDMConfig())
    sig = sigmas.reshape(b, 1, 1, 1, 1)
    cond_latents = (latents + noise * tcfg.noise_aug_strength)[:, 0] / bundle.vae.scaling_factor
    noisy_latents = latents + noise * sig
    timesteps = 0.25 * torch.log(sigmas)
    c_in, c_out, c_skip = edm_scalings(sig)
    inp = noisy_latents * c_in

    if "clip_emb" in batch:
        clip_emb = batch["clip_emb"]
    else:
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
    bbox = batch.get("bbox_trajectories")
    down_res, mid_res = cn.controlnet_forward(
        controlnet_params, c, inp8, timesteps, clip_emb, time_ids, controlnet_cond=batch["trajectories"],
        bbox_cond=None if bbox is None else bbox.to(compute_dtype), camera_cond=batch.get("cam_parameter"),
        rot_id=batch.get("rot_id"), compute_dtype=compute_dtype, remat=remat,
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
    if tcfg.lr_scheduler != "constant":
        raise NotImplementedError(tcfg.lr_scheduler)


def _float32_power(base: float, count: int) -> float:
    """base ** count in float32, as optax computes Adam's bias corrections."""
    return float(np.float32(base) ** np.float32(count))


class AdamWBF16(torch.optim.Optimizer):
    """AdamW with both moments stored in bfloat16 (TrainConfig.adam_mu_bf16;
    the JAX package's _scale_by_adam_bf16, then add_decayed_weights and the
    learning rate). Each step, in float32:
        m = bf16(b1 m + (1 - b1) g),  v = bf16(b2 v + (1 - b2) g^2)
        p = p - lr (m / c1 / (sqrt(v / c2) + eps) + wd p)
    with the stored (rounded) moments and c = 1 - b^t in float32. Leaves are
    updated in groups of at most CHUNK elements, so the float32 temporaries
    stay far below a float32 copy of the moments."""

    CHUNK = 1 << 26

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            live = [p for p in group["params"] if p.grad is not None]
            for p in live:
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.bfloat16)
                st["step"] += 1
            for chunk in _chunks(live, self.CHUNK):
                count = self.state[chunk[0]]["step"]
                c1, c2 = 1.0 - _float32_power(b1, count), 1.0 - _float32_power(b2, count)
                grads = [p.grad.float() for p in chunk]
                mu = [self.state[p]["exp_avg"] for p in chunk]
                nu = [self.state[p]["exp_avg_sq"] for p in chunk]
                m = [t.float() for t in mu]
                torch._foreach_mul_(m, b1)
                torch._foreach_add_(m, grads, alpha=1.0 - b1)
                torch._foreach_copy_(mu, m)
                v = [t.float() for t in nu]
                torch._foreach_mul_(v, b2)
                torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
                torch._foreach_copy_(nu, v)
                del grads
                m = [t.float() for t in mu]
                v = [t.float() for t in nu]
                torch._foreach_div_(m, c1)
                torch._foreach_div_(v, c2)
                torch._foreach_sqrt_(v)
                torch._foreach_add_(v, group["eps"])
                torch._foreach_div_(m, v)
                torch._foreach_add_(m, chunk, alpha=group["weight_decay"])
                torch._foreach_add_(chunk, m, alpha=-group["lr"])

    def load_state_dict(self, state_dict):
        """As Optimizer's, which casts each moment to its parameter's dtype;
        the moments go back to bf16 (exactly: they were bf16 values)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].to(torch.bfloat16)


def _chunks(tensors: List[torch.Tensor], limit: int):
    """Consecutive groups of `tensors` of at most `limit` elements each (a
    larger tensor alone)."""
    group, n = [], 0
    for t in tensors:
        if group and n + t.numel() > limit:
            yield group
            group, n = [], 0
        group.append(t)
        n += t.numel()
    if group:
        yield group


def make_optimizer(tcfg: TrainConfig, params):
    """AdamW with linear warmup to a constant learning rate: (optimizer,
    scheduler). float32 moments (torch.optim.AdamW), or bf16 ones under
    adam_mu_bf16 (AdamWBF16). The schedule's first value is 0, as
    optax.linear_schedule's at count 0."""
    _check_supported(tcfg)
    kw = dict(lr=tcfg.learning_rate, betas=(tcfg.adam_beta1, tcfg.adam_beta2), eps=tcfg.adam_epsilon,
              weight_decay=tcfg.adam_weight_decay)
    opt = (AdamWBF16 if tcfg.adam_mu_bf16 else torch.optim.AdamW)(list(params), **kw)
    warmup = tcfg.lr_warmup_steps
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, n / warmup) if warmup > 0 else 1.0)
    return opt, sched


def grad_accum_dtype(tcfg: TrainConfig) -> torch.dtype:
    """The accumulator's dtype: TrainConfig.grad_accum_dtype where the
    gradients of several micro-steps are summed, else float32 (the JAX
    package takes the option only with accumulation > 1)."""
    if tcfg.grad_accum_dtype is None or tcfg.gradient_accumulation_steps == 1:
        return torch.float32
    return getattr(torch, tcfg.grad_accum_dtype)


@dataclasses.dataclass
class TrainState:
    """`step` counts micro-steps. `grad_acc` sums the micro-gradients of the
    current accumulation window, a buffer a master (made on first use);
    `loss_params` are the bf16 copies the loss is differentiated against
    under grads_bf16 (else None)."""

    step: int
    controlnet_params: Dict
    ema_params: Optional[Dict]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_acc: Optional[List[torch.Tensor]] = None
    loss_params: Optional[Dict] = None


def global_norm(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float32)))


def _grad_acc(state: TrainState, tcfg: TrainConfig) -> List[torch.Tensor]:
    if state.grad_acc is None:
        dt = grad_accum_dtype(tcfg)
        state.grad_acc = [torch.zeros_like(p, dtype=dt) for p in leaves(state.controlnet_params)]
    return state.grad_acc


@torch.no_grad()
def _accumulate(state: TrainState, tcfg: TrainConfig, grads) -> None:
    """acc += g for every leaf with a gradient (in float32, rounded once to
    the accumulator's dtype)."""
    pairs = [(a, g) for a, g in zip(_grad_acc(state, tcfg), grads) if g is not None]
    if pairs:
        torch._foreach_add_([a for a, _ in pairs], [g for _, g in pairs])


def micro_step(state: TrainState, frozen_params: Dict, bundle, tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
               randoms: Dict[str, torch.Tensor], compute_dtype) -> Dict[str, torch.Tensor]:
    """The loss, its gradient with respect to the ControlNet and the sum of
    that gradient into state.grad_acc: what MicroStepGraph captures. Issues
    no host synchronisation. Returns metrics as 0-d tensors, with
    grad_norm, the global norm of this micro-step's gradient."""
    masters = list(leaves(state.controlnet_params))
    params = state.controlnet_params
    if state.loss_params is not None:
        params = state.loss_params
        with torch.no_grad():
            torch._foreach_copy_(list(leaves(params)), masters)
    loss, metrics = edm_training_loss(params, frozen_params, bundle, tcfg, batch, randoms, compute_dtype)
    grads = torch.autograd.grad(loss, list(leaves(params)), allow_unused=True)
    metrics["grad_norm"] = global_norm([g for g in grads if g is not None])
    _accumulate(state, tcfg, grads)
    return metrics


def sync_step(state: TrainState, tcfg: TrainConfig) -> None:
    """The update at the end of an accumulation window: the accumulator's
    float32 mean is clipped to max_grad_norm and applied by the optimizer,
    the scheduler steps, the accumulator is zeroed and the EMA steps (decay
    0 on the first update, then diffusers' warmup ramp). foreach ops."""
    accum = tcfg.gradient_accumulation_steps
    masters = list(leaves(state.controlnet_params))
    acc = _grad_acc(state, tcfg)
    with torch.no_grad():
        if acc[0].dtype == torch.float32:
            torch._foreach_div_(acc, float(accum))
            means = acc
        else:
            means = [a.float() for a in acc]
            torch._foreach_div_(means, float(accum))
        for p, m in zip(masters, means):
            p.grad = m
    torch.nn.utils.clip_grad_norm_(masters, tcfg.max_grad_norm)
    state.optimizer.step()
    state.scheduler.step()
    for p in masters:
        p.grad = None
    with torch.no_grad():
        torch._foreach_zero_(acc)
    if state.ema_params is not None:
        ema_update(state.ema_params, state.controlnet_params,
                   ema_decay_schedule(state.step // accum, tcfg.ema_decay))


def advance(state: TrainState, tcfg: TrainConfig) -> None:
    """Counts a micro-step; every gradient_accumulation_steps-th one ends
    its window with sync_step."""
    state.step += 1
    if state.step % tcfg.gradient_accumulation_steps == 0:
        sync_step(state, tcfg)


def apply_micro_grads(state: TrainState, tcfg: TrainConfig, grads) -> None:
    """Sums one micro-step's gradients (in the order of leaves(params)) into
    the accumulator and advances: optax.MultiSteps over make_optimizer's
    chain, then the JAX step's EMA. Updates `state` in place."""
    _accumulate(state, tcfg, grads)
    advance(state, tcfg)


def train_step(state: TrainState, frozen_params: Dict, bundle, tcfg: TrainConfig, batch: Dict[str, torch.Tensor],
               randoms: Dict[str, torch.Tensor], compute_dtype) -> Dict[str, torch.Tensor]:
    """One micro-step from the host: micro_step, then advance. Updates
    `state` in place; returns micro_step's metrics."""
    metrics = micro_step(state, frozen_params, bundle, tcfg, batch, randoms, compute_dtype)
    advance(state, tcfg)
    return metrics


class MicroStepGraph:
    """The micro-step captured once in a CUDA graph and replayed for every
    later micro-step of the same key, as the JAX package compiles its train
    step once (jax.jit(step_fn, donate_argnums=(0,))).

    Everything the micro-step reads lives at a fixed address: the batch and
    the five draws in static buffers (`buffers`), which each call fills
    anew (the draws are made eagerly from the trainer's generator, so the
    graph computes what the eager step computes and a resumed run draws
    what an uninterrupted one does); the masters, the bf16 loss copies and
    the accumulator in the trainer's state, which the optimizer and a
    restore update in place; the frozen weights. The first call of a key
    runs the micro-step eagerly on the capture stream (it builds the kernel
    libraries, makes kernel A's workspace, lets cuBLAS and cuDNN choose and
    lets the recompute backwards allocate), then captures it; later calls
    replay. The key: the batch's keys, shapes and dtypes, the addresses of
    the state's and the frozen tensors, the bundle, the TrainConfig, the
    KernelConfig and the compute dtype; another key captures anew. The
    graph holds kernel A's workspace as captured (groupnorm.workspaces).
    Launch counts stay device launches (_native.capturing_launches). A
    failed capture raises."""

    def __init__(self):
        self._key = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._held = ()  # device memory outside the graph's pool that its launches use
        self._per_replay: Dict[str, int] = {}
        self._outputs: Dict[str, torch.Tensor] = {}  # the captured metrics
        self.buffers: Dict[str, Dict[str, torch.Tensor]] = {}
        self.capture_s = 0.0  # host seconds of the last capture and instantiation

    @staticmethod
    def key(trainer: "Trainer", batch: Dict[str, torch.Tensor]) -> tuple:
        st = trainer.state
        tensors = [*leaves(st.controlnet_params), *(st.grad_acc or ()), *leaves(st.loss_params or {}),
                   *leaves(trainer.frozen_params)]
        return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())),
                tuple(t.data_ptr() for t in tensors), trainer.bundle, trainer.tcfg, kernel_config(),
                trainer.compute_dtype)

    def load(self, trainer: "Trainer", batch: Dict[str, torch.Tensor], randoms: Dict[str, torch.Tensor]) -> bool:
        """Copy one micro-step's batch and draws into the static buffers;
        another key makes the buffers anew and drops the graph. Returns
        whether a captured graph can serve the call."""
        key = self.key(trainer, batch)
        if key != self._key:
            self._key, self._graph, self._per_replay, self._outputs = key, None, {}, {}
            self.buffers = {"batch": {k: v.clone() for k, v in batch.items()},
                            "randoms": {k: v.clone() for k, v in randoms.items()}}
        else:
            for name, src in (("batch", batch), ("randoms", randoms)):
                for k, v in src.items():
                    self.buffers[name][k].copy_(v)
        return self._graph is not None

    def run(self, trainer: "Trainer", batch: Dict[str, torch.Tensor],
            randoms: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One micro-step on a CUDA device (without the sync step); returns
        its metrics."""
        from posetraj_torch.ops import _native, groupnorm

        _grad_acc(trainer.state, trainer.tcfg)
        ready = self.load(trainer, batch, randoms)
        step = lambda: micro_step(trainer.state, trainer.frozen_params, trainer.bundle, trainer.tcfg,
                                  self.buffers["batch"], self.buffers["randoms"], trainer.compute_dtype)
        if ready:
            self._graph.replay()
            _native.add_launches(self._per_replay)
            return {k: v.clone() for k, v in self._outputs.items()}
        stream = torch.cuda.Stream(device=trainer.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            metrics = step()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _native.capturing_launches() as per_replay, torch.cuda.graph(graph, stream=stream):
            outputs = step()
        self.capture_s = time.perf_counter() - t0
        self._graph, self._per_replay, self._outputs, self._held = graph, per_replay, outputs, groupnorm.workspaces()
        return metrics


class Trainer:
    """Single-device training entry point: `Trainer(bundle, tcfg, frozen_params,
    controlnet_params)`, then `.step(batch)` per micro-step.

    frozen_params {"unet", "vae", "clip"} and controlnet_params are on
    `device` already (core/init.py, pipeline.init_params); the ControlNet is
    copied into float32 masters (and an EMA copy), the frozen weights are
    used as given. Runs on `cuda` unless device="cpu". The step's random
    draws come from a generator seeded with tcfg.seed. The bundle's
    KernelConfig, any of them, is pinned here (resolve_kernels) and scopes
    every step; every hint variant trains (entity raises in its first step,
    as in the JAX package: its map is no batch key). batch: the keys of
    edm_training_loss (integer rot_id; every other value float32).

    On the card `step` replays the micro-step from one captured CUDA graph
    (`self.graph`, a MicroStepGraph); `step_eager` runs it from the host, on
    the same state and generator, and is what the CPU runs."""

    def __init__(self, bundle, tcfg: TrainConfig, frozen_params: Dict, controlnet_params: Dict, mesh=None,
                 device=None, compute_dtype=None):
        if mesh is not None:
            raise NotImplementedError("Trainer(mesh=...): the parallel layer's data- and tensor-parallel mesh "
                                      "(parallel/mesh.py) is not in the port yet")
        _check_supported(tcfg)
        self.device = resolve_device(device)
        bundle = resolve_kernels(bundle)
        if self.device.type == "cuda":
            set_float32_precision()
        self.bundle = bundle
        self.tcfg = tcfg
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        # The step never runs the VAE decoder; it stays out of the trainer.
        frozen = {k: v for k, v in frozen_params.items() if k != "vae"}
        frozen["vae"] = {"encoder": frozen_params["vae"]["encoder"]}
        for t in leaves(frozen):
            t.requires_grad_(False)
        self.encode_params = None
        if tcfg.encode_outside_step:
            # CLIP and the VAE encoder feed encode_conditioning; only the
            # UNet stays in the step.
            self.encode_params = {k: frozen[k] for k in ("vae", "clip")}
            frozen = {"unet": frozen["unet"]}
        self.frozen_params = frozen
        params = tree_map(lambda t: t.detach().to(torch.float32, copy=True).requires_grad_(True), controlnet_params)
        ema = tree_map(lambda t: t.detach().clone(), params) if tcfg.use_ema else None
        opt, sched = make_optimizer(tcfg, leaves(params))
        loss_params = (tree_map(lambda t: t.detach().to(torch.bfloat16).requires_grad_(True), params)
                       if tcfg.grads_bf16 else None)
        self.state = TrainState(step=0, controlnet_params=params, ema_params=ema, optimizer=opt, scheduler=sched,
                                loss_params=loss_params)
        _grad_acc(self.state, tcfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tcfg.seed)
        self.graph = MicroStepGraph()

    def _prepare(self, batch: Dict):
        """The batch on the device (integers as int64, the rest float32),
        this micro-step's draws and, under encode_outside_step, the frozen
        encodes."""
        def put(v):
            t = torch.as_tensor(v).to(self.device)
            return t.float() if t.is_floating_point() else t.long()

        batch = {k: put(v) for k, v in batch.items()}
        b, f, hh, ww = batch["pixel_values"].shape[:4]
        sf = self.bundle.vae.scale_factor
        randoms = draw_step_randoms(self.generator, b, f, (hh // sf, ww // sf, self.bundle.vae.latent_channels),
                                    self.device)
        if self.encode_params is not None:
            batch.update(encode_conditioning(self.encode_params, self.bundle, batch["pixel_values"],
                                             randoms["vae_eps"], self.compute_dtype))
        return batch, randoms

    def step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One micro-step (and, at the end of an accumulation window, the
        update): on the card from the captured graph, on the CPU eagerly."""
        if self.device.type != "cuda":
            return self.step_eager(batch)
        with use_kernels(self.bundle.kernels):
            batch, randoms = self._prepare(batch)
            metrics = self.graph.run(self, batch, randoms)
            advance(self.state, self.tcfg)
        return metrics

    def step_eager(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One micro-step issued from the host: the reference the graph is
        held against."""
        with use_kernels(self.bundle.kernels):
            batch, randoms = self._prepare(batch)
            return train_step(self.state, self.frozen_params, self.bundle, self.tcfg, batch, randoms,
                              self.compute_dtype)

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the step, the float32 masters, the EMA,
        the accumulator, the optimizer's and scheduler's state and the
        generator's (references to the live tensors; torch.save copies)."""
        return {"step": self.state.step, "controlnet": self.state.controlnet_params,
                "ema": self.state.ema_params, "grad_acc": self.state.grad_acc,
                "optimizer": self.state.optimizer.state_dict(), "scheduler": self.state.scheduler.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: Dict) -> None:
        """Restore `state_dict()`'s contents. Tensors are copied into the
        trainer's own in place, so a captured graph, which holds their
        addresses, stays valid."""
        st = self.state
        with torch.no_grad():
            for name, dst in (("controlnet", st.controlnet_params), ("ema", st.ema_params), ("grad_acc", st.grad_acc)):
                src = list(leaves(sd[name] or {}))
                dst = list(leaves(dst or {}))
                if len(src) != len(dst):
                    raise ValueError(f"checkpoint {name}: {len(src)} tensors, the trainer has {len(dst)}")
                for d, s in zip(dst, src):
                    d.copy_(s)
        st.optimizer.load_state_dict(sd["optimizer"])
        st.scheduler.load_state_dict(sd["scheduler"])
        st.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
