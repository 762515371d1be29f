"""Euler-Discrete scheduler with the Karras sigma "fix", as pure functions.

The port's own copy of posetraj_tpu/diffusion/euler_karras.py: the sigma
ladder and the training sigma table are built host-side in numpy
(`make_schedule`, `training_sigmas_grid`); `euler_step` is a pure function
of (model_output, sample, sigma, sigma_next) over tensors, run in float32
whatever the model's compute dtype, and `add_noise` is x + sigma * n.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from posetraj_torch.configs import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static denoising schedule: n steps -> n+1 sigmas (last is 0)."""

    sigmas: np.ndarray  # (n+1,) float32, descending, sigmas[-1] == 0
    timesteps: np.ndarray  # (n,) float32 model-conditioning timesteps
    init_noise_sigma: float
    prediction_type: str

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def _train_sigmas(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, cfg.num_train_timesteps, dtype=np.float64) ** 2
    else:
        raise NotImplementedError(f"beta_schedule={cfg.beta_schedule}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod).astype(np.float64)


def _convert_to_karras(cfg: SchedulerConfig, in_sigmas: np.ndarray, num_steps: int) -> np.ndarray:
    """Karras rho-7 ladder honouring the config's sigma_min/sigma_max."""
    sigma_min = cfg.sigma_min if cfg.sigma_min is not None else float(in_sigmas[-1])
    sigma_max = cfg.sigma_max if cfg.sigma_max is not None else float(in_sigmas[0])
    ramp = np.linspace(0, 1, num_steps)
    min_inv_rho = sigma_min ** (1 / cfg.rho)
    max_inv_rho = sigma_max ** (1 / cfg.rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** cfg.rho


def _sigma_to_t_interp(sigma: np.ndarray, log_sigmas: np.ndarray) -> np.ndarray:
    log_sigma = np.log(np.maximum(sigma, 1e-10))
    dists = log_sigma - log_sigmas[:, None]
    low_idx = np.cumsum((dists >= 0), axis=0).argmax(axis=0).clip(max=log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = np.clip((low - log_sigma) / (low - high), 0, 1)
    return ((1 - w) * low_idx + w * high_idx).reshape(sigma.shape)


def make_schedule(cfg: SchedulerConfig, num_inference_steps: int) -> Schedule:
    """The reference scheduler's set_timesteps, host-side and stateless."""
    if cfg.timestep_spacing == "linspace":
        timesteps = np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps, dtype=np.float64)[::-1].copy()
    elif cfg.timestep_spacing == "leading":
        step_ratio = cfg.num_train_timesteps // num_inference_steps
        timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy().astype(np.float64)
        timesteps += cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = cfg.num_train_timesteps / num_inference_steps
        timesteps = np.arange(cfg.num_train_timesteps, 0, -step_ratio).round().astype(np.float64) - 1
    else:
        raise ValueError(f"timestep_spacing={cfg.timestep_spacing}")

    full_sigmas = _train_sigmas(cfg)
    log_sigmas = np.log(full_sigmas)
    if cfg.interpolation_type == "linear":
        sigmas = np.interp(timesteps, np.arange(0, len(full_sigmas)), full_sigmas)
    elif cfg.interpolation_type == "log_linear":
        sigmas = np.exp(np.linspace(np.log(full_sigmas[-1]), np.log(full_sigmas[0]), num_inference_steps + 1))
    else:
        raise ValueError(cfg.interpolation_type)

    if cfg.use_karras_sigmas:
        sigmas = _convert_to_karras(cfg, sigmas, num_inference_steps)
        timesteps = _sigma_to_t_interp(sigmas, log_sigmas)

    if cfg.timestep_type == "continuous" and cfg.prediction_type == "v_prediction":
        cond_timesteps = 0.25 * np.log(sigmas)
    else:
        cond_timesteps = timesteps

    sigmas_out = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    max_sigma = float(sigmas_out.max())
    if cfg.timestep_spacing in ("linspace", "trailing"):
        init_noise_sigma = max_sigma
    else:
        init_noise_sigma = (max_sigma**2 + 1.0) ** 0.5
    return Schedule(
        sigmas=sigmas_out,
        timesteps=cond_timesteps.astype(np.float32),
        init_noise_sigma=init_noise_sigma,
        prediction_type=cfg.prediction_type,
    )


def training_sigmas_grid(cfg: SchedulerConfig) -> np.ndarray:
    """The full training sigma table (num_train_timesteps entries, float32),
    for add_noise by timestep."""
    return _train_sigmas(cfg).astype(np.float32)


def sigma_to_timestep(sigma: torch.Tensor) -> torch.Tensor:
    """Continuous v-prediction conditioning timestep: 0.25 * log(sigma)."""
    return 0.25 * torch.log(sigma)


def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
    """EDM c_in: x / sqrt(sigma^2 + 1), in float32, back to sample's dtype."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
    return (sample.float() / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)


def euler_step(model_output: torch.Tensor, sample: torch.Tensor, sigma, sigma_next,
               prediction_type: str = "v_prediction", gamma: float = 0.0, noise: Optional[torch.Tensor] = None,
               s_noise: float = 1.0):
    """One Euler ODE step in float32; returns (prev_sample,
    pred_original_sample). gamma > 0 is the churn branch: the sample is
    first noised from sigma up to sigma_hat = sigma * (gamma + 1) with
    `noise` times s_noise (the reference always runs gamma = 0)."""
    out_dtype = model_output.dtype
    sample = sample.float()
    model_output = model_output.float()
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
    sigma_next = torch.as_tensor(sigma_next, dtype=torch.float32, device=sample.device)
    sigma_hat = sigma * (gamma + 1.0) if gamma else sigma
    if gamma > 0:
        if noise is None:
            raise ValueError("gamma-churn requires noise")
        sample = sample + noise.float() * s_noise * torch.sqrt(sigma_hat**2 - sigma**2)
    if prediction_type in ("original_sample", "sample"):
        pred_original = model_output
    elif prediction_type == "epsilon":
        pred_original = sample - sigma_hat * model_output
    elif prediction_type == "v_prediction":
        pred_original = model_output * (-sigma / torch.sqrt(sigma**2 + 1.0)) + sample / (sigma**2 + 1.0)
    else:
        raise ValueError(prediction_type)
    derivative = (sample - pred_original) / sigma_hat
    prev_sample = sample + derivative * (sigma_next - sigma_hat)
    return prev_sample.to(out_dtype), pred_original


def add_noise(original: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """x_sigma = x + sigma * n; `sigma` of shape (batch,) broadcasts over
    the trailing dims."""
    sigma = torch.as_tensor(sigma, dtype=original.dtype, device=original.device)
    return original + noise * sigma.reshape(sigma.shape + (1,) * (original.ndim - sigma.ndim))
