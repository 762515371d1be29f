"""EDM preconditioning scalings, loss weighting and the cosine-interpolated
training-sigma sampler (the reference's train_svd_traj_blender_14.py:223-269
and :1323-1336).

The samplers take their uniform draw `u` as an argument: the caller draws it
from its own generator, and a test can hand in the JAX package's draw.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from posetraj_torch.configs import EDMConfig


def edm_scalings(sigma: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(c_in, c_out, c_skip) = (1/sqrt(s^2+1), -s/sqrt(s^2+1), 1/(s^2+1))."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    root = torch.sqrt(sigma**2 + 1.0)
    return 1.0 / root, -sigma / root, 1.0 / (sigma**2 + 1.0)


def edm_loss_weight(sigma: torch.Tensor) -> torch.Tensor:
    """w(sigma) = (1 + sigma^2) / sigma^2."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    return (1.0 + sigma**2) / sigma**2


def stratified_uniform(u: torch.Tensor) -> torch.Tensor:
    """Stratified U[0, 1) samples from plain uniform draws `u` (..., n):
    sample i lands in stratum i of n (the JAX function with one group)."""
    n = u.shape[-1]
    offsets = torch.arange(n, dtype=u.dtype, device=u.device)
    return (offsets + u) / n


def rand_cosine_interpolated(u: torch.Tensor, cfg: EDMConfig = EDMConfig()) -> torch.Tensor:
    """Training sigmas from the interpolated cosine logSNR schedule (simple
    diffusion), given plain uniform draws `u` of the output's shape."""
    return cosine_interpolated_sigmas(stratified_uniform(u.float()), cfg)


def cosine_interpolated_sigmas(t: torch.Tensor, cfg: EDMConfig = EDMConfig()) -> torch.Tensor:
    """rand_cosine_interpolated from its stratified draws `t` (a batch's
    strata are those of the whole batch: a rank holding some of its rows
    takes its rows of the whole batch's `t`)."""

    def logsnr_schedule_cosine(t, logsnr_min, logsnr_max):
        t_min = math.atan(math.exp(-0.5 * logsnr_max))
        t_max = math.atan(math.exp(-0.5 * logsnr_min))
        return -2.0 * torch.log(torch.tan(t_min + t * (t_max - t_min)))

    def shifted(t, noise_d, logsnr_min, logsnr_max):
        shift = 2.0 * math.log(noise_d / cfg.image_d)
        return logsnr_schedule_cosine(t, logsnr_min - shift, logsnr_max - shift) + shift

    logsnr_min = -2.0 * math.log(cfg.min_value / cfg.sigma_data)
    logsnr_max = -2.0 * math.log(cfg.max_value / cfg.sigma_data)
    low = shifted(t, cfg.noise_d_low, logsnr_min, logsnr_max)
    high = shifted(t, cfg.noise_d_high, logsnr_min, logsnr_max)
    logsnr = low + t * (high - low)
    return torch.exp(-logsnr / 2.0) * cfg.sigma_data
