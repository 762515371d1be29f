"""Antialiased resize: separable Gaussian blur + bicubic interpolation.

Port of posetraj_tpu/ops/resize.py:resize_antialias (the reference's
`_resize_with_antialiasing`): skimage-style sigma from the scale factor, odd
kernel of ~4 sigma taps, reflect padding, x-pass then y-pass blur, then
bicubic resampling (a = -0.75) with align_corners=True. Channels-last
(N, H, W, C), computed in float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posetraj_torch.core.init import device_constant


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    if ksize % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur2d(x: torch.Tensor, ksize: Tuple[int, int], sigma: Tuple[float, float]) -> torch.Tensor:
    """Separable blur over (N, H, W, C), reflect padding, per channel."""
    ky, kx = ksize
    c = x.shape[-1]
    xc = x.permute(0, 3, 1, 2)
    kern_x = device_constant(tuple(_gaussian_kernel1d(kx, sigma[1]).tolist()), x.dtype, x.device)
    kern_y = device_constant(tuple(_gaussian_kernel1d(ky, sigma[0]).tolist()), x.dtype, x.device)
    front = (kx - 1) // 2
    h = F.pad(xc, (front, kx - 1 - front, 0, 0), mode="reflect")
    h = F.conv2d(h, kern_x.reshape(1, 1, 1, kx).expand(c, 1, 1, kx), groups=c)
    front = (ky - 1) // 2
    h = F.pad(h, (0, 0, front, ky - 1 - front), mode="reflect")
    h = F.conv2d(h, kern_y.reshape(1, 1, ky, 1).expand(c, 1, ky, 1), groups=c)
    return h.permute(0, 2, 3, 1)


def _cubic_weight(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    at = t.abs()
    w1 = (a + 2) * at**3 - (a + 3) * at**2 + 1
    w2 = a * at**3 - 5 * a * at**2 + 8 * a * at - 4 * a
    return torch.where(at <= 1, w1, torch.where(at < 2, w2, torch.zeros_like(at)))


def _bicubic_1d(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    coords = torch.arange(out_size, dtype=torch.float32, device=x.device) * scale
    idx0 = torch.floor(coords).to(torch.long)
    t = coords - idx0
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    out = None
    for offset in (-1, 0, 1, 2):
        idx = (idx0 + offset).clamp(0, in_size - 1)
        term = torch.index_select(x, axis, idx) * _cubic_weight(t - offset).reshape(wshape).to(x.dtype)
        out = term if out is None else out + term
    return out


def resize_antialias(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) -> (N, size[0], size[1], C), reference-parity antialiasing."""
    h, w = x.shape[1], x.shape[2]
    factors = (h / size[0], w / size[1])
    sigmas = (max((factors[0] - 1.0) / 2.0, 0.001), max((factors[1] - 1.0) / 2.0, 0.001))
    ks = int(max(2.0 * 2 * sigmas[0], 3)), int(max(2.0 * 2 * sigmas[1], 3))
    ks = (ks[0] + 1 if ks[0] % 2 == 0 else ks[0], ks[1] + 1 if ks[1] % 2 == 0 else ks[1])
    x = gaussian_blur2d(x, ks, sigmas)
    x = _bicubic_1d(x, 1, size[0])
    return _bicubic_1d(x, 2, size[1])
