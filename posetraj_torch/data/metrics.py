"""Video quality / trajectory-adherence metrics (port of
posetraj_tpu/data/metrics.py), on host arrays.

The paper (arXiv:2503.16068) evaluates FVD/FID (pretrained-feature metrics —
they need external Inception/I3D weights, exactly why the reference repo only
EXPORTS frame folders for external tooling, run_inference_vipseg_json_repro.py
:307-318) and ObjMC (mean distance between the target trajectory and the
generated object's tracked trajectory). This module provides the weight-free
parts natively:

  * psnr / ssim — reconstruction quality per frame pair
  * objmc — given target points and tracked points (from any point tracker,
    e.g. CoTracker run externally), the paper's mean-pixel-distance metric
  * frame folders remain exportable for external FID/FVD tooling via
    posetraj_torch/data/export.py
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(max_val**2 / mse)


def _gaussian_kernel1d(win_size: int, sigma: float) -> np.ndarray:
    r = np.arange(win_size, dtype=np.float64) - (win_size - 1) / 2.0
    k = np.exp(-(r**2) / (2.0 * sigma**2))
    return k / k.sum()


def _windowed_moments(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable 2D correlation over the leading two axes of (H, W[, C])."""
    from scipy.ndimage import correlate1d

    out = correlate1d(x, kernel, axis=0, mode="constant")
    return correlate1d(out, kernel, axis=1, mode="constant")


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> float:
    """Sliding-window SSIM (Wang et al. 2004, the standard evaluation form:
    11x11 Gaussian window, sigma=1.5, K1=0.01, K2=0.03, population
    covariance). Inputs (H, W) or (H, W, C) in [0, max_val]; channels are
    averaged as independent planes (the common multichannel convention).
    The map is cropped to windows fully inside the image before the mean, so
    zero-padded borders never bias the score (matches the `crop=True`
    behavior of the canonical implementations)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    # Tiny inputs (test fixtures, thumbnail renders): shrink to the largest
    # odd window that fits rather than raising — the 11x11 default applies
    # whenever the image is at least 11x11 (every real evaluation).
    win_size = min(win_size, min(a.shape[0], a.shape[1]) | 1)
    if win_size > min(a.shape[:2]):
        win_size -= 2
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    k = _gaussian_kernel1d(win_size, sigma)
    mu_a = _windowed_moments(a, k)
    mu_b = _windowed_moments(b, k)
    # E[x^2] - mu^2 (population statistics; the Gaussian window weights sum
    # to 1, so no sample-covariance correction term).
    var_a = _windowed_moments(a * a, k) - mu_a**2
    var_b = _windowed_moments(b * b, k) - mu_b**2
    cov = _windowed_moments(a * b, k) - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    pad = win_size // 2
    h, w = ssim_map.shape[:2]
    return float(ssim_map[pad : h - pad, pad : w - pad].mean())


def ssim_global(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Global-statistics SSIM (no sliding window) — a cheap relative-tracking
    signal across training runs; NOT the paper metric (use `ssim`)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(
        ((2 * mu_a * mu_b + c1) * (2 * cov + c2))
        / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    )


def objmc(target_points: np.ndarray, tracked_points: np.ndarray) -> float:
    """Object Motion Control error: mean Euclidean pixel distance between the
    conditioning trajectory and the tracked trajectory of the generated video.

    target_points/tracked_points: (K, F, 2) pixel coords. Tracking the
    generated video is the caller's job (external point tracker).
    """
    t = np.asarray(target_points, np.float64)
    g = np.asarray(tracked_points, np.float64)
    assert t.shape == g.shape, (t.shape, g.shape)
    return float(np.linalg.norm(t - g, axis=-1).mean())


def video_psnr_ssim(pred: np.ndarray, gt: np.ndarray) -> dict:
    """(F, H, W, 3) in [0,1] -> mean per-frame PSNR/SSIM."""
    ps = [psnr(p, g) for p, g in zip(pred, gt)]
    ss = [ssim(p, g) for p, g in zip(pred, gt)]
    return {"psnr": float(np.mean(ps)), "ssim": float(np.mean(ss))}
