"""Trajectory -> control-video rasterization (port of
posetraj_tpu/ops/rasterize.py).

The reference draws per-frame trajectory maps with cv2 on the host, four
near-identical copies of the same recipe (dataset.py:741-766,
train_svd_traj_VIPSeg_14.py:202-217, run_inference_vipseg_json_repro.py:438-449):
for frame t, draw segment t->t+1 of every trajectory as a red 3px line plus a
green filled endpoint circle r=3, on black; the final (14th) control frame is
all black.

Three implementations:

  * `rasterize_cv2` — host-side cv2 parity mode, including quirk Q5: the
    reference converts BGR->RGB INSIDE the per-trajectory loop, so with k
    trajectories the line drawn for trajectory i has its R/B channels swapped
    (k - i) times: the last-drawn line ends up red, the one before blue, etc.
    Exposed via `fidelity_bgr_swap=True` (default) for dataset parity.

  * `rasterize_host(impl="native")` — the port's C++ library
    (ops/host_rasterize.py), the same recipe without cv2.

  * `rasterize` / `rasterize_video` — torch functions on the caller's device,
    the counterparts of the JAX package's `rasterize_xla` /
    `rasterize_video_xla`: a segment distance field, `mode="hard"` (cv2-like
    crisp line and circle masks) or `mode="gaussian"` (a soft Gaussian
    heatmap around the segment, BASELINE.json's "Gaussian-heatmap"
    conditioning rasterizer).

XLA fuses the (H, W, K) distance temporaries of `rasterize_xla` away; eager
PyTorch would store each (1.96 GB in float32 at 13 x 576 x 1024 x 64). So
`rasterize_video` runs one frame at a time and the trajectories in chunks
whose temporaries stay within `chunk_bytes`, and reduces over the
trajectories by the minimum squared distance, exactly: each mask is a
monotone function of that distance (d <= r^2; exp(-d / 2 sigma^2)), so the
max over trajectories of the JAX package's masks is the mask of the least
distance, and any chunking gives the same bits.

Coordinates follow the reference's scaling convention (dataset.py:751):
x' = int(x * W_t / W_s), y' = int(y * H_t / H_s) done by the caller or via
`scale_trajectories`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Bytes of the float32 temporaries a chunk of trajectories may hold at once.
CHUNK_BYTES = 512 * 2**20
# Float32 temporaries of the chunk's shape alive at once in min_distances,
# counted with margin.
_LIVE_TEMPS = 8


def scale_trajectories(traj: np.ndarray, src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> np.ndarray:
    """(..., 2) [x, y] points from source-video pixels to target pixels with
    the reference's int() truncation (dataset.py:751)."""
    out = traj.astype(np.float64).copy()
    out[..., 0] = np.floor(out[..., 0] / src_hw[1] * dst_hw[1])
    out[..., 1] = np.floor(out[..., 1] / src_hw[0] * dst_hw[0])
    return out


# ---------------------------------------------------------------------------
# Host rasterizers
# ---------------------------------------------------------------------------


def rasterize_cv2(
    trajectories: np.ndarray,
    num_frames: int,
    size: Tuple[int, int],
    fidelity_bgr_swap: bool = True,
    line_width: int = 3,
    circle_radius: int = 3,
) -> np.ndarray:
    """trajectories: (K, >=num_frames, 2) int pixel coords. Returns
    (num_frames, H, W, 3) uint8: num_frames-1 drawn + 1 black pad frame."""
    import cv2

    h, w = size
    frames = []
    for t in range(num_frames - 1):
        img = np.zeros((h, w, 3), dtype=np.uint8)
        for k in range(trajectories.shape[0]):
            p0 = (int(trajectories[k, t, 0]), int(trajectories[k, t, 1]))
            p1 = (int(trajectories[k, t + 1, 0]), int(trajectories[k, t + 1, 1]))
            cv2.line(img, p0, p1, (0, 0, 255), line_width)
            cv2.circle(img, p1, circle_radius, (0, 255, 0), -1)
            if fidelity_bgr_swap:
                # Q5: conversion inside the per-trajectory loop (dataset.py:762)
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if not fidelity_bgr_swap:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        frames.append(img)
    frames.append(np.zeros((h, w, 3), dtype=np.uint8))
    return np.stack(frames)


def rasterize_host(
    trajectories: np.ndarray,
    num_frames: int,
    size: Tuple[int, int],
    fidelity_bgr_swap: bool = True,
    impl: str = "cv2",
) -> np.ndarray:
    """Host-path rasterizer dispatch for the data loaders.

    impl:
      * "cv2"    — exact reference parity (pixel-identical to the four cv2
                   recipes in the reference, incl. quirk Q5). Default: the
                   loaders must reproduce the reference's training pixels.
      * "native" — the port's dependency-free C++ library
                   (ops/host_rasterize.py): same recipe and Q5 color
                   algebra, distance-based thick-line geometry (boundary
                   pixels differ from cv2's Bresenham by <1px). Raises if the
                   library cannot be built.
      * "auto"   — "native" when the library builds, else "cv2".
    """
    from posetraj_torch.ops import host_rasterize

    if impl == "auto":
        impl = "native" if host_rasterize.is_available() else "cv2"
    if impl == "native":
        return host_rasterize.rasterize_trajectory_video_native(
            trajectories, num_frames, size, fidelity_bgr_swap=fidelity_bgr_swap
        )
    if impl != "cv2":
        raise ValueError(f"unknown rasterizer impl: {impl!r}")
    return rasterize_cv2(trajectories, num_frames, size, fidelity_bgr_swap=fidelity_bgr_swap)


# ---------------------------------------------------------------------------
# Device rasterizer (torch)
# ---------------------------------------------------------------------------


def chunk_size(height: int, width: int, chunk_bytes: int = CHUNK_BYTES) -> int:
    """Trajectories a chunk of min_distances takes at (height, width)."""
    return max(1, chunk_bytes // (_LIVE_TEMPS * 4 * height * width))


def min_distances(points_from: torch.Tensor, points_to: torch.Tensor, valid: torch.Tensor, height: int,
                   width: int, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) float32: each pixel's least squared distance to a valid
    segment, and to a valid segment's end point (+inf where no trajectory
    is valid). The per-trajectory arithmetic is the JAX package's
    _segment_distance_sq, element for element; trajectories run in chunks
    of `chunk`."""
    dev = points_from.device
    px = torch.arange(width, device=dev, dtype=torch.float32).view(1, 1, width)
    py = torch.arange(height, device=dev, dtype=torch.float32).view(1, height, 1)
    inf = torch.tensor(float("inf"), device=dev)
    d_line = torch.full((height, width), float("inf"), device=dev)
    d_circle = torch.full((height, width), float("inf"), device=dev)
    for s in range(0, points_from.shape[0], chunk):
        a, b, ok = points_from[s:s + chunk], points_to[s:s + chunk], valid[s:s + chunk].view(-1, 1, 1)
        x0, y0 = a[:, 0].view(-1, 1, 1), a[:, 1].view(-1, 1, 1)
        x1, y1 = b[:, 0].view(-1, 1, 1), b[:, 1].view(-1, 1, 1)
        dx, dy = x1 - x0, y1 - y0
        len_sq = torch.clamp_min(dx * dx + dy * dy, 1e-8)
        t = ((px - x0) * dx + (py - y0) * dy) / len_sq  # (k, H, W)
        t = t.clamp_(0.0, 1.0)
        ex = px - (x0 + t * dx)
        ey = py - (y0 + t * dy)
        d = torch.where(ok, ex * ex + ey * ey, inf)
        d_line = torch.minimum(d_line, d.amin(dim=0))
        cx, cy = px - x1, py - y1
        d = torch.where(ok, cx * cx + cy * cy, inf)
        d_circle = torch.minimum(d_circle, d.amin(dim=0))
    return d_line, d_circle


def masks(d_line: torch.Tensor, d_circle: torch.Tensor, mode: str, line_width: int, circle_radius: int,
          sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The line and circle channels before the circle is drawn over the
    line: 0/1 masks (hard) or Gaussian heatmaps of the least distances."""
    if mode == "hard":
        return ((d_line <= (line_width / 2.0) ** 2).float(),
                (d_circle <= float(circle_radius) ** 2).float())
    if mode == "gaussian":
        return torch.exp(-d_line / (2.0 * sigma**2)), torch.exp(-d_circle / (2.0 * sigma**2))
    raise ValueError(mode)


def rasterize(
    points_from: torch.Tensor,
    points_to: torch.Tensor,
    valid: torch.Tensor,
    height: int,
    width: int,
    mode: str = "hard",
    line_width: int = 3,
    circle_radius: int = 3,
    sigma: float = 3.0,
    chunk_bytes: int = CHUNK_BYTES,
) -> torch.Tensor:
    """One control frame from K segments, on the tensors' device.

    points_from/points_to: (K, 2) float [x, y]; valid: (K,) bool mask
    (variable trajectory count handled by masking). Returns (H, W, 3)
    float32 in [0, 1]: red line channel, green endpoint channel.

    mode="hard": crisp masks with the cv2 widths (line thickness 3 ~ radius
    1.5, circle r=3). mode="gaussian": exp(-d^2 / 2 sigma^2) soft heatmap.
    """
    if mode not in ("hard", "gaussian"):
        raise ValueError(mode)
    d_line, d_circle = min_distances(points_from.float(), points_to.float(), valid.bool(), height, width,
                                      chunk_size(height, width, chunk_bytes))
    line, circle = masks(d_line, d_circle, mode, line_width, circle_radius, sigma)
    # Circles are filled on top of lines (drawn after, dataset.py:761): where a
    # circle covers, green wins over red.
    red = torch.clamp_min(line - circle, 0.0) if mode == "hard" else line * (1.0 - circle)
    return torch.stack([red, circle, torch.zeros_like(red)], dim=-1)


def rasterize_video(
    trajectories: torch.Tensor,
    valid: torch.Tensor,
    num_frames: int,
    height: int,
    width: int,
    mode: str = "hard",
    **kwargs,
) -> torch.Tensor:
    """(K, num_frames, 2) -> (num_frames, H, W, 3) float32: frame t shows
    segment t->t+1; the last frame is black padding
    (run_inference...repro.py:448-449). One frame at a time (see the module
    docstring)."""
    trajectories = torch.as_tensor(trajectories)
    valid = torch.as_tensor(valid, device=trajectories.device)
    out = torch.zeros((num_frames, height, width, 3), device=trajectories.device)
    for t in range(num_frames - 1):
        out[t] = rasterize(trajectories[:, t], trajectories[:, t + 1], valid, height, width, mode, **kwargs)
    return out
