"""Seeded inputs: images, drag trajectories drawn as control videos, 3D-bbox
maps, training clips and the sampler's noises.

Trajectories are drawn by this file's own numpy code: each is a smooth
path (a start point, a velocity and a turn rate) whose points up to frame t
are drawn as a trail of disks in the path's colour on frame t, as the
PoseTraj control videos show a dragged point and its past. A request's
count of trajectories is drawn from the traffic's range. Every draw comes
from (seed, index), so the same seed gives the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.weights import sub_seed


def _rng(seed: int, tag: str, index: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, f"{tag}:{index}"))


def smooth_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) in [0, 1]: a random coarse colour field, upsampled
    bicubically, with fine noise."""
    coarse = torch.from_numpy(rng.random((1, 3, max(2, h // 64), max(2, w // 64)), dtype=np.float32))
    img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    img = img + 0.05 * rng.standard_normal((h, w, 3), dtype=np.float32)
    return np.clip(img, 0.0, 1.0)


def paths(rng: np.random.Generator, count: int, frames: int, h: int, w: int) -> np.ndarray:
    """(count, frames, 2) points (y, x) of smooth paths inside the frame."""
    start = rng.uniform([0.15 * h, 0.15 * w], [0.85 * h, 0.85 * w], size=(count, 2))
    speed = rng.uniform(0.01, 0.04, size=(count, 1)) * min(h, w)
    angle = rng.uniform(0, 2 * np.pi, size=(count, 1)) + np.arange(frames) * rng.uniform(-0.15, 0.15, (count, 1))
    steps = np.stack([np.sin(angle), np.cos(angle)], axis=-1) * speed[..., None]
    pts = start[:, None] + np.concatenate([np.zeros((count, 1, 2)), np.cumsum(steps[:, :-1], axis=1)], axis=1)
    return np.clip(pts, [0, 0], [h - 1, w - 1])


def _disk(canvas: np.ndarray, y: float, x: float, r: int, color) -> None:
    h, w = canvas.shape[:2]
    y0, y1, x0, x1 = max(0, int(y) - r), min(h, int(y) + r + 1), max(0, int(x) - r), min(w, int(x) + r + 1)
    yy, xx = np.ogrid[y0:y1, x0:x1]
    mask = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
    canvas[y0:y1, x0:x1][mask] = color


def trail_video(pts: np.ndarray, colors: np.ndarray, h: int, w: int, radius: int) -> np.ndarray:
    """(frames, h, w, 3) in [0, 1]: frame t holds each path's trail up to t."""
    frames = pts.shape[1]
    canvas = np.zeros((h, w, 3), np.float32)
    out = np.empty((frames, h, w, 3), np.float32)
    for t in range(frames):
        for p, c in zip(pts, colors):
            a, b = p[max(t - 1, 0)], p[t]
            n = int(np.hypot(*(b - a)) / max(radius / 2, 1)) + 1
            for s in np.linspace(0.0, 1.0, n):
                _disk(canvas, *(a + s * (b - a)), radius, c)
        out[t] = canvas
    return out


def box_video(pts: np.ndarray, colors: np.ndarray, h: int, w: int, half: np.ndarray) -> np.ndarray:
    """(frames, h, w, 3): each path's box outline around its point, frame by
    frame (the rendered 3D-bbox maps of the stage-1 data)."""
    frames = pts.shape[1]
    out = np.zeros((frames, h, w, 3), np.float32)
    for t in range(frames):
        for (y, x), c, (hy, hx) in zip(pts[:, t], colors, half):
            y0, y1, x0, x1 = int(max(0, y - hy)), int(min(h - 1, y + hy)), int(max(0, x - hx)), int(min(w - 1, x + hx))
            out[t, y0:y1 + 1, [x0, x1]] = c
            out[t, [y0, y1], x0:x1 + 1] = c
    return out


def video_request(seed: int, index: int, traffic: dict) -> dict:
    """One img2vid request: image (1, H, W, 3) and control (1, F, H, W, 3),
    both numpy float32 in [0, 1], as a client sends them."""
    rng = _rng(seed, "request", index)
    h, w, frames = traffic["height"], traffic["width"], traffic["frames"]
    lo, hi = traffic["trajectories"]
    count = int(rng.integers(lo, hi + 1))
    pts = paths(rng, count, frames, h, w)
    colors = rng.uniform(0.3, 1.0, size=(count, 3)).astype(np.float32)
    control = trail_video(pts, colors, h, w, traffic["radius"])
    return {"image": smooth_image(rng, h, w)[None], "control": control[None]}


def video_noises(seed: int, index: int, traffic: dict, latent_channels: int, scale: int, device) -> dict:
    """The sampler's draws for a request: initial latents (1, F, h, w, c) and
    the image augmentation (1, H, W, 3), standard normal, on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, f"noise:{index}"))
    h, w, frames = traffic["height"], traffic["width"], traffic["frames"]
    return {"latents": torch.randn((1, frames, h // scale, w // scale, latent_channels), generator=gen,
                                   device=device),
            "image_aug": torch.randn((1, h, w, 3), generator=gen, device=device)}


def train_batch(seed: int, index: int, traffic: dict, device) -> dict:
    """One micro-batch of the stage-1 data, all in [-1, 1] but the motion
    value: pixel_values, a clip of an image panned along a path; the
    trajectories' control video; bbox_trajectories, the boxes around them."""
    rng = _rng(seed, "batch", index)
    h, w, frames = traffic["height"], traffic["width"], traffic["frames"]
    lo, hi = traffic["trajectories"]
    count = int(rng.integers(lo, hi + 1))
    pts = paths(rng, count, frames, h, w)
    colors = rng.uniform(0.3, 1.0, size=(count, 3)).astype(np.float32)
    pad = frames * 4
    big = smooth_image(rng, h + 2 * pad, w + 2 * pad)
    pan = np.round(np.cumsum(rng.uniform(-4, 4, size=(frames, 2)), axis=0)).astype(int)
    clip = np.stack([big[pad + dy:pad + dy + h, pad + dx:pad + dx + w] for dy, dx in pan])
    half = rng.uniform(0.05, 0.15, size=(count, 2)) * [h, w]
    batch = {"pixel_values": clip, "trajectories": trail_video(pts, colors, h, w, traffic["radius"]),
             "bbox_trajectories": box_video(pts, colors, h, w, half)}
    out = {k: torch.from_numpy(v * 2.0 - 1.0)[None].to(device) for k, v in batch.items()}
    out["motion_values"] = torch.tensor([float(rng.uniform(1.0, 255.0))], device=device)
    return out
