"""Video/image export: GIF, mp4, PNG sequences, side-by-side grids (port of
posetraj_tpu/data/export.py). Frames are numpy arrays or tensors on any
device, float in [0, 1] or uint8; PIL and imageio are imported by the
writer that needs them.

Rebuild of the reference's scattered writers (run_inference_vipseg_json_repro.py
export_to_gif :15-37, export_to_images :307-318, save_gifs_side_by_side
:39-99; utils/util.py save_videos_grid :19-31) as one module.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch


def _host(x):
    """A tensor (any device, any float dtype) as a numpy array; anything
    else as is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x if x.dtype == torch.uint8 else x.float()).numpy()
    return x


def _to_uint8(frame) -> np.ndarray:
    arr = np.asarray(_host(frame))
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).round().astype(np.uint8)
    return arr


def export_to_images(frames: Sequence, out_dir: str, prefix: str = "") -> List[str]:
    """Frame-folder output for external metric tooling (FVD/FID/ObjMC)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, fr in enumerate(frames):
        p = os.path.join(out_dir, f"{prefix}{i:05d}.png")
        Image.fromarray(_to_uint8(fr)).save(p)
        paths.append(p)
    return paths


def export_to_gif(frames: Sequence, path: str, fps: int = 7) -> str:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imgs = [Image.fromarray(_to_uint8(f)) for f in frames]
    imgs[0].save(
        path, format="GIF", append_images=imgs[1:], save_all=True,
        duration=max(int(1000 / fps), 1), loop=0,
    )
    return path


def export_to_video(frames: Sequence, path: str, fps: int = 7) -> str:
    import imageio

    with imageio.get_writer(path, fps=fps) as w:
        for f in frames:
            w.append_data(_to_uint8(f))
    return path


def save_side_by_side_gif(videos: Sequence[Sequence], path: str, fps: int = 7) -> str:
    """Horizontally concatenate N videos frame-by-frame into one GIF
    (reference save_gifs_side_by_side)."""
    n_frames = min(len(v) for v in videos)
    frames = [
        np.concatenate([_to_uint8(v[i]) for v in videos], axis=1) for i in range(n_frames)
    ]
    return export_to_gif(frames, path, fps)


def save_videos_grid(videos: np.ndarray, path: str, n_rows: int = 2, fps: int = 7) -> str:
    """(N, F, H, W, 3) -> tiled-grid GIF (reference util.py:19-31)."""
    videos = np.asarray(_host(videos))
    n, f = videos.shape[:2]
    n_cols = -(-n // n_rows)
    pad = n_rows * n_cols - n
    if pad:
        videos = np.concatenate([videos, np.zeros((pad,) + videos.shape[1:], videos.dtype)])
    frames = []
    for i in range(f):
        rows = [
            np.concatenate([_to_uint8(videos[r * n_cols + c, i]) for c in range(n_cols)], axis=1)
            for r in range(n_rows)
        ]
        frames.append(np.concatenate(rows, axis=0))
    return export_to_gif(frames, path, fps)
