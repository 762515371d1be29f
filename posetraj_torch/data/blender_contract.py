"""PoseTraj-10k data-generation contracts (Blender engine interop).

The reference generates its synthetic pretrain set offline with a Blender/
Cycles script (data_render/render_objs_v2.py: Objaverse GLB normalized to the
unit cube :562-599, dropped onto a textured floor with HDRI sun :1025-1071,
animated along a sampled S/circle/line curve via FOLLOW_PATH + DAMPED_TRACK so
heading follows the tangent — that is where the 6-DoF rotation supervision
comes from :1234-1247; 32 frames @720x480 :1283-1291). The Blender side stays
offline tooling; what the training framework depends on are the ARTIFACT
CONTRACTS, re-implemented here:

  per-video folder:
    images/            32 RGB frames (720x480)
    images_bbox/       frames with the projected 3D bbox composited (the
                       stage-1 --images_bbox=True targets)
    depth_maps/        per-frame Z-pass depth renders
    traj_vid_enhanced/ pre-rendered trajectory control frames
    traj.npy           (32, 2)    projected curve points, pixel coords
    bbox.npy           (32, 8, 2) projected 3D-bbox corners per frame
    writed.txt / missing.txt      render resume/failure bookkeeping
                                  (render_objs_v2.py:1020-1023, 1339-1365)

This module loads those artifacts and rasterizes the bbox wireframe control
maps the bbox ControlNet variant consumes.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# 12 edges of a box given the renderer's corner ordering (the 8 corners of
# object.bound_box: bottom face 0-1-2-3, top face 4-5-6-7).
BBOX_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)


def load_traj_npy(path: str) -> np.ndarray:
    """(num_frames, 2) projected trajectory points, pixel coords."""
    arr = np.load(path)
    assert arr.ndim == 2 and arr.shape[-1] == 2, arr.shape
    return arr.astype(np.float32)


def load_bbox_npy(path: str) -> np.ndarray:
    """(num_frames, 8, 2) projected 3D-bbox corners, pixel coords."""
    arr = np.load(path)
    assert arr.ndim == 3 and arr.shape[1:] == (8, 2), arr.shape
    return arr.astype(np.float32)


def camera_rt_vector(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """(3,3) rotation + (3,) translation -> the 12-d per-frame camera vector
    the cam variant consumes (flattened R ++ T; dataset.py:806-812)."""
    return np.concatenate([np.asarray(R, np.float32).reshape(-1), np.asarray(T, np.float32).reshape(-1)])


def rasterize_bbox_video(
    bbox_px: np.ndarray,
    num_frames: int,
    size: Tuple[int, int],
    color: Tuple[int, int, int] = (255, 255, 0),
    line_width: int = 2,
    source_hw: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """(F, 8, 2) projected corners -> (num_frames, H, W, 3) uint8 wireframe
    control maps (frame t draws the bbox at frame t; final frame black,
    matching the trajectory-map padding convention)."""
    import cv2

    h, w = size
    pts = bbox_px.astype(np.float64).copy()
    if source_hw is not None:
        pts[..., 0] = pts[..., 0] / source_hw[1] * w
        pts[..., 1] = pts[..., 1] / source_hw[0] * h
    frames = []
    for t in range(num_frames - 1):
        img = np.zeros((h, w, 3), np.uint8)
        corners = pts[min(t, len(pts) - 1)].astype(int)
        for a, b in BBOX_EDGES:
            cv2.line(img, tuple(corners[a]), tuple(corners[b]), color[::-1], line_width)
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    frames.append(np.zeros((h, w, 3), np.uint8))
    return np.stack(frames)


def read_render_bookkeeping(root: str) -> Tuple[list, list]:
    """(rendered, failed) video ids from writed.txt / missing.txt."""

    def read(name):
        p = os.path.join(root, name)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return [line.strip() for line in f if line.strip()]

    return read("writed.txt"), read("missing.txt")
