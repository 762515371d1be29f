"""ctypes binding of the port's host rasterizer (csrc/host/rasterize.cpp), the
counterpart of posetraj_tpu/native.

The library is built at first use with g++ (no other dependency) into
`build/host/` at the repository root, named by a hash of the source and
flags, so a changed source is rebuilt and an unchanged one is reused. The
data loader's worker threads call it: a build is made once under a lock,
and the drawing runs in C without the interpreter lock. `is_available()`
says whether the library builds here; the draw functions raise if it does
not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "rasterize.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the build failed, once it has

_F = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librasterize-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if it cannot be
    built or loaded (and keeps raising, without building again)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(f"host rasterizer unavailable: {_error}")
        out = lib_path()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = str(e)
            raise RuntimeError(f"host rasterizer unavailable: {_error}") from e
        lib.rasterize_trajectory_video.argtypes = [_F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_float, ctypes.c_float, ctypes.c_int, _U8]
        lib.rasterize_trajectory_video.restype = None
        lib.rasterize_bbox_video.argtypes = [_F, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _U8]
        lib.rasterize_bbox_video.restype = None
        _lib = lib
        return _lib


def is_available() -> bool:
    try:
        _load()
    except RuntimeError:
        return False
    return True


def rasterize_trajectory_video_native(
    trajectories: np.ndarray,
    num_frames: int,
    size: Tuple[int, int],
    line_width: float = 3.0,
    circle_radius: float = 3.0,
    fidelity_bgr_swap: bool = False,
) -> np.ndarray:
    """(K, >=num_frames, 2) float trajectories -> (num_frames, H, W, 3) uint8.
    RGB output (red lines, green endpoints), final frame black.
    fidelity_bgr_swap reproduces quirk Q5's per-trajectory color alternation
    (reference dataset.py:754-766) via color algebra in the kernel."""
    lib = _load()
    h, w = size
    if trajectories.ndim != 3 or trajectories.shape[-1] != 2 or trajectories.shape[1] < num_frames:
        raise ValueError(f"trajectories {trajectories.shape}: expected (K, >={num_frames}, 2)")
    traj = np.ascontiguousarray(trajectories[:, :num_frames], np.float32)
    out = np.empty((num_frames, h, w, 3), np.uint8)
    lib.rasterize_trajectory_video(
        traj.ctypes.data_as(_F), traj.shape[0], num_frames, h, w,
        ctypes.c_float(line_width), ctypes.c_float(circle_radius),
        ctypes.c_int(1 if fidelity_bgr_swap else 0), out.ctypes.data_as(_U8),
    )
    return out


def rasterize_bbox_video_native(
    corners: np.ndarray,
    num_frames: int,
    size: Tuple[int, int],
    line_width: float = 2.0,
) -> np.ndarray:
    """(num_frames, 8, 2) projected bbox corners -> (num_frames, H, W, 3)."""
    lib = _load()
    h, w = size
    if corners.ndim != 3 or corners.shape[1:] != (8, 2) or corners.shape[0] < num_frames:
        raise ValueError(f"corners {corners.shape}: expected (>={num_frames}, 8, 2)")
    pts = np.ascontiguousarray(corners[:num_frames], np.float32)
    out = np.empty((num_frames, h, w, 3), np.uint8)
    lib.rasterize_bbox_video(pts.ctypes.data_as(_F), num_frames, h, w, ctypes.c_float(line_width),
                             out.ctypes.data_as(_U8))
    return out
