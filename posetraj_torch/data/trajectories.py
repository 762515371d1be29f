"""CoTracker trajectory JSON handling (port of posetraj_tpu/data/trajectories.py).

Format (SURVEY.md 2.22; dataset/VIPSeg/output_cotracker_all/*.json in the
reference): a dict {track_id: [[x, y] per frame]} in source-video pixel
coordinates; every track has the same frame count.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np


def load_cotracker_json(path: str) -> Dict[str, List[List[float]]]:
    with open(path) as f:
        return json.load(f)


def trajectories_to_array(traj_json: Dict[str, List[List[float]]]) -> np.ndarray:
    """{track: [[x,y]...]} -> (K, T, 2) float32 array (insertion order)."""
    tracks = [np.asarray(v, np.float32) for v in traj_json.values()]
    if not tracks:
        return np.zeros((0, 0, 2), np.float32)
    t = min(len(tr) for tr in tracks)
    return np.stack([tr[:t] for tr in tracks])


def num_frames(traj_json: Dict) -> int:
    first = next(iter(traj_json.values()), [])
    return len(first)


def scale_to_target(
    traj: np.ndarray, source_hw: Tuple[int, int], target_hw: Tuple[int, int]
) -> np.ndarray:
    """Reference coordinate scaling: int(x / W_s * W_t) per point
    (dataset.py:751)."""
    out = traj.copy()
    out[..., 0] = np.floor(out[..., 0] / source_hw[1] * target_hw[1])
    out[..., 1] = np.floor(out[..., 1] / source_hw[0] * target_hw[0])
    return out
