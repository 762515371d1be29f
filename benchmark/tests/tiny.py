"""Cells at a size a CPU test holds: the program's small configurations
(ModelBundle.tiny) in float32 on the CPU, driven by the real drivers with
the real cells' limits."""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from benchmark import config
from benchmark.harness import Run

VIDEO = {"kind": "video", "height": 64, "width": 64, "frames": 2, "steps": 3, "min_guidance": 1.0,
         "max_guidance": 3.0, "decode_chunk": 8, "trajectories": [1, 3], "radius": 3, "pool": 2}
# 128x128: at 64x64 the deepest level is one pixel and its GroupNorm's
# gradients are ill-conditioned (both sides agree on the loss, not on them).
TRAIN = {"kind": "train", "height": 128, "width": 128, "frames": 2, "trajectories": [1, 3], "radius": 3, "pool": 6,
         "check_windows": 3}


def cfg(variant: str) -> dict:
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.pipeline.svd_controlnet import ModelBundle

    out = config.as_dict(ModelBundle.tiny(variant))
    out["compute_dtype"] = "float32"
    out["train"] = json.loads(json.dumps(dataclasses.asdict(TrainConfig(num_frames=2, height=128, width=128))))
    return out


def run(cell: str, seed: int = 11) -> Run:
    """A Run of `cell` at the tiny size on the CPU, held to the cell's limits."""
    kind = "train" if "train" in cell else "video"
    limits = json.loads((config.ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    r = Run(cfg=cfg("bbox" if kind == "train" else "base"), traffic=TRAIN if kind == "train" else VIDEO,
            cell={"name": cell, "chips": 1}, seed=seed, seconds=0.0, trace=False, device=torch.device("cpu"),
            t0=time.perf_counter(), limits=limits)
    import importlib

    importlib.import_module(f"benchmark.drivers.{kind}").run(r)
    return r
