"""Checkpoint save and restore with rotation (port of
posetraj_tpu/train/checkpoints.py).

A checkpoint is the directory `<root>/checkpoint-<step>/` holding one
`torch.save` file, `state.pt`: the float32 masters, the EMA, the gradient
accumulator, the optimizer's and the scheduler's state, the step and the
trainer's generator state (`Trainer.state_dict`). A trainer on a mesh
writes the file an unsharded trainer writes at the same step, and restores
one into its own layout. The JAX step folds its
step into its key, so a resumed run draws what an uninterrupted one draws;
here the saved generator state does that. `keep_total_limit` removes the
oldest checkpoints beyond that many (the reference's
checkpoints_total_limit); `latest_checkpoint` serves
`--resume_from_checkpoint latest`. `export_diffusers` writes a ControlNet
(or any model) in the diffusers layout through the port's weight converter
(tools/convert_weights.py), so reference tooling can load trained weights.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _ckpt_dirs(root: str) -> List[str]:
    if not os.path.isdir(root):
        return []
    out = [d for d in os.listdir(root) if re.fullmatch(r"checkpoint-\d+", d)]
    return sorted(out, key=lambda d: int(d.split("-")[1]))


def latest_checkpoint(root: str) -> Optional[str]:
    dirs = _ckpt_dirs(root)
    return os.path.join(root, dirs[-1]) if dirs else None


def save_checkpoint(root: str, step: int, trainer_state, keep_total_limit: Optional[int] = None,
                    mesh=None) -> str:
    """Write `trainer_state` (a Trainer, or a dict such as its state_dict())
    under checkpoint-<step>; then keep only the newest keep_total_limit
    checkpoints. The file is written under a temporary name and renamed, so
    a run cut during the write leaves no checkpoint that looks whole.

    Under a mesh (a Trainer's own, or `mesh` with a dict) every rank calls
    this: the trainer's state_dict gathers the unsharded trainer's dict
    (JAX's device_get), rank 0 writes it, and every rank waits on a barrier
    before and after the write."""
    mesh = getattr(trainer_state, "mesh", mesh)
    sd = trainer_state.state_dict() if hasattr(trainer_state, "state_dict") else trainer_state
    path = os.path.join(root, f"checkpoint-{step}")
    if mesh is not None:
        mesh.barrier()
    if mesh is None or mesh.rank == 0:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(sd, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if keep_total_limit:
            dirs = _ckpt_dirs(root)
            for d in dirs[: max(0, len(dirs) - keep_total_limit)]:
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    if mesh is not None:
        mesh.barrier()
    return path


def load_checkpoint(path: str, map_location=None):
    """The dict save_checkpoint wrote under `path` (a checkpoint-<step>
    directory). Only checkpoints this program wrote should be loaded:
    torch.load unpickles."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location, weights_only=False)


def restore_checkpoint(path: str, trainer) -> None:
    """Restore the checkpoint at `path` into `trainer` in place
    (Trainer.load_state_dict), into any mesh's layout: the next micro-step
    is the one that followed the save. Read to host memory first: the
    optimizer keeps its step counts there, and the tensors are copied into
    the trainer's own."""
    trainer.load_state_dict(load_checkpoint(path, map_location="cpu"))


def export_diffusers(params, model: str, out_path: str) -> str:
    """Write the port's parameters of `model` as a diffusers-layout
    .safetensors (or, without safetensors, an .npz) of float32 arrays;
    returns the path written (the suffix added)."""
    from posetraj_torch.tools.convert_weights import params_to_diffusers

    sd = params_to_diffusers(params, model)
    try:
        from safetensors.numpy import save_file
    except ImportError:
        if not out_path.endswith(".npz"):
            out_path += ".npz"
        np.savez(out_path, **sd)
    else:
        if not out_path.endswith(".safetensors"):
            out_path += ".safetensors"
        save_file(sd, out_path)
    return out_path
