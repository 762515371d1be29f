"""Training-step benchmark of the port (port of posetraj_tpu/tools/bench_train.py).

Times the reference recipe's step (start_pretrain.sh:1-19, BASELINE.md) on
the card: 320x576, 14 frames, batch 1, gradient accumulation 2, gradient
checkpointing, the EDM loss with the auxiliary spatial loss, bf16 Adam
moments (the stand-in for --use_8bit_adam), no EMA (start_pretrain.sh does
not pass --use_ema), and the JAX version's memory options: a bf16
accumulator, bf16 gradients, the conditioning encodes outside the step.
Weights are tools/fill.py's pattern: the frozen UNet, VAE and CLIP in the
compute dtype, the ControlNet masters in float32.

    python -m posetraj_torch.tools.bench_train [--tiny] [--iters 4] [--device cpu]

prints one JSON line. This is a tool, not the port's benchmark.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict

import numpy as np
import torch

from posetraj_torch.core.params import leaves


def _nbytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees for t in leaves(tree))


def _device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them (its
    name alone where nvidia-smi is missing), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        lines = smi.stdout.strip().splitlines()
        index = device.index if device.index is not None else torch.cuda.current_device()
        if smi.returncode == 0 and len(lines) > index:
            return lines[index].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(device)


def bench_train_step(height: int = 320, width: int = 576, frames: int = 14, iters: int = 4, tiny: bool = False,
                     verbose: bool = True, device=None) -> Dict:
    """Build the trainer, run the capturing micro-step and the rest of its
    accumulation window, then time `iters` replayed micro-steps (and one
    window of eager ones). Returns the JAX version's keys with the port's
    meanings (train_step_sec: s/micro-step of the graphed Trainer.step;
    train_arg_gb: bytes of the state and frozen weights at rest;
    train_temp_gb: the peak of torch.cuda.max_memory_allocated during an
    eager micro-step less the bytes allocated at rest, 0.0 on the CPU;
    train_loss, train_config) plus train_optimizer_step_sec,
    train_step_eager_sec, capture_sec and device."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.core.init import default_compute_dtype, resolve_device
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline.svd_controlnet import init_params
    from posetraj_torch.tools.fill import fill_like
    from posetraj_torch.train.trainer import Trainer

    device = resolve_device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    bundle = ModelBundle.tiny() if tiny else ModelBundle()
    compute_dtype = default_compute_dtype(device)

    t0 = time.perf_counter()
    template = init_params(bundle, device="meta", compute_dtype=compute_dtype)
    frozen = {k: fill_like(template[k], compute_dtype, device) for k in ("unet", "vae", "clip")}
    cn_params = fill_like(template["controlnet"], torch.float32, device)
    del template
    tcfg = TrainConfig(
        height=height, width=width, num_frames=frames,
        gradient_accumulation_steps=2, adam_mu_bf16=True,
        use_ema=False, grad_accum_dtype="bfloat16", encode_outside_step=True,
        grads_bf16=True,
        lr_warmup_steps=0,
    )
    trainer = Trainer(bundle, tcfg, frozen, cn_params, device=device, compute_dtype=compute_dtype)
    del frozen, cn_params
    accum = tcfg.gradient_accumulation_steps

    rng = np.random.RandomState(0)

    def vid():  # a cheap nonzero batch: an 8x8 random patch tiled to full size
        small = rng.rand(1, frames, 8, 8, 3).astype(np.float32) * 2 - 1
        return torch.from_numpy(small.repeat(height // 8, axis=2).repeat(width // 8, axis=3)).to(device)

    batch = {"pixel_values": vid(), "trajectories": vid(), "motion_values": torch.full((1,), 127.0, device=device)}
    if verbose:
        print(f"[bench-train] trainer built in {time.perf_counter() - t0:.1f}s on {device}", flush=True)

    t0 = time.perf_counter()
    warm = trainer.step(batch)  # on the card: eager on the capture stream, then the capture
    loss0 = float(warm["loss"])
    capture_sec = trainer.graph.capture_s if cuda else 0.0
    if verbose:
        print(f"[bench-train] first micro-step {time.perf_counter() - t0:.1f}s (capture {capture_sec:.2f}s) "
              f"loss={loss0:.4f}", flush=True)
    while trainer.state.step % accum:  # finish the window, so the timed run starts at a window's start
        trainer.step(batch)
    sync()

    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = trainer.step(batch)
    loss = float(metrics["loss"])  # the sync point that stops the clock
    sec = (time.perf_counter() - t0) / iters

    while trainer.state.step % accum:
        trainer.step(batch)
    # One window of eager micro-steps; the first is where the temporaries
    # peak outside the graph's pool.
    gb_rest = _nbytes(trainer.frozen_params, trainer.encode_params or {}, trainer.state.controlnet_params,
                      trainer.state.ema_params or {}, trainer.state.loss_params or {}, trainer.state.grad_acc,
                      [v for s in trainer.state.optimizer.state.values() for v in s.values()
                       if isinstance(v, torch.Tensor)]) / 1e9
    temp_gb = 0.0
    if cuda:
        sync()
        rest = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for i in range(accum):
        trainer.step_eager(batch)
        if cuda and i == 0:
            sync()
            temp_gb = (torch.cuda.max_memory_allocated(device) - rest) / 1e9
    sync()
    eager_sec = (time.perf_counter() - t0) / accum

    return {
        "train_step_sec": sec,
        "train_temp_gb": temp_gb,
        "train_arg_gb": gb_rest,
        "train_loss": loss,
        "train_config": (f"{height}x{width} f{frames} bs1 accum2 remat "
                         "bf16-moments bf16-accum bf16-grads no-ema split-encode"),
        "train_optimizer_step_sec": sec * accum,
        "train_step_eager_sec": eager_sec,
        "capture_sec": capture_sec,
        "device": _device_name(device),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=576)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to ask for the CPU")
    a = ap.parse_args()
    print(json.dumps(bench_train_step(a.height, a.width, a.frames, a.iters, a.tiny, verbose=True, device=a.device)))
