#!/usr/bin/env python3
"""Smoke test of posetraj_torch on one NVIDIA GPU (an H100 for the numbers
in PERF.md): the quickest proof that the port builds and runs on the card,
for inference and for training.

    python3 chip_smoke.py            # every phase, as the checks run it
    python3 chip_smoke.py --steps 4  # fewer Euler steps in phases 4, 6, 8, 10(c), 11, 12 and 13(c)

Phases, one line of output each (more for phases 2, 5, 6, 8 and 9):
  1. the card (nvidia-smi name, power limit) and the build of the six CUDA
     libraries from posetraj_torch/csrc, one nvcc per source, in parallel;
     the count of HGMMA (wgmma) and UTMALDG (TMA load) instructions in the
     SASS of the flash, mlp, qkvt and temporal libraries, and of HMMA
     (mma.sync) and UTMALDG in D's frame_attn, which must all be above 0;
     the global loads in kernel 8's SASS, which must all be LDG.E.128;
  2. each kernel against its plain PyTorch version at the main paths'
     shapes (and the 320x576 ones, whose S is ragged for the attention
     tiles), bf16, with its error against the stated tolerance (for the
     residual sub-layers B, C, D: the error of the branch, out minus the
     residual term), its median time, the plain version's, the bound (bytes
     over 3.35 TB/s or operations over the dense peak, whichever is larger)
     and, where one PyTorch call computes the same function, that call's
     time (none for B, C, D: no one call computes the sub-layer; C's
     attention core, the shared flash forward on C's scratch, and D's frame
     attention are timed alone beside SDPA instead; D's frame attention is
     also checked alone at each level and has its own row); A at five
     shapes (one a ragged row count) and its VAE shapes; B at each UNet level's
     shape beside its two F.linear products, and in each variant at a
     ragged row count; the Hopper GEMM of B, C and D alone at C's QKV and
     out-projection shapes beside F.linear; kernel 5 (flash
     attention) forward (o, base-2 lse) and backward
     (dq, dk, dv) at the training shapes, a ragged, a rectangular and a
     head_dim 128 case; kernel 7 (forward-only flash attention) at the
     un-fused path's shapes and a ragged rectangular one; kernel 6 (packed
     QKV, head_dim 128) with its lse and its gradient through
     FlashAttentionQKV; kernel 8 (row LayerNorm) at the un-fused path's
     three widths and the temp hint's 258048 rows in bf16 and one width in
     float32, each timed beside its bound, its plain version and
     F.layer_norm, on copies of x that do not fit in L2, a call by CUDA
     events and its device time under torch.profiler: by device time it
     must beat F.layer_norm at each and reach half its bound at (80640,
     320); then the gates of C and D: spatial and temporal
     blocks at head_dim 16 and 128 run without C or D and agree with the
     plain block, and a direct call at head_dim 16 still raises;
  3. one denoise step (ControlNet -> UNet, CFG batch) at full SVD width and
     14x576x1024, with the kernels and with the plain versions (attention()
     included), compared, and with uniform attention, to show the comparison
     can see kernels C and D; the kernel step once more under
     torch.profiler, its device time grouped by kernel (kernel A's device
     launches must equal its calls: one launch a call);
  4. SVDControlNetPipeline at full width (UNet 320..1280, ViT-H CLIP, VAE
     128..512), 14x576x1024 with CFG, two requests, the denoise loop a
     captured CUDA graph (captured in the first request, replayed in the
     second); launch counts of every kernel over that run, output checked
     for shape, finiteness and range;
  5. training at full width, 14x320x576, batch 1, TrainConfig defaults:
     (a) one micro-step's loss and ControlNet gradients with the kernels
     against the same step with every wrapper plain, and with uniform
     attention to show the check sees kernels C and 5; (b) every ControlNet
     leaf has a finite, non-zero gradient; (c) Trainer.step x 4 (two
     optimizer updates; the micro-step replays a captured CUDA graph after
     the first call): accumulation, EMA, frozen UNet, launches of every
     kernel, s/micro-step, s/optimizer step, peak memory; (d) one more
     micro-step under torch.profiler, grouped by kernel; (e) the graphed
     micro-step (Trainer.step) against the eager one (Trainer.step_eager),
     4 micro-steps from one state and generator: params, EMA, moments and
     accumulator bitwise equal where two eager runs are (else within their
     spread), the same launches by the wrappers' counts and, in one
     micro-step, by the profiler's; s/micro-step and s/optimizer-step as
     medians of 4 optimizer steps taken in turns (eager, graph, graph,
     eager), busy share, capture seconds, memory at rest and at an eager
     peak, the graph's pool, the bytes of a full-width checkpoint; the
     graphed step must not be slower; (f) bbox, cam, rot and temp under the
     default switches, the base variant under UNFUSED (kernels 5, 7 and 8;
     kernel 8 only where no gradient flows) and the four memory options
     together: one micro-step's gradient with the kernels against the
     all-plain step, the next micro-step replayed with the update, a
     replayed micro-step against an eager one, launches, memory beside the
     defaults'; (g) resume from a checkpoint at a reduced depth (UNet and
     ControlNet 320, 640 wide, one layer a block): the restored run's two
     micro-steps bitwise the uninterrupted run's;
  6. inference at 14x320x576 under the un-fused KernelConfig (UNFUSED:
     kernels 7 and 8, B without its LayerNorm, no C or D): (a) one denoise
     step against the all-plain step and the default-config step, with
     uniform kernel-7 attention, its launches against the prediction
     (UNFUSED_PER_STEP) and its profile; (b) SVDControlNetPipeline with
     ModelBundle(kernels=UNFUSED), two requests: s/request, s/denoise-step,
     peak memory, launches per kernel against the prediction;
  8. the hint encoder's variants at 14x576x1024 on phase 3's parameters,
     the hint encoder swapped: (a) kernel A at the temp variant's
     per-video GroupNorm shape (2, 129024, 320) against its plain version,
     with F.group_norm's time; (b) each variant's hint embedding (bbox,
     cam, rot, entity, temp) on the CFG batch, kernels against plain, its
     launches (temp: A once, B twice; the others none), and another value
     of its condition moving it; temp again under UNFUSED (kernel 8 on its
     blocks' LayerNorms, 258048 rows); (c) bbox, cam, rot and temp through
     SVDControlNetPipeline, one request each (cam a second one with
     another camera, whose latents must differ), launches against phase
     4's per request; entity through controlnet_forward with two maps;
  9. the denoise loop as one captured CUDA graph against the eager loop
     (pipeline.svd_controlnet.denoise_eager), 4 steps from the same inputs,
     at 14x576x1024 default and 14x320x576 un-fused: bitwise equal where
     two eager runs are (else within their spread), the same launches,
     s/denoise-step eager and graphed (the median of 4 calls each, taken
     in turns), capture and instantiation seconds, device time and busy
     share under torch.profiler, where each port kernel's device launches
     in the graphed run must equal the eager run's and, for the kernels of
     one device launch a call, the launches the graph's replays added to
     the counts; the un-fused graphed step must
     not be slower than the eager one; then generate() called directly (8
     Euler steps), twice with the eager loop (the loop before the graph)
     and twice with the graph (the first call captures it), s/request at
     each configuration, the outputs equal where two eager runs are;
 10. the data layer and the two drivers: (a) every port module imports
     with PIL, cv2, imageio, safetensors and tensorboard refused (the
     readers a card host may lack); rasterize_video on the card, hard and gaussian,
     at 14x576x1024 and 14x320x576 with 64 and 256 trajectories, against
     the CPU on three frames (gaussian 1e-5; hard equal but near a
     threshold), ms and peak memory; the host C++ library built with g++,
     ms a video, its disagreements with the card's hard mode only on
     line-circle overlaps or near a threshold, and few; (b) the training
     CLI's loop (train/cli.train_loop), stage ft_cam at full width and
     depth, 14x320x576, batch 1, accumulation 2, 4 micro-steps on the CLI's
     TrajectoryVIPSegDataset (--rasterizer native, --cam_norm) over a
     VIPSeg-layout folder of 720p JPEGs written under build/, through
     PrefetchLoader with 8 workers, a checkpoint and the diffusers exports
     at step 4 and a 25-step validation render: finite losses, 4 metrics
     lines, the checkpoint restored bitwise, the exports the converter's
     state dicts of the live ControlNet and EMA, the render finite and its
     GIF written, every training kernel launched; save and export seconds and
     bytes; s/micro-step through the loop against Trainer.step alone in
     turns, the loop's busy share; (c) the inference driver:
     build_pipeline, then blender_sample with --bbox at 14x576x1024 and
     vipseg_sample (base) at 14x320x576 with a host-library control, each
     bitwise a direct pipeline call and launching phase 4's kernels a
     request; s/request;
 11. single-video sharded serving (parallel/serve.py): (a) kernel A's
     split form (statistics launch, the sums added across W blocks, apply
     launch) on the two W halves, drawn apart, of (14, 72, 32, 320) and
     (28, 72, 128, 320) bf16 +temb +SiLU and of (2, 14, 72, 128, 320) with
     its per-frame addend, against the one-launch A and the plain version
     (A's tolerance), which a half normalised by its own statistics must
     fail; the sweep: every rank-local shape group_norm_silu hands the
     split form at 14x576x1024 on the (1, 2), (2, 2) and (2, 4) meshes,
     derived from kernel_sweep's record of one generate() (the calls of the
     hint and the step, H sharded, W / sp, the CFG batch / cfg; the step's
     split calls must be its 152 GroupNorms), each over its sp blocks drawn
     apart, held the same way; then stats and apply timed at the (2,
     4)-local (14, 72, 32, 320) and the full shape, device time with L2
     flushed before each call (a 256 MB write) and warm, and a call by CUDA
     events cold and warm, beside one-launch A, the plain versions,
     torch.var_mean / F.group_norm and the bounds, a split GroupNorm two
     device kernels; (b) kernel 7 at the shapes of the
     gathered K/V, q (14, 2304) / kv (14, 9216) and q (14, 576) / kv (14,
     2304), and square at (28, 9216), against its plain version, beside
     SDPA and the bound; (c) generate_sharded on a (1, 1) mesh through a
     one-rank NCCL group at 14x576x1024, full width, CFG, two requests
     (the loop eager): s/request beside phase 4's, each request's
     launches, request 0's latents against generate() (graphed) under
     KernelConfig(qkvt_attn=False, temporal_attn=False) with its launches,
     within twice the spread of generate() itself from initial latents one
     float32 ulp apart; (d) only on a host with
     two cards: a (1, 2) mesh over NCCL, one process a card started by
     torch.multiprocessing, and (2, 2) where there are four, against (1, 1), s/request of each (else "phase
     11(d) not run: 1 device", not counted as passed);
 12. the ("data", "model") mesh (parallel/mesh.py): (a) a (1, 1) mesh
     through a one-rank NCCL group at full width: Trainer(mesh=), four
     graphed micro-steps at 14x320x576 (two updates), against the
     unsharded Trainer from the same state and draws, masters, EMA,
     moments and accumulator bitwise (every collective has size 1), every
     training kernel launched, s/micro-step and s/optimizer-step beside
     phase 5(e)'s; SVDControlNetPipeline(mesh=) on a batch of 2 at
     14x576x1024, CFG, frames bitwise the pipeline's without a mesh,
     s/request and launches a request; (b) (2, 1) and (1, 2) trainers in
     two processes sharing the card over gloo with CUDA tensors (NCCL
     refuses two ranks on one device), phase 5(g)'s depth, global batch 2,
     against the unsharded Trainer on the same batch: Adam's first moment
     after each update within 2e-2 relative RMS for (2, 1) (bf16 batch-1
     against batch-2 forwards; the parameters' change printed beside one
     device's own spread from pixels one float32 ulp apart: Adam amplifies
     the noise), the moments and the change within 1e-3 for (1, 2), every
     rank's weights and EMA bitwise
     alike, every training kernel launched on every rank; (d) only on a
     host with four cards: (2, 1), (1, 2) on two and (2, 2) on four over
     NCCL at full depth, the same checks, and a batch of 4 served on each
     against one card's, s/optimizer-step and s/request beside one card's
     (else "phase 12(d) not run: 1 device", not counted as passed);
 13. the tools (posetraj_torch/tools, utils/profiling.py): (a) the kernel
     sweep: every kernel instance generate() dispatches under the default
     KernelConfig at 14x576x1024 and 14x320x576 and under UNFUSED at
     14x320x576, recorded from one eager generate() each on phase 3's
     parameters and replayed alone against its plain version at phase 2's
     tolerance (no deadline, no skip-cache: a shed or cached instance
     fails), the distinct instances of each kernel printed (every line in
     build/kernel_sweep.log); (b) bench_train_step() at full width,
     14x320x576, its JSON line; (c) two flagship requests (the first
     captures the denoise loop's graph, the second replays it) under
     StageTimer, the pipeline's CLIP, VAE encode, hint, denoise and decode
     wrapped, the stages within 2% of each request's wall time; trace() of
     one replay of that graph (a Chrome trace under build/, removed); the
     frozen encodes of encode_outside_step at the training shape under the
     timer; (d) the parity gate: a diffusers-layout checkpoint of phase 3's
     parameters under build/ (the recorded config.json files, the weights
     through the converter's direct export), verify_against_expected
     empty, parity_gate.main --skip-reference at its defaults exits 0, its
     latents bit for bit generate()'s on the in-memory parameters (or
     within the spread of two generate() calls); the directory removed;
  7. (printed last) a `kernels` summary, the JSON line of kernel numbers,
     and the last line {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. Weights are random, from a
seed; the zero-initialised ControlNet heads get small random values so the
ControlNet branch reaches the output, and Wq, Wk are scaled so that the
attention is peaked (QK_SCALE).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# Bytes of distinct inputs a timing takes in turn where one input would stay
# in the 50 MB L2 of an H100 SXM: four times it.
L2_ROTATE = 4 * 50 * 2**20

KERNEL_META = {
    "groupnorm": ("posetraj_torch/csrc/groupnorm.cu", "posetraj_tpu/ops/pallas_groupnorm.py:209"),
    "gn_stats": ("posetraj_torch/csrc/groupnorm.cu", "posetraj_tpu/ops/pallas_groupnorm.py:133"),
    "gn_apply": ("posetraj_torch/csrc/groupnorm.cu", "posetraj_tpu/ops/pallas_groupnorm.py:159"),
    "gemm": ("posetraj_torch/csrc/gemm.cuh", "posetraj_tpu/ops/pallas_qkvt.py:87"),
    "mlp": ("posetraj_torch/csrc/mlp.cu", "posetraj_tpu/ops/pallas_mlp.py:129"),
    "qkvt": ("posetraj_torch/csrc/qkvt.cu", "posetraj_tpu/ops/pallas_qkvt.py:367"),
    "temporal": ("posetraj_torch/csrc/temporal.cu", "posetraj_tpu/ops/pallas_temporal.py:299"),
    "frame_attn": ("posetraj_torch/csrc/temporal.cu", "posetraj_tpu/ops/pallas_temporal.py:178"),
    "flash_fwd": ("posetraj_torch/csrc/flash.cu", "posetraj_tpu/ops/pallas_attention.py:439"),
    "flash_bwd": ("posetraj_torch/csrc/flash.cu", "posetraj_tpu/ops/pallas_attention.py:484"),
    "flash_tq": ("posetraj_torch/csrc/flash.cu", "posetraj_tpu/ops/pallas_attention.py:183"),
    "flash_qkv": ("posetraj_torch/csrc/flash.cu", "posetraj_tpu/ops/pallas_attention.py:655"),
    "layernorm": ("posetraj_torch/csrc/layernorm.cu", "posetraj_tpu/ops/pallas_groupnorm.py:324"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median milliseconds of one call, from CUDA events around `inner`
    calls, over `reps` repetitions, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rotating(inputs, fn):
    """A call of fn on the next of `inputs` in turn."""
    turn = itertools.cycle(inputs)
    return lambda: fn(next(turn))


def _profiled(torch, fn, calls: int, flush=None):
    """The device kernels of `calls` calls of fn under torch.profiler (after
    one call outside it), `flush` run before each call where given."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PREROLL):  # spin kernels take the records a window may miss (profile_step)
            torch.cuda._sleep(1000)
        for _ in range(calls):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    return device_kernels(torch, prof)


def device_kernels(torch, prof):
    """The kernels of a torch.profiler window: its CUDA-device events less
    the spin kernels (PROFILE_PREROLL) and the user annotations, the
    mirrors that the program's spans (utils/profiling.py, on while a
    profiler records) leave on the device's timeline over the kernels they
    cover."""
    return [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.is_user_annotation and "spin_kernel" not in ev.name]


def profiled_kernel_ms(torch, fn, key: str, calls: int = 3) -> float:
    """Mean device milliseconds per call of the kernels whose name holds
    `key`, over `calls` warm calls of fn under torch.profiler."""
    total = sum((ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total)
                for ev in _profiled(torch, fn, calls) if key in ev.name)
    return total / calls / 1e3


def profiled_kernel_count(torch, fn, windows: int = 5) -> int:
    """Device kernels a call of fn launches, by torch.profiler: the median
    over one-call windows (a window can miss a record)."""
    return int(statistics.median(len(_profiled(torch, fn, 1)) for _ in range(windows)))


def cold_kernel_ms(torch, fn, key: str, kernels: int, flush, windows: int = 10) -> float:
    """Median device milliseconds of one call of fn with `flush` run just
    before it, by torch.profiler: one call a window, a window kept only if
    it recorded fn's `kernels` device kernels whose name holds `key` (the
    profiler can miss records in a process that has profiled before).
    Fails if none did."""
    times, seen = [], []
    for _ in range(windows):
        window = _profiled(torch, fn, 1, flush)
        evs = [ev for ev in window if key in ev.name]
        seen.append(len(window))
        if len(evs) == kernels:
            times.append(sum((ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total)
                             for ev in evs) / 1e3)
    if not times:
        fail(f"torch.profiler recorded no L2-cold call's {kernels} '{key}' kernels in {windows} windows (device "
             f"records a window: {seen}; the last window's: {sorted({ev.name[:60] for ev in window})})")
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, tol: float, base=None, rms_tol=None):
    """Kernel output `got` against the plain output `want`: the max abs error
    must be within `tol` times the reference's max, and the error's RMS within
    `rms_tol` of the reference's RMS. With `base` (a sub-layer's residual
    term) the reference is the branch want - base. The one copy is
    posetraj_torch/tools/kernel_sweep.py's, which phase 13's sweep uses."""
    from posetraj_torch.tools.kernel_sweep import compare as sweep_compare

    return sweep_compare(got, want, tol, base, rms_tol)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(torch, ops):
    # Each kernel's tolerance is kernel_sweep's, which phase 13 holds every
    # dispatched instance to.
    from posetraj_torch.tools.kernel_sweep import FLOAT32_LAYERNORM_TOLERANCE
    from posetraj_torch.tools.kernel_sweep import TOLERANCES as TOL

    groupnorm, mlp, qkvt, temporal, flash, layernorm, gemm = ops
    F = torch.nn.functional
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(1234)

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def ln_params(c):
        return rnd(c, scale=0.1, dtype=torch.float32) + 1.0, rnd(c, scale=0.1, dtype=torch.float32)

    def sublayer_args(shape, sigma):
        """Inputs of kernel C or D. Wq and Wk are scaled so that the logits
        q.k/8 have standard deviation `sigma`; x is small beside the branch
        (LayerNorm makes q, k, v independent of its scale), so the bf16
        output resolves the attention branch that the check compares."""
        c = shape[-1]
        wqkv = rnd(3 * c, c, scale=c**-0.5)
        wqkv[: 2 * c] *= sigma**0.5
        return (rnd(*shape, scale=0.1), *ln_params(c), wqkv, rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), c // 64)

    rows, cores, mlp_levels, gemm_shapes, ok_all = [], [], [], [], True

    def report(name, label, err, scale, rel_rms, ok, tol, rms_tol=None, branch=False):
        nonlocal ok_all
        ok_all &= ok
        rms = f" (tol {rms_tol:g})" if rms_tol is not None else ""
        say(f"  {name:9s} {label:50s} max_abs_err={err:.4g} (|{'branch' if branch else 'ref'}|max {scale:.3g}, "
            f"tol {tol:g}x) rel_rms={rel_rms:.3g}{rms} {'ok' if ok else 'FAIL'}")

    # A: GroupNorm. Timed shape: UNet level-0 resnet norm2 with the temb fold
    # and SiLU, (28, 72, 128, 320) bf16. Also checked: the temporal resnet's
    # per-frame fold, a ragged row count (1517 rows a sample, which no team
    # of the schedule divides evenly), the float32 VAE encode, and a
    # full-resolution VAE decode chunk (14, 576, 1024, 128) of more than
    # 2^28 elements (one team, the second read from HBM).
    tol = TOL["groupnorm.group_norm"][0]
    w, b = ln_params(320)
    x, add = rnd(28, 72, 128, 320), rnd(28, 320)
    run_k = lambda: groupnorm.group_norm_kernel(x, w, b, 32, 1e-5, True, add)
    run_p = lambda: groupnorm.group_norm_plain(x, w, b, 32, 1e-5, True, add)
    err_a, scale, rel_rms, ok = compare(run_k(), run_p(), tol)
    report("groupnorm", "(28,72,128,320) bf16 +temb +silu", err_a, scale, rel_rms, ok, tol)
    ms, plain = cuda_ms(run_k), cuda_ms(run_p)
    xc = x.permute(0, 3, 1, 2)
    lib = cuda_ms(lambda: F.group_norm(xc, 32, w.to(bf), b.to(bf), 1e-5))
    n = x.numel()
    bnd, by = bound_ms(2 * n * 2 + add.numel() * 2, 10 * n, FP32_FLOPS)
    rows.append(dict(name="groupnorm", max_abs_err=err_a, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                     library_ms=lib))
    for label, xs, a_shape, dtype, eps in (
        ("(2,14,72,128,320) bf16 per-frame temb", (2, 14, 72, 128, 320), (2, 14, 320), bf, 1e-6),
        ("(5,37,41,320) bf16 ragged rows +temb", (5, 37, 41, 320), (5, 320), bf, 1e-5),
        ("(1,576,1024,128) float32 (VAE encode)", (1, 576, 1024, 128), None, torch.float32, 1e-6),
        ("(14,576,1024,128) bf16 (VAE decode, >2^28)", (14, 576, 1024, 128), None, bf, 1e-6),
    ):
        w2, b2 = ln_params(xs[-1])
        x2 = rnd(*xs, dtype=dtype) + 0.5
        a2 = rnd(*a_shape) if a_shape else None
        err, scale, rel_rms, ok = compare(groupnorm.group_norm_kernel(x2, w2, b2, 32, eps, True, a2),
                                          groupnorm.group_norm_plain(x2, w2, b2, 32, eps, True, a2), tol)
        report("groupnorm", label, err, scale, rel_rms, ok, tol)
        rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del x2, a2
    torch.cuda.empty_cache()

    # B: fused LN + GEGLU MLP on the Hopper GEMM, at the three UNet levels of
    # 576x1024 with the addend the model folds in (rows 28*S, K 320, 640,
    # 1280, hidden 4K), each timed beside its plain version and, as a
    # yardstick, the two F.linear products alone (no one call computes B:
    # library_ms is null); the JSON row is level 0. Then every variant at the
    # ragged 320x576 level-1 rows 28*720 (the last 128-row tile holds 64):
    # no LayerNorm, LayerNorm without residual, LayerNorm + residual +
    # addend (G, 1, K) and (G, S_a, K). The check is on the MLP branch,
    # out - (x + add).
    tol, rms_tol = TOL["mlp.geglu_mlp"]
    mlp_cases = [(f"level {lv}", m, k, True, True, a) for lv, (m, k, a) in
                 enumerate(((28 * 9216, 320, (28, 1, 320)), (28 * 2304, 640, (2, 2304, 640)),
                            (28 * 576, 1280, (28, 1, 1280))))]
    mlp_cases += [("ragged, no LN", 28 * 720, 640, False, False, None), ("ragged, LN", 28 * 720, 640, True, False, None),
                  ("ragged", 28 * 720, 640, True, True, (28, 1, 640)), ("ragged", 28 * 720, 640, True, True, (2, 720, 640))]
    for case, (label, m, k, ln, res, add_shape) in enumerate(mlp_cases):
        n4 = 4 * k
        args = [rnd(m, k), rnd(2 * n4, k, scale=k**-0.5), rnd(2 * n4, scale=0.1), rnd(k, n4, scale=n4**-0.5),
                rnd(k, scale=0.1), *(ln_params(k) if ln else (None, None))]
        addm = rnd(*add_shape) if add_shape else None
        run_k = lambda: mlp.geglu_mlp_kernel(*args, 1e-5, res, addm)
        run_p = lambda: mlp.geglu_mlp_plain(*args, 1e-5, res, addm)
        base = (mlp.broadcast_add_rows(args[0], addm) if addm is not None else args[0]) if res else None
        err, scale, rel_rms, ok = compare(run_k(), run_p(), tol, base, rms_tol)
        report("mlp", f"{label}: rows={m} K={k} hidden={n4}{' +ln' if ln else ''}{' +res' if res else ''}"
               f"{f' +add{add_shape}' if add_shape else ''}", err, scale, rel_rms, ok, tol, rms_tol, branch=res)
        if case < 3:
            ms, plain = cuda_ms(run_k), cuda_ms(run_p)
            w1, w2 = args[1], args[3]
            hid = rnd(m, n4)
            linears = cuda_ms(lambda: (F.linear(args[0], w1), F.linear(hid, w2)))
            del hid
            flops = 2 * m * k * 2 * n4 + 2 * m * n4 * k
            nbytes = 2 * (2 * m * k + 3 * n4 * k + addm.numel())
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            mlp_levels.append(dict(label=label, rows=m, k=k, ms=ms, plain_ms=plain, linears_ms=linears, bound_ms=bnd))
            if case == 0:
                mlp_row = dict(name="mlp", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                               library_ms=None)
                rows.append(mlp_row)
        mlp_row["max_abs_err"] = max(mlp_row["max_abs_err"], err)
        del args, addm
    torch.cuda.empty_cache()

    # The Hopper GEMM of B, C and D alone at C's QKV (LN(x) (M, C) by
    # Wqkv (3C, C), stored) and out-projection (o by Wo (C, C) + bo + x)
    # shapes at the three levels of 576x1024 (M = 28*S), beside F.linear of
    # the same product (no residual add) as the library yardstick; the JSON
    # row is the level-0 QKV product. Output within B's tolerances of the
    # plain product.
    for lv, (s_l, c) in enumerate(((9216, 320), (2304, 640), (576, 1280))):
        m = 28 * s_l
        a, o = rnd(m, c), rnd(m, c)
        wq, wo, bo, x = rnd(3 * c, c, scale=c**-0.5), rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), rnd(m, c)
        for what, args, lib_args in (("QKV", (a, wq), (a, wq)), ("out-proj +bias +res", (o, wo, bo, x), (o, wo, bo))):
            run_k = lambda: gemm.linear_kernel(*args)
            run_p = lambda: gemm.linear_plain(*args)
            err, scale, rel_rms, ok = compare(run_k(), run_p(), tol, args[3] if len(args) > 3 else None, rms_tol)
            n = args[1].shape[0]
            report("gemm", f"{what} level {lv}: (M,N,K)=({m},{n},{c})", err, scale, rel_rms, ok, tol, rms_tol,
                   branch=len(args) > 3)
            ms, plain = cuda_ms(run_k), cuda_ms(run_p)
            lib = cuda_ms(lambda: F.linear(*lib_args))
            nbytes = 2 * (m * c + n * c + m * n * (2 if len(args) > 3 else 1) + (n if len(args) > 2 else 0))
            bnd, by = bound_ms(nbytes, 2.0 * m * n * c, BF16_FLOPS)
            gemm_shapes.append(dict(label=f"{what} level {lv}", shape=(m, n, c), ms=ms, plain_ms=plain, library_ms=lib,
                                    bound_ms=bnd, bound_by=by))
            if lv == 0 and what == "QKV":
                rows.append(dict(name="gemm", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                                 library_ms=lib))
            else:
                rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del a, o, wq, wo, bo, x
    torch.cuda.empty_cache()

    # C: spatial attention sub-layer at the three UNet levels of 576x1024 and
    # of 320x576 (S = 2880, 720, 180: ragged for the 128-query tiles, and
    # 720 and 180 for the 64-key tiles too), CFG batch 28. The check is on
    # the branch out - x. Logits get sigma^2 = ln(S / 64), so that about 64
    # keys carry each query's weight and the attention pattern, not the mean
    # of V, makes the branch; a key mask that let the padded keys in would
    # move it by 2-4% at S = 720 and 180, above the RMS tolerance.
    tol, rms_tol = TOL["qkvt.attn_sublayer"]
    for level, (bsz, s, c) in enumerate(((28, 9216, 320), (28, 2304, 640), (28, 576, 1280), (28, 2880, 320),
                                         (28, 720, 640), (28, 180, 1280))):
        sigma = max(1.0, np.log(s / 64)) ** 0.5
        a = sublayer_args((bsz, s, c), sigma)
        run_k = lambda: qkvt.attn_sublayer_kernel(*a)
        run_p = lambda: qkvt.attn_sublayer_plain(*a)
        err, scale, rel_rms, ok = compare(run_k(), run_p(), tol, a[0], rms_tol)
        report("qkvt", f"(B,S,C)=({bsz},{s},{c}) heads={c // 64} logit sd {sigma:.2f}", err, scale, rel_rms, ok,
               tol, rms_tol, branch=True)
        if level == 0:
            ms, plain = cuda_ms(run_k, reps=3, inner=2), cuda_ms(run_p, reps=3, inner=1)
            m = bsz * s
            flops = 2 * m * c * 3 * c + 4 * bsz * (c // 64) * s * s * 64 + 2 * m * c * c
            nbytes = 2 * (2 * m * c + 4 * c * c + c)
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            # No one PyTorch call computes the sub-layer (LN, projections,
            # attention, residual): library_ms is null; the attention core
            # is held against SDPA on its own below.
            rows.append(dict(name="qkvt", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=None))
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del a
    torch.cuda.empty_cache()

    # C's attention core alone: the shared forward on C's q/k/v scratch
    # (3, B, heads, S, 64), o as (B, S, C), at the level-0 S of both
    # resolutions, beside SDPA on the same (B, heads, S, 64) tensors and the
    # bound 4 B N S^2 d at the dense peak; checked against the plain forward
    # at S = 2880.
    for s in (9216, 2880):
        bsz, heads = 28, 5
        scratch = rnd(3, bsz, heads, s, 64)
        qc, kc, vc = (t.permute(0, 2, 1, 3) for t in scratch)
        run_k = lambda: flash._launch_fwd(qc, kc, vc, 0.125, False, "flash_tq")[0]
        if s == 2880:
            t7, r7 = TOL["flash.flash_attention_tq"]
            err, sc, rr, ok = compare(run_k(), flash.flash_attention_tq_plain(qc, kc, vc, 0.125), t7, rms_tol=r7)
            report("qkvt", f"attention core (B,N,S,d)=({bsz},{heads},{s},64)", err, sc, rr, ok, t7, r7)
        ms = cuda_ms(run_k, reps=5, inner=2)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(scratch[0], scratch[1], scratch[2]), reps=5, inner=2)
        bnd, _ = bound_ms(2 * 4 * bsz * heads * s * 64, 4.0 * bsz * heads * s * s * 64, BF16_FLOPS)
        cores.append(dict(name="qkvt core", shape=(bsz, heads, s, 64), ms=ms, sdpa_ms=lib, bound_ms=bnd,
                          bound_by="operations", where="alone"))
        del scratch, qc, kc, vc
    torch.cuda.empty_cache()

    # D: temporal sub-layer, x (2, 14, S, C) at the three levels; logits of
    # standard deviation 1 over the 14 frames. The check is on out - x.
    tol, rms_tol = TOL["temporal.temporal_attn_sublayer"]
    for level, (s, c) in enumerate(((9216, 320), (2304, 640), (576, 1280))):
        heads, f = c // 64, 14
        a = sublayer_args((2, f, s, c), 1.0)
        run_k = lambda: temporal.temporal_attn_sublayer_kernel(*a)
        run_p = lambda: temporal.temporal_attn_sublayer_plain(*a)
        err, scale, rel_rms, ok = compare(run_k(), run_p(), tol, a[0], rms_tol)
        report("temporal", f"(B,F,S,C)=(2,{f},{s},{c}) heads={heads}", err, scale, rel_rms, ok, tol, rms_tol,
               branch=True)
        if level == 0:
            ms, plain = cuda_ms(run_k), cuda_ms(run_p)
            m = 2 * f * s
            flops = 2 * m * c * 3 * c + 4 * 2 * s * heads * f * f * 64 + 2 * m * c * c
            nbytes = 2 * (2 * m * c + 4 * c * c + c)
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            rows.append(dict(name="temporal", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=None))
            # D's frame-attention core inside the sub-layer (its kernel's
            # device time, from torch.profiler).
            core_in_d = profiled_kernel_ms(torch, run_k, "frame_attn")
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del a
    torch.cuda.empty_cache()

    # D's frame-attention core alone (temporal.frame_attention_kernel) on a
    # QKV scratch (2, 14, S, 3C) at the three levels, logits of standard
    # deviation 1, against the plain frame_attention on the same q, k, v;
    # level 0 timed beside the plain version and SDPA on (2 S, heads, 14,
    # 64) copies of the same q, k, v. Bound: bytes (q, k, v read once, o
    # written once).
    for level, (s, c) in enumerate(((9216, 320), (2304, 640), (576, 1280))):
        heads, f = c // 64, 14
        qkv = rnd(2, f, s, 3 * c)
        run_k = lambda: temporal.frame_attention_kernel(qkv, heads)
        run_p = lambda: temporal.frame_attention(*qkv.chunk(3, dim=-1), heads)
        err, scale, rel_rms, ok = compare(run_k(), run_p(), tol, rms_tol=rms_tol)
        report("frame_attn", f"(B,F,S,C)=(2,{f},{s},{c}) heads={heads} core alone", err, scale, rel_rms, ok, tol,
               rms_tol)
        if level == 0:
            ms, plain = cuda_ms(run_k, reps=7, inner=10), cuda_ms(run_p)
            qs, ks, vs = (t.reshape(2, f, s, heads, 64).permute(0, 2, 3, 1, 4).reshape(2 * s, heads, f, 64).contiguous()
                          for t in qkv.chunk(3, dim=-1))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), reps=7, inner=10)
            bnd, by = bound_ms(2 * 4 * 2 * f * s * c, 4.0 * 2 * s * heads * f * f * 64, BF16_FLOPS)
            rows.append(dict(name="frame_attn", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=lib))
            cores.append(dict(name="temporal core", shape=(2 * s, heads, f, 64), ms=core_in_d, sdpa_ms=lib,
                              bound_ms=bnd, bound_by=by, where="in D, profiler"))
            del qs, ks, vs
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del qkv
    torch.cuda.empty_cache()

    # 5: flash attention forward and backward over head-folded (BN, S, 64)
    # tensors at the training shapes: the video loss at 320x576 (14 frames
    # x 5 heads at S = 2880, x 10 heads at S = 720) and the spatial loss's
    # single frame (5 heads at S = 2880); then a ragged S = 200, a
    # rectangular Skv = 2 Sq and a head_dim 128 case. Logits of sd
    # sqrt(ln(S/64)), as for C. o, dq, dk, dv: max error within 3e-2 of the
    # reference's max and rel RMS within 1e-2; lse (base 2) within 2e-3.
    # The backward is fed the plain forward's o and lse, so each half is
    # held on its own. A kernel whose lse or p dropped log2(e) would be off
    # by a factor in every p, far outside the RMS limit.
    (tol, rms_tol), lse_tol = TOL["flash.flash_attention"], 2e-3
    for case, (bn, sq, skv, d) in enumerate(((70, 2880, 2880, 64), (140, 720, 720, 64), (5, 2880, 2880, 64),
                                             (28, 200, 200, 64), (14, 720, 1440, 64), (14, 720, 720, 128))):
        sigma = max(1.0, np.log(skv / 64)) ** 0.5
        q, k = rnd(bn, sq, d, scale=sigma**0.5), rnd(bn, skv, d, scale=sigma**0.5)
        v, do = rnd(bn, skv, d), rnd(bn, sq, d)
        scale = d**-0.5
        o, lse = flash.flash_fwd_kernel(q, k, v, scale)
        o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale)
        err_o, sc_o, rr_o, ok_o = compare(o, o_ref, tol, rms_tol=rms_tol)
        err_l = float((lse - lse_ref).abs().max())
        ok_l = err_l <= lse_tol
        report("flash_fwd", f"(BN,Sq,Skv,d)=({bn},{sq},{skv},{d}) o", err_o, sc_o, rr_o, ok_o, tol, rms_tol)
        say(f"  {'flash_fwd':9s} {'':50s} lse max_abs_err={err_l:.3g} (tol {lse_tol:g}) {'ok' if ok_l else 'FAIL'}")
        ok_all &= ok_l
        grads = flash.flash_bwd_kernel(q, k, v, o_ref, lse_ref, do, scale)
        want = flash.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, scale)
        err_b = 0.0
        for gname, got_g, want_g in zip(("dq", "dk", "dv"), grads, want):
            err, sc, rr, ok = compare(got_g, want_g, tol, rms_tol=rms_tol)
            report("flash_bwd", f"(BN,Sq,Skv,d)=({bn},{sq},{skv},{d}) {gname}", err, sc, rr, ok, tol, rms_tol)
            err_b = max(err_b, err)
        if case == 0:
            ms_f = cuda_ms(lambda: flash.flash_fwd_kernel(q, k, v, scale))
            plain_f = cuda_ms(lambda: flash.flash_fwd_plain(q, k, v, scale), reps=3, inner=1)
            ms_b = cuda_ms(lambda: flash.flash_bwd_kernel(q, k, v, o_ref, lse_ref, do, scale))
            plain_b = cuda_ms(lambda: flash.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, scale), reps=3, inner=1)
            # Library yardstick: SDPA on the (B, H, S, d) view, its forward
            # and, alone, the backward of one recorded forward.
            heads = 5
            qs, ks, vs = (t.reshape(bn // heads, heads, t.shape[1], d).detach().requires_grad_(True)
                          for t in (q, k, v))
            lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
            out_s = F.scaled_dot_product_attention(qs, ks, vs)
            do_s = do.reshape(out_s.shape)
            lib_b = cuda_ms(lambda: torch.autograd.grad(out_s, (qs, ks, vs), do_s, retain_graph=True))
            e = 2  # bf16 bytes
            fwd_bytes = e * (2 * bn * sq * d + 2 * bn * skv * d) + 4 * bn * sq
            bwd_bytes = e * (3 * bn * sq * d + 2 * bn * skv * d) + 4 * bn * sq + e * (bn * sq * d + 2 * bn * skv * d)
            bnd_f, by_f = bound_ms(fwd_bytes, 4.0 * bn * sq * skv * d, BF16_FLOPS)
            bnd_b, by_b = bound_ms(bwd_bytes, 10.0 * bn * sq * skv * d, BF16_FLOPS)
            rows.append(dict(name="flash_fwd", max_abs_err=err_o, ms=ms_f, plain_ms=plain_f, bound_ms=bnd_f,
                             bound_by=by_f, library_ms=lib_f))
            rows.append(dict(name="flash_bwd", max_abs_err=err_b, ms=ms_b, plain_ms=plain_b, bound_ms=bnd_b,
                             bound_by=by_b, library_ms=lib_b))
            del qs, ks, vs, out_s, do_s
        else:
            flash_rows = {r["name"]: r for r in rows if r["name"].startswith("flash")}
            flash_rows["flash_fwd"]["max_abs_err"] = max(flash_rows["flash_fwd"]["max_abs_err"], err_o)
            flash_rows["flash_bwd"]["max_abs_err"] = max(flash_rows["flash_bwd"]["max_abs_err"], err_b)
        del q, k, v, do, o, lse, o_ref, lse_ref, grads, want
    torch.cuda.empty_cache()

    # 7: forward-only flash attention at the un-fused path's shapes (phase
    # 6): the spatial self-attention of 14x320x576 at levels 0 and 1, B*F =
    # 28, read in place from the q, k, v views of a packed (B, S, 3C)
    # projection as self_attention_qkv splits it; then a ragged rectangular
    # case (Sq 200, Skv 400). o within 3e-2 of the reference's max and 1e-2
    # in rel RMS, as kernel 5's; logits of sd sqrt(ln(Skv/64)).
    tol, rms_tol = TOL["flash.flash_attention_tq"]
    for case, (bsz, sq, skv, heads) in enumerate(((28, 2880, 2880, 5), (28, 720, 720, 10), (4, 200, 400, 5))):
        c, d = heads * 64, 64
        sigma = max(1.0, np.log(skv / 64)) ** 0.5
        if sq == skv:
            qkv = rnd(bsz, sq, 3 * c)
            qkv[..., : 2 * c] *= sigma**0.5
            q, k, v = (t.unflatten(-1, (heads, d)) for t in qkv.split(c, dim=-1))
        else:
            q = rnd(bsz, sq, heads, d, scale=sigma**0.5)
            k, v = rnd(bsz, skv, heads, d, scale=sigma**0.5), rnd(bsz, skv, heads, d)
        scale = d**-0.5
        run_k = lambda: flash.flash_attention_tq(q, k, v, scale)
        run_p = lambda: flash.flash_attention_tq_plain(q, k, v, scale)
        err, sc, rr, ok = compare(run_k(), run_p(), tol, rms_tol=rms_tol)
        report("flash_tq", f"(B,Sq,Skv,N,d)=({bsz},{sq},{skv},{heads},{d}){' packed views' if sq == skv else ''}",
               err, sc, rr, ok, tol, rms_tol)
        if case == 0:
            ms, plain = cuda_ms(run_k), cuda_ms(run_p, reps=3, inner=1)
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
            nbytes = 2 * (2 * bsz * sq * c + 2 * bsz * skv * c)
            bnd, by = bound_ms(nbytes, 4.0 * bsz * heads * sq * skv * d, BF16_FLOPS)
            rows.append(dict(name="flash_tq", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=lib))
            del qs, ks, vs
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del q, k, v
    torch.cuda.empty_cache()

    # 6: packed-QKV flash attention at head_dim 128 (no SVD configuration
    # has it), timed at the level-0 width of 320x576 as 5 heads of 128, and
    # a ragged S = 600: o and the base-2 lse against the plain version, and
    # the gradient of qkv through FlashAttentionQKV (kernel 5's backward on
    # the kernel's own o and lse) against the plain backward of the plain
    # forward. Tolerances as kernel 5's.
    (tol, rms_tol), lse_tol = TOL["flash.flash_attention_qkv"], 2e-3
    for case, (bsz, s, heads) in enumerate(((28, 2880, 5), (3, 600, 2))):
        d = 128
        c = heads * d
        sigma = max(1.0, np.log(s / 64)) ** 0.5
        qkv = rnd(bsz, s, 3 * c)
        qkv[..., : 2 * c] *= sigma**0.5
        scale = d**-0.5
        o, lse = flash.flash_qkv_kernel(qkv, heads, scale)
        o_ref, lse_ref = flash.flash_qkv_plain(qkv, heads, scale)
        err_o, sc_o, rr_o, ok_o = compare(o, o_ref, tol, rms_tol=rms_tol)
        err_l = float((lse - lse_ref).abs().max())
        ok_l = err_l <= lse_tol
        report("flash_qkv", f"(B,S,N,d)=({bsz},{s},{heads},{d}) o", err_o, sc_o, rr_o, ok_o, tol, rms_tol)
        say(f"  {'flash_qkv':9s} {'':50s} lse max_abs_err={err_l:.3g} (tol {lse_tol:g}) {'ok' if ok_l else 'FAIL'}")
        ok_all &= ok_l
        do = rnd(bsz, s, c)
        leaf = qkv.clone().requires_grad_(True)
        flash.flash_attention_qkv(leaf, heads, scale).backward(do)
        fold = lambda t: flash._fold(t.unflatten(-1, (heads, d)))
        want = flash.flash_bwd_plain(*(fold(t) for t in qkv.split(c, dim=-1)), fold(o_ref),
                                     lse_ref.reshape(bsz * heads, s), fold(do), scale)
        for gname, got_g, want_g in zip(("dq", "dk", "dv"), leaf.grad.split(c, dim=-1), want):
            err, sc, rr, ok = compare(got_g, flash._unfold(want_g, bsz).reshape(bsz, s, c), tol, rms_tol=rms_tol)
            report("flash_qkv", f"(B,S,N,d)=({bsz},{s},{heads},{d}) {gname} via FlashAttentionQKV", err, sc, rr,
                   ok, tol, rms_tol)
        if case == 0:
            run_k = lambda: flash.flash_qkv_kernel(qkv, heads, scale)
            ms, plain = cuda_ms(run_k), cuda_ms(lambda: flash.flash_qkv_plain(qkv, heads, scale), reps=3, inner=1)
            qs, ks, vs = (t.unflatten(-1, (heads, d)).transpose(1, 2).contiguous() for t in qkv.split(c, dim=-1))
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
            nbytes = 2 * (3 * bsz * s * c + bsz * s * c) + 4 * bsz * heads * s
            bnd, by = bound_ms(nbytes, 4.0 * bsz * heads * s * s * d, BF16_FLOPS)
            rows.append(dict(name="flash_qkv", max_abs_err=err_o, ms=ms, plain_ms=plain, bound_ms=bnd,
                             bound_by=by, library_ms=lib))
            del qs, ks, vs
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err_o)
        del qkv, o, lse, o_ref, lse_ref, do, leaf, want
    torch.cuda.empty_cache()

    # 8: row LayerNorm at the main paths' shapes: the un-fused path's three
    # widths (rows B*F*S of 14x320x576 at levels 0-2) and the temp hint's
    # block LayerNorms (258048 rows) in bf16, and level 1 in float32. x has
    # a mean of 0.5 beside its unit spread, so a kernel that took E[x^2] -
    # mean^2 in float32 would lose digits; bf16: max error within 1e-2 of
    # the reference's max (one bf16 rounding apart) and rel RMS within 2e-3;
    # float32: 1e-5 and 1e-6 (summation order). Each shape is timed beside
    # its bound, the plain version and F.layer_norm (with w, b in x's type),
    # on copies of x taken in turn, together more than L2_ROTATE bytes, so
    # that each call reads its x from HBM as the path does: ms and
    # library_ms a call by CUDA events, as every row of phase 2; and each
    # call's device time under torch.profiler. On the main path kernel 8
    # runs inside the captured denoise graph, where no wrapper runs, so the
    # gate is on device time: half the bound at (80640, 320), and no slower
    # than F.layer_norm at every shape. A call's time is printed beside it:
    # at the small shapes it is the host's (the wrapper's Python and ctypes
    # against F.layer_norm's C++ dispatch).
    ln_lines = []
    for case, (m, c, dtype) in enumerate(((28 * 2880, 320, bf), (28 * 720, 640, bf), (28 * 180, 1280, bf),
                                          (2 * 14 * 9216, 320, bf), (28 * 720, 640, torch.float32))):
        tol, rms_tol = TOL["layernorm.layer_norm"] if dtype == bf else FLOAT32_LAYERNORM_TOLERANCE
        x_bytes = m * c * torch.finfo(dtype).bits // 8
        xs = [rnd(m, c, dtype=dtype) + 0.5 for _ in range(-(-L2_ROTATE // x_bytes))]
        w, b = ln_params(c)
        err, sc, rr, ok = compare(layernorm.layer_norm_kernel(xs[0], w, b, 1e-5),
                                  layernorm.layer_norm_plain(xs[0], w, b, 1e-5), tol, rms_tol=rms_tol)
        label = f"({m},{c}) {str(dtype).replace('torch.', '')}"
        report("layernorm", label, err, sc, rr, ok, tol, rms_tol)
        wb, bb = w.to(dtype), b.to(dtype)
        run_k = rotating(xs, lambda x: layernorm.layer_norm_kernel(x, w, b, 1e-5))
        run_l = rotating(xs, lambda x: F.layer_norm(x, (c,), wb, bb, 1e-5))
        run_p = rotating(xs, lambda x: layernorm.layer_norm_plain(x, w, b, 1e-5))
        dev_ms, lib_dev_ms = profiled_kernel_ms(torch, run_k, "", 10), profiled_kernel_ms(torch, run_l, "", 10)
        ms, lib = cuda_ms(run_k, reps=7, inner=10), cuda_ms(run_l, reps=7, inner=10)
        plain = cuda_ms(run_p)
        bnd, by = bound_ms(2 * x_bytes + 2 * 4 * c, 8.0 * m * c, FP32_FLOPS)
        fast = lib_dev_ms >= dev_ms and (case != 0 or dev_ms <= 2 * bnd)
        ok_all &= fast
        pl = layernorm.plan(m, c, dtype, *layernorm.occupancy(xs[0].device, dtype,
                                                              layernorm.layout(c, dtype.itemsize)[1]))
        ln_lines.append(f"  layernorm {label:22s} plan {pl.lanes} lanes x {pl.vecs} vectors, {pl.grid} CTAs; "
                        f"x {len(xs)} copies; device ms={dev_ms:.4f} bound_ms={bnd:.4f} ({by}, "
                        f"{bnd / dev_ms:.0%} of it) F.layer_norm device ms={lib_dev_ms:.4f} "
                        + ("ok" if fast else "FAIL (slower than F.layer_norm" + (" or than twice its bound)"
                                                                               if case == 0 else ")"))
                        + f"; a call by CUDA events: ms={ms:.4f} ({bnd / ms:.0%} of the bound) F.layer_norm "
                        f"{lib:.4f} ({'faster' if ms <= lib else 'slower'}); plain_ms={plain:.4f}")
        if case == 0:
            rows.append(dict(name="layernorm", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=lib))
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del xs
    torch.cuda.empty_cache()
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        say(f"  {r['name']:9s} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={lib}")
    for r in cores:
        say(f"  {r['name']:13s} {str(r['shape']):22s} ms={r['ms']:.4f} ({r['where']}) sdpa_ms={r['sdpa_ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    for r in mlp_levels:
        say(f"  mlp {r['label']}: rows={r['rows']} K={r['k']} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"two F.linear products {r['linears_ms']:.4f} bound_ms={r['bound_ms']:.4f} (operations)")
    for r in gemm_shapes:
        say(f"  gemm {r['label']:26s} (M,N,K)={r['shape']} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"F.linear {r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']})")
    for line in ln_lines:
        say(line)
    return rows, ok_all


def gates_check(torch, ops, native):
    """The dispatch gates of C and D on the card: spatial and temporal
    transformer blocks at head_dim 16 (ModelBundle.tiny()'s 32 channels, 2
    heads) and 128 (256 channels, 2 heads; a (5, 10, 10, 20)-heads UNet's
    1280 channels, 10 heads), bf16, S = 45, 3 frames, CFG batch 2: each
    runs without C or D, within the step tolerance (3e-2 rel RMS) of the
    same block with every kernel switch of the block off; then a direct
    call of each wrapper at head_dim 16 still raises."""
    from posetraj_torch.configs import KernelConfig, use_kernels
    from posetraj_torch.core.init import Init
    from posetraj_torch.models import transformer as tt

    qkvt, temporal = ops[2], ops[3]
    dev, bf, f, s, tol = torch.device("cuda"), torch.bfloat16, 3, 45, 3e-2
    plain = KernelConfig(qkvt_attn=False, temporal_attn=False, fused_ff=False)
    ok_all = True
    for dim, heads in ((32, 2), (256, 2), (1280, 10)):
        for temporal_block in (False, True):
            g = torch.Generator(device="cuda").manual_seed(dim + heads + temporal_block)
            init = tt.init_temporal_basic_transformer_block if temporal_block else tt.init_basic_transformer_block
            p = init(Init(g, dev, bf), dim, heads, 1024)
            x = torch.randn(2 * f, s, dim, generator=g, device="cuda").to(bf)
            if temporal_block:
                ctx = torch.randn(2, 1, s, 1024, generator=g, device="cuda").to(bf)
                run = lambda: tt.temporal_basic_transformer_block(p, x, f, heads, context=ctx)
            else:
                ctx = torch.randn(2 * f, 1, 1024, generator=g, device="cuda").to(bf)
                run = lambda: tt.basic_transformer_block(p, x, heads, context=ctx)
            native.reset_launches()
            with torch.inference_mode():
                with use_kernels(KernelConfig()):
                    got = run().float()
                torch.cuda.synchronize()
                launched = native.LAUNCHES["qkvt"] + native.LAUNCHES["temporal"] + native.LAUNCHES["frame_attn"]
                with use_kernels(plain):
                    want = run().float()
            rel = float((got - want).norm() / want.norm())
            ok = bool(torch.isfinite(got).all()) and launched == 0 and rel <= tol
            ok_all &= ok
            say(f"  gates     {'temporal' if temporal_block else 'spatial'} block C={dim} heads={heads} "
                f"(head_dim {dim // heads}): C/D launches {launched}, vs plain block rel_rms={rel:.3g} "
                f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    c = 32
    w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    wq, wo, bo = torch.randn(3 * c, c, device=dev, dtype=bf), torch.randn(c, c, device=dev, dtype=bf), torch.zeros(
        c, device=dev, dtype=bf)
    for name, call in (("qkvt.attn_sublayer", lambda: qkvt.attn_sublayer(torch.randn(2, s, c, device=dev, dtype=bf),
                                                                         w, b, wq, wo, bo, 2)),
                       ("temporal.temporal_attn_sublayer",
                        lambda: temporal.temporal_attn_sublayer(torch.randn(2, f, s, c, device=dev, dtype=bf), w, b,
                                                                wq, wo, bo, 2))):
        try:
            call()
            raised = False
        except ValueError:
            raised = True
        ok_all &= raised
        say(f"  gates     {name} called directly at head_dim 16: {'raises' if raised else 'did NOT raise'} "
            f"{'ok' if raised else 'FAIL'}")
    return ok_all


# ---------------------------------------------------------------------------
# Phases 3 and 4: the model
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched(*replacements):
    """Context that sets module attributes, given as (module, name, value)."""
    with contextlib.ExitStack() as stack:
        for module, name, value in replacements:
            stack.enter_context(mock.patch.object(module, name, value))
        yield


def plain_versions(ops):
    """Routes the model's kernel wrappers to their plain versions, autograd
    through plain PyTorch included (the reference of phases 3, 5 and 6): A-D,
    kernels 5 (the un-fused training path's attention() under grad), 6, 7
    and 8. The callers check that the plain runs launch nothing."""
    from posetraj_torch.ops.attention import dot_product_attention

    groupnorm, mlp, qkvt, temporal, flash, layernorm, _ = ops
    return patched((groupnorm, "group_norm", groupnorm.group_norm_plain), (mlp, "geglu_mlp", mlp.geglu_mlp_plain),
                   (qkvt, "attn_sublayer", qkvt.attn_sublayer_plain),
                   (temporal, "temporal_attn_sublayer", temporal.temporal_attn_sublayer_plain),
                   (flash, "flash_attention", dot_product_attention),
                   (flash, "flash_attention_tq", flash.flash_attention_tq_plain),
                   (flash, "flash_attention_qkv", lambda qkv, n, scale: flash.flash_qkv_plain(qkv, n, scale)[0]),
                   (layernorm, "layer_norm", layernorm.layer_norm_plain))


def uniform_attention(ops):
    """Zeroes Wq in every call of kernels C and D, so that each query weighs
    all keys alike: the step it gives shows how far the attention pattern
    moves the step's output."""
    qkvt, temporal = ops[2], ops[3]

    def without_queries(fn):
        def run(x, ln_w, ln_b, wqkv, *rest):
            wqkv = wqkv.clone()
            wqkv[: x.shape[-1]] = 0
            return fn(x, ln_w, ln_b, wqkv, *rest)

        return run

    return patched((qkvt, "attn_sublayer", without_queries(qkvt.attn_sublayer)),
                   (temporal, "temporal_attn_sublayer", without_queries(temporal.temporal_attn_sublayer)))


def uniform_flash_tq(ops):
    """Zeroes q in every call of kernel 7: the un-fused path's spatial
    self-attention at levels 0 and 1 weighs all keys alike."""
    flash = ops[4]
    real = flash.flash_attention_tq
    return patched((flash, "flash_attention_tq", lambda q, k, v, scale: real(q.new_zeros(q.shape), k, v, scale)),)


# Wq and Wk of every self-attention are scaled by this factor. The fan-in
# init gives logits q.k/8 of standard deviation ~1/3, attention so near
# uniform that a fault in its pattern would barely move the step; scaled,
# their deviation is ~2, peaked as in trained models.
QK_SCALE = 2.5


def make_params(torch, bundle, seed):
    from posetraj_torch.pipeline import init_params

    params = init_params(bundle, seed=seed, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7)
    cp = params["controlnet"]
    for zc in cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"], cp["controlnet_cond_embedding"]["stack"]["conv_out"]]:
        w = zc["weight"]
        zc["weight"] = (torch.randn(w.shape, generator=g, device="cuda") * 1e-2).to(w.dtype).contiguous(
            memory_format=torch.channels_last)

    scaled = set()  # data pointers, so that a shared tensor is scaled once

    def scale_qk(node):
        if isinstance(node, dict):
            w = node.get("wqkv")
            if w is not None and w.data_ptr() not in scaled:
                scaled.add(w.data_ptr())
                w[: 2 * w.shape[1]] *= QK_SCALE
            for v in node.values():
                scale_qk(v)
        elif isinstance(node, list):
            for v in node:
                scale_qk(v)

    scale_qk(params["unet"])
    scale_qk(params["controlnet"])
    return params


def _kernel_group(name: str) -> str:
    """The group of a device kernel's name in the step profile."""
    low = name.lower()
    for key, group in (("gn_", "A groupnorm (port)"), ("mlp_gemm", "B mlp (port)"), ("ln_rows", "8 LayerNorm (port)"),
                       ("hopper_flash_fwd", "flash attention fwd (port: C's core, 5, 6, 7)"),
                       ("flash_bwd", "5 flash attention bwd (port)"), ("frame_attn", "D frame attention (port)"),
                       ("projection_gemm", "C/D projection GEMMs (port)")):
        if key in low:
            return group
    if "multi_tensor" in low or "adam" in low:
        return "optimizer (PyTorch foreach)"
    if any(k in low for k in ("conv", "implicit", "xmma_fprop", "cudnn", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "sm90")):
        return "matmul (cuBLAS)"
    if any(k in low for k in ("elementwise", "vectorized", "reduce", "cat", "copy", "layer_norm")):
        return "elementwise / copy / norm (PyTorch)"
    return "other"


PROFILE_PREROLL = 64


def profile_step(torch, step):
    """One warm step under torch.profiler: wall time, summed device time of
    its kernels (device_kernels), and that time grouped by _kernel_group."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # In a process that has profiled before, the profiler has missed the
        # first device records of a window (a training micro-step's first
        # kernel A, a dozen kernels in): spin kernels, left out of the
        # groups, take those places.
        for _ in range(PROFILE_PREROLL):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = collections.defaultdict(lambda: [0.0, 0])
    for ev in device_kernels(torch, prof):
        gr = groups[_kernel_group(ev.name)]
        gr[0] += (ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total) / 1e3
        gr[1] += 1
    return wall_ms, dict(groups)


def step_check(torch, ops, native, bundle, params, height, width, cfg, uniform, other=None):
    """One ControlNet -> UNet step on the CFG batch at 14 x height x width
    under KernelConfig `cfg`: kernels vs plain, kernels with `uniform`
    attention, the warm kernel step under the profiler, and, if `other` (a
    KernelConfig) is given, the same step under it."""
    from posetraj_torch.configs import use_kernels
    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.models import unet as unet_m

    dt = torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(99)
    f, h, w = 14, height // 8, width // 8
    lat_in = torch.randn(2, f, h, w, 8, generator=g, device="cuda").to(dt)
    clip = torch.randn(2, 1, 1024, generator=g, device="cuda").to(dt)
    ids = torch.tensor([[6.0, 128.0, 0.02]] * 2, device="cuda")
    control = (torch.rand(2, f, height, width, 3, generator=g, device="cuda") * 2 - 1).to(dt)
    t = torch.tensor(0.25 * 6.55, device="cuda")
    hint = cn.hint_encoder(params["controlnet"]["controlnet_cond_embedding"], bundle.controlnet.hint, control, f, dt)

    def step():
        down, mid = cn.controlnet_forward(params["controlnet"], bundle.controlnet, lat_in, t, clip, ids,
                                          compute_dtype=dt, hint_embedding=hint)
        return unet_m.unet_forward(params["unet"], bundle.unet, lat_in, t, clip, ids, down, mid, compute_dtype=dt)

    def rel_rms(a, b):
        return float((a - b).norm() / b.norm())

    out = {}
    with torch.inference_mode():
        with use_kernels(cfg):
            native.reset_launches()
            got = step().float()
            torch.cuda.synchronize()
            out["per_step"] = dict(native.LAUNCHES)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            out["step_s"] = time.perf_counter() - t0
            out["profile"] = profile_step(torch, step)
            with uniform(ops):
                out["attn_effect"] = rel_rms(step().float(), got)
            native.reset_launches()
            with plain_versions(ops):
                want = step().float()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                out["plain_s"] = time.perf_counter() - t0
            out["plain_launches"] = sum(native.LAUNCHES.values())
        if other is not None:
            with use_kernels(other):
                out["other_rel_rms"] = rel_rms(got, step().float())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                out["other_s"] = time.perf_counter() - t0
    out.update(err=float((got - want).abs().max()), scale=float(want.abs().max()), rel_rms=rel_rms(got, want),
               finite=bool(torch.isfinite(got).all()))
    return out


def print_profile(label, profile):
    wall_ms, groups = profile
    device_ms = sum(v[0] for v in groups.values())
    say(f"  {label}: wall {wall_ms:.1f} ms, device kernel time {device_ms:.1f} ms, busy share "
        f"{device_ms / wall_ms:.3f}")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        say(f"    {name:36s} {ms:9.2f} ms {n:6d} launches {ms / max(device_ms, 1e-9):7.1%}")


def training_batch(torch, f, h, w, seed):
    """A synthetic batch from a seed on the card: frames and control video
    in [-1, 1], motion bucket 127."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return {"pixel_values": torch.rand(1, f, h, w, 3, generator=g, device="cuda") * 2 - 1,
            "trajectories": torch.rand(1, f, h, w, 3, generator=g, device="cuda") * 2 - 1,
            "motion_values": torch.full((1,), 127.0, device="cuda")}


def _tree_leaves(tree):
    from posetraj_torch.core.params import leaves

    return list(leaves(tree))


def _tree_paths(tree, prefix=""):
    """Dotted paths of a tree's leaves, in the order of core.params.leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}.{i}")
    else:
        yield prefix


# Leaves that only feed the query of a cross-attention over ONE key (the
# CLIP token): softmax over one key is identically 1, so norm2, to_q and
# to_k of every transformer block never reach the loss and their gradient
# is exactly 0, in the reference and the JAX package alike.
DEAD_LEAF = re.compile(r"(^|\.)(blocks|temporal_blocks)\.\d+\.(norm2|attn2\.to_q|attn2\.to_k)\.")


def _rel_rms(got, want):
    num = sum(float((a.float() - b.float()).pow(2).sum()) for a, b in zip(got, want))
    den = sum(float(b.float().pow(2).sum()) for b in want)
    return (num / den) ** 0.5


def train_check(torch, ops, native, bundle, params, f, h, w):
    """Phase 5. Returns a dict of what it measured; main() judges it.

    (a)/(b): one micro-step's loss and ControlNet gradients from
    edm_training_loss (same draws, same float32 masters) with the kernels,
    with every wrapper plain, and with uniform attention. (c): Trainer.step
    x 4 with the TrainConfig defaults, checked step by step; the UNet's down
    path and mid block are watched for a graph. (d): a fifth micro-step
    under the profiler."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.core.params import ema_decay_schedule
    from posetraj_torch.models import unet as unet_m
    from posetraj_torch.train import Trainer, draw_step_randoms, edm_training_loss

    sync = torch.cuda.synchronize
    tcfg = TrainConfig(num_frames=f, height=h, width=w)
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    trainer = Trainer(bundle, tcfg, frozen, params["controlnet"], device="cuda")
    dt = trainer.compute_dtype
    batch = training_batch(torch, f, h, w, 4321)
    sf = bundle.vae.scale_factor
    g = torch.Generator(device="cuda")
    g.manual_seed(77)
    randoms = draw_step_randoms(g, 1, f, (h // sf, w // sf, bundle.vae.latent_channels), "cuda")
    # No conditioning dropout in (a)/(b): a dropped CLIP embedding is zero,
    # and so are then the gradients of every cross-attention's to_v and
    # to_out (bias-free to_v of a zero context), which (b) would flag.
    randoms["drop_p"].fill_(0.5)
    masters = _tree_leaves(trainer.state.controlnet_params)

    def grads():
        loss, _ = edm_training_loss(trainer.state.controlnet_params, trainer.frozen_params, bundle, tcfg, batch,
                                    randoms, dt)
        gs = torch.autograd.grad(loss, masters, allow_unused=True)
        sync()
        return float(loss.detach()), [torch.zeros_like(p) if x is None else x for p, x in zip(masters, gs)]

    out = {}
    native.reset_launches()
    t0 = time.perf_counter()
    out["loss_k"], g_k = grads()
    out["grad_s"] = time.perf_counter() - t0
    out["grad_launches"] = dict(native.LAUNCHES)
    with uniform_attention(ops):
        _, g_u = grads()
    out["uniform_effect"] = _rel_rms(g_u, g_k)
    del g_u
    native.reset_launches()
    with plain_versions(ops):
        out["loss_p"], g_p = grads()
    out["plain_launches"] = sum(native.LAUNCHES.values())
    out["grad_rel_rms"] = _rel_rms(g_k, g_p)
    del g_p
    names = list(_tree_paths(trainer.state.controlnet_params))
    out["leaves"] = len(g_k)
    out["dead"] = sum(1 for n in names if DEAD_LEAF.search(n))
    # (b) finite everywhere; zero exactly on the dead leaves, nowhere else
    out["bad_leaves"] = [n for n, x in zip(names, g_k) if not bool(torch.isfinite(x).all())
                         or bool(x.abs().max() > 0) == bool(DEAD_LEAF.search(n))]
    del g_k
    torch.cuda.empty_cache()

    # (c) Trainer.step x 4: a graph must never be built in the UNet's down
    # path or mid block, whose inputs need no gradient.
    graph_in_down = []
    real_down, real_mid = unet_m.down_block, unet_m.mid_block

    def watch_down(*a, **k):
        x, skips = real_down(*a, **k)
        graph_in_down.append(x.requires_grad or any(t.requires_grad for t in skips))
        return x, skips

    def watch_mid(*a, **k):
        x = real_mid(*a, **k)
        graph_in_down.append(x.requires_grad)
        return x

    unet_leaves = _tree_leaves(trainer.frozen_params["unet"])
    unet_before = [t.clone() for t in unet_leaves]
    steps = []
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    with mock.patch.object(unet_m, "down_block", watch_down), mock.patch.object(unet_m, "mid_block", watch_mid):
        for i in range(4):
            before = [t.detach().clone() for t in _tree_leaves(trainer.state.controlnet_params)]
            sync()
            t0 = time.perf_counter()
            m = trainer.step(batch)
            sync()
            secs = time.perf_counter() - t0
            after = _tree_leaves(trainer.state.controlnet_params)
            ema = _tree_leaves(trainer.state.ema_params)
            opt_state = trainer.state.optimizer.state.get(after[0], {})
            steps.append(dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), s=secs,
                changed=any(not torch.equal(a, b) for a, b in zip(before, after)),
                adam_steps=int(opt_state["step"]) if "step" in opt_state else 0,
                lr=trainer.state.optimizer.param_groups[0]["lr"],
                ema_equal=all(torch.equal(e, p) for e, p in zip(ema, after)),
            ))
            if i == 3:
                # Second update: ema = d * (params after the first update)
                # + (1 - d) * params, d = ema_decay_schedule(2) = 2/11.
                d = ema_decay_schedule(2, tcfg.ema_decay)
                steps[-1]["ema_lag_err"] = max(float((e - (d * b + (1 - d) * a.detach())).abs().max() /
                                                     a.detach().abs().max().clamp_min(1e-30))
                                               for e, a, b in zip(ema, after, before))
            del before
    out["launches"] = dict(native.LAUNCHES)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["steps"] = steps
    out["unet_unchanged"] = all(torch.equal(a, b) for a, b in zip(unet_leaves, unet_before))
    out["graph_in_down"] = any(graph_in_down)
    out["down_calls"] = len(graph_in_down)
    del unet_before

    # (d) a fifth micro-step (no optimizer update) under the profiler
    out["profile"] = profile_step(torch, lambda: trainer.step(batch))
    return out


def run_pipeline(torch, native, bundle, params, steps, height, width):
    """SVDControlNetPipeline for two requests; the first captures the
    denoise loop's graph (its capture seconds are returned last), the second
    replays it."""
    from posetraj_torch.pipeline import SVDControlNetPipeline
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    pipe = SVDControlNetPipeline(params, bundle, device="cuda")
    denoise_s = []
    real_denoise = pipe_m.denoise

    def timed_denoise(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_denoise(*a, **k)
        torch.cuda.synchronize()
        denoise_s.append(time.perf_counter() - t0)
        return out

    outs, req_s, capture_s = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(pipe_m, "denoise", timed_denoise):
        native.reset_launches()
        for seed in (0, 1):
            rng = np.random.RandomState(100 + seed)
            image = rng.rand(1, height, width, 3).astype(np.float32)
            control = rng.rand(1, 14, height, width, 3).astype(np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe(image, control, height=height, width=width, num_frames=14, num_inference_steps=steps,
                             seed=seed))
            req_s.append(time.perf_counter() - t0)
            capture_s.append(pipe.graph.capture_s if seed == 0 else 0.0)
        launches = dict(native.LAUNCHES)
    # The second request replays the first one's graph: it captured nothing.
    if pipe.graph.capture_s != capture_s[0]:
        fail("the pipeline's second request captured its denoise graph anew")
    return outs, req_s, denoise_s, launches, torch.cuda.max_memory_allocated(), capture_s[0]


# Launches per denoise step under the default KernelConfig at 14x576x1024
# (ControlNet + UNet, CFG batch B*F = 28), from the code: 23 transformers
# (ControlNet down 2+2+2 and mid 1, UNet down 2+2+2, mid 1, up 3+3+3), each
# with one spatial (C) and one temporal (D) self-attention sub-layer, each
# of those with two GEMM launches (and D with one frame attention), and
# three GEGLU feed-forwards (B: ff, ff_in and the temporal ff).
DEFAULT_PER_STEP = {"mlp": 69, "qkvt": 23, "temporal": 23, "gemm": 92, "frame_attn": 23}
# Launches of PyTorch's matrix products (cuBLAS) in one default step: 347
# and 349 in two H100 runs of the same model code (proj_in/out, the
# one-token cross-attentions, the temporal conv's taps; cuBLAS picks its
# kernels, some in two launches, run by run; PERF.md). A product of B, C or
# D sent to a library would add at least 23 (C's and D's run 23 times a
# step, B's 69), so the step is held below 347 + 23.
CUBLAS_PER_STEP = 347
CUBLAS_MARGIN = 23

# The un-fused configuration of phase 6: spatial and temporal self-attention
# outside kernels C and D, the FF's LayerNorm outside kernel B, and every
# standalone LayerNorm in kernel 8.
UNFUSED = dict(qkvt_attn=False, temporal_attn=False, fused_ff_ln=False, fused_ln=True)

# Launches per denoise step under UNFUSED at 14x320x576 (ControlNet + UNet,
# CFG batch B*F = 28), predicted from the code: 23 transformers (ControlNet
# down 2+2+2 and mid 1, UNet down 2+2+2, mid 1, up 3+3+3 at levels 0-2);
# latent levels of 40x72, 20x36, 10x18, 5x9 tokens (S = 2880, 720, 180, 45).
#   flash_tq: spatial self-attention with S >= 512 (levels 0 and 1): 14.
#   layernorm: five LayerNorms a transformer (spatial norm1 and norm3;
#     temporal norm_in, norm1, norm3) where the rows 28*S reach 4096, i.e.
#     levels 0-2, 21 transformers: 105. (The mid blocks' 28*45 = 1260 rows
#     stay on PyTorch; norm2 is skipped before a one-token cross-attention.)
#   qkvt, temporal (and so C's and D's GEMMs), flash_fwd, flash_bwd,
#   flash_qkv: 0.
# CLIP (257 tokens) and the VAE (head_dim 512, no LayerNorm) add none.
UNFUSED_PER_STEP = {"flash_tq": 14, "layernorm": 105, "qkvt": 0, "temporal": 0, "gemm": 0, "frame_attn": 0,
                    "flash_fwd": 0, "flash_bwd": 0, "flash_qkv": 0}


def un_fused_check(torch, ops, native, bundle, params, steps, card):
    """Phase 6: one denoise step at 14x320x576 under UNFUSED against the
    all-plain step, the default-config step and uniform kernel-7 attention,
    with its launches and profile; then SVDControlNetPipeline for two
    requests under ModelBundle(kernels=UNFUSED). Fails on any miss; returns
    the pipeline run's launches."""
    import dataclasses

    from posetraj_torch.configs import KernelConfig

    cfg = KernelConfig(**UNFUSED)
    height, width = 320, 576
    st = step_check(torch, ops, native, bundle, params, height, width, cfg, uniform_flash_tq, KernelConfig())
    # Kernels against plain: bf16 rounding along the step, as in phase 3
    # (3e-2 there). The default-config step rounds elsewhere again (kernels
    # C, D and B with its LayerNorm), so it is held to the same limit.
    rms_tol = 3e-2
    launches_ok = all(st["per_step"][k] == n for k, n in UNFUSED_PER_STEP.items())
    ok = (st["finite"] and st["rel_rms"] <= rms_tol and st["other_rel_rms"] <= rms_tol
          and st["attn_effect"] > rms_tol and st["plain_launches"] == 0 and launches_ok)
    say(f"phase 6: un-fused KernelConfig({', '.join(f'{k}={v}' for k, v in UNFUSED.items())}) at 14x{height}x{width} "
        f"CFG on {card}")
    say(f"  (a) one denoise step: vs all-plain max_abs_err={st['err']:.4g} (|ref|max {st['scale']:.3g}) "
        f"rel_rms={st['rel_rms']:.4g} (tol {rms_tol:g}); vs the default-config step rel_rms="
        f"{st['other_rel_rms']:.4g} (tol {rms_tol:g}); uniform kernel-7 attention rel_rms={st['attn_effect']:.4g} "
        f"(must exceed {rms_tol:g}); launches/step={st['per_step']} (predicted {UNFUSED_PER_STEP}); step "
        f"{st['step_s']:.3f} s (plain {st['plain_s']:.3f} s, {st['plain_launches']} launches; default config "
        f"{st['other_s']:.3f} s) "
        f"{'ok' if ok else 'FAIL'}")
    print_profile(f"(a) profile of one un-fused step on {card}", st["profile"])
    if not ok:
        fail("the un-fused step disagrees, cannot see kernel 7, or launched other kernels than predicted")

    outs, req_s, denoise_s, launches, peak, capture_s = run_pipeline(
        torch, native, dataclasses.replace(bundle, kernels=cfg), params, steps, height, width)
    for out in outs:
        if out.shape != (1, 14, height, width, 3):
            fail(f"output shape {out.shape}")
        if not (np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
            fail("output not finite or outside [0, 1]")
    n_steps = 2 * steps
    per_step = {k: launches[k] / n_steps for k in launches}
    ok = all(launches[k] == n * n_steps for k, n in UNFUSED_PER_STEP.items())
    say(f"  (b) SVDControlNetPipeline, {steps} steps, 2 requests (the denoise loop a captured graph, "
        f"{capture_s:.2f} s to capture in the first): s/request={[round(x, 3) for x in req_s]} "
        f"s/denoise-step={[round(x / steps, 4) for x in denoise_s]} peak_mem={peak / 2**30:.2f} GiB "
        f"launches={launches} per step={per_step} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the un-fused pipeline launched other kernels than predicted")
    return launches


# Phase 8: the hint encoder's variants at full width.
VARIANTS = ("bbox", "cam", "rot", "entity", "temp")
# Launches the temp variant's hint adds to a request: kernel A for its
# per-video GroupNorm, kernel B for the FF of each of its two blocks; under
# UNFUSED also kernel 8 for each block's norm1 and FF LayerNorm (258048 rows).
TEMP_HINT_LAUNCHES = {"groupnorm": 1, "mlp": 2}
TEMP_HINT_LAUNCHES_UNFUSED = {"groupnorm": 1, "mlp": 2, "layernorm": 4}


def variant_hint_params(torch, variant, seed):
    """The variant's hint encoder at flagship width, bf16, from a seed, with
    random values in every zero-initialised leaf (conv_out, stack_2's
    conv_out, entity_in, entity_out; ~1e-2, as make_params gives the
    ControlNet's heads) and a random camera projection in place of its
    identity init, so that each condition reaches the embedding."""
    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.pipeline import ModelBundle

    cfg = ModelBundle.with_variant(variant).controlnet.hint
    ini = make_init(seed, torch.device("cuda"), torch.bfloat16)
    hp = cn.init_hint_encoder(ini, cfg)
    zeros = [hp["stack"]["conv_out"]] + [hp[k] for k in ("entity_in", "entity_out") if k in hp]
    if "stack_2" in hp:
        zeros.append(hp["stack_2"]["conv_out"])
    for node in zeros:
        node["weight"] = ini.normal(node["weight"].shape, 1e-2).contiguous(memory_format=torch.channels_last)
    if "cc_projection" in hp:
        hp["cc_projection"] = ini.linear(cfg.embedding_channels + cfg.camera_dim, cfg.embedding_channels)
    return cfg, hp


def variants_check(torch, ops, native, params, steps, card, base_launches, gn_row):
    """Phase 8. (a) kernel A at the temp variant's GroupNorm shape; (b) each
    variant's hint embedding at 14x576x1024 on the CFG batch, kernels
    against plain, launches, and each condition moving the embedding; (c)
    bbox, cam, rot and temp through SVDControlNetPipeline, one request
    each, cam twice with two cameras; entity through one controlnet_forward.
    The ControlNet, UNet, VAE and CLIP are phase 3's parameters; only the
    hint encoder is swapped. Fails on any miss."""
    from posetraj_torch.configs import KernelConfig, use_kernels
    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    groupnorm = ops[0]
    F = torch.nn.functional
    dev, bf, f, hh, ww = "cuda", torch.bfloat16, 14, 576, 1024
    g = torch.Generator(device=dev)
    g.manual_seed(808)
    say(f"phase 8: hint variants at 14x{hh}x{ww} on {card}")

    # (a) A at (2, F*h*w, 320): the temp variant's per-video GroupNorm, no
    # addend, no SiLU; 82.6 MB a sample, more than the card's shared memory,
    # so the sample streams twice. Tolerance as A's in phase 2.
    from posetraj_torch.tools.kernel_sweep import TOLERANCES

    tol = TOLERANCES["groupnorm.group_norm"][0]
    x = (torch.randn(2, f * (hh // 8) * (ww // 8), 320, generator=g, device=dev) + 0.5).to(bf)
    w = torch.rand(320, generator=g, device=dev) + 0.5
    b = torch.randn(320, generator=g, device=dev) * 0.1
    run_k = lambda: groupnorm.group_norm_kernel(x, w, b, 32, 1e-6, False)
    run_p = lambda: groupnorm.group_norm_plain(x, w, b, 32, 1e-6, False)
    err, scale, rel_rms, ok = compare(run_k(), run_p(), tol)
    gn_row["max_abs_err"] = max(gn_row["max_abs_err"], err)
    ms, plain = cuda_ms(run_k), cuda_ms(run_p)
    xc = x.transpose(1, 2)
    lib = cuda_ms(lambda: F.group_norm(xc, 32, w.to(bf), b.to(bf), 1e-6))
    bnd, by = bound_ms(2 * x.numel() * 2, 10 * x.numel(), FP32_FLOPS)
    say(f"  (a) groupnorm {tuple(x.shape)} bf16 eps 1e-6 (temp hint): max_abs_err={err:.4g} (|ref|max {scale:.3g}, "
        f"tol {tol:g}x) rel_rms={rel_rms:.3g} ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bnd:.4f} ({by}) "
        f"F.group_norm_ms={lib:.4f} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernel A disagrees with its plain version at the temp hint's shape")
    del x, xc
    torch.cuda.empty_cache()

    # (b) The hint embedding of each variant on the CFG batch (2, 14, 576,
    # 1024, 3), kernels against plain. The check is on the variant's part,
    # the embedding minus the first conv stack's output, with kernel B's
    # tolerances (3e-2 of its max, 1e-2 rel RMS: bf16 roundings through
    # A, the block's attention and B). Each condition is then changed (bbox:
    # to the blank map) and must move the variant's part by more than 1e-3
    # rel RMS. The bbox stack's output is mostly its biases' (each random
    # fan-in layer keeps about a third of its input's variance), so a
    # blank map moves it by a few parts in a thousand; the other
    # conditions move theirs by O(1). Without a kernel in the variant the
    # kernel and plain runs are the same bits, so 1e-3 is far above noise.
    tol, rms_tol, moved_tol = 3e-2, 1e-2, 1e-3
    control = (torch.rand(2, f, hh, ww, 3, generator=g, device=dev) * 2 - 1).to(bf)
    conds = {
        "bbox": ("bbox_cond", (torch.rand(2, f, hh, ww, 3, generator=g, device=dev) * 2 - 1).to(bf),
                 torch.full((2, f, hh, ww, 3), -1.0, device=dev, dtype=bf)),
        "cam": ("camera_cond", torch.randn(2, f, 12, generator=g, device=dev),
                torch.randn(2, f, 12, generator=g, device=dev)),
        "rot": ("rot_id", torch.tensor([1, 1], device=dev), torch.tensor([0, 0], device=dev)),
        "entity": ("entity_cond", torch.randn(1, hh // 8, ww // 8, 320, generator=g, device=dev).to(bf),
                   torch.randn(1, hh // 8, ww // 8, 320, generator=g, device=dev).to(bf)),
    }
    hints = {}
    ok_all = True
    with torch.inference_mode(), use_kernels(KernelConfig()):
        for i, v in enumerate(VARIANTS):
            cfg, hp = variant_hint_params(torch, v, 900 + i)
            hints[v] = hp
            name, c1, c2 = conds.get(v, (None, None, None))
            kw = {name: c1} if name else {}
            run = lambda **k: cn.hint_encoder(hp, cfg, control, f, compute_dtype=bf, **{**kw, **k})
            native.reset_launches()
            got = run()
            torch.cuda.synchronize()
            launched = {k: n for k, n in native.LAUNCHES.items() if n}
            hint_ms = cuda_ms(run, reps=3, inner=1)
            want_launched = TEMP_HINT_LAUNCHES if v == "temp" else {}
            native.reset_launches()
            with plain_versions(ops):
                want = run()
            plain_launches = sum(native.LAUNCHES.values())
            stack = cn._conv_stack(hp["stack"], control.reshape(2 * f, hh, ww, 3), bf)
            err, scale, rel_rms, ok = compare(got, want, tol, stack, rms_tol)
            moved = float((run(**{name: c2}).float() - got.float()).norm() / (got.float() - stack.float()).norm()) \
                if name else None
            ok = (ok and launched == want_launched and plain_launches == 0 and bool(torch.isfinite(got).all())
                  and got.shape == (2 * f, hh // 8, ww // 8, 320) and (moved is None or moved > moved_tol))
            ok_all &= ok
            say(f"  (b) {v:6s} hint {tuple(got.shape)}: vs plain max_abs_err={err:.4g} (|variant part|max "
                f"{scale:.3g}, tol {tol:g}x) rel_rms={rel_rms:.3g} (tol {rms_tol:g}); launches {launched} "
                f"(expected {want_launched}; plain {plain_launches}); "
                + (f"another {name} moves it by {moved:.3g} rel (must exceed {moved_tol:g}); " if name else "")
                + f"{hint_ms:.2f} ms {'ok' if ok else 'FAIL'}")
            del got, want, stack
        # temp under the un-fused switches: its blocks' LayerNorms go to
        # kernel 8, B runs without its LayerNorm.
        temp_cfg = ModelBundle.with_variant("temp").controlnet.hint
        native.reset_launches()
        with use_kernels(KernelConfig(**UNFUSED)):
            got = cn.hint_encoder(hints["temp"], temp_cfg, control, f, compute_dtype=bf)
            torch.cuda.synchronize()
            launched = {k: n for k, n in native.LAUNCHES.items() if n}
            native.reset_launches()
            with plain_versions(ops):
                want = cn.hint_encoder(hints["temp"], temp_cfg, control, f, compute_dtype=bf)
        stack = cn._conv_stack(hints["temp"]["stack"], control.reshape(2 * f, hh, ww, 3), bf)
        err, scale, rel_rms, ok = compare(got, want, tol, stack, rms_tol)
        ok = ok and launched == TEMP_HINT_LAUNCHES_UNFUSED and sum(native.LAUNCHES.values()) == 0
        ok_all &= ok
        say(f"  (b) temp   hint under UNFUSED: vs plain max_abs_err={err:.4g} (|variant part|max {scale:.3g}, tol "
            f"{tol:g}x) rel_rms={rel_rms:.3g} (tol {rms_tol:g}); launches {launched} (expected "
            f"{TEMP_HINT_LAUNCHES_UNFUSED}) {'ok' if ok else 'FAIL'}")
        del got, want, stack
    if not ok_all:
        fail("a hint variant disagrees with its plain version, launched other kernels than expected, or ignores "
             "its condition")
    del conds
    torch.cuda.empty_cache()

    # (c) One 25-step request per variant through the pipeline, the latents
    # taken from its denoise loop; launches against phase 4's per request
    # plus what the temp hint adds. cam: a second request with another
    # camera, whose latents must differ by more than 1e-3 rel RMS.
    per_request = {k: n // 2 for k, n in base_launches.items()}
    if any(n % 2 for n in base_launches.values()):
        fail(f"phase 4's two requests launched an odd count: {base_launches}")
    latents = []
    real_denoise = pipe_m.denoise

    def keep_latents(*a, **k):
        out = real_denoise(*a, **k)
        latents.append(out.float().clone())
        return out

    rng = np.random.RandomState(100)
    image = rng.rand(1, hh, ww, 3).astype(np.float32)
    video = rng.rand(1, f, hh, ww, 3).astype(np.float32)
    extra = {"bbox": [{"bbox_condition": rng.rand(1, f, hh, ww, 3).astype(np.float32)}],
             "cam": [{"camera_cond": rng.randn(1, f, 12).astype(np.float32)},
                     {"camera_cond": rng.randn(1, f, 12).astype(np.float32)}],
             "rot": [{"rot_id": np.array([1])}], "temp": [{}]}
    req_s, cam_moved = {}, None
    with mock.patch.object(pipe_m, "denoise", keep_latents):
        for v, requests in extra.items():
            bundle = ModelBundle.with_variant(v)
            pv = dict(params, controlnet=dict(params["controlnet"], controlnet_cond_embedding=hints[v]))
            pipe = SVDControlNetPipeline(pv, bundle, device="cuda")
            want = {k: n + (TEMP_HINT_LAUNCHES.get(k, 0) if v == "temp" else 0) for k, n in per_request.items()}
            for kw in requests:
                native.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pipe(image, video, height=hh, width=ww, num_frames=f, num_inference_steps=steps, seed=0, **kw)
                req_s.setdefault(v, []).append(time.perf_counter() - t0)
                launched = dict(native.LAUNCHES)
                ok = (out.shape == (1, f, hh, ww, 3) and bool(np.isfinite(out).all()) and out.min() >= 0.0
                      and out.max() <= 1.0 and launched == want)
                nonzero = lambda d: {k: n for k, n in d.items() if n}
                say(f"  (c) {v:6s} SVDControlNetPipeline {steps} steps: {req_s[v][-1]:.3f} s/request on {card}; "
                    f"output {out.shape} in [{out.min():.3f}, {out.max():.3f}]; launches {nonzero(launched)} "
                    f"(expected {nonzero(want)}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"the {v} variant's request gave a bad output or launched other kernels than expected")
            if v == "cam":
                a, b = latents[-2], latents[-1]
                cam_moved = float((a - b).norm() / a.norm())
                say(f"  (c) cam: another camera_cond moves the latents by {cam_moved:.4g} rel RMS (must exceed 1e-3)")
                if not cam_moved > 1e-3:
                    fail("the cam variant's latents do not change with camera_cond")
            latents.clear()
            del pipe, pv, out
            torch.cuda.empty_cache()

    # entity: generate() passes no entity map (as in the JAX package), so it
    # runs through one controlnet_forward at full width, with two maps.
    bundle = ModelBundle.with_variant("entity")
    lat_in = torch.randn(2, f, hh // 8, ww // 8, 8, generator=g, device=dev).to(bf)
    clip = torch.randn(2, 1, 1024, generator=g, device=dev).to(bf)
    ids = torch.tensor([[6.0, 128.0, 0.02]] * 2, device=dev)
    cp = dict(params["controlnet"], controlnet_cond_embedding=hints["entity"])
    ents = [torch.randn(1, hh // 8, ww // 8, 320, generator=g, device=dev).to(bf) for _ in range(2)]
    with torch.inference_mode():
        native.reset_launches()
        outs = [cn.controlnet_forward(cp, bundle.controlnet, lat_in, torch.tensor(1.6, device=dev), clip, ids,
                                      controlnet_cond=control, entity_cond=e, compute_dtype=bf) for e in ents]
        torch.cuda.synchronize()
    down, mid = outs[0]
    moved = float((outs[1][1].float() - mid.float()).norm() / mid.float().norm())
    ok = (len(down) == 12 and all(bool(torch.isfinite(t).all()) for t in (*down, mid)) and moved > 1e-3
          and native.LAUNCHES["mlp"] > 0 and native.LAUNCHES["qkvt"] > 0)
    say(f"  (c) entity controlnet_forward: {len(down)} residuals + mid {tuple(mid.shape)}, finite; another "
        f"entity_cond moves the mid residual by {moved:.4g} rel RMS (must exceed 1e-3); launches "
        f"{ {k: n for k, n in native.LAUNCHES.items() if n} } {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the entity variant's controlnet_forward is not finite or ignores entity_cond")
    say(f"phase 8: s/request {', '.join(f'{v} {[round(x, 3) for x in t]}' for v, t in req_s.items())} on {card}")


# Phase 9: the denoise loop as one captured CUDA graph against the eager loop.
GRAPH_STEPS = 4
# Rounds of (eager, graph, graph, eager) calls that time s/denoise-step.
GRAPH_TIME_ROUNDS = 2
# Euler steps of phase 9's direct generate() calls: the graph's reuse and
# its bits against the eager loop show at any step count.
DIRECT_STEPS = 8
# Profile groups (_kernel_group) of the port's kernels that launch one device
# kernel a counted call, and their counters (C's call launches one flash
# forward, its core). B's calls launch two or three kernels and C's and D's
# projection GEMMs three a call with the LayerNorm pre-pass: those are held
# to the eager run's device launches only.
ONE_LAUNCH_GROUPS = {
    "A groupnorm (port)": ("groupnorm",),
    "8 LayerNorm (port)": ("layernorm",),
    "D frame attention (port)": ("frame_attn",),
    "flash attention fwd (port: C's core, 5, 6, 7)": ("qkvt", "flash_fwd", "flash_tq", "flash_qkv"),
}


def graph_check(torch, native, bundle, params, height, width, cfg, per_step, card, label):
    """Phase 9 at one configuration: GRAPH_STEPS Euler steps of `denoise`
    (the captured graph: a first call that runs step 0 eagerly, captures
    and replays; a second call that only replays) against `denoise_eager`
    twice, on the same inputs at 14 x height x width, CFG, under
    KernelConfig `cfg`. The graph must equal the eager loop bit for bit
    where two eager runs are equal (else differ no more than they do), and
    launch what the eager loop launches, `per_step` a step, counted by the
    wrappers and by the profiler (ONE_LAUNCH_GROUPS; the larger count of
    two profiled windows of each loop). s/denoise-step is the
    median over GRAPH_TIME_ROUNDS rounds of eager, graph, graph, eager
    calls, each after a garbage collection, so that a drift of the card's
    clock weighs on both loops alike and no collection lands in one call.
    Returns the eager and the graphed s/denoise-step; fails on a miss."""
    from posetraj_torch.configs import PipelineConfig, use_kernels
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    n, f, h, w = GRAPH_STEPS, 14, height // 8, width // 8
    g = torch.Generator(device="cuda")
    g.manual_seed(909)
    sched = make_schedule(bundle.scheduler, n)
    pcfg = PipelineConfig(height=height, width=width, num_frames=f, num_inference_steps=n)
    image_latents = torch.randn(1, h, w, 4, generator=g, device="cuda")
    args = (params, bundle, pcfg, torch.randn(1, f, h, w, 4, generator=g, device="cuda") * float(sched.sigmas[0]),
            torch.cat([torch.zeros_like(image_latents), image_latents]),
            torch.randn(2, 1, 1024, generator=g, device="cuda").to(torch.bfloat16),
            (torch.rand(2, f, height, width, 3, generator=g, device="cuda") * 2 - 1).to(torch.bfloat16),
            torch.tensor([[6.0, 128.0, 0.02]] * 2, device="cuda"), torch.as_tensor(sched.sigmas, device="cuda"),
            torch.as_tensor(sched.timesteps, device="cuda"), torch.linspace(1.0, 3.0, f, device="cuda"),
            torch.bfloat16)
    runner = pipe_m.DenoiseGraph()
    eager = lambda: pipe_m.denoise_eager(*args)
    graphed = lambda: pipe_m.denoise(*args, graph=runner)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(native.LAUNCHES)

    with torch.inference_mode(), use_kernels(cfg):
        outs, secs, launched = {}, {}, {}
        for name, fn in (("eager", eager), ("eager again", eager), ("graph, first call", graphed),
                         ("graph", graphed)):
            native.reset_launches()
            outs[name], secs[name], launched[name] = timed(fn)
        samples = {"eager": [], "graph": []}
        for _ in range(GRAPH_TIME_ROUNDS):
            for name, fn in (("eager", eager), ("graph", graphed), ("graph", graphed), ("eager", eager)):
                gc.collect()
                samples[name].append(timed(fn)[1] / n)
        eager_profs = [profile_step(torch, eager) for _ in range(2)]
        native.reset_launches()
        graph_profs = [profile_step(torch, graphed)]
        added = dict(native.LAUNCHES)
        graph_profs.append(profile_step(torch, graphed))
        eager_prof, graph_prof = eager_profs[0], graph_profs[0]
    # The replays' counts are added by DenoiseGraph, not counted at a launch:
    # the profiler's device launches hold them. The profiler can drop a
    # device record of a window but never adds one, so each group's device
    # launches are the larger count of two windows (as in phase 5(e)).
    profs = {"eager": eager_profs, "graph": graph_profs}
    groups = sorted(set(ONE_LAUNCH_GROUPS) | {k for w in profs.values() for p in w for k in p[1] if "(port" in k})
    device_n = {name: {k: max(p[1].get(k, (0.0, 0))[1] for p in w) for k in groups} for name, w in profs.items()}
    one_call = {k: sum(added[c] for c in counters) for k, counters in ONE_LAUNCH_GROUPS.items()}
    device_ok = (device_n["graph"] == device_n["eager"] and device_n["graph"]["A groupnorm (port)"] > 0
                 and all(device_n["graph"][k] == n for k, n in one_call.items()))
    maxdiff = lambda a, b: float((outs[a] - outs[b]).abs().max())
    spread = maxdiff("eager", "eager again")
    diffs = [maxdiff("graph, first call", "eager"), maxdiff("graph", "eager")]
    agree = max(diffs) <= spread
    launches_ok = (all(launched[k] == launched["eager"] for k in launched)
                   and all(launched["eager"][k] == c * n for k, c in per_step.items()))
    eager_s, graph_s = (statistics.median(samples[k]) for k in ("eager", "graph"))
    device = {k: sum(v[0] for v in prof[1].values()) / n for k, prof in (("eager", eager_prof), ("graph", graph_prof))}
    ok = agree and launches_ok and device_ok and bool(torch.isfinite(outs["graph"]).all())
    say(f"  {label} 14x{height}x{width}, {n} steps: eager vs eager max diff {spread:.4g}; graph vs eager "
        f"{diffs[0]:.4g} (first call) / {diffs[1]:.4g} (replays only): "
        f"{('bitwise equal' if max(diffs) == 0 else 'within the eager spread') if agree else 'FAIL'}")
    say(f"    launches over {n} steps: eager {launched['eager']}, graph {launched['graph']} (predicted {per_step} a "
        f"step) {'ok' if launches_ok else 'FAIL'}")
    short = lambda d: {k.split(" (")[0]: n for k, n in d.items() if n}
    say(f"    device launches of the port's kernels under torch.profiler, {n} steps: eager {short(device_n['eager'])}, "
        f"graph {short(device_n['graph'])}; added to the counts by the graph's run for the kernels of one launch "
        f"a call {short(one_call)} {'ok' if device_ok else 'FAIL'}")
    span = lambda k: f"{min(samples[k]):.4f}-{max(samples[k]):.4f}"
    say(f"    s/denoise-step, median of {len(samples['eager'])} calls each: eager {eager_s:.4f} ({span('eager')}), "
        f"graphed {graph_s:.4f} ({span('graph')}) ({eager_s / graph_s:.3f}x); first graphed call "
        f"{secs['graph, first call']:.3f} s, of it capture + instantiate {runner.capture_s:.3f} s")
    for name, prof in (("eager", eager_prof), ("graphed", graph_prof)):
        key = "graph" if name == "graphed" else "eager"
        wall = (graph_s if key == "graph" else eager_s) * 1e3
        say(f"    {name} under torch.profiler: device {device[key]:.2f} ms a step, wall {prof[0] / n:.2f} ms a step "
            f"profiled ({device[key] * n / prof[0]:.3f} busy), {wall:.2f} ms unprofiled ({device[key] / wall:.3f} "
            f"busy) on {card}")
    if not ok:
        fail(f"the denoise graph ({label}) disagrees with the eager loop or launched other kernels than it")
    return eager_s, graph_s


def direct_generate_check(torch, bundle, params, steps, height, width, cfg, card, label):
    """generate() called directly, as a script calls it, at 14 x height x
    width under KernelConfig `cfg`, `steps` steps: with the eager loop
    (denoise_eager, the loop before the graph), then with the module's
    captured graph twice (the first call captures it, the second replays
    it), then with the eager loop again. Prints s/request of each; fails
    unless the second graphed call reuses the first one's graph and the
    graph's outputs equal the eager loop's where the two eager runs are
    equal (else differ no more than they do)."""
    import dataclasses

    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    b = dataclasses.replace(bundle, kernels=cfg)
    rng = np.random.RandomState(300)
    image = rng.rand(1, height, width, 3).astype(np.float32)
    control = rng.rand(1, 14, height, width, 3).astype(np.float32)
    g = torch.Generator(device="cuda")
    g.manual_seed(301)
    noises = {"latents": torch.randn(1, 14, height // 8, width // 8, 4, generator=g, device="cuda"),
              "image_aug": torch.randn(1, height, width, 3, generator=g, device="cuda")}
    sched = make_schedule(b.scheduler, steps)
    pcfg = PipelineConfig(height=height, width=width, num_frames=14, num_inference_steps=steps)
    eager_loop = lambda *a, graph=None, **k: pipe_m.denoise_eager(*a, **k)
    outs, secs, graphs = {}, {}, []
    for name in ("eager", "graph, first call", "graph", "eager again"):
        loop = mock.patch.object(pipe_m, "denoise", eager_loop) if "eager" in name else contextlib.nullcontext()
        with loop:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = pipe_m.generate(params, b, pcfg, image, control, noises, [[6.0, 128.0, 0.02]],
                                         sched.sigmas, sched.timesteps, 14)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        if "graph" in name:
            graphs.append((pipe_m._SHARED_GRAPH._graph, pipe_m._SHARED_GRAPH.capture_s))
    maxdiff = lambda a, c: float((outs[a] - outs[c]).abs().max())
    spread = maxdiff("eager", "eager again")
    diff = max(maxdiff("graph, first call", "eager"), maxdiff("graph", "eager"))
    reused = graphs[1][0] is graphs[0][0] is not None
    ok = diff <= spread and reused and bool(torch.isfinite(outs["graph"]).all())
    say(f"  {label} generate() 14x{height}x{width}, {steps} steps, called directly: s/request eager loop "
        f"{secs['eager']:.3f} / {secs['eager again']:.3f}, graph {secs['graph, first call']:.3f} (first call, "
        f"capture + instantiate {graphs[0][1]:.3f} s) / {secs['graph']:.3f} (replays its graph: {reused}); "
        f"graph vs eager max diff {diff:.4g} (eager vs eager {spread:.4g}) {'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        fail(f"generate() ({label}) called directly: its graph disagrees with the eager loop or was not reused")


# Phase 5(e)-(g): the micro-step's captured graph against the eager step,
# the other training configurations, resume.
GRAPH_TRAIN_STEPS = 4   # micro-steps from one state in each run of 5(e): two updates
TRAIN_TIME_ROUNDS = 2   # rounds of (eager, graph, graph, eager) optimizer steps timing 5(e)
# 5(f): each configuration's name, hint variant, KernelConfig switches and
# TrainConfig options.
TRAIN_CONFIGS = (
    ("bbox", "bbox", {}, {}),
    ("cam", "cam", {}, {}),
    ("rot", "rot", {}, {}),
    ("temp", "temp", {}, {}),
    ("un-fused", "base", UNFUSED, {}),
    ("memory options", "base", {}, dict(grads_bf16=True, adam_mu_bf16=True, grad_accum_dtype="bfloat16",
                                         encode_outside_step=True)),
)


def _to_host(obj):
    """A copy of a state dict with every tensor in host memory."""
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if hasattr(obj, "to") and hasattr(obj, "is_cuda"):
        # Detached: a copy that kept the masters' autograd nodes alive would
        # tie them to this stream, and a later capture on another stream
        # would have to wait on it (which capture refuses).
        return obj.detach().to("cpu", copy=True)
    return obj


def train_state_groups(trainer):
    """The trainer's tensors that a step updates, by group: params
    (float32 masters), EMA, Adam's moments, the gradient accumulator."""
    st = trainer.state
    masters = _tree_leaves(st.controlnet_params)
    moments = [st.optimizer.state[p][k] for p in masters if p in st.optimizer.state
               for k in ("exp_avg", "exp_avg_sq")]
    return {"params": masters, "EMA": _tree_leaves(st.ema_params), "moments": moments, "accumulator": st.grad_acc}


def state_diff(torch, host, live):
    """Max |a - b| of each group between a host copy (train_state_groups
    through _to_host) and the live tensors, leaf by leaf on the card."""
    out = {}
    with torch.no_grad():
        for name, hs in host.items():
            ls = live[name]
            if len(hs) != len(ls):
                out[name] = float("inf")
                continue
            out[name] = max((float((h.to(d.device) - d).abs().max()) for h, d in zip(hs, ls) if d.numel()),
                            default=0.0)
    return out


def state_bytes(trainer) -> int:
    """Bytes of the tensors a checkpoint holds (Trainer.state_dict)."""
    return sum(t.numel() * t.element_size() for ts in train_state_groups(trainer).values() for t in ts)


def memory_numbers(torch, trainer, batch):
    """(GiB allocated at rest, GiB at the peak of one eager micro-step that
    ends an accumulation window, the update included). The trainer must be
    one micro-step short of a window's end; the step is taken."""
    if trainer.state.step % trainer.tcfg.gradient_accumulation_steps != trainer.tcfg.gradient_accumulation_steps - 1:
        fail("memory_numbers: the trainer is not one micro-step short of an update")
    gc.collect()
    torch.cuda.empty_cache()
    rest = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    trainer.step_eager(batch)
    torch.cuda.synchronize()
    return rest, torch.cuda.max_memory_allocated() / 2**30


def graph_train_check(torch, native, bundle, params, f, h, w, card):
    """Phase 5(e): the micro-step replayed from its captured CUDA graph
    (Trainer.step) against the same micro-step issued from the host
    (Trainer.step_eager), at full width with the TrainConfig defaults.

    GRAPH_TRAIN_STEPS micro-steps (two optimizer updates) from one state
    and one generator state, four times: eager, eager again, graphed with a
    first call that captures, graphed with replays only. Params, EMA,
    moments and accumulator must be bitwise equal to the eager run's where
    the two eager runs are (else differ no more than they do), with the
    same launches by the wrappers' counts; the profiler's device launches
    of each port kernel in a graphed micro-step must equal an eager one's
    and, for the kernels of one launch a call, what the replay added to the
    counts. s/micro-step and s/optimizer-step: medians over
    TRAIN_TIME_ROUNDS rounds of eager, graph, graph, eager optimizer steps
    (each after a garbage collection); the graphed step must not be slower.
    Returns what it measured; fails on a miss."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import Trainer

    sync = torch.cuda.synchronize
    tcfg = TrainConfig(num_frames=f, height=h, width=w)
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    trainer = Trainer(bundle, tcfg, frozen, params["controlnet"], device="cuda")
    batch = training_batch(torch, f, h, w, 4321)
    init = _to_host(trainer.state_dict())
    out = {}

    def run(step):
        trainer.load_state_dict(init)
        native.reset_launches()
        sync()
        t0 = time.perf_counter()
        losses = [float(step(batch)["loss"]) for _ in range(GRAPH_TRAIN_STEPS)]
        sync()
        return losses, dict(native.LAUNCHES), time.perf_counter() - t0

    runs = {}
    runs["eager"] = run(trainer.step_eager)
    ref = _to_host(train_state_groups(trainer))
    diffs = {}
    for name, step in (("eager again", trainer.step_eager), ("graph, first call", trainer.step),
                       ("graph", trainer.step)):
        runs[name] = run(step)
        diffs[name] = state_diff(torch, ref, train_state_groups(trainer))
        if name == "graph, first call":
            out["capture_s"] = trainer.graph.capture_s
    del ref
    spread = max(diffs["eager again"].values())
    worst = max(max(diffs[k].values()) for k in ("graph, first call", "graph"))
    out["bitwise"] = worst == 0.0
    out["agree"] = worst <= spread and all(runs[k][0] == runs["eager"][0] or spread > 0 for k in runs)
    out["launches_equal"] = all(runs[k][1] == runs["eager"][1] for k in runs)
    say(f"  (e) the micro-step as one captured CUDA graph vs issued from the host, {GRAPH_TRAIN_STEPS} micro-steps "
        f"(two updates) from one state, 14x{h}x{w}, defaults: eager vs eager max diff "
        f"{ {k: round(v, 9) for k, v in diffs['eager again'].items()} }; graph vs eager "
        f"{ {k: round(v, 9) for k, v in diffs['graph, first call'].items()} } (first call) / "
        f"{ {k: round(v, 9) for k, v in diffs['graph'].items()} } (replays only): "
        f"{('bitwise equal' if out['bitwise'] else 'within the eager spread') if out['agree'] else 'FAIL'}; "
        f"losses {runs['eager'][0]} / {runs['graph'][0]}")
    say(f"    launches over {GRAPH_TRAIN_STEPS} micro-steps: eager {runs['eager'][1]}, graph {runs['graph'][1]} "
        f"{'ok' if out['launches_equal'] else 'FAIL'}; capture + instantiate {out['capture_s']:.3f} s, the first "
        f"graphed run {runs['graph, first call'][2]:.3f} s against {runs['graph'][2]:.3f} replaying")

    # s/micro-step and s/optimizer-step in turns; the state moves on.
    samples = {"eager": ([], []), "graph": ([], [])}
    steps = {"eager": trainer.step_eager, "graph": trainer.step}
    for _ in range(TRAIN_TIME_ROUNDS):
        for name in ("eager", "graph", "graph", "eager"):
            gc.collect()
            sync()
            t0 = time.perf_counter()
            steps[name](batch)
            sync()
            t1 = time.perf_counter()
            steps[name](batch)
            sync()
            samples[name][0].append(t1 - t0)
            samples[name][1].append(time.perf_counter() - t0)
    out["state_gb"] = state_bytes(trainer) / 1e9  # the moments exist now
    med = {k: (statistics.median(v[0]), statistics.median(v[1])) for k, v in samples.items()}
    out["micro_s"] = {k: v[0] for k, v in med.items()}
    out["opt_s"] = {k: v[1] for k, v in med.items()}

    # Micro-steps under the profiler, each at the start of a window (no
    # update in it), then the window's end, also profiled: its launches
    # beyond a replay's are the eager update's (clip, AdamW, EMA, the
    # accumulator's mean and zeroing). Two windows of each: the profiler
    # can drop a record of a window of ~22,000 launches (one kernel A of an
    # eager micro-step in one run) but never adds one, so each group's
    # device launches are the larger count of the two.
    def window(step):
        native.reset_launches()
        start = profile_step(torch, lambda: step(batch))
        added = dict(native.LAUNCHES)
        return start, added, profile_step(torch, lambda: step(batch))

    profs = {name: [window(step) for _ in range(2)] for name, step in (("eager", trainer.step_eager),
                                                                      ("graph", trainer.step))}
    eager_prof, graph_prof = profs["eager"][0][0], profs["graph"][0][0]
    added = profs["graph"][0][1]
    count = lambda prof: sum(v[1] for v in prof[1].values())  # noqa: E731
    out["update_launches"] = count(profs["graph"][0][2]) - count(graph_prof)
    out["update_ms"] = profs["graph"][0][2][0] - graph_prof[0]
    groups = sorted(set(ONE_LAUNCH_GROUPS) | {k for w in profs.values() for p in w for k in p[0][1] if "(port" in k})
    device_n = {name: {k: max(p[0][1].get(k, (0.0, 0))[1] for p in w) for k in groups} for name, w in profs.items()}
    one_call = {k: sum(added[c] for c in counters) for k, counters in ONE_LAUNCH_GROUPS.items()}
    out["device_ok"] = (device_n["graph"] == device_n["eager"] and device_n["graph"]["A groupnorm (port)"] > 0
                        and all(device_n["graph"][k] == n for k, n in one_call.items()))
    device = {k: sum(v[0] for v in prof[1].values()) for k, prof in (("eager", eager_prof), ("graph", graph_prof))}
    out["busy"] = {k: device[k] / (out["micro_s"][k] * 1e3) for k in device}
    out["profiles"] = {"eager": eager_prof, "graph": graph_prof}
    trainer.step(batch)
    out["mem"] = memory_numbers(torch, trainer, batch)
    gc.collect()
    torch.cuda.empty_cache()
    out["graph_pool_gib"] = (torch.cuda.memory_reserved() - torch.cuda.memory_allocated()) / 2**30
    short = lambda d: {k.split(" (")[0]: n for k, n in d.items() if n}
    say(f"    device launches of the port's kernels in one micro-step under torch.profiler: eager "
        f"{short(device_n['eager'])}, graph {short(device_n['graph'])}; added to the counts by the replay for the "
        f"kernels of one launch a call {short(one_call)} {'ok' if out['device_ok'] else 'FAIL'}")
    span = lambda k, i: f"{min(samples[k][i]):.4f}-{max(samples[k][i]):.4f}"
    say(f"    s/micro-step, median of {len(samples['eager'][0])} each in turns: eager {out['micro_s']['eager']:.4f} "
        f"({span('eager', 0)}), graphed {out['micro_s']['graph']:.4f} ({span('graph', 0)}) "
        f"({out['micro_s']['eager'] / out['micro_s']['graph']:.3f}x); s/optimizer-step eager "
        f"{out['opt_s']['eager']:.4f} ({span('eager', 1)}), graphed {out['opt_s']['graph']:.4f} "
        f"({span('graph', 1)}) on {card}")
    for name, prof in (("eager", eager_prof), ("graph", graph_prof)):
        wall_ms = out["micro_s"][name] * 1e3
        say(f"    {name} micro-step under torch.profiler: device {device[name]:.1f} ms, wall {prof[0]:.1f} ms "
            f"profiled, {wall_ms:.1f} ms unprofiled: busy share {device[name] / wall_ms:.3f}")
    say(f"    the update at a window's end, eager foreach ops: {out['update_launches']} device launches beyond a "
        f"replay's, {out['update_ms']:.1f} ms of wall beyond it under the profiler")
    say(f"    memory: {out['mem'][0]:.2f} GiB allocated at rest, {out['mem'][1]:.2f} GiB at the peak of an eager "
        f"micro-step; the graph's private pool {out['graph_pool_gib']:.2f} GiB; a checkpoint's tensors "
        f"{out['state_gb']:.2f} GB")
    print_profile(f"profile of one graphed micro-step on {card}", graph_prof)
    ok = (out["agree"] and out["launches_equal"] and out["device_ok"]
          and out["micro_s"]["graph"] <= out["micro_s"]["eager"])
    if not ok:
        fail("the graphed micro-step disagrees with the eager one, launched other kernels, or is slower")
    del trainer, init
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_configs_check(torch, ops, native, params, f, h, w, grad_tol, default_mem, card):
    """Phase 5(f): each of TRAIN_CONFIGS at full width, on phase 3's
    parameters (the variant's hint encoder swapped in, variant_hint_params):
    one micro-step's accumulated gradient with the kernels (Trainer.step's
    first call: eager on the capture stream, then the capture) against the
    all-plain eager step from the same state within phase 5(a)'s
    tolerance; the second
    micro-step replayed, with the update; a third micro-step from one state
    replayed and issued from the host, which must agree; memory at rest and
    at the peak of an eager micro-step that ends a window, beside the
    defaults' (`default_mem`, 5(e)'s). Returns {name: launches of the
    first micro-step}; fails on a miss."""
    import dataclasses

    from posetraj_torch.configs import KernelConfig, TrainConfig
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.train import Trainer

    sync = torch.cuda.synchronize
    g = torch.Generator(device="cuda")
    g.manual_seed(515)
    extra = {"bbox_trajectories": torch.rand(1, f, h, w, 3, generator=g, device="cuda") * 2 - 1,
             "cam_parameter": torch.randn(1, f, 12, generator=g, device="cuda"),
             "rot_id": torch.tensor([1], device="cuda")}
    needs = {"bbox": "bbox_trajectories", "cam": "cam_parameter", "rot": "rot_id"}
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    launches = {}
    for name, variant, switches, options in TRAIN_CONFIGS:
        t_start = time.perf_counter()
        bundle = dataclasses.replace(ModelBundle.with_variant(variant), kernels=KernelConfig(**switches))
        cp = dict(params["controlnet"])
        if variant != "base":
            cp["controlnet_cond_embedding"] = variant_hint_params(torch, variant, 61)[1]
        trainer = Trainer(bundle, TrainConfig(num_frames=f, height=h, width=w, **options), frozen, cp, device="cuda")
        del cp
        batch = training_batch(torch, f, h, w, 4321)
        if variant in needs:
            batch[needs[variant]] = extra[needs[variant]]
        st = trainer.state

        def rewind(gen_state, step):
            with torch.no_grad():
                torch._foreach_zero_(st.grad_acc)
            st.step = step
            trainer.generator.set_state(gen_state)

        # The kernels' micro-step first (the graph's first call: eager on the
        # capture stream, then the capture), so that the graph's pool is
        # taken before the plain step's large attention buffers are cached.
        g0 = trainer.generator.get_state()
        native.reset_launches()
        loss_k = float(trainer.step(batch)["loss"])
        sync()
        launches[name] = first = dict(native.LAUNCHES)
        acc_k = [a.clone() for a in st.grad_acc]
        g1 = trainer.generator.get_state()
        rewind(g0, 0)
        native.reset_launches()
        with plain_versions(ops):
            loss_p = float(trainer.step_eager(batch)["loss"])
        plain_launches = sum(native.LAUNCHES.values())
        rel = _rel_rms(acc_k, st.grad_acc)
        rewind(g1, 1)
        with torch.no_grad():
            torch._foreach_copy_(st.grad_acc, acc_k)
        del acc_k
        gc.collect()
        torch.cuda.empty_cache()
        native.reset_launches()
        trainer.step(batch)  # replayed; the update
        sync()
        replayed = dict(native.LAUNCHES)
        adam = [v for s in st.optimizer.state.values() for k, v in s.items() if k == "step"]
        updated = len(adam) == len(_tree_leaves(st.controlnet_params)) and bool(
            all(torch.isfinite(p).all() for p in _tree_leaves(st.controlnet_params)))
        g1 = trainer.generator.get_state()
        trainer.step_eager(batch)
        acc_e = [a.clone() for a in st.grad_acc]
        rewind(g1, 2)
        trainer.step(batch)
        sync()
        graph_vs_eager = _rel_rms(st.grad_acc, acc_e)
        bitwise = all(torch.equal(a, b) for a, b in zip(st.grad_acc, acc_e))
        del acc_e
        rest, peak = memory_numbers(torch, trainer, batch)
        ok = (np.isfinite(loss_k) and rel <= grad_tol and plain_launches == 0 and replayed == first and updated
              and graph_vs_eager <= 1e-3 and first["groupnorm"] > 0)
        if name == "un-fused":
            ok = ok and all(first[k] > 0 for k in ("flash_fwd", "flash_bwd", "flash_tq", "layernorm")) and not any(
                first[k] for k in ("qkvt", "temporal", "frame_attn"))
        elif name == "temp":
            ok = ok and first["mlp"] > launches["bbox"]["mlp"]
        short = {k: n for k, n in first.items() if n}
        say(f"  (f) {name}: loss {loss_k:.6g} (plain {loss_p:.6g}), gradient vs all-plain rel_rms={rel:.4g} "
            f"(tol {grad_tol:g}); replayed micro-step vs eager rel_rms={graph_vs_eager:.3g} "
            f"({'bitwise' if bitwise else 'not bitwise'}); launches a micro-step {short} (replay: "
            f"{'same' if replayed == first else replayed}); update applied {updated}; memory {rest:.2f} GiB at "
            f"rest, {peak:.2f} GiB eager peak (defaults {default_mem[0]:.2f} / {default_mem[1]:.2f}, 5(e)); "
            f"{time.perf_counter() - t_start:.1f} s {'ok' if ok else 'FAIL'}")
        del trainer, st, batch
        gc.collect()
        torch.cuda.empty_cache()
        if not ok:
            fail(f"training under {name} disagrees with the plain step, its replay with the eager step, or "
                 "launched other kernels than expected")
    return launches


def resume_check(torch, params, f, h, w, card):
    """Phase 5(g): resume from a checkpoint at a reduced depth (UNet and
    ControlNet of two levels, 320 and 640 wide, one layer a block; VAE and
    CLIP at full width): a run of five graphed micro-steps, saved after the
    third, against a new Trainer restored from that checkpoint for the last
    two, bitwise. Returns (checkpoint GB on disk, save s, restore s)."""
    import dataclasses
    import tempfile

    from posetraj_torch.configs import ControlNetConfig, TrainConfig
    from posetraj_torch.pipeline import ModelBundle, init_params
    from posetraj_torch.train import Trainer, restore_checkpoint, save_checkpoint
    from posetraj_torch.train.checkpoints import STATE_FILE

    full = ModelBundle()
    u = dataclasses.replace(full.unet, block_out_channels=(320, 640), cross_attention_levels=(True, True),
                            num_attention_heads=(5, 10), layers_per_block=1)
    bundle = dataclasses.replace(full, unet=u, controlnet=ControlNetConfig(unet=u))
    small = init_params(bundle, seed=9, device="cuda")
    frozen = {"unet": small["unet"], "vae": params["vae"], "clip": params["clip"]}
    tcfg = TrainConfig(num_frames=f, height=h, width=w, lr_warmup_steps=1)
    make = lambda: Trainer(bundle, tcfg, frozen, small["controlnet"], device="cuda")
    batch = training_batch(torch, f, h, w, 777)
    run = make()
    with tempfile.TemporaryDirectory() as root:
        for _ in range(3):
            run.step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(root, run.state.step, run, keep_total_limit=1)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(path, STATE_FILE)) / 1e9
        want = [float(run.step(batch)["loss"]) for _ in range(2)]
        resumed = make()
        with torch.no_grad():
            for ts in train_state_groups(resumed).values():
                for t in ts:
                    t.add_(1.0)  # whatever it held, the checkpoint's values replace it
        t0 = time.perf_counter()
        restore_checkpoint(path, resumed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = [float(resumed.step(batch)["loss"]) for _ in range(2)]
    a, b = train_state_groups(run), train_state_groups(resumed)
    equal = all(len(a[k]) == len(b[k]) and all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a)
    ok = equal and got == want and run.state.step == resumed.state.step == 5
    say(f"  (g) resume at 14x{h}x{w}, UNet/ControlNet (320, 640) one layer a block: checkpoint after micro-step 3 "
        f"{size:.3f} GB on disk, saved in {save_s:.2f} s, restored in {restore_s:.2f} s; micro-steps 4-5 losses "
        f"{got} resumed vs {want} uninterrupted; params, EMA, moments, accumulator bitwise equal {equal} on {card} "
        f"{'ok' if ok else 'FAIL'}")
    del run, resumed, small
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        fail("a run resumed from its checkpoint differs from the uninterrupted run")
    return size, save_s, restore_s


# ---------------------------------------------------------------------------
# Phase 10: the data layer, the training CLI's loop, the inference driver
# ---------------------------------------------------------------------------

# Readers the JAX package imports lazily and a card host may lack: every
# port module must import with each of them refused (import_check).
READERS = ("PIL", "cv2", "imageio", "safetensors", "tensorboard", "torch.utils.tensorboard")
# The device rasterizer against itself on the CPU, as tests/test_torch_data.py
# holds it against the JAX package: gaussian within 1e-5; hard equal but on
# pixels whose least squared distance lies within RASTER_NEAR of a threshold,
# those at most RASTER_HARD_BOUND of the pixels compared. The CPU runs
# RASTER_CPU_FRAMES of each video (rasterize, the per-frame function). The
# host library differs from the card's hard mode only on line-circle overlaps
# or near a threshold, and on at most HOST_BOUND of those pixels.
RASTER_NEAR = 1e-4
RASTER_HARD_BOUND = 1e-3
HOST_BOUND = 0.1
RASTER_CPU_FRAMES = (0, 6, 12)
RASTER_CASES = ((576, 1024, 64), (576, 1024, 256), (320, 576, 64), (320, 576, 256))
# Rounds of (loop, Trainer.step alone, Trainer.step alone, loop) turns of
# LOOP_TURN_STEPS micro-steps that time 10(b).
LOOP_TIME_ROUNDS = 2
LOOP_TURN_STEPS = 3
# The VIPSeg-layout folder 10(b) reads: videos at VIPSeg's 720p, their
# frames JPEG, LOOP_TRACKS CoTracker tracks each.
VIPSEG_VIDEOS, VIPSEG_LEN, VIPSEG_HW, LOOP_TRACKS = 3, 24, (720, 1280), 64


def import_check():
    """Every module of posetraj_torch imports in a fresh interpreter with
    READERS refused, and brings in nothing of JAX or the JAX package."""
    code = (
        "import pkgutil, sys\n"
        f"for m in {READERS!r}:\n"
        "    sys.modules[m] = None\n"
        "import posetraj_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(posetraj_torch.__path__, 'posetraj_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'posetraj_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=HERE)
    say(f"  (a) every posetraj_torch module imports with {', '.join(READERS)} refused: {res.stdout.strip()} "
        f"(modules, JAX modules loaded) in {time.perf_counter() - t0:.1f} s {'ok' if res.returncode == 0 else 'FAIL'}")
    if res.returncode != 0:
        fail(f"a port module does not import without the readers, or imports JAX: {res.stdout}{res.stderr[-2000:]}")


def seeded_tracks(seed, k, f, h, w):
    """(k, f, 2) float32 [x, y] random walks over an h x w frame."""
    rng = np.random.RandomState(seed)
    start = rng.rand(k, 1, 2) * [w, h]
    return (start + rng.randn(k, f, 2).cumsum(axis=1) * 6.0).astype(np.float32)


def near_threshold(torch, pr, tracks, valid, t, h, w):
    """(H, W) bool on the card: pixels of frame t whose least squared
    distance lies within RASTER_NEAR of the line's or the circle's
    threshold, and (H, W) bool: pixels a line and a circle both cover."""
    d_line, d_circle = pr.min_distances(tracks[:, t], tracks[:, t + 1], valid, h, w, pr.chunk_size(h, w))
    line, circle = pr.masks(d_line, d_circle, "hard", 3, 3, 3.0)
    near = ((d_line - 1.5**2).abs() <= RASTER_NEAR) | ((d_circle - 3.0**2).abs() <= RASTER_NEAR)
    return near, (line * circle).bool()


def raster_check(torch, card):
    """Phase 10(a): rasterize_video on the card, hard and gaussian, at
    14x576x1024 and 14x320x576 with 64 and 256 trajectories (every seventh
    invalid), against the same code on the CPU (RASTER_CPU_FRAMES); ms a
    video and peak transient memory. Then the host C++ library (built with
    g++ at first use): its build, ms a video, and its disagreements with
    the card's hard mode on the same floored tracks, all valid, which must
    lie on line-circle overlaps (the library draws trajectory after
    trajectory, the card every circle last) or near a threshold."""
    from posetraj_torch.ops import host_rasterize
    from posetraj_torch.ops import rasterize as pr

    f = 14
    t0 = time.perf_counter()
    built = not host_rasterize.lib_path().exists()
    if not host_rasterize.is_available():
        fail("the host rasterizer library does not build")
    say(f"  (a) host rasterizer library {'built with g++' if built else 'found built'} in "
        f"{time.perf_counter() - t0:.2f} s ({host_rasterize.lib_path().name})")
    for h, w, k in RASTER_CASES:
        tracks = seeded_tracks(h * 7 + k, k, f, h, w)
        valid = np.arange(k) % 7 != 3
        td, vd = torch.from_numpy(tracks).cuda(), torch.from_numpy(valid).cuda()
        tc, vc = torch.from_numpy(tracks), torch.from_numpy(valid)
        for mode in ("hard", "gaussian"):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            video = pr.rasterize_video(td, vd, f, h, w, mode)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            ms = cuda_ms(lambda: pr.rasterize_video(td, vd, f, h, w, mode), reps=3, inner=1)
            t0 = time.perf_counter()
            cpu = [pr.rasterize(tc[:, t], tc[:, t + 1], vc, h, w, mode) for t in RASTER_CPU_FRAMES]
            cpu_s = (time.perf_counter() - t0) / len(RASTER_CPU_FRAMES)
            got = video.cpu()
            ok = (tuple(video.shape) == (f, h, w, 3) and bool(torch.isfinite(got).all()) and not got[-1].any())
            if mode == "gaussian":
                err = max(float((got[t] - c).abs().max()) for t, c in zip(RASTER_CPU_FRAMES, cpu))
                ok = ok and err <= 1e-5
                detail = f"max abs diff vs CPU {err:.3g} (tol 1e-5)"
            else:
                differ = outside = 0
                for t, c in zip(RASTER_CPU_FRAMES, cpu):
                    d = (got[t] != c).any(-1)
                    near = near_threshold(torch, pr, td, vd, t, h, w)[0].cpu()
                    differ += int(d.sum())
                    outside += int((d & ~near).sum())
                bound = RASTER_HARD_BOUND * h * w * len(RASTER_CPU_FRAMES)
                ok = ok and outside == 0 and differ <= bound and bool(got[:-1, ..., 0].any() and got[:-1, ..., 1].any())
                detail = (f"{differ} pixels differ from the CPU, {outside} of them away from a threshold (bound "
                          f"{bound:.0f}, 0)")
            say(f"  (a) rasterize_video {mode:8s} {f}x{h}x{w} K={k}: {ms:.2f} ms a video, peak {peak:.0f} MiB "
                f"transient; CPU {cpu_s:.2f} s a frame; {detail} {'ok' if ok else 'FAIL'} on {card}")
            if not ok:
                fail(f"rasterize_video {mode} on the card disagrees with the CPU at {f}x{h}x{w}, K={k}")
            del video, got
        # The host library against the card's hard mode.
        ints = np.floor(tracks)
        ti, vall = torch.from_numpy(ints).cuda(), torch.ones(k, dtype=torch.bool, device="cuda")
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            host = host_rasterize.rasterize_trajectory_video_native(ints, f, (h, w))
            secs.append(time.perf_counter() - t0)
        dev = (pr.rasterize_video(ti, vall, f, h, w, "hard") * 255).to(torch.uint8).cpu().numpy()
        differ = (host != dev).any(-1)
        allowed = np.zeros_like(differ)
        for t in range(f - 1):
            near, overlap = near_threshold(torch, pr, ti, vall, t, h, w)
            allowed[t] = (near | overlap).cpu().numpy()
        outside = int((differ & ~allowed).sum())
        ok = outside == 0 and int(differ.sum()) <= HOST_BOUND * int(allowed.sum()) and not host[-1].any()
        say(f"  (a) host library {f}x{h}x{w} K={k}: {statistics.median(secs) * 1e3:.1f} ms a video (median of 3); "
            f"{int(differ.sum())} pixels differ from the card's hard mode, on line-circle overlaps or near a "
            f"threshold: {int(allowed.sum())} such pixels (bound {HOST_BOUND} of them), {outside} elsewhere "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the host rasterizer disagrees with the card's hard mode beyond its bound at {f}x{h}x{w}, K={k}")
        torch.cuda.empty_cache()


def make_vipseg_folder(root, seed):
    """A folder in VIPSeg's layout under `root`, from a seed: imgs/<video>/
    of VIPSEG_LEN noise JPEGs at VIPSEG_HW, trajectory_CoTracker_all/
    <video>.json of LOOP_TRACKS tracks, camera/<video>/camera.npy (4D-Humans'
    pred_cam_R and pred_cam_T; the last video's T holds a NaN, which the
    dataset zeroes), train.txt of every video but the last and val.txt of the
    last. Returns (folder, camera folder)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    names = [f"{seed}_{v}" for v in range(VIPSEG_VIDEOS)]
    for v, name in enumerate(names):
        os.makedirs(os.path.join(root, "imgs", name))
        for i in range(VIPSEG_LEN):
            Image.fromarray(rng.randint(0, 256, VIPSEG_HW + (3,), np.uint8)).save(
                os.path.join(root, "imgs", name, f"{i:05d}.jpg"), quality=90)
        tracks = seeded_tracks(seed * 100 + v, LOOP_TRACKS, VIPSEG_LEN, *VIPSEG_HW)
        os.makedirs(os.path.join(root, "trajectory_CoTracker_all"), exist_ok=True)
        with open(os.path.join(root, "trajectory_CoTracker_all", f"{name}.json"), "w") as fh:
            json.dump({str(i): tr.tolist() for i, tr in enumerate(tracks)}, fh)
        cam_t = rng.randn(VIPSEG_LEN, 3).astype(np.float32)
        if v == len(names) - 1:
            cam_t[5, 1] = np.nan
        os.makedirs(os.path.join(root, "camera", name))
        np.save(os.path.join(root, "camera", name, "camera.npy"),
                {"pred_cam_R": rng.randn(VIPSEG_LEN, 3, 3).astype(np.float32), "pred_cam_T": cam_t})
    for split, members in (("train.txt", names[:-1]), ("val.txt", names[-1:])):
        with open(os.path.join(root, split), "w") as fh:
            fh.write("".join(n + "\n" for n in members))
    return root, os.path.join(root, "camera")


def train_cli_check(torch, native, params, card, training_kernels):
    """Phase 10(b): the training CLI's loop (train/cli.train_loop) at full
    width and depth, stage ft_cam (the cam hint encoder swapped into phase
    3's ControlNet), 14x320x576, batch 1, accumulation 2, on the CLI's own
    TrajectoryVIPSegDataset (cli.build_dataset, --rasterizer native,
    --cam_norm) over a make_vipseg_folder, read through PrefetchLoader with
    8 workers (JPEG decode, resize and rasterization in its threads): 4
    micro-steps, a checkpoint with the diffusers exports and a 25-step
    validation render of the held-out video at step 4, in a temporary
    directory under build/ that the phase removes. Checks every loss
    finite, 4 metrics lines, the checkpoint restored into a fresh trainer
    bitwise the live state, each export the converter's state dict of the
    live ControlNet and EMA, the render finite and its GIF written, every
    training kernel launched. Then s/micro-step through the loop against
    Trainer.step alone, medians of turns taken in turns, and the loop's
    busy share."""
    import shutil
    import tempfile

    from PIL import Image

    from posetraj_torch.core.params import tree_map
    from posetraj_torch.data import datasets as data_m
    from posetraj_torch.data import export
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.tools.convert_weights import params_to_diffusers
    from posetraj_torch.train import Trainer
    from posetraj_torch.train import checkpoints as ckpt
    from posetraj_torch.train import cli
    from posetraj_torch.utils import MetricsLogger

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase10-", dir=os.path.join(HERE, "build"))
    try:
        t0 = time.perf_counter()
        folder, cam_path = make_vipseg_folder(os.path.join(root, "vipseg"), 1010)
        folder_s = time.perf_counter() - t0
        args = cli.parse_args(["--stage", "ft_cam", "--video_folder", folder, "--cam_path", cam_path, "--output_dir",
                               os.path.join(root, "out"), "--height", "320", "--width", "576", "--num_frames", "14",
                               "--per_device_batch_size", "1", "--gradient_accumulation_steps", "2",
                               "--max_train_steps", "4", "--checkpointing_steps", "4", "--validation_steps", "4",
                               "--num_validation_samples", "1", "--num_inference_steps", "25", "--num_workers", "8",
                               "--num_train_epochs", "1000", "--cam_norm", "--rasterizer", "native"])
        bundle = ModelBundle.with_variant("cam")
        _, hint = variant_hint_params(torch, "cam", 31)
        cn_params = dict(params["controlnet"], controlnet_cond_embedding=hint)
        frozen = {k: params[k] for k in ("unet", "vae", "clip")}
        cn_dtypes = tree_map(lambda t: t.dtype, cn_params)
        tcfg = cli.train_config(args)
        trainer = Trainer(bundle, tcfg, frozen, cn_params, device="cuda")
        # The datasets as cli.main builds them with --validation_folder.
        dataset = cli.build_dataset(args)
        val_dataset = cli.build_dataset(args, root=folder, split_file=os.path.join(folder, "val.txt"))
        val_dataset.cam_mask_ratio = 0.0
        if len(dataset) != 4 * (VIPSEG_VIDEOS - 1) or len(val_dataset) != 4:
            fail(f"the VIPSeg folder gave {len(dataset)} training and {len(val_dataset)} validation samples")
        t0 = time.perf_counter()
        dataset[0]
        sample_s = time.perf_counter() - t0
        os.makedirs(args.output_dir)

        saves, exports, renders, entries, validations = [], [], [], [], []
        real_save, real_export, real_step = ckpt.save_checkpoint, ckpt.export_diffusers, trainer.step
        real_gif = export.save_side_by_side_gif

        def timed(fn, log):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                log.append((time.perf_counter() - t0, out))
                return out
            return run

        def step(batch):
            entries.append(time.perf_counter())
            return real_step(batch)

        def keep_render(videos, path, fps=7):
            renders.append([np.asarray(export._host(v)) for v in videos])
            return real_gif(videos, path, fps)

        with mock.patch.object(ckpt, "save_checkpoint", timed(real_save, saves)), \
                mock.patch.object(ckpt, "export_diffusers", timed(real_export, exports)), \
                mock.patch.object(export, "save_side_by_side_gif", keep_render), \
                mock.patch.object(cli, "run_validation", timed(cli.run_validation, validations)), \
                mock.patch.object(trainer, "step", step):
            logger = MetricsLogger(args.output_dir)
            native.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = cli.train_loop(args, trainer, frozen, cn_dtypes, dataset, val_dataset, logger)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            launches = dict(native.LAUNCHES)
            first_steps = [b - a for a, b in zip(entries[:-1], entries[1:])]
            logger.close()
        lines = [json.loads(x) for x in open(os.path.join(args.output_dir, "posetraj.metrics.jsonl"))]
        ckpt_dir = os.path.join(args.output_dir, "checkpoint-4")
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, ckpt.STATE_FILE))
        export_bytes = sum(os.path.getsize(p) for _, p in exports)
        say(f"  (b) VIPSeg-layout folder ({VIPSEG_VIDEOS} videos of {VIPSEG_LEN} {VIPSEG_HW[0]}x{VIPSEG_HW[1]} "
            f"JPEGs, {LOOP_TRACKS} tracks each) written in {folder_s:.2f} s; one sample read "
            f"(decode, resize, native rasterizer) in {sample_s * 1e3:.0f} ms on one thread")
        say(f"  (b) training CLI loop, stage ft_cam at full width and depth, 14x320x576, batch 1, accumulation 2, "
            f"{len(dataset)} TrajectoryVIPSegDataset samples through PrefetchLoader (8 workers): 4 micro-steps in "
            f"{loop_s:.2f} s "
            f"with the checkpoint, the exports and the render; losses {[round(x['loss'], 5) for x in lines]}; "
            f"checkpoint {ckpt_bytes / 1e9:.2f} GB saved in {sum(s for s, _ in saves):.2f} s; exports "
            f"{[os.path.basename(p) for _, p in exports]} {export_bytes / 1e9:.2f} GB written in "
            f"{sum(s for s, _ in exports):.2f} s; the validation render (a new pipeline, its graph captured) "
            f"{sum(s for s, _ in validations):.2f} s; micro-steps 1-3 entry to entry "
            f"{[round(x, 3) for x in first_steps]} s (the first runs eagerly and captures); launches {launches} "
            f"on {card}")

        # The checkpoint into a fresh trainer, bitwise the live state.
        fresh = Trainer(bundle, tcfg, frozen, cn_params, device="cuda")
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(ckpt_dir, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        a, b = train_state_groups(trainer), train_state_groups(fresh)
        restored = (all(len(a[k]) == len(b[k]) > 0 and all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a)
                    and fresh.state.step == trainer.state.step == 4
                    and torch.equal(fresh.generator.get_state(), trainer.generator.get_state()))
        del fresh, a, b
        gc.collect()
        torch.cuda.empty_cache()
        # Each export (.safetensors where safetensors imports, else .npz): the
        # converter's state dict of the live ControlNet / EMA.
        same = []
        for (_, path), tree in zip(exports, (trainer.state.controlnet_params, trainer.state.ema_params)):
            want = params_to_diffusers(tree, "controlnet")
            if path.endswith(".safetensors"):
                from safetensors.numpy import load_file

                got = load_file(path)
            else:
                got = dict(np.load(path))
            same.append(sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want))
            del want, got
        (gt, control, out), = renders
        gif = os.path.join(args.output_dir, "validation-4", "sample0.gif")
        gif_frames = Image.open(gif).n_frames if os.path.exists(gif) else 0
        render_ok = (out.shape == (14, 320, 576, 3) and bool(np.isfinite(out).all()) and 0 <= out.min() <= out.max() <= 1
                     and gif_frames == 14)
        ok = (last == 4 and len(lines) == 4 and all(np.isfinite(x["loss"]) for x in lines) and restored
              and len(exports) == 2 and all(same) and render_ok and len(saves) == 1 and len(validations) == 1
              and all(launches[k] > 0 for k in training_kernels))
        say(f"  (b) restored into a fresh trainer in {restore_s:.2f} s: params, EMA, moments, accumulator, step, "
            f"generator bitwise the live state {restored}; exports equal params_to_diffusers of the live "
            f"ControlNet and EMA {same}; validation render {out.shape} in [{out.min():.3f}, {out.max():.3f}], "
            f"its GIF {gif_frames} frames, {render_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("the training CLI's loop: a loss, the metrics, the checkpoint, an export, the render or a kernel "
                 "launch is wrong")

        # s/micro-step through the loop against Trainer.step alone, in turns.
        # Checkpoints, exports and renders are off in these turns.
        turn_args = argparse.Namespace(**vars(args))
        turn_args.checkpointing_steps, turn_args.validation_steps = 10**9, 0
        batches = [data_m._collate([dataset[i]], ("img_key",)) for i in range(LOOP_TURN_STEPS)]
        samples = {"loop": [], "alone": []}

        def loop_turn():
            entries.clear()
            turn_args.max_train_steps = trainer.state.step + LOOP_TURN_STEPS
            cli.train_loop(turn_args, trainer, frozen, cn_dtypes, dataset, val_dataset, logger)
            torch.cuda.synchronize()
            entries.append(time.perf_counter())
            return [b - a for a, b in zip(entries[:-1], entries[1:])]

        def alone_turn():
            out = []
            for batch in batches:
                t0 = time.perf_counter()
                real_step(batch)
                torch.cuda.synchronize()
                out.append(time.perf_counter() - t0)
            return out

        logger = MetricsLogger(os.path.join(root, "turns"))
        with mock.patch.object(ckpt, "save_checkpoint", lambda *a, **k: None), \
                mock.patch.object(trainer, "step", step):
            for _ in range(LOOP_TIME_ROUNDS):
                for name, fn in (("loop", loop_turn), ("alone", alone_turn), ("alone", alone_turn),
                                 ("loop", loop_turn)):
                    gc.collect()
                    samples[name].extend(fn())
            turn_args.max_train_steps = trainer.state.step + 4
            prof = profile_step(torch, lambda: cli.train_loop(turn_args, trainer, frozen, cn_dtypes, dataset,
                                                              val_dataset, logger))
        logger.close()
        loop_ms, alone_ms = (statistics.median(samples[k]) * 1e3 for k in ("loop", "alone"))
        device_ms = sum(v[0] for v in prof[1].values()) / 4
        span = lambda k: f"{min(samples[k]):.4f}-{max(samples[k]):.4f}"
        say(f"  (b) s/micro-step through the loop {loop_ms / 1e3:.4f} ({span('loop')}, {len(samples['loop'])} "
            f"micro-steps) against Trainer.step alone {alone_ms / 1e3:.4f} ({span('alone')}, "
            f"{len(samples['alone'])}), medians of turns taken in turns: the loop (metrics read a micro-step, "
            f"the loader) adds {loop_ms - alone_ms:.1f} ms; device time {device_ms:.1f} ms a micro-step under "
            f"torch.profiler, busy share of the loop {device_ms / loop_ms:.3f} on {card}")
        del trainer, logger
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def driver_check(torch, native, steps, per_request, card):
    """Phase 10(c): the inference driver's per-sample functions on
    build_pipeline(None, None, variant) (random full-width parameters from
    seeded torch generators): blender_sample with --bbox at 14x576x1024 and
    vipseg_sample with the base variant at the driver's default 14x320x576,
    its control from the host library. Each must equal a direct pipeline
    call on the same inputs and seed, bitwise, and each request launch what
    phase 4's (and phase 8's bbox) request launched."""
    from posetraj_torch import inference
    from posetraj_torch.data.datasets import _normalize
    from posetraj_torch.ops import host_rasterize
    from posetraj_torch.ops.rasterize import rasterize_host, scale_trajectories

    rng = np.random.RandomState(1010)
    cases = []
    b_args = inference.parse_args(["--mode", "blender", "--bbox", "--data_root", "in-memory", "--height", "576",
                                   "--width", "1024", "--steps", str(steps)])
    f, hh, ww = b_args.num_frames, b_args.height, b_args.width
    corners = seeded_tracks(1011, 8, f, hh, ww).transpose(1, 0, 2).copy()
    tracks = np.floor(seeded_tracks(1012, 64, f, hh, ww))
    sample = {"pixel_values": _normalize(rng.randint(0, 256, (f, hh, ww, 3)).astype(np.float32)),
              "trajectories": _normalize(rasterize_host(tracks, f, (hh, ww), impl="native").astype(np.float32)),
              "bbox_trajectories": _normalize(host_rasterize.rasterize_bbox_video_native(corners, f, (hh, ww))
                                              .astype(np.float32))}

    def blender_direct(pipe):
        image = (sample["pixel_values"][0] + 1.0) / 2.0
        return pipe(image[None], ((sample["trajectories"] + 1.0) / 2.0)[None], height=hh, width=ww, num_frames=f,
                    num_inference_steps=steps, seed=b_args.seed,
                    bbox_condition=(sample["bbox_trajectories"][None] + 1.0) / 2.0)

    cases.append(("blender --bbox", "bbox", lambda pipe: inference.blender_sample(pipe, sample, b_args),
                  blender_direct))
    v_args = inference.parse_args(["--mode", "vipseg", "--data_root", "in-memory", "--steps", str(steps)])
    f, hv, wv = v_args.num_frames, v_args.height, v_args.width
    image = rng.rand(hv, wv, 3).astype(np.float32)
    pts = scale_trajectories(seeded_tracks(1013, 64, f, 480, 854), (480, 854), (hv, wv))
    control = rasterize_host(pts, f, (hv, wv), impl="native").astype(np.float32) / 255.0

    def vipseg_direct(pipe):
        return pipe(image[None], control[None], height=hv, width=wv, num_frames=f, num_inference_steps=steps,
                    motion_bucket_id=v_args.motion_bucket_id, controlnet_cond_scale=v_args.cond_scale,
                    seed=v_args.seed)

    cases.append(("vipseg", inference.variant_of(v_args),
                  lambda pipe: inference.vipseg_sample(pipe, image, control, v_args), vipseg_direct))
    for label, variant, per_sample, call in cases:
        t0 = time.perf_counter()
        pipe = inference.build_pipeline(None, None, variant)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        outs, secs, launched = [], [], []
        for fn in (per_sample, lambda p: call(p)[0]):
            native.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(fn(pipe))
            secs.append(time.perf_counter() - t0)
            launched.append(dict(native.LAUNCHES))
        out = outs[0]
        ok = (np.array_equal(outs[0], outs[1]) and all(n == per_request for n in launched)
              and bool(np.isfinite(out).all()) and 0.0 <= out.min() <= out.max() <= 1.0)
        nonzero = {k: n for k, n in launched[0].items() if n}
        say(f"  (c) inference driver {label} {'x'.join(map(str, out.shape[:3]))}, {steps} steps: build_pipeline "
            f"{build_s:.2f} s; s/request {secs[0]:.3f} (per-sample function, captures its graph) / {secs[1]:.3f} "
            f"(direct pipeline call, replays it); outputs bitwise equal {np.array_equal(outs[0], outs[1])}; "
            f"launches a request {nonzero} (phase 4's {({k: n for k, n in per_request.items() if n})}) "
            f"{'ok' if ok else 'FAIL'} on {card}")
        if not ok:
            fail(f"the inference driver's {label} render differs from a direct pipeline call or launched other "
                 "kernels than phase 4's request")
        del pipe, outs
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 11: single-video sharded serving (parallel/serve.py, spmd.py)
# ---------------------------------------------------------------------------

# Kernel A's split form at the flagship's level-0 resnet GroupNorm: (2, 4)
# gives each rank (14, 72, 32, 320) of the (28, 72, 128, 320) activation.
SPLIT_GN_SHAPES = (("(2,4)-local", (14, 72, 32, 320)), ("full", (28, 72, 128, 320)))
# The (cfg, sp) meshes whose rank-local shapes 11(a) sweeps, and the
# GroupNorms of one denoise step (ControlNet + UNet), each a split call
# where every level is W-sharded, as at 14x576x1024 on these meshes.
SPLIT_MESHES = ((1, 2), (2, 2), (2, 4))
GN_PER_STEP = 152
# Bytes written between timed calls that must find L2 cold: more than the
# 50 MB L2 of an H100 holds.
FLUSH_BYTES = 256 * 2**20
# Kernel 7 where the sharded path runs it at 14x576x1024: rectangular on
# K/V gathered over sp = 4 at levels 0 and 1 (rank-local B*F = 14 under
# cfg = 2), square at level 0 on a (1, 1) mesh (C off under the context).
GATHERED_FLASH = (("(2,4) level 0, K/V gathered", 14, 2304, 9216, 5),
                  ("(2,4) level 1, K/V gathered", 14, 576, 2304, 10),
                  ("(1,1) level 0, square", 28, 9216, 9216, 5))
# The switches generate() runs with to launch what the sharded path does:
# kernels C and D decline under a spatial-sharding context.
SHARDED_AS = dict(qkvt_attn=False, temporal_attn=False)
# generate_sharded on (1, 1) against generate() under SHARDED_AS: the two
# differ only in the CFG combine's float32 rounding (sum_b coeff_b pred_b
# against uncond + g (cond - uncond)), a last-bit change of each step's
# noise prediction that the next step's bf16 input can round either way,
# and the full-width model with peaked attention carries such a change on
# through its steps. Its yardstick is measured in the same run: generate()
# again with the initial latents moved by one float32 ulp (nextafter). The
# sharded latents must lie within SHARDED_FLOOR_FACTOR times that floor
# (or SHARDED_MIN_TOL, where the floor is below it) of generate()'s.
SHARDED_FLOOR_FACTOR = 2.0
SHARDED_MIN_TOL = 1e-3
SHARDED_RANKS_TIMEOUT_S = 600


def sharded_gn_calls(torch, params):
    """Every kernel-A call of one eager generate() at 14x576x1024 (default
    KernelConfig, one Euler step, CFG), recorded by tools/kernel_sweep as
    phase 13(a) records it, that runs inside the denoise loop: the hint
    encoder's and the step's, the calls generate_sharded makes under the
    spatial-sharding context (CLIP and the VAE run outside it). Returns
    [(stage "hint" or "step", x shape, addend shape or None, dtype)]."""
    from posetraj_torch.configs import KernelConfig
    from posetraj_torch.ops import groupnorm
    from posetraj_torch.pipeline import svd_controlnet as sc
    from posetraj_torch.tools import kernel_sweep as ks

    calls, stage = [], []
    gn, loop, step = groupnorm.group_norm, sc.denoise_eager, sc._denoise_step

    def counted(*args, **kwargs):
        if stage:
            add = args[6] if len(args) > 6 else kwargs.get("add")
            calls.append((stage[-1], tuple(args[0].shape), None if add is None else tuple(add.shape), args[0].dtype))
        return gn(*args, **kwargs)

    def staged(name, fn):
        def run(*args, **kwargs):
            stage.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                stage.pop()
        return run

    groupnorm.group_norm, sc.denoise_eager, sc._denoise_step = counted, staged("hint", loop), staged("step", step)
    try:
        ks.record_instances(((576, 1024),), KernelConfig(), params=params, device=torch.device("cuda"))
    finally:
        groupnorm.group_norm, sc.denoise_eager, sc._denoise_step = gn, loop, step
    return calls


def split_shapes(torch, calls, meshes=SPLIT_MESHES):
    """The rank-local shapes group_norm_silu hands A's split form on each
    (cfg, sp) mesh at 14x576x1024: every call whose H the mesh shards
    (SpmdCtx.w_sharded_at, the replicated levels from
    serve._check_divisible), W divided by sp, the CFG-doubled batch (x's
    and the addend's first axis) by cfg. Returns ({(x shape, addend shape,
    dtype): sp of the first mesh that gives it}, {mesh: the step's split
    calls})."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.parallel import serve, spmd
    from posetraj_torch.pipeline import ModelBundle

    pcfg = PipelineConfig(height=576, width=1024, num_frames=14, decode_chunk_size=2)
    shapes, per_step = {}, {}
    for n_cfg, n_sp in meshes:
        rep_h, rep_s = serve._check_divisible(pcfg, ModelBundle(), 14, n_cfg, n_sp)
        ctx = spmd.SpmdCtx(spmd.ServeMesh(n_cfg, n_sp, 0, torch.device("cuda")), rep_h, rep_s)
        per_step[(n_cfg, n_sp)] = 0
        for stage, xs, adds, dt in calls:
            if len(xs) < 4 or not ctx.w_sharded_at(xs[-3]):
                continue
            per_step[(n_cfg, n_sp)] += stage == "step"
            local = (xs[0] // n_cfg,) + xs[1:-2] + (xs[-2] // n_sp, xs[-1])
            add = None if adds is None else (adds[0] // n_cfg,) + adds[1:]
            shapes.setdefault((local, add, dt), n_sp)
    return shapes, per_step


def split_case(torch, groupnorm, shape, add_shape, sp, g, dtype=None):
    """x of `sp` W blocks of `shape` (rank-local), drawn apart (block j
    scaled 1 + j and shifted by j), weight, bias, addend, the blocks."""
    bf = dtype or torch.bfloat16
    c, w_axis = shape[-1], len(shape) - 2
    full = shape[:-2] + (shape[-2] * sp, c)
    x = torch.randn(*full, generator=g, device="cuda") + 0.5
    for j, blk in enumerate(x.chunk(sp, dim=w_axis)):
        blk.mul_(1.0 + j).add_(float(j))
    x = x.to(bf)
    w = torch.rand(c, generator=g, device="cuda") + 0.5
    b = torch.randn(c, generator=g, device="cuda") * 0.1
    add = torch.randn(*add_shape, generator=g, device="cuda").to(bf) if add_shape is not None else None
    return x, w, b, add, [blk.contiguous() for blk in x.chunk(sp, dim=w_axis)]


def split_run(torch, groupnorm, blocks, w, b, add, shards):
    """Statistics of every block, summed (the all-reduce of the ranks),
    then the apply of each, concatenated along W; and the sums."""
    sums = sum(groupnorm.group_norm_stats_kernel(blk, 32, add) for blk in blocks)
    y = [groupnorm.group_norm_apply_kernel(blk, w, b, sums, 32, 1e-5, True, add, shards=shards) for blk in blocks]
    return torch.cat(y, dim=blocks[0].ndim - 2), sums


def flush_l2(torch):
    """A write of FLUSH_BYTES, more than the 50 MB L2 holds."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    return lambda: buf.add_(1.0)


def cold_event_ms(torch, fn, flush, calls: int = 15) -> float:
    """Median milliseconds of one call by CUDA events, L2 flushed before
    each outside the bracket."""
    fn()
    times = []
    for _ in range(calls):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def split_groupnorm_check(torch, groupnorm, params, card):
    """Phase 11(a): kernel A's split form. Two W halves of (14, 72, 32, 320)
    (the (2, 4)-local shape) and of (28, 72, 128, 320) bf16 (+ the per-sample
    temb addend, SiLU), and of (2, 14, 72, 128, 320) with its per-frame
    addend: statistics on each, the sums added on the card (what the
    all-reduce of two ranks gives), apply on each; against the one-launch A
    and the plain version at A's tolerance, the float64 sums against the
    plain float32 statistics. The halves are drawn apart, so that a half
    normalised by its own statistics (sums never reduced, or never read)
    fails that tolerance: the check asserts it does. Then the sweep: every
    rank-local shape group_norm_silu hands the split form at 14x576x1024 on
    the SPLIT_MESHES (sharded_gn_calls, split_shapes), the statistics of
    its sp blocks summed and each applied, held the same way; the step's
    split calls on each mesh must be the 152 GroupNorms of a step. Then
    stats and apply timed at the (2, 4)-local and the full shape beside
    one-launch A, the plain versions, torch.var_mean / F.group_norm and the
    bounds: device time from torch.profiler with L2 flushed before each
    call (the time the bytes bound is read against; the JSON rows, the
    (2, 4)-local shape) and warm, and a call by CUDA events cold and warm,
    which at the small shape is the wrapper's host time. Returns the JSON
    rows."""
    F = torch.nn.functional
    bf = torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(1111)
    from posetraj_torch.tools.kernel_sweep import TOLERANCES

    tol = TOLERANCES["groupnorm.group_norm"][0]  # A's (phase 2)

    def inputs(shape, add_shape, apart=False):
        c = shape[-1]
        x = torch.randn(*shape, generator=g, device="cuda") + 0.5
        if apart:
            # The second W half x3 + 2: each half's own mean and variance
            # are then far from the whole tensor's.
            half = shape[-2] // 2
            x.narrow(x.ndim - 2, half, half).mul_(3.0).add_(2.0)
        return (x.to(bf), torch.rand(c, generator=g, device="cuda") + 0.5,
                torch.randn(c, generator=g, device="cuda") * 0.1,
                torch.randn(*add_shape, generator=g, device="cuda").to(bf))

    say(f"phase 11: single-video sharded serving on {card}")
    ok_all, errs = True, {"gn_stats": 0.0, "gn_apply": 0.0}
    cases = [(shape, (shape[0], 320)) for _, shape in SPLIT_GN_SHAPES] + [((2, 14, 72, 128, 320), (2, 14, 320))]
    for shape, add_shape in cases:
        x, w, b, add = inputs(shape, add_shape, apart=True)
        halves = [h.contiguous() for h in x.chunk(2, dim=x.ndim - 2)]
        got, sums = split_run(torch, groupnorm, halves, w, b, add, 2)
        want_sums = groupnorm.group_norm_stats_plain(x, 32, add).double()
        sums_err = float((sums - want_sums).abs().max() / want_sums.abs().max())
        want = groupnorm.group_norm_plain(x, w, b, 32, 1e-5, True, add)
        err_one, scale, rr_one, ok_one = compare(got, groupnorm.group_norm_kernel(x, w, b, 32, 1e-5, True, add), tol)
        err_p, _, rr_p, ok_p = compare(got, want, tol)
        # Each half by its own statistics: what a split form that lost the
        # reduction gives. It must fail the tolerance, or the check is blind.
        local = torch.cat([groupnorm.group_norm_apply_kernel(h, w, b, groupnorm.group_norm_stats_kernel(h, 32, add),
                                                             32, 1e-5, True, add) for h in halves], dim=x.ndim - 2)
        err_local, _, _, ok_local = compare(local, want, tol)
        ok = ok_one and ok_p and sums_err <= 1e-4 and not ok_local
        ok_all &= ok
        errs["gn_stats"] = max(errs["gn_stats"], float((sums - want_sums).abs().max()))
        errs["gn_apply"] = max(errs["gn_apply"], err_p)
        say(f"  (a) split A {str(shape):22s} +temb{' per frame' if len(add_shape) == 3 else ''} +silu, two W halves "
            f"(the second x3 + 2): vs one-launch A max_abs_err={err_one:.4g} rel_rms={rr_one:.3g}, vs plain "
            f"max_abs_err={err_p:.4g} rel_rms={rr_p:.3g} (|ref|max {scale:.3g}, tol {tol:g}x); each half by its own "
            f"statistics max_abs_err={err_local:.4g} (must fail the tol); sums vs plain float32 rel err "
            f"{sums_err:.3g} (tol 1e-4) {'ok' if ok else 'FAIL'}")
        del x, halves, got, add, local, want

    # The sweep at the sharded path's rank-local shapes.
    t0 = time.perf_counter()
    calls = sharded_gn_calls(torch, params)
    shapes, per_step = split_shapes(torch, calls)
    hint_calls = sum(stage == "hint" for stage, *_ in calls)
    step_ok = all(n == GN_PER_STEP for n in per_step.values())
    say(f"  (a) sweep: {len(calls)} kernel-A calls inside one denoise loop at 14x576x1024 ({hint_calls} in the hint, "
        f"{len(calls) - hint_calls} in the step); split calls a step by mesh {per_step} (must be {GN_PER_STEP}) "
        f"{'ok' if step_ok else 'FAIL'}; {len(shapes)} distinct rank-local shapes over the meshes {SPLIT_MESHES}")
    ok_all &= step_ok
    worst = {"err": 0.0, "sums": 0.0, "bad": []}
    for (shape, add_shape, dt), sp in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        x, w, b, add, blocks = split_case(torch, groupnorm, shape, add_shape, sp, g, dt)
        got, sums = split_run(torch, groupnorm, blocks, w, b, add, sp)
        want_sums = groupnorm.group_norm_stats_plain(x, 32, add).double()
        sums_err = float((sums - want_sums).abs().max() / want_sums.abs().max())
        err, scale, _, ok_p = compare(got, groupnorm.group_norm_plain(x, w, b, 32, 1e-5, True, add), tol)
        _, _, _, ok_one = compare(got, groupnorm.group_norm_kernel(x, w, b, 32, 1e-5, True, add), tol)
        ok = ok_p and ok_one and sums_err <= 1e-4
        worst["err"] = max(worst["err"], err / (tol * scale))
        worst["sums"] = max(worst["sums"], sums_err)
        if not ok:
            worst["bad"].append((shape, add_shape, sp))
        errs["gn_stats"] = max(errs["gn_stats"], float((sums - want_sums).abs().max()))
        errs["gn_apply"] = max(errs["gn_apply"], err)
        del x, blocks, got, add
    ok_all &= not worst["bad"]
    say(f"  (a) sweep: {len(shapes)} shapes, each over its sp blocks drawn apart, vs plain and one-launch A: worst "
        f"max_abs_err {worst['err']:.3f} of its tolerance, worst sums rel err {worst['sums']:.3g} (tol 1e-4); "
        f"failing {worst['bad'][:5]} in {time.perf_counter() - t0:.1f} s {'ok' if not worst['bad'] else 'FAIL'}")

    flush = flush_l2(torch)
    rows = []
    for label, shape in SPLIT_GN_SHAPES:
        x, w, b, add = inputs(shape, (shape[0], 320))
        n, s, c = shape[0], shape[1] * shape[2], shape[3]
        sums = groupnorm.group_norm_stats_kernel(x, 32, add)
        stats = lambda: groupnorm.group_norm_stats_kernel(x, 32, add)
        apply = lambda: groupnorm.group_norm_apply_kernel(x, w, b, sums, 32, 1e-5, True, add)
        both = lambda: groupnorm.group_norm(x, w, b, 32, 1e-5, True, add, lambda t: t, 1)
        one = lambda: groupnorm.group_norm_kernel(x, w, b, 32, 1e-5, True, add)
        plain_stats = lambda: groupnorm.group_norm_stats_plain(x, 32, add)
        plain_apply = lambda: groupnorm.group_norm_apply_plain(x, w, b, sums, 32, 1e-5, True, add)
        xv = x.view(n, s, 32, c // 32)
        lib_stats = lambda: torch.var_mean(xv, dim=(1, 3))
        xc, wb, bb = x.permute(0, 3, 1, 2), w.to(bf), b.to(bf)
        lib_apply = lambda: F.group_norm(xc, 32, wb, bb, 1e-5)
        # One rank's split form alone (one block, its own sums) is GroupNorm.
        err, sc, _, ok = compare(apply(), groupnorm.group_norm_plain(x, w, b, 32, 1e-5, True, add), tol)
        ok_all &= ok
        timed = (("stats", stats, "gn_stats"), ("apply", apply, "gn_apply"), ("both", both, "gn_"),
                 ("one", one, "gn_fused"))
        dev = {k: profiled_kernel_ms(torch, fn, key, 10) for k, fn, key in timed + (
            ("plain_stats", plain_stats, ""), ("plain_apply", plain_apply, ""), ("lib_stats", lib_stats, ""),
            ("lib_apply", lib_apply, ""))}
        cold = {k: cold_kernel_ms(torch, fn, key, 2 if k == "both" else 1, flush) for k, fn, key in timed}
        both_kernels = profiled_kernel_count(torch, both)
        call = {k: cuda_ms(fn) for k, fn, _ in timed}
        call_cold = {k: cold_event_ms(torch, fn, flush) for k, fn, _ in timed}
        el, sums_b = x.numel(), n * 64 * 8
        bnd_s, by_s = bound_ms(2 * el + 2 * add.numel() + sums_b, 3.0 * el, FP32_FLOPS)
        bnd_a, by_a = bound_ms(4 * el + 2 * add.numel() + sums_b + 8 * c, 10.0 * el, FP32_FLOPS)
        bnd_one, _ = bound_ms(4 * el + 2 * add.numel(), 10.0 * el, FP32_FLOPS)

        def share(bound, k):
            warm = "warm beats the HBM bound (L2)" if dev[k] < bound else f"warm {bound / dev[k]:.0%}"
            return f"{bound / cold[k]:.0%} of it cold, {warm}"

        say(f"  (a) split A {label} {shape}, one block vs plain max_abs_err={err:.4g} (|ref|max {sc:.3g}, tol "
            f"{tol:g}x) {'ok' if ok else 'FAIL'}; device ms, L2 cold / warm: stats {cold['stats']:.4f} / "
            f"{dev['stats']:.4f} (bound {bnd_s:.4f} {by_s}, {share(bnd_s, 'stats')}; plain {dev['plain_stats']:.4f}, "
            f"torch.var_mean {dev['lib_stats']:.4f}), apply {cold['apply']:.4f} / {dev['apply']:.4f} (bound "
            f"{bnd_a:.4f} {by_a}, {share(bnd_a, 'apply')}; plain {dev['plain_apply']:.4f}, F.group_norm "
            f"{dev['lib_apply']:.4f}), stats + apply through the wrapper {cold['both']:.4f} / {dev['both']:.4f} "
            f"({both_kernels} device kernels a call) against one-launch A {cold['one']:.4f} / {dev['one']:.4f} "
            f"(bound {bnd_one:.4f}); a call by CUDA events cold / warm: stats {call_cold['stats']:.4f} / "
            f"{call['stats']:.4f}, apply {call_cold['apply']:.4f} / {call['apply']:.4f}, through the wrapper "
            f"{call_cold['both']:.4f} / {call['both']:.4f}, one-launch A {call_cold['one']:.4f} / {call['one']:.4f} "
            f"on {card}")
        ok_all &= both_kernels == 2
        if label == SPLIT_GN_SHAPES[0][0]:
            rows.append(dict(name="gn_stats", max_abs_err=errs["gn_stats"], ms=cold["stats"],
                             plain_ms=dev["plain_stats"], bound_ms=bnd_s, bound_by=by_s, library_ms=dev["lib_stats"]))
            rows.append(dict(name="gn_apply", max_abs_err=errs["gn_apply"], ms=cold["apply"],
                             plain_ms=dev["plain_apply"], bound_ms=bnd_a, bound_by=by_a, library_ms=dev["lib_apply"]))
        del x, add, sums, xv, xc
    torch.cuda.empty_cache()
    if not ok_all:
        fail("kernel A's split form disagrees with the one-launch A or its plain version at a shape, the check "
             "cannot see a half normalised by its own statistics, the sharded step's split calls are not its "
             "GroupNorms, or a split GroupNorm is not two device kernels")
    return rows


def gathered_flash_check(torch, flash, card):
    """Phase 11(b): kernel 7 at the shapes the sharded path gives it: q a
    view of the packed projection, k and v contiguous as the all-gather
    leaves them; logits of sd sqrt(ln(Skv / 64)). Phase 2's kernel-7
    tolerances; timed beside its plain version, SDPA and the bound."""
    F = torch.nn.functional
    g = torch.Generator(device="cuda")
    g.manual_seed(2222)
    from posetraj_torch.tools.kernel_sweep import TOLERANCES

    tol, rms_tol = TOLERANCES["flash.flash_attention_tq"]
    ok_all = True
    for label, bsz, sq, skv, heads in GATHERED_FLASH:
        c, d = heads * 64, 64
        sigma = max(1.0, np.log(skv / 64)) ** 0.5
        qkv = (torch.randn(bsz, sq, 3 * c, generator=g, device="cuda") * sigma**0.5).to(torch.bfloat16)
        q = qkv[..., :c].unflatten(-1, (heads, d))
        k = (torch.randn(bsz, skv, heads, d, generator=g, device="cuda") * sigma**0.5).to(torch.bfloat16)
        v = torch.randn(bsz, skv, heads, d, generator=g, device="cuda").to(torch.bfloat16)
        run_k = lambda: flash.flash_attention_tq(q, k, v, d**-0.5)
        err, sc, rr, ok = compare(run_k(), flash.flash_attention_tq_plain(q, k, v, d**-0.5), tol, rms_tol=rms_tol)
        ok_all &= ok
        ms = cuda_ms(run_k)
        plain = cuda_ms(lambda: flash.flash_attention_tq_plain(q, k, v, d**-0.5), reps=1, inner=1)
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
        bnd, by = bound_ms(2 * (2 * bsz * sq * c + 2 * bsz * skv * c), 4.0 * bsz * heads * sq * skv * d, BF16_FLOPS)
        say(f"  (b) flash_tq {label}: (B,Sq,Skv,N,d)=({bsz},{sq},{skv},{heads},{d}) max_abs_err={err:.4g} "
            f"(|ref|max {sc:.3g}, tol {tol:g}x) rel_rms={rr:.3g} (tol {rms_tol:g}) ms={ms:.4f} bound_ms={bnd:.4f} "
            f"({by}, {bnd / ms:.0%} of it) sdpa_ms={lib:.4f} plain_ms={plain:.4f} {'ok' if ok else 'FAIL'} on {card}")
        del qkv, q, k, v, qs, ks, vs
    torch.cuda.empty_cache()
    if not ok_all:
        fail("kernel 7 disagrees with its plain version at a gathered shape")


def sharded_request(torch, seed, height=576, width=1024):
    """One request's inputs, the same on every device: numpy image and
    control, noises from a CUDA generator."""
    rng = np.random.RandomState(400 + seed)
    image = rng.rand(1, height, width, 3).astype(np.float32)
    control = rng.rand(1, 14, height, width, 3).astype(np.float32)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(401 + seed)
    noises = {"latents": torch.randn(1, 14, height // 8, width // 8, 4, generator=gen, device="cuda"),
              "image_aug": torch.randn(1, height, width, 3, generator=gen, device="cuda")}
    return image, control, noises


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_serving_check(torch, native, bundle, params, steps, per_request, card):
    """Phase 11(c): generate_sharded on a (1, 1) mesh through a one-rank NCCL
    group at 14x576x1024, full width, `steps` steps, CFG, two requests
    (the loop eager), each request's launches; request 0's latents against
    generate() (graphed) on the same inputs under SHARDED_AS, and both
    requests' launches against it. Returns (the launches of both requests,
    request 0's latents)."""
    import dataclasses

    import torch.distributed as dist

    from posetraj_torch.configs import KernelConfig, PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.parallel import make_serve_mesh, serve
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_serve_mesh(1, 1)
        pcfg = PipelineConfig(height=576, width=1024, num_frames=14, num_inference_steps=steps, decode_chunk_size=14)
        sched = make_schedule(bundle.scheduler, steps)
        latents = []

        def keep(decode):
            def wrapped(params_, bundle_, lat, *a, **k):
                latents.append(lat.float().clone())
                return decode(params_, bundle_, lat, *a, **k)
            return wrapped

        req_s, launches = [], []
        with mock.patch.object(serve, "_decode_sharded", keep(serve._decode_sharded)):
            for seed in (0, 1):
                image, control, noises = sharded_request(torch, seed)
                native.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frames = serve.generate_sharded(params, bundle, pcfg, image, control, noises, [[6.0, 128.0, 0.02]],
                                                sched.sigmas, sched.timesteps, 14, mesh)
                torch.cuda.synchronize()
                req_s.append(time.perf_counter() - t0)
                launches.append(dict(native.LAUNCHES))
                if tuple(frames.shape) != (1, 14, 576, 1024, 3) or not bool(torch.isfinite(frames).all()) or \
                        float(frames.min()) < 0.0 or float(frames.max()) > 1.0:
                    fail(f"generate_sharded: frames {tuple(frames.shape)} not finite or outside [0, 1]")
                del frames
        image, control, noises = sharded_request(torch, 0)
        ref_bundle = dataclasses.replace(bundle, kernels=KernelConfig(**SHARDED_AS))
        nudged = dict(noises, latents=torch.nextafter(noises["latents"], torch.full_like(noises["latents"], np.inf)))
        ref_s, ref_launches = [], []
        with mock.patch.object(pipe_m, "decode_latents", keep(pipe_m.decode_latents)):
            for inputs in (noises, nudged):  # the second call replays the first one's graph
                native.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe_m.generate(params, ref_bundle, pcfg, image, control, inputs, [[6.0, 128.0, 0.02]],
                                sched.sigmas, sched.timesteps, 14)
                torch.cuda.synchronize()
                ref_s.append(time.perf_counter() - t0)
                ref_launches.append(dict(native.LAUNCHES))
    finally:
        dist.destroy_process_group()
    sharded0, ref, ref_nudged = latents[0], latents[2], latents[3]
    rel_rms = lambda a, b: float((a - b).norm() / b.norm())
    rel, floor = rel_rms(sharded0, ref), rel_rms(ref_nudged, ref)
    tol = max(SHARDED_FLOOR_FACTOR * floor, SHARDED_MIN_TOL)
    nonzero = {k: n for k, n in launches[0].items() if n}
    expected = ("groupnorm", "mlp", "flash_tq")
    absent = ("qkvt", "temporal", "gemm", "frame_attn", "gn_stats", "gn_apply", "layernorm", "flash_fwd", "flash_bwd",
              "flash_qkv")
    ok = (rel <= tol and launches[0] == launches[1] == ref_launches[0]
          and all(launches[0][k] > 0 for k in expected) and not any(launches[0][k] for k in absent))
    say(f"  (c) generate_sharded, (1, 1) mesh over a one-rank NCCL group, 14x576x1024 CFG, {steps} steps, the loop "
        f"eager: s/request={[round(x, 3) for x in req_s]} (phase 4's pipeline, default switches, graphed: "
        f"{[round(x, 3) for x in per_request]}; generate() under "
        f"{SHARDED_AS}, graphed: {ref_s[0]:.3f} first call, "
        f"{ref_s[1]:.3f} replayed); latents vs that generate() rel_rms={rel:.4g} (tol {tol:.4g}: "
        f"{SHARDED_FLOOR_FACTOR:g}x the floor {floor:.4g}, generate() with its initial latents one ulp apart, or "
        f"{SHARDED_MIN_TOL:g}); launches a request {nonzero} (generate(): the same "
        f"{launches[0] == ref_launches[0]}) {'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        fail("the (1, 1) sharded request disagrees with generate(), or launched other kernels than it")
    return {k: launches[0][k] + launches[1][k] for k in launches[0]}, sharded0, tol


def sharded_rank(rank, n_cfg, n_sp, port, steps, seed, out_dir) -> None:
    """One rank of phase 11(d), a process that torch.multiprocessing starts:
    generate_sharded on an (n_cfg, n_sp) mesh over NCCL on device `rank`,
    request 0 twice; its latents (first request), launches (second) and
    s/request to out_dir."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.ops import _native
    from posetraj_torch.parallel import make_serve_mesh, serve
    from posetraj_torch.pipeline import ModelBundle

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank, world_size=n_cfg * n_sp)
    try:
        bundle = ModelBundle()
        params = make_params(torch, bundle, seed)
        mesh = make_serve_mesh(n_cfg, n_sp)
        pcfg = PipelineConfig(height=576, width=1024, num_frames=14, num_inference_steps=steps, decode_chunk_size=14)
        sched = make_schedule(bundle.scheduler, steps)
        image, control, noises = sharded_request(torch, 0)
        latents, secs = [], []
        decode = serve._decode_sharded

        def keep(params_, bundle_, lat, *a, **k):
            latents.append(lat.float().cpu())
            return decode(params_, bundle_, lat, *a, **k)

        with mock.patch.object(serve, "_decode_sharded", keep):
            for _ in range(2):
                _native.reset_launches()
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve.generate_sharded(params, bundle, pcfg, image, control, noises, [[6.0, 128.0, 0.02]],
                                       sched.sigmas, sched.timesteps, 14, mesh)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        torch.save({"latents": latents[0], "launches": dict(_native.LAUNCHES), "s": secs},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def split_mesh_check(torch, steps, seed, ref_latents, tol, card):
    """Phase 11(d), where the host has several cards: generate_sharded on a
    (1, 2) mesh over NCCL, and on (2, 2) where there are four, one process
    a card, request 0 twice, against the (1, 1) run's latents within
    11(c)'s tolerance (the GroupNorm statistics, the gathered softmax and
    the halo convolutions' cuDNN algorithms change last bits as the CFG
    combine does there); s/request of each. The ranks are killed after
    SHARDED_RANKS_TIMEOUT_S. Returns the launches of one request summed
    over each mesh's ranks, or None where it did not run."""
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        say(f"  (d) phase 11(d) not run: {n_dev} device")
        return None
    import tempfile

    import torch.multiprocessing as tmp

    total = None
    for n_cfg, n_sp in [(1, 2)] + ([(2, 2)] if n_dev >= 4 else []):
        world = n_cfg * n_sp
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
            ranks = tmp.start_processes(sharded_rank, args=(n_cfg, n_sp, free_port(), steps, seed, d), nprocs=world,
                                        join=False, start_method="spawn")
            deadline = time.monotonic() + SHARDED_RANKS_TIMEOUT_S
            try:
                while not ranks.join(timeout=max(1.0, deadline - time.monotonic())):
                    if time.monotonic() >= deadline:
                        fail(f"phase 11(d): the ({n_cfg}, {n_sp}) mesh's ranks took over {SHARDED_RANKS_TIMEOUT_S} s")
            except Exception as e:  # a rank raised or exited non-zero: the others are ended by join
                fail(f"phase 11(d): a rank of the ({n_cfg}, {n_sp}) mesh failed: {e}")
            finally:
                for p in ranks.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
            outs = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(world)]
        rel = float((outs[0]["latents"].cuda() - ref_latents).norm() / ref_latents.norm())
        same = all(torch.equal(o["latents"], outs[0]["latents"]) for o in outs)
        launches = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
        ok = same and rel <= tol and launches["gn_stats"] > 0 and launches["gn_apply"] > 0
        say(f"  (d) generate_sharded on a ({n_cfg}, {n_sp}) mesh over NCCL, {world} cards: latents vs (1, 1) "
            f"rel_rms={rel:.4g} (tol {tol:.4g}), every rank's equal {same}; s/request (rank 0, the request twice) "
            f"{[round(x, 3) for x in outs[0]['s']]}; launches of a request, summed over the ranks "
            f"{ {k: n for k, n in launches.items() if n} } {'ok' if ok else 'FAIL'} on {card}")
        if not ok:
            fail(f"the ({n_cfg}, {n_sp}) sharded request disagrees with (1, 1), or missed kernel A's split form")
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
    return total


# ---------------------------------------------------------------------------
# Phase 12: the ("data", "model") mesh (parallel/mesh.py)
# ---------------------------------------------------------------------------

# (2, 1) against one device: two batch-1 forwards in bf16 round
# differently from one batch-2 forward, so what the data all-reduce feeds
# the optimizer, Adam's first moment after each update (m1 = 0.1 g1, then
# 0.9 m1 + 0.1 g2: the windows' mean gradients), is held to phase 5(a)'s
# gradient tolerance, MESH_DP_TOL relative RMS over the tree. The
# parameters' change after the second update, Adam's m / sqrt(v), amplifies
# that noise wherever the two windows' gradients nearly cancel (4.2e-2
# measured at full depth on four H100s); it is printed beside one
# device's own spread from pixel values one float32 ulp apart. (1, 2)
# computes the global batch on every rank; only the clipping norm's sum
# order differs (the split leaves' squares summed over "model"), so both
# moments and the change are held to MESH_TP_TOL.
MESH_DP_TOL = 2e-2
MESH_TP_TOL = 1e-3
MESH_TRAIN_STEPS = 4  # two optimizer updates at accumulation 2
# 12(d): a batch of 4 served over (2, x) computes batch-2 forwards, in bf16
# rounded otherwise than one card's batch-4 forward: frames within this
# relative RMS of one card's (phase 3's step tolerance).
MESH_FRAMES_TOL = 3e-2
MESH_RANKS_TIMEOUT_S = 600
MESH_PG_TIMEOUT_S = 300


def mesh_bundle(depth: str):
    """The flagship bundle, or ("cut") phase 5(g)'s: UNet and ControlNet of
    two levels, 320 and 640 wide, one layer a block; VAE and CLIP full."""
    import dataclasses

    from posetraj_torch.configs import ControlNetConfig
    from posetraj_torch.pipeline import ModelBundle

    full = ModelBundle()
    if depth == "full":
        return full
    u = dataclasses.replace(full.unet, block_out_channels=(320, 640), cross_attention_levels=(True, True),
                            num_attention_heads=(5, 10), layers_per_block=1)
    return dataclasses.replace(full, unet=u, controlnet=ControlNetConfig(unet=u))


def mesh_batch(torch, b, f, h, w, seed):
    """A global training batch of b rows from a seed, the same on every
    process (training_batch's draws)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return {"pixel_values": torch.rand(b, f, h, w, 3, generator=g, device="cuda") * 2 - 1,
            "trajectories": torch.rand(b, f, h, w, 3, generator=g, device="cuda") * 2 - 1,
            "motion_values": torch.linspace(100.0, 160.0, b, device="cuda")}


def mesh_request(b, height, width, seed):
    """b videos' image and control video (numpy, [0, 1]) from a seed."""
    rng = np.random.RandomState(1200 + seed)
    return rng.rand(b, height, width, 3).astype(np.float32), rng.rand(b, 14, height, width, 3).astype(np.float32)


def mesh_train_run(torch, native, bundle, params, mesh, batch, keep: bool):
    """MESH_TRAIN_STEPS graphed micro-steps of a Trainer on `mesh` (None:
    one device) at batch's size, TrainConfig defaults, warmup 1 (the second
    update moves the parameters). Returns (the trainer, what it measured):
    losses, s a micro-step, launches, and, with keep, host copies of the
    whole ControlNet before, Adam's first moment after the first update and
    the whole ControlNet, EMA and first moment after the second
    (state_dict: a collective), and a digest of the whole weights."""
    import hashlib

    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import Trainer

    f, h, w = batch["pixel_values"].shape[1:4]
    tcfg = TrainConfig(num_frames=f, height=h, width=w, lr_warmup_steps=1)
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    trainer = Trainer(bundle, tcfg, frozen, params["controlnet"], mesh=mesh, device="cuda")
    out = {"loss": [], "s": []}
    host = lambda ts: [t.detach().float().cpu() for t in ts]  # noqa: E731
    if keep:
        out["before"] = host(_tree_leaves(trainer.state.controlnet_params))
    native.reset_launches()
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step(batch)
        torch.cuda.synchronize()
        out["s"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        if i == 1:
            sd = trainer.state_dict()
            if keep:
                out["m1"] = host(sd["optimizer"]["state"][j]["exp_avg"] for j in sorted(sd["optimizer"]["state"]))
            del sd
    out["launches"] = dict(native.LAUNCHES)
    sd = trainer.state_dict()
    if keep:
        out["after"], out["ema"] = host(_tree_leaves(sd["controlnet"])), host(_tree_leaves(sd["ema"]))
        out["m2"] = host(sd["optimizer"]["state"][j]["exp_avg"] for j in sorted(sd["optimizer"]["state"]))
    digest = hashlib.sha1()
    for t in _tree_leaves(sd["controlnet"]) + _tree_leaves(sd["ema"]):
        digest.update(t.detach().cpu().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    del sd
    return trainer, out


def mesh_serve_run(torch, native, bundle, params, mesh, b, steps, calls=2):
    """SVDControlNetPipeline(mesh=) (None: one device) on b videos at
    14x576x1024, CFG, `steps` steps, `calls` times (the first call captures
    the denoise graph): the frames and s of each, the last call's
    launches."""
    from posetraj_torch.pipeline import SVDControlNetPipeline

    pipe = SVDControlNetPipeline(params, bundle, mesh=mesh, device="cuda")
    image, control = mesh_request(b, 576, 1024, 0)
    frames, secs = [], []
    for _ in range(calls):
        native.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames.append(pipe(image, control, height=576, width=1024, num_frames=14, num_inference_steps=steps, seed=3))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    out = {"frames": frames, "s": secs, "launches": dict(native.LAUNCHES)}
    del pipe
    return out


def mesh_reference(torch, native, bundle, params, batch):
    """mesh_train_run on one device over `batch`, with "floor": the relative
    RMS between its parameters' change after the second update and that of
    the same run from pixel values one float32 ulp up (the spread of bf16
    rounding through Adam)."""
    trainer, ref = mesh_train_run(torch, native, bundle, params, None, batch, True)
    del trainer
    pix = batch["pixel_values"]
    nudged = dict(batch, pixel_values=torch.nextafter(pix, torch.full_like(pix, np.inf)))
    trainer, far = mesh_train_run(torch, native, bundle, params, None, nudged, True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    ref["floor"] = rel_rms_tree(mesh_delta(far), mesh_delta(ref))
    return ref


def mesh_delta(run):
    """The parameters' change over a mesh_train_run, leaf by leaf."""
    return [a - b for a, b in zip(run["after"], run["before"])]


def rel_rms_tree(got, want) -> float:
    """||got - want|| / ||want|| over every leaf of two lists of tensors."""
    num = sum(float((g.double() - w.double()).square().sum()) for g, w in zip(got, want))
    den = sum(float(w.double().square().sum()) for w in want)
    return (num / max(den, 1e-300)) ** 0.5


def mesh_single_check(torch, native, bundle, params, steps, card, ge, training_kernels, inference_kernels):
    """Phase 12(a): a (1, 1) mesh through a one-rank NCCL group at full
    width: MESH_TRAIN_STEPS graphed micro-steps at 14x320x576 of
    Trainer(mesh=) against the unsharded Trainer from the same state and
    draws, masters, EMA and moments bitwise (every collective has size
    1), every training kernel launched; SVDControlNetPipeline(mesh=) on a
    batch of 2, 14x576x1024, CFG, `steps` steps, frames bitwise those of
    the pipeline without a mesh (one call of each, which captures its
    denoise graph). Returns the mesh request's launches."""
    import torch.distributed as dist

    from posetraj_torch.parallel.mesh import make_mesh

    say(f"phase 12: the (\"data\", \"model\") mesh (parallel/mesh.py) on {card}")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1)
        batch = mesh_batch(torch, 1, 14, 320, 576, 1212)
        trainer, ref = mesh_train_run(torch, native, bundle, params, None, batch, False)
        want = _to_host(train_state_groups(trainer))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        trainer, got = mesh_train_run(torch, native, bundle, params, mesh, batch, False)
        diff = state_diff(torch, want, train_state_groups(trainer))
        del trainer, want
        gc.collect()
        torch.cuda.empty_cache()
        bitwise = all(v == 0.0 for v in diff.values()) and got["loss"] == ref["loss"]
        launched = all(got["launches"][k] > 0 for k in training_kernels)
        micro = lambda r: round(statistics.median(r["s"][2:]), 4)  # noqa: E731
        opt = lambda r: round(r["s"][2] + r["s"][3], 4)  # noqa: E731
        say(f"  (a) Trainer(mesh=) on (1, 1) over a one-rank NCCL group, 14x320x576, {MESH_TRAIN_STEPS} graphed "
            f"micro-steps (two updates) against the unsharded Trainer from the same state and draws: max diff "
            f"{diff}, losses {got['loss']} vs {ref['loss']}: {'bitwise' if bitwise else 'FAIL'}; launches "
            f"{ {k: n for k, n in got['launches'].items() if n} } {'ok' if launched else 'FAIL'}; s/micro-step "
            f"(steps 3-4, replays) mesh {micro(got)}, unsharded {micro(ref)}, phase 5(e) {ge['micro_s']['graph']:.4f}; "
            f"s/optimizer-step mesh {opt(got)}, unsharded {opt(ref)}, phase 5(e) {ge['opt_s']['graph']:.4f}; "
            f"first micro-step (eager, capture) {got['s'][0]:.3f} s on {card}")
        if not (bitwise and launched):
            fail("Trainer(mesh=) on (1, 1) is not bitwise the unsharded Trainer, or missed a training kernel")
        ref = mesh_serve_run(torch, native, bundle, params, None, 2, steps, calls=1)
        got = mesh_serve_run(torch, native, bundle, params, mesh, 2, steps, calls=1)
    finally:
        dist.destroy_process_group()
    frames = got["frames"]
    same = all(np.array_equal(x, ref["frames"][0]) for x in frames)
    ok = (same and frames[0].shape == (2, 14, 576, 1024, 3) and np.isfinite(frames[0]).all()
          and all(got["launches"][k] > 0 for k in inference_kernels)
          and not any(got["launches"][k] for k in ("flash_fwd", "flash_bwd", "flash_qkv", "flash_tq", "layernorm",
                                                   "gn_stats", "gn_apply")))
    say(f"  (a) SVDControlNetPipeline(mesh=) on (1, 1), a batch of 2 at 14x576x1024 CFG, {steps} steps: frames "
        f"{'bitwise' if same else 'NOT bitwise'} those without a mesh; s/request {got['s'][0]:.3f}, without a mesh "
        f"{ref['s'][0]:.3f} (each a pipeline's first call, its denoise graph captured in it); launches a request "
        f"{ {k: n for k, n in got['launches'].items() if n} } {'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        fail("SVDControlNetPipeline(mesh=) on (1, 1) is not bitwise the pipeline without a mesh, or launched other "
             "kernels")
    return got["launches"]


def mesh_rank(rank, world, backend, port, depth, steps, out_dir) -> None:
    """One rank of phase 12(b) (gloo, both ranks on cuda:0) or 12(d) (NCCL,
    cuda:rank), a process that torch.multiprocessing starts: world 2 trains
    on (2, 1) and (1, 2), world 4 on (2, 2) (mesh_train_run on the global
    batch of 2); with steps, each mesh also serves a batch of 4. Writes what
    it measured to out_dir."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from posetraj_torch.ops import _native
    from posetraj_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT_S))
    try:
        bundle = mesh_bundle(depth)
        params = make_params(torch, bundle, 12)
        batch = mesh_batch(torch, 2, 14, 320, 576, 1213)
        out = {}
        for shape in ([(2, 1), (1, 2)] if world == 2 else [(2, 2)]):
            mesh = make_mesh(*shape, device=device)
            trainer, run = mesh_train_run(torch, _native, bundle, params, mesh, batch, rank == 0)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            if steps:
                serve = mesh_serve_run(torch, _native, bundle, params, mesh, 4, steps, calls=1)
                run["serve_s"], run["serve_launches"] = serve["s"], serve["launches"]
                run["frames"] = serve["frames"][0] if rank == 0 else None
            out[shape] = run
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_mesh_ranks(torch, world, backend, depth, steps, label):
    """Start `world` mesh_rank processes, join them within
    MESH_RANKS_TIMEOUT_S (killed on overrun) and return their outputs."""
    import tempfile

    import torch.multiprocessing as tmp

    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        ranks = tmp.start_processes(mesh_rank, args=(world, backend, free_port(), depth, steps, d), nprocs=world,
                                    join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_RANKS_TIMEOUT_S
        try:
            while not ranks.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    fail(f"{label}: the ranks took over {MESH_RANKS_TIMEOUT_S} s")
        except Exception as e:  # a rank raised or exited non-zero: the others are ended by join
            fail(f"{label}: a rank failed: {e}")
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def mesh_compare(outs, shape, ref, training_kernels, label, card):
    """Phase 12(b) and (d)'s checks of one mesh's training against the
    unsharded run on the same global batch: every rank's whole weights and
    EMA bitwise alike, every training kernel launched on every rank, Adam's
    first moment after each update within the mesh's tolerance, and at
    (1, x) the parameters' change too (MESH_DP_TOL's comment); losses
    beside."""
    run = outs[0][shape]
    tol = MESH_DP_TOL if shape[0] > 1 else MESH_TP_TOL
    alike = len({o[shape]["digest"] for o in outs}) == 1
    launched = all(o[shape]["launches"][k] > 0 for o in outs for k in training_kernels)
    m1, m2 = rel_rms_tree(run["m1"], ref["m1"]), rel_rms_tree(run["m2"], ref["m2"])
    upd = rel_rms_tree(mesh_delta(run), mesh_delta(ref))
    ema = rel_rms_tree(run["ema"], ref["ema"])
    ok = alike and launched and m1 <= tol and m2 <= tol and (shape[0] > 1 or upd <= tol)
    say(f"  {label} ({shape[0]}, {shape[1]}) trainer, global batch 2, {MESH_TRAIN_STEPS} graphed micro-steps: Adam's "
        f"first moment after updates 1 and 2 rel RMS {m1:.4g}, {m2:.4g} (tol {tol:g}); the parameters' change after "
        f"update 2 {upd:.4g}{'' if shape[0] > 1 else f' (tol {tol:g})'}, one device's own from pixels one ulp "
        f"apart {ref['floor']:.4g}; EMA {ema:.4g}; losses {run['loss']} vs {ref['loss']}; every rank's weights and "
        f"EMA bitwise "
        f"alike {alike}; every training kernel on every rank {launched}; s/micro-step (replays) "
        f"{round(statistics.median(run['s'][2:]), 4)}, s/optimizer-step {round(run['s'][2] + run['s'][3], 4)} "
        f"{'ok' if ok else 'FAIL'} on {card}")
    if not ok:
        fail(f"{label}: the ({shape[0]}, {shape[1]}) trainer disagrees with one device's, its ranks differ, or a "
             "training kernel was missed")


def mesh_gloo_check(torch, native, training_kernels, card):
    """Phase 12(b): two processes sharing the card over gloo with CUDA
    tensors (NCCL refuses two ranks on one device): (2, 1) and (1, 2)
    trainers on a global batch of 2 at 14x320x576, full width, phase 5(g)'s
    depth, against the unsharded Trainer on the same batch, made here."""
    bundle = mesh_bundle("cut")
    params = make_params(torch, bundle, 12)
    ref = mesh_reference(torch, native, bundle, params, mesh_batch(torch, 2, 14, 320, 576, 1213))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = run_mesh_ranks(torch, 2, "gloo", "cut", 0, "phase 12(b)")
    say(f"  (b) two processes on one card over gloo with CUDA tensors, UNet/ControlNet (320, 640) one layer a "
        f"block, VAE and CLIP full: the ranks took {time.perf_counter() - t0:.1f} s; unsharded s/micro-step "
        f"(replays) {round(statistics.median(ref['s'][2:]), 4)}")
    for shape in ((2, 1), (1, 2)):
        mesh_compare(outs, shape, ref, training_kernels, "(b)", card)


def mesh_multi_check(torch, native, bundle, steps, training_kernels, inference_kernels, card):
    """Phase 12(d), only where the host has four cards: (2, 1) and (1, 2) on
    two, (2, 2) on four, over NCCL, one process a card, full width and
    depth: mesh_compare against the unsharded Trainer on the same batch
    (made here on card 0), and a batch of 4 served on each mesh (one call,
    which captures), its frames against one card's (the (2, x) meshes
    compute batch-2 forwards: MESH_FRAMES_TOL), s/optimizer-step and
    s/request beside one card's."""
    n_dev = torch.cuda.device_count()
    if n_dev < 4:
        say(f"  (d) phase 12(d) not run: {n_dev} device")
        return
    mparams = make_params(torch, bundle, 12)
    ref = mesh_reference(torch, native, bundle, mparams, mesh_batch(torch, 2, 14, 320, 576, 1213))
    one = mesh_serve_run(torch, native, bundle, mparams, None, 4, steps, calls=1)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  (d) one card: s/optimizer-step {round(ref['s'][2] + ref['s'][3], 4)}, s/request of a batch of 4 "
        f"{one['s'][0]:.3f} (a first call, its capture included, as on each mesh)")
    for world in (2, 4):
        outs = run_mesh_ranks(torch, world, "nccl", "full", steps, "phase 12(d)")
        for shape, run in outs[0].items():
            mesh_compare(outs, shape, ref, training_kernels, "(d)", card)
            rel = rel_rms_tree([torch.from_numpy(run["frames"])], [torch.from_numpy(one["frames"][0])])
            served = all(o[shape]["serve_launches"][k] > 0 for o in outs for k in inference_kernels)
            ok = served and rel <= MESH_FRAMES_TOL
            say(f"  (d) ({shape[0]}, {shape[1]}) serving a batch of 4, {steps} steps: s/request (rank 0) "
                f"{[round(s, 3) for s in run['serve_s']]}; frames vs one card rel RMS {rel:.4g} (tol "
                f"{MESH_FRAMES_TOL:g}); every inference kernel on every rank {served} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"phase 12(d): the ({shape[0]}, {shape[1]}) batched request disagrees with one card's")


def mesh_phase(torch, native, bundle, params, args, ge, training_kernels, inference_kernels, card):
    """Phase 12; returns the (1, 1) mesh request's launches."""
    t0 = time.perf_counter()
    launches = mesh_single_check(torch, native, bundle, params, args.steps, card, ge, training_kernels,
                                 inference_kernels)
    torch.cuda.empty_cache()
    mesh_gloo_check(torch, native, training_kernels, card)
    torch.cuda.empty_cache()
    mesh_multi_check(torch, native, bundle, args.steps, training_kernels, inference_kernels, card)
    say(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the tools on the card
# ---------------------------------------------------------------------------

def sweep_check(torch, params, card):
    """Phase 13(a): tools/kernel_sweep on the card. Every kernel instance
    generate() dispatches under the default KernelConfig at 14x576x1024 and
    14x320x576 and under UNFUSED at 14x320x576 (kernels 7 and 8), recorded
    from one eager generate() a configuration on phase 3's parameters, each
    replayed alone against its plain version at phase 2's tolerance. No
    deadline and no skip-cache: an instance SHED or CACHED fails the phase.
    Every instance's line goes to build/kernel_sweep.log."""
    from posetraj_torch.configs import KernelConfig
    from posetraj_torch.tools import kernel_sweep as ks

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    records = ks.record_instances(((576, 1024), (320, 576)), KernelConfig(), params=params, device=dev)
    n_default = len(records)
    unfused = ks.record_instances(((320, 576),), KernelConfig(**UNFUSED), params=params, device=dev)
    n_unfused = len(unfused)
    records.update(unfused)
    rec_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = ks.replay_records(records, dev, verbose=False)
    replay_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "kernel_sweep.log"), "w") as f:
        f.writelines(f"{o.status:6s} {k}  {o.detail}\n" for k, o in res.instances)
    by = {}
    for k, o in res.instances:
        row = by.setdefault(k.split("(", 1)[0], {"n": 0, "bad": 0, "worst": 0.0, "rms": 0.0})
        row["n"] += 1
        row["bad"] += o.status != "OK"
        if not o.note:
            row["worst"] = max(row["worst"], o.err / (o.tol * o.scale) if o.scale else float("inf"))
            row["rms"] = max(row["rms"], o.rel_rms)
    for name, row in sorted(by.items()):
        say(f"  (a) {name:33s} {row['n']:4d} distinct instances, {row['n'] - row['bad']} OK; worst max_abs_err "
            f"{row['worst']:.3f} of its tolerance, worst rel_rms {row['rms']:.3g}")
    bad = [(k, o) for k, o in res.instances if o.status != "OK"]
    for k, o in bad[:20]:
        say(f"  (a) {o.status} {k}  {o.detail}")
    say(f"  (a) kernel sweep: {len(records)} distinct instances ({n_default} default at 14x576x1024 and 14x320x576, "
        f"{n_unfused} un-fused at 14x320x576, {n_default + n_unfused - len(records)} shared), recorded in "
        f"{rec_s:.1f} s, replayed in {replay_s:.1f} s on {card}: {len(records) - len(bad)} OK, {len(bad)} not "
        f"{'ok' if not bad else 'FAIL'}")
    if bad:
        fail("the kernel sweep: an instance failed against its plain version, or was shed or cached")
    return {name: row["n"] for name, row in by.items()}


def bench_check(torch, card):
    """Phase 13(b): tools/bench_train.bench_train_step() at full width,
    14x320x576, its defaults; prints its JSON line."""
    from posetraj_torch.tools.bench_train import bench_train_step

    t0 = time.perf_counter()
    out = bench_train_step(verbose=False)
    gc.collect()
    torch.cuda.empty_cache()
    ok = np.isfinite(out["train_loss"]) and out["train_step_sec"] > 0 and out["train_temp_gb"] > 0
    say(f"  (b) bench_train_step() on {card} in {time.perf_counter() - t0:.1f} s: {json.dumps(out)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the training bench's loss is not finite or it measured nothing")
    return out


def stage_check(torch, native, bundle, params, card, train_step_s, steps):
    """Phase 13(c): requests at 14x576x1024 (`steps` steps, CFG) through
    SVDControlNetPipeline under utils.StageTimer: the pipeline's own calls
    wrapped (CLIP encode, VAE encode, hint, the denoise loop, decode), the
    first request capturing the loop's graph, the second replaying it; for
    each request the stages must sum to within 2% of its wall time (the
    host time of its generate() call is printed beside). Then trace()
    of one replay of that graph (a non-empty Chrome trace under build/,
    removed), and the frozen encodes of encode_outside_step at the training
    shape (14x320x576, batch 1) under the timer, beside the bench's
    s/micro-step."""
    import shutil

    from posetraj_torch.pipeline import SVDControlNetPipeline
    from posetraj_torch.pipeline import svd_controlnet as sc
    from posetraj_torch.train import trainer as trainer_m
    from posetraj_torch.utils import StageTimer, trace

    pipe = SVDControlNetPipeline(params, bundle, device="cuda")
    rng = np.random.RandomState(1300)
    image = rng.rand(1, 576, 1024, 3).astype(np.float32)
    control = rng.rand(1, 14, 576, 1024, 3).astype(np.float32)
    stages = (("CLIP", sc, "encode_image_clip"), ("VAE encode", sc, "encode_image_vae"), ("hint", sc, "_hint"),
              ("denoise", sc.DenoiseGraph, "run"), ("decode", sc, "decode_latents"))
    ok_all = True
    for request in ("first", "second"):
        timer = StageTimer()
        inner = []  # host seconds of the generate() call the request makes

        def timed(name, fn):
            def wrapper(*a, **k):
                with timer.stage(name):
                    return fn(*a, **k)
            return wrapper

        def timed_generate(*a, _generate=sc.generate, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = _generate(*a, **k)
            torch.cuda.synchronize()
            inner.append(time.perf_counter() - t0)
            return frames

        patches = [mock.patch.object(obj, attr, timed(name, getattr(obj, attr))) for name, obj, attr in stages]
        patches.append(mock.patch.object(sc, "generate", timed_generate))
        for p in patches:
            p.start()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe(image, control, height=576, width=1024, num_frames=14, num_inference_steps=steps, seed=0)
            wall = time.perf_counter() - t0
        finally:
            for p in patches:
                p.stop()
        st = timer.as_dict()
        total = sum(st.values())
        ok = (np.isfinite(out).all() and set(st) == {n for n, _, _ in stages}
              and all(timer.counts[n] == 1 for n in st) and abs(total - wall) <= 0.02 * wall)
        ok_all &= ok
        split = ", ".join(f"{n} {st[n] * 1e3:.1f} ms" for n, _, _ in stages)
        say(f"  (c) {request} request ({'replays the graph' if request == 'second' else 'captures the graph'}) "
            f"14x576x1024 {steps} steps under StageTimer on {card}: {split}; the stages sum to {total:.4f} s, "
            f"{(total - wall) / wall:+.2%} of the request's {wall:.4f} s wall (held to 2%); its generate() call "
            f"{inner[0]:.4f} s, {wall - inner[0]:.4f} s of the request outside it; capture "
            f"{pipe.graph.capture_s:.3f} s {'ok' if ok else 'FAIL'}")
    tdir = os.path.join(HERE, "build", "trace_phase13")
    shutil.rmtree(tdir, ignore_errors=True)
    graph = pipe.graph
    with torch.inference_mode():  # a replay reads sigmas[step], sigmas[step + 1]: from step 0 again
        graph.buffers["step"].zero_()
    with trace(tdir) as prof:
        graph._graph.replay()
    size = os.path.getsize(prof.trace_path)
    with open(prof.trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    shutil.rmtree(tdir)
    trace_ok = size > 0 and bool(events)
    ok_all &= trace_ok
    say(f"  (c) trace() of one graphed denoise step: {os.path.basename(prof.trace_path)} {size / 1e6:.2f} MB, "
        f"{len(events)} events, {kernels} device kernels; removed {'ok' if trace_ok else 'FAIL'}")
    del pipe, graph, out
    gc.collect()
    torch.cuda.empty_cache()

    # The frozen encodes of encode_outside_step (train/trainer.py
    # encode_conditioning) at the training shape, by the same timer.
    g = torch.Generator(device="cuda")
    g.manual_seed(1301)
    pixels = torch.rand(1, 14, 320, 576, 3, generator=g, device="cuda") * 2 - 1
    vae_eps = torch.randn(14, 40, 72, 4, generator=g, device="cuda")
    enc = {"vae": {"encoder": params["vae"]["encoder"]}, "clip": params["clip"]}
    timer = StageTimer()
    with torch.no_grad():
        for _ in range(3):
            with timer.stage("VAE encode (float32, 14 frames)"):
                trainer_m._vae_encode_frames(enc, bundle, pixels, vae_eps)
            with timer.stage("CLIP (frame 0)"):
                trainer_m.encode_image_clip_train(enc, bundle, pixels[:, 0], torch.bfloat16)
    st = timer.as_dict()
    split = ", ".join(f"{n} {t / timer.counts[n] * 1e3:.1f} ms" for n, t in st.items())
    say(f"  (c) encode_outside_step's encodes at 14x320x576, batch 1, mean of 3 under StageTimer on {card}: {split}; "
        f"the bench's graphed micro-step {train_step_s * 1e3:.1f} ms")
    if not ok_all:
        fail("a request's stages do not sum to its wall time within 2%, or the trace is empty")


def write_gate_checkpoint(torch, params, root, hint_channels):
    """A diffusers-layout checkpoint of `params` under `root`: the recorded
    config.json files (tools/hub_configs.EXPECTED), a ControlNet config
    (the UNet's keys and the hint encoder's channels), and each model's
    weights through the converter's direct export, as .safetensors where
    safetensors imports, else torch .bin. Returns (export s, write s,
    bytes on disk)."""
    from posetraj_torch.tools import hub_configs as hc
    from posetraj_torch.tools.convert_weights import params_to_diffusers

    names = {"feature_extractor": "preprocessor_config.json", "scheduler": "scheduler_config.json"}
    for sub, cfg in hc.EXPECTED.items():
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        with open(os.path.join(root, sub, names.get(sub, "config.json")), "w") as f:
            json.dump(cfg, f)
    cn_cfg = {k: v for k, v in hc.EXPECTED["unet"].items() if k != "up_block_types"}
    cn_cfg.update(conditioning_channels=3, conditioning_embedding_out_channels=list(hint_channels))
    os.makedirs(os.path.join(root, "controlnet"), exist_ok=True)
    with open(os.path.join(root, "controlnet", "config.json"), "w") as f:
        json.dump(cn_cfg, f)
    try:
        from safetensors.numpy import save_file
    except ImportError:
        save_file = None
    export_s = write_s = 0.0
    for model, sub in (("unet", "unet"), ("controlnet", "controlnet"), ("vae", "vae"), ("clip", "image_encoder")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd = params_to_diffusers(params[model], model)
        export_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        if save_file is not None:
            save_file(sd, os.path.join(root, sub, "diffusion_pytorch_model.safetensors"))
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                       os.path.join(root, sub, "diffusion_pytorch_model.bin"))
        write_s += time.perf_counter() - t0
        del sd
    nbytes = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(root) for n in ns)
    return export_s, write_s, nbytes


def gate_check(torch, bundle, params, card):
    """Phase 13(d): tools/parity_gate on the card. A diffusers-layout
    checkpoint of phase 3's seeded full-width parameters under build/
    (write_gate_checkpoint); verify_against_expected must find nothing;
    parity_gate.main([dir, "--skip-reference"]) at its defaults (256x384,
    14 frames, 4 steps) must exit 0, and its latents must equal generate()
    on the in-memory parameters with the gate's inputs bit for bit, or lie
    within the spread of two such calls. The directory is removed."""
    import shutil

    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference, generate
    from posetraj_torch.tools import hub_configs as hc
    from posetraj_torch.tools import parity_gate

    root = os.path.join(HERE, "build", "gate_checkpoint")
    shutil.rmtree(root, ignore_errors=True)
    try:
        export_s, write_s, nbytes = write_gate_checkpoint(torch, params, root,
                                                          bundle.controlnet.hint.block_out_channels)
        issues = hc.verify_against_expected(root)
        npz = os.path.join(root, "latents.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = parity_gate.main([root, "--skip-reference", "--out", npz])
        gate_s = time.perf_counter() - t0
        ours = np.load(npz)["ours"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    h, w, f, steps = 256, 384, 14, 4
    pcfg = PipelineConfig(height=h, width=w, num_frames=f, num_inference_steps=steps, decode_chunk_size=f)
    image, control, noises, _ = parity_gate.make_gate_inputs(h, w, f, 0)
    sched = make_schedule(bundle.scheduler, steps)
    direct = [generate(params, bundle, pcfg, image, control, noises, added_time_ids_inference(pcfg), sched.sigmas,
                       sched.timesteps, f, output_latent=True, device="cuda").float().cpu().numpy()
              for _ in range(2)]
    spread = float(np.abs(direct[0] - direct[1]).max())
    diff = float(np.abs(ours - direct[0]).max())
    ok = rc == 0 and not issues and ours.shape == direct[0].shape and np.isfinite(ours).all() and diff <= spread
    say(f"  (d) parity gate on a diffusers-layout checkpoint of phase 3's full-width parameters: {nbytes / 1e9:.2f} GB "
        f"on disk (direct export {export_s:.2f} s, written in {write_s:.2f} s, removed after); "
        f"verify_against_expected {issues or '[]'}; parity_gate.main --skip-reference (256x384, 14 frames, 4 steps) "
        f"exit {rc} in {gate_s:.1f} s; its latents {ours.shape} against generate() on the in-memory parameters: "
        f"max |diff| {diff:.3g} (two generate() calls differ by {spread:.3g}) on {card} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the parity gate: the checkpoint's configs diverge, the gate failed, or its latents differ from "
             "generate() on the parameters it was written from")


def tools_phase(torch, native, bundle, params, card, steps):
    """Phase 13; returns the sweep's distinct instances by kernel."""
    t0 = time.perf_counter()
    say(f"phase 13: the tools on {card}")
    counts = sweep_check(torch, params, card)
    bench = bench_check(torch, card)
    stage_check(torch, native, bundle, params, card, bench["train_step_sec"], steps)
    gate_check(torch, bundle, params, card)
    say(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=25,
                    help="Euler steps per request in phases 4, 6, 8, 10(c), 11, 12 and 13(c)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs on an NVIDIA GPU only")
    sys.path.insert(0, HERE)
    try:
        from posetraj_torch.configs import KernelConfig
        from posetraj_torch.ops import _native, flash, gemm, groupnorm, layernorm, mlp, qkvt, temporal
        from posetraj_torch.pipeline import ModelBundle
    except ImportError as e:
        fail(f"cannot import posetraj_torch next to this script ({e})")
    ops = (groupnorm, mlp, qkvt, temporal, flash, layernorm, gemm)
    inference_kernels = ("groupnorm", "mlp", "qkvt", "temporal", "gemm", "frame_attn")
    training_kernels = inference_kernels + ("flash_fwd", "flash_bwd")
    off_default = ("flash_fwd", "flash_bwd", "flash_qkv", "flash_tq", "layernorm")
    t_start = time.perf_counter()

    # Phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    say(card)
    t0 = time.perf_counter()
    _native.build_all()
    build_s = time.perf_counter() - t0
    for name in _native.KERNELS:
        _native.library(name)
        regs = [ln.strip() for ln in _native.build_log(name).splitlines() if "registers" in ln]
        say(f"  build {name}: {'; '.join(regs) if regs else 'cached'}")
    # The flash library (the forward of C, 5, 6, 7 and kernel 5's backward)
    # and the libraries of B, C and D (the Hopper GEMM) must run on wgmma fed
    # by TMA: count both in their SASS.
    cuobjdump = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    for name in ("flash", "mlp", "qkvt", "temporal"):
        sass = subprocess.run([cuobjdump, "-sass", str(_native._lib_path(name))], capture_output=True, text=True,
                              timeout=300).stdout
        hgmma, utmaldg = sass.count("HGMMA"), sass.count("UTMALDG")
        say(f"  {name} library SASS: {hgmma} HGMMA, {utmaldg} UTMALDG instructions")
        if not hgmma or not utmaldg:
            fail(f"the {name} library has no HGMMA or no UTMALDG instruction: it is not on wgmma and TMA")
        if name == "temporal":
            # D's frame attention runs on mma.sync (HMMA) fed by TMA: count
            # both in its own function of the library's SASS.
            frame = "".join(part for part in sass.split("Function : ")[1:] if "frame_attn" in part.split("\n", 1)[0])
            hmma, utmaldg = frame.count("HMMA"), frame.count("UTMALDG")
            say(f"  temporal library SASS, frame_attn: {hmma} HMMA, {utmaldg} UTMALDG instructions")
            if not hmma or not utmaldg:
                fail("D's frame attention has no HMMA or no UTMALDG instruction: it is not on mma.sync and TMA")
    # Kernel 8 moves x, y, w and b in 16-byte vectors only: every global
    # load in its library's SASS must be LDG.E.128 (a scalar LDG.E would be
    # the per-element w/b loads of its first port).
    sass = subprocess.run([cuobjdump, "-sass", str(_native._lib_path("layernorm"))], capture_output=True, text=True,
                          timeout=300).stdout
    # Its launch bounds (csrc/layernorm.cu target_registers) must leave
    # every instance the registers it needs: ptxas must spill nothing.
    spills = re.findall(r"(\d+) bytes spill stores", _native.build_log("layernorm"))
    if any(int(n) for n in spills):
        fail(f"kernel 8 spills registers ({spills} bytes of spill stores by instance): its register target "
             "is too low")
    loads = re.findall(r"\bLDG\.E[.A-Z0-9_]*", sass)
    wide = sum(".128" in ld for ld in loads)
    say(f"  layernorm library SASS: {wide} LDG.E.128, {len(loads) - wide} narrower global loads "
        f"({sorted(set(loads))})")
    if not wide or wide != len(loads):
        fail("kernel 8's SASS has a global load narrower than 16 bytes, or none at all")
    say(f"phase 1: {torch.cuda.get_device_name(0)} | {card} | kernels built in {build_s:.1f} s")
    # Phase 2
    say("phase 2: kernels vs plain versions (bf16 unless stated)")
    rows, kernels_ok = check_kernels(torch, ops)
    if not kernels_ok:
        fail("a kernel disagrees with its plain version, or kernel 8 is slower than F.layer_norm or than twice "
             "its bound")
    if not gates_check(torch, ops, _native):
        fail("a block whose gate declines C or D raised, launched them, or disagrees with the plain block")

    # Phase 3
    bundle = ModelBundle()
    t0 = time.perf_counter()
    params = make_params(torch, bundle, args.seed)
    torch.cuda.synchronize()
    say(f"  full-width random parameters on the card in {time.perf_counter() - t0:.1f} s")
    st = step_check(torch, ops, _native, bundle, params, 576, 1024, KernelConfig(), uniform_attention)
    # The step must agree with the plain step, and making the attention
    # uniform must move it by more than that tolerance: otherwise the check
    # could not see a fault in kernels C and D.
    step_tol, step_rms_tol = 5e-2, 3e-2
    cublas = st["profile"][1].get("matmul (cuBLAS)", (0.0, 0))[1]
    # Kernel A is one device launch a call: its profiled launches equal its
    # wrapper's count.
    gn_device = st["profile"][1].get("A groupnorm (port)", (0.0, 0))[1]
    step_ok = (gn_device == st["per_step"]["groupnorm"] and st["finite"]
               and st["err"] <= step_tol * max(st["scale"], 1.0) and st["rel_rms"] <= step_rms_tol
               and st["attn_effect"] > step_rms_tol and not any(st["per_step"][k] for k in off_default)
               and all(st["per_step"][k] == n for k, n in DEFAULT_PER_STEP.items())
               and cublas < CUBLAS_PER_STEP + CUBLAS_MARGIN and st["plain_launches"] == 0)
    say(f"phase 3: one denoise step 14x576x1024 CFG: max_abs_err={st['err']:.4g} (|ref|max {st['scale']:.3g}, "
        f"tol {step_tol:g}x) rel_rms={st['rel_rms']:.3g} (tol {step_rms_tol:g}) uniform-attention "
        f"rel_rms={st['attn_effect']:.3g} (must exceed {step_rms_tol:g}) launches/step={st['per_step']} "
        f"(predicted {DEFAULT_PER_STEP}; cuBLAS {cublas}, below {CUBLAS_PER_STEP + CUBLAS_MARGIN}; A {gn_device} "
        f"device launches for {st['per_step']['groupnorm']} calls) "
        f"step {st['step_s']:.3f} s (plain {st['plain_s']:.3f} s, {st['plain_launches']} launches) "
        f"{'ok' if step_ok else 'FAIL'}")
    print_profile(f"profile of one kernel step on {card}", st["profile"])
    if not step_ok:
        fail("the kernel step disagrees with the plain step, cannot see the attention, or launched other kernels "
             "than predicted")

    # Phase 4
    outs, req_s, denoise_s, launches, peak, capture_s = run_pipeline(torch, _native, bundle, params, args.steps,
                                                                      576, 1024)
    for out in outs:
        if out.shape != (1, 14, 576, 1024, 3):
            fail(f"output shape {out.shape}")
        if not (np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
            fail("output not finite or outside [0, 1]")
    if any(launches[k] == 0 for k in inference_kernels) or any(launches[k] for k in off_default):
        fail(f"inference launched a kernel it should not, or missed one: {launches}")
    say(f"phase 4: SVDControlNetPipeline 14x576x1024 CFG, {args.steps} steps, 2 requests on {card} (the denoise "
        f"loop a captured graph, {capture_s:.2f} s to capture in the first): "
        f"s/request={[round(s, 3) for s in req_s]} s/denoise-step={[round(s / args.steps, 4) for s in denoise_s]} "
        f"peak_mem={peak / 2**30:.1f} GiB launches={launches}")

    # Phase 5: training. Params of phases 3-4 are reused: the trainer copies
    # the ControlNet into float32 masters and freezes the rest.
    del outs
    torch.cuda.empty_cache()
    f, h, w = 14, 320, 576
    tr = train_check(torch, ops, _native, bundle, params, f, h, w)
    # Gradient of one micro-step, kernels against plain: bf16 activations
    # round differently along ~100 layers of forward and backward, so the
    # global relative RMS is held to 2e-2 (0.0039 measured on an H100);
    # uniform attention (Wq zeroed in C and D, so kernel 5 in C's backward
    # sees it too) must move the gradient by more than that (0.155 measured
    # with dropout in the draw), or the check could not see C and 5.
    grad_tol = 2e-2
    grad_ok = (np.isfinite(tr["loss_k"]) and tr["grad_rel_rms"] <= grad_tol and tr["uniform_effect"] > grad_tol
               and not tr["bad_leaves"] and tr["plain_launches"] == 0)
    say(f"phase 5: training 14x320x576 batch 1 on {card}")
    say(f"  (a) one micro-step, kernels vs plain: loss {tr['loss_k']:.6g} vs {tr['loss_p']:.6g}, ControlNet "
        f"gradient rel_rms={tr['grad_rel_rms']:.4g} (tol {grad_tol:g}); uniform attention moves it by "
        f"{tr['uniform_effect']:.4g} (must exceed {grad_tol:g}); {tr['grad_s']:.3f} s; launches "
        f"{tr['grad_launches']} (plain step: {tr['plain_launches']})")
    say(f"  (b) {tr['leaves']} ControlNet leaves: every gradient finite, non-zero on all but the "
        f"{tr['dead']} that feed only a one-key cross-attention's query (exactly zero there); leaves that break "
        f"this: {tr['bad_leaves'][:10]} {'ok' if grad_ok else 'FAIL'}")
    if not grad_ok:
        fail("training gradients disagree with the plain step, cannot see the attention, or miss a leaf")
    st4 = tr["steps"]
    for i, m in enumerate(st4):
        say(f"  (c) micro-step {i + 1}: loss {m['loss']:.6g} grad_norm {m['grad_norm']:.6g} lr {m['lr']:.3g} "
            f"adam steps {m['adam_steps']} params changed {m['changed']} ema==params {m['ema_equal']} "
            f"{m['s']:.3f} s" + (f" ema lag rel err {m['ema_lag_err']:.3g}" if "ema_lag_err" in m else ""))
    # Micro-steps 1 and 3 accumulate only. Micro-step 2 is the first update:
    # Adam takes its step, at the warmup's first learning rate, 0 (optax's
    # schedule at count 0; torch's LambdaLR alike), so the params stay; the
    # EMA becomes the params (decay 0). Micro-step 4 moves the params and
    # the EMA lags them with decay 2/11.
    acc_ok = (all(np.isfinite(m["loss"]) for m in st4)
              and [m["adam_steps"] for m in st4] == [0, 1, 1, 2]
              and [m["changed"] for m in st4] == [False, False, False, True]
              and st4[1]["ema_equal"] and not st4[3]["ema_equal"] and st4[3]["ema_lag_err"] <= 1e-5
              and tr["unet_unchanged"] and not tr["graph_in_down"] and tr["down_calls"] > 0)
    tl = tr["launches"]
    launch_ok = all(tl[k] > 0 for k in training_kernels)
    micro_s = [m["s"] for m in st4]
    say(f"  (c) Trainer.step x4: accumulation/EMA {'ok' if acc_ok else 'FAIL'}, UNet unchanged "
        f"{tr['unet_unchanged']}, graph in UNet down/mid {tr['graph_in_down']} ({tr['down_calls']} calls), "
        f"launches {tl} {'ok' if launch_ok else 'FAIL'}; s/micro-step={[round(x, 4) for x in micro_s]} "
        f"s/optimizer-step={[round(micro_s[0] + micro_s[1], 4), round(micro_s[2] + micro_s[3], 4)]} "
        f"peak_mem={tr['peak_gib']:.2f} GiB on {card}")
    if not (acc_ok and launch_ok):
        fail("the train steps broke accumulation, EMA, the frozen UNet, or missed a kernel")
    print_profile(f"(d) profile of one micro-step on {card}", tr["profile"])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ge = graph_train_check(torch, _native, bundle, params, f, h, w, card)
    train_configs_check(torch, ops, _native, params, f, h, w, grad_tol, ge["mem"], card)
    resume_check(torch, params, f, h, w, card)
    say(f"  phase 5(e)-(g) took {time.perf_counter() - t0:.1f} s; a full-width checkpoint holds "
        f"{ge['state_gb']:.2f} GB of tensors")

    # Phase 6: inference at 14x320x576 under the un-fused KernelConfig.
    un = un_fused_check(torch, ops, _native, bundle, params, args.steps, card)
    torch.cuda.empty_cache()

    # Phase 8: the hint encoder's variants (phase 7 is the summary below).
    t0 = time.perf_counter()
    variants_check(torch, ops, _native, params, args.steps, card, launches,
                   next(r for r in rows if r["name"] == "groupnorm"))
    say(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    # Phase 9: the denoise loop's captured graph against the eager loop.
    say(f"phase 9: the denoise loop as one captured CUDA graph vs the eager loop on {card}")
    graph_check(torch, _native, bundle, params, 576, 1024, KernelConfig(), DEFAULT_PER_STEP, card, "default")
    torch.cuda.empty_cache()
    eager_s, graph_s = graph_check(torch, _native, bundle, params, 320, 576, KernelConfig(**UNFUSED),
                                   UNFUSED_PER_STEP, card, "un-fused")
    if graph_s > eager_s:
        fail("the un-fused graphed denoise step is slower than its eager step")
    torch.cuda.empty_cache()
    direct = min(args.steps, DIRECT_STEPS)
    direct_generate_check(torch, bundle, params, direct, 576, 1024, KernelConfig(), card, "default")
    direct_generate_check(torch, bundle, params, direct, 320, 576, KernelConfig(**UNFUSED), card, "un-fused")
    torch.cuda.empty_cache()

    # Phase 10: the data layer, the training CLI's loop, the inference driver.
    t0 = time.perf_counter()
    say(f"phase 10: the data layer, the training CLI's loop and the inference driver on {card}")
    import_check()
    raster_check(torch, card)
    train_cli_check(torch, _native, params, card, training_kernels)
    driver_check(torch, _native, args.steps, {k: n // 2 for k, n in launches.items()}, card)
    say(f"  phase 10 took {time.perf_counter() - t0:.1f} s")

    # Phase 11: single-video sharded serving.
    rows11, sharded = sharded_phase(torch, _native, groupnorm, flash, bundle, params, args, req_s, card)

    # Phase 12: the ("data", "model") mesh.
    mesh_phase(torch, _native, bundle, params, args, ge, training_kernels, inference_kernels, card)

    # Phase 13: the tools (the kernel sweep, the training bench, stage
    # timing and tracing, the parity gate).
    tools_phase(torch, _native, bundle, params, card, args.steps)

    # Phase 7: A-D count phase 4's run, kernel 5 phase 5(c)'s, 6-8 phase 6's
    # (A's split form phase 11's sharded requests).
    for r in rows:
        name = r["name"]
        r["launches"] = launches[name] if name in inference_kernels else tl[name] if name in training_kernels \
            else un[name]
    summary(torch, _native, rows + rows11, t_start)


def sharded_phase(torch, native, groupnorm, flash, bundle, params, args, per_request, card):
    """Phase 11; returns its JSON rows (A's split form) and the launches of
    its sharded requests."""
    t0 = time.perf_counter()
    rows = split_groupnorm_check(torch, groupnorm, params, card)
    gathered_flash_check(torch, flash, card)
    sharded, lat11, tol11 = sharded_serving_check(torch, native, bundle, params, args.steps, per_request, card)
    torch.cuda.empty_cache()
    split = split_mesh_check(torch, args.steps, args.seed, lat11, tol11, card)
    if split is not None:
        sharded = {k: sharded[k] + split[k] for k in sharded}
    say(f"  kernel A's split form on the sharded path: {sharded['gn_stats']} statistics and {sharded['gn_apply']} "
        "apply launches (none on a (1, 1) mesh, where no GroupNorm's W is sharded: 11(a) holds the split form "
        "alone; 11(d) runs it where the host has two cards)")
    say(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    for r in rows:
        r["launches"] = sharded[r["name"]]
    return rows, sharded


def summary(torch, native, rows, t_start) -> None:
    """Phase 7, printed last: the kernels line, the JSON line of kernel
    numbers and the last line."""
    say("kernels: " + " ".join(f"{k}=pass" for k in native.COUNTERS))
    for r in rows:
        r["source"], r["replaces"] = KERNEL_META[r["name"]]
        r["route"] = "cuda"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
