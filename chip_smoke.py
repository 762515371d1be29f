#!/usr/bin/env python3
"""Smoke test of posetraj_torch on one NVIDIA GPU (an H100 for the numbers
in PERF.md): the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py            # every phase, as the checks run it
    python3 chip_smoke.py --steps 4  # fewer Euler steps in phase 4

Phases, one line of output each (more for phase 2):
  1. the card (nvidia-smi name, power limit) and the build of the four CUDA
     kernels from posetraj_torch/csrc, one nvcc per source, in parallel;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (and the 320x576 ones, whose S is ragged for the attention
     tiles), bf16, with its error against the stated tolerance (for the
     residual sub-layers B, C, D: the error of the branch, out minus the
     residual term), its median time, the plain version's, the bound (bytes
     over 3.35 TB/s or operations over the dense peak, whichever is larger)
     and, where one PyTorch call computes the same function, that call's
     time;
  3. one denoise step (ControlNet -> UNet, CFG batch) at full SVD width and
     14x576x1024, with the kernels and with the plain versions, compared,
     and with uniform attention, to show the comparison can see kernels C
     and D; the kernel step once more under torch.profiler, its device time
     grouped by kernel;
  4. SVDControlNetPipeline at full width (UNet 320..1280, ViT-H CLIP, VAE
     128..512), 14x576x1024 with CFG, two requests; launch counts of every
     kernel over that run, output checked for shape, finiteness and range;
  5. a `kernels` summary, the JSON line of kernel numbers, and the last line
     {"ok": true, "device": {...}}.
Any failure exits non-zero before the last line. Weights are random, from a
seed; the zero-initialised ControlNet heads get small random values so the
ControlNet branch reaches the output, and Wq, Wk are scaled so that the
attention is peaked (QK_SCALE).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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

KERNEL_META = {
    "groupnorm": ("posetraj_torch/csrc/groupnorm.cu", "posetraj_tpu/ops/pallas_groupnorm.py:209"),
    "mlp": ("posetraj_torch/csrc/mlp.cu", "posetraj_tpu/ops/pallas_mlp.py:129"),
    "qkvt": ("posetraj_torch/csrc/qkvt.cu", "posetraj_tpu/ops/pallas_qkvt.py:367"),
    "temporal": ("posetraj_torch/csrc/temporal.cu", "posetraj_tpu/ops/pallas_temporal.py:299"),
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


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, tol: float, base=None, rms_tol=None):
    """Kernel output `got` against the plain output `want`: the max abs error
    must be within `tol` times the reference's max, and the error's RMS within
    `rms_tol` of the reference's RMS. With `base` (a sub-layer's residual
    term) the reference is the branch want - base, not the whole output, so a
    residual larger than the branch cannot hide a wrong branch."""
    want = want.float()
    ref = want - base.float() if base is not None else want
    diff = got.float() - want
    err, scale = float(diff.abs().max()), float(ref.abs().max())
    rel_rms = float(diff.norm() / ref.norm())
    ok = err <= tol * scale and (rms_tol is None or rel_rms <= rms_tol)
    return err, scale, rel_rms, ok


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(torch, ops):
    groupnorm, mlp, qkvt, temporal = ops
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

    rows, ok_all = [], True

    def report(name, label, err, scale, rel_rms, ok, tol, rms_tol=None, branch=False):
        nonlocal ok_all
        ok_all &= ok
        rms = f" (tol {rms_tol:g})" if rms_tol is not None else ""
        say(f"  {name:9s} {label:50s} max_abs_err={err:.4g} (|{'branch' if branch else 'ref'}|max {scale:.3g}, "
            f"tol {tol:g}x) rel_rms={rel_rms:.3g}{rms} {'ok' if ok else 'FAIL'}")

    # A: GroupNorm. Timed shape: UNet level-0 resnet norm2 with the temb fold
    # and SiLU, (28, 72, 128, 320) bf16. Also checked: the temporal resnet's
    # per-frame fold, the float32 VAE encode, and a full-resolution VAE
    # decode chunk (14, 576, 1024, 128) of more than 2^28 elements.
    tol = 2e-2
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

    # B: fused LN + GEGLU MLP. Timed shape: level-0 FF with the folded
    # cross-attention vector, rows 28*9216, K 320, hidden 1280. Also checked:
    # level 1 (K 640) and level 2 (K 1280), which take other row tiles. The
    # check is on the MLP branch, out - (x + add).
    tol, rms_tol = 3e-2, 1e-2
    for level, (m, k, add_shape) in enumerate(((28 * 9216, 320, (28, 1, 320)), (28 * 2304, 640, (2, 2304, 640)),
                                               (28 * 576, 1280, (28, 1, 1280)))):
        n4 = 4 * k
        args = (rnd(m, k), rnd(2 * n4, k, scale=k**-0.5), rnd(2 * n4, scale=0.1), rnd(k, n4, scale=n4**-0.5),
                rnd(k, scale=0.1), *ln_params(k))
        addm = rnd(*add_shape)
        run_k = lambda: mlp.geglu_mlp_kernel(*args, 1e-5, True, addm)
        run_p = lambda: mlp.geglu_mlp_plain(*args, 1e-5, True, addm)
        err, scale, rel_rms, ok = compare(run_k(), run_p(), tol, mlp.broadcast_add_rows(args[0], addm), rms_tol)
        report("mlp", f"rows={m} K={k} hidden={n4} +ln +res +add{add_shape}", err, scale, rel_rms, ok, tol,
               rms_tol, branch=True)
        if level == 0:
            ms, plain = cuda_ms(run_k), cuda_ms(run_p)
            flops = 2 * m * k * 2 * n4 + 2 * m * n4 * k
            nbytes = 2 * (2 * m * k + 3 * n4 * k + addm.numel())
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            rows.append(dict(name="mlp", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=None))
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del args, addm
    torch.cuda.empty_cache()

    # C: spatial attention sub-layer at the three UNet levels of 576x1024 and
    # of 320x576 (S = 2880, 720, 180: ragged for the 128-query tiles, and
    # 720 and 180 for the 64-key tiles too), CFG batch 28. The check is on
    # the branch out - x. Logits get sigma^2 = ln(S / 64), so that about 64
    # keys carry each query's weight and the attention pattern, not the mean
    # of V, makes the branch; a key mask that let the padded keys in would
    # move it by 2-4% at S = 720 and 180, above the RMS tolerance.
    tol, rms_tol = 3e-2, 1e-2
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
            heads = c // 64
            ms, plain = cuda_ms(run_k, reps=3, inner=2), cuda_ms(run_p, reps=3, inner=1)
            q = rnd(bsz, heads, s, 64)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, q, q), reps=3, inner=2)
            m = bsz * s
            flops = 2 * m * c * 3 * c + 4 * bsz * heads * s * s * 64 + 2 * m * c * c
            nbytes = 2 * (2 * m * c + 4 * c * c + c)
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            rows.append(dict(name="qkvt", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=lib))
            del q
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del a
    torch.cuda.empty_cache()

    # D: temporal sub-layer, x (2, 14, S, C) at the three levels; logits of
    # standard deviation 1 over the 14 frames. The check is on out - x.
    tol, rms_tol = 3e-2, 1e-2
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
            q = rnd(2 * s, heads, f, 64)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, q, q))
            m = 2 * f * s
            flops = 2 * m * c * 3 * c + 4 * 2 * s * heads * f * f * 64 + 2 * m * c * c
            nbytes = 2 * (2 * m * c + 4 * c * c + c)
            bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            rows.append(dict(name="temporal", max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=lib))
            del q
        else:
            rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
        del a
    torch.cuda.empty_cache()
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        say(f"  {r['name']:9s} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']}) library_ms={lib}")
    return rows, ok_all


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
    """Routes the model's four kernel wrappers to their plain versions (the
    reference of phase 3)."""
    groupnorm, mlp, qkvt, temporal = ops
    return patched((groupnorm, "group_norm", groupnorm.group_norm_plain), (mlp, "geglu_mlp", mlp.geglu_mlp_plain),
                   (qkvt, "attn_sublayer", qkvt.attn_sublayer_plain),
                   (temporal, "temporal_attn_sublayer", temporal.temporal_attn_sublayer_plain))


def uniform_attention(ops):
    """Zeroes Wq in every call of kernels C and D, so that each query weighs
    all keys alike: the step it gives shows how far the attention pattern
    moves the step's output."""
    _, _, qkvt, temporal = ops

    def without_queries(fn):
        def run(x, ln_w, ln_b, wqkv, *rest):
            wqkv = wqkv.clone()
            wqkv[: x.shape[-1]] = 0
            return fn(x, ln_w, ln_b, wqkv, *rest)

        return run

    return patched((qkvt, "attn_sublayer", without_queries(qkvt.attn_sublayer)),
                   (temporal, "temporal_attn_sublayer", without_queries(temporal.temporal_attn_sublayer)))


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
    for key, group in (("gn_", "A groupnorm (port)"), ("mlp_kernel", "B mlp (port)"),
                       ("flash_fwd", "C flash attention (port)"), ("frame_attn", "D frame attention (port)"),
                       ("gemm_kernel", "C/D projection GEMMs (port)"), ("row_stats", "C/D projection GEMMs (port)")):
        if key in low:
            return group
    if any(k in low for k in ("conv", "implicit", "xmma_fprop", "cudnn")):
        return "convolution (cuDNN)"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "sm90")):
        return "matmul (cuBLAS)"
    if any(k in low for k in ("elementwise", "vectorized", "reduce", "cat", "copy", "layer_norm")):
        return "elementwise / copy / norm (PyTorch)"
    return "other"


def profile_step(torch, step):
    """One warm step under torch.profiler: wall time, summed device time of
    its kernels, and that time grouped by _kernel_group."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            gr = groups[_kernel_group(ev.name)]
            gr[0] += (ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total) / 1e3
            gr[1] += 1
    return wall_ms, dict(groups)


def step_check(torch, ops, native, bundle, params):
    """One ControlNet -> UNet step on the CFG batch: kernels vs plain, kernels
    with uniform attention, and the warm kernel step under the profiler."""
    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.models import unet as unet_m

    dt = torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(99)
    f, h, w = 14, 72, 128
    lat_in = torch.randn(2, f, h, w, 8, generator=g, device="cuda").to(dt)
    clip = torch.randn(2, 1, 1024, generator=g, device="cuda").to(dt)
    ids = torch.tensor([[6.0, 128.0, 0.02]] * 2, device="cuda")
    control = (torch.rand(2, f, 576, 1024, 3, generator=g, device="cuda") * 2 - 1).to(dt)
    t = torch.tensor(0.25 * 6.55, device="cuda")
    hint = cn.hint_encoder(params["controlnet"]["controlnet_cond_embedding"], bundle.controlnet.hint, control, f, dt)

    def step():
        down, mid = cn.controlnet_forward(params["controlnet"], bundle.controlnet, lat_in, t, clip, ids,
                                          compute_dtype=dt, hint_embedding=hint)
        return unet_m.unet_forward(params["unet"], bundle.unet, lat_in, t, clip, ids, down, mid, compute_dtype=dt)

    with torch.inference_mode():
        native.reset_launches()
        got = step().float()
        torch.cuda.synchronize()
        per_step = dict(native.LAUNCHES)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        profile = profile_step(torch, step)
        with uniform_attention(ops):
            uniform = step().float()
        with plain_versions(ops):
            want = step().float()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel_rms = float((got - want).norm() / want.norm())
    attn_effect = float((uniform - got).norm() / got.norm())
    return dict(err=err, scale=scale, rel_rms=rel_rms, attn_effect=attn_effect, finite=bool(torch.isfinite(got).all()),
                per_step=per_step, step_s=step_s, plain_s=plain_s, profile=profile)


def run_pipeline(torch, native, bundle, params, steps):
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

    outs, req_s = [], []
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(pipe_m, "denoise", timed_denoise):
        native.reset_launches()
        for seed in (0, 1):
            rng = np.random.RandomState(100 + seed)
            image = rng.rand(1, 576, 1024, 3).astype(np.float32)
            control = rng.rand(1, 14, 576, 1024, 3).astype(np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(pipe(image, control, height=576, width=1024, num_frames=14, num_inference_steps=steps,
                             seed=seed))
            req_s.append(time.perf_counter() - t0)
        launches = dict(native.LAUNCHES)
    return outs, req_s, denoise_s, launches, torch.cuda.max_memory_allocated()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=25, help="Euler steps per request in phase 4")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test runs on an NVIDIA GPU only")
    sys.path.insert(0, HERE)
    try:
        from posetraj_torch.ops import _native, groupnorm, mlp, qkvt, temporal
        from posetraj_torch.pipeline import ModelBundle
    except ImportError as e:
        fail(f"cannot import posetraj_torch next to this script ({e})")
    ops = (groupnorm, mlp, qkvt, temporal)
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
    say(f"phase 1: {torch.cuda.get_device_name(0)} | {card} | kernels built in {build_s:.1f} s")

    # Phase 2
    say("phase 2: kernels vs plain versions (bf16 unless stated)")
    rows, kernels_ok = check_kernels(torch, ops)
    if not kernels_ok:
        fail("a kernel disagrees with its plain version")

    # Phase 3
    bundle = ModelBundle()
    t0 = time.perf_counter()
    params = make_params(torch, bundle, args.seed)
    torch.cuda.synchronize()
    say(f"  full-width random parameters on the card in {time.perf_counter() - t0:.1f} s")
    st = step_check(torch, ops, _native, bundle, params)
    # The step must agree with the plain step, and making the attention
    # uniform must move it by more than that tolerance: otherwise the check
    # could not see a fault in kernels C and D.
    step_tol, step_rms_tol = 5e-2, 3e-2
    step_ok = (st["finite"] and st["err"] <= step_tol * max(st["scale"], 1.0) and st["rel_rms"] <= step_rms_tol
               and st["attn_effect"] > step_rms_tol)
    say(f"phase 3: one denoise step 14x576x1024 CFG: max_abs_err={st['err']:.4g} (|ref|max {st['scale']:.3g}, "
        f"tol {step_tol:g}x) rel_rms={st['rel_rms']:.3g} (tol {step_rms_tol:g}) uniform-attention "
        f"rel_rms={st['attn_effect']:.3g} (must exceed {step_rms_tol:g}) launches/step={st['per_step']} "
        f"step {st['step_s']:.3f} s (plain {st['plain_s']:.3f} s) {'ok' if step_ok else 'FAIL'}")
    wall_ms, groups = st["profile"]
    device_ms = sum(v[0] for v in groups.values())
    say(f"  profile of one kernel step on {card}: wall {wall_ms:.1f} ms, device kernel time {device_ms:.1f} ms, "
        f"busy share {device_ms / wall_ms:.3f}")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        say(f"    {name:36s} {ms:9.2f} ms {n:6d} launches {ms / max(device_ms, 1e-9):7.1%}")
    if not step_ok:
        fail("the kernel step disagrees with the plain step, or cannot see the attention")

    # Phase 4
    outs, req_s, denoise_s, launches, peak = run_pipeline(torch, _native, bundle, params, args.steps)
    for out in outs:
        if out.shape != (1, 14, 576, 1024, 3):
            fail(f"output shape {out.shape}")
        if not (np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
            fail("output not finite or outside [0, 1]")
    if any(launches[k] == 0 for k in _native.KERNELS):
        fail(f"a kernel was not launched on the main path: {launches}")
    say(f"phase 4: SVDControlNetPipeline 14x576x1024 CFG, {args.steps} steps, 2 requests on {card}: "
        f"s/request={[round(s, 3) for s in req_s]} s/denoise-step={[round(s / args.steps, 4) for s in denoise_s]} "
        f"peak_mem={peak / 2**30:.1f} GiB launches={launches}")

    # Phase 5
    say("kernels: " + " ".join(f"{k}=pass" for k in _native.KERNELS))
    for r in rows:
        src, replaces = KERNEL_META[r["name"]]
        r.update(route="cuda", source=src, replaces=replaces, launches=launches[r["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    say(f"  total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
