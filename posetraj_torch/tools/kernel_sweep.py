"""Sweep of every kernel instance that generate() dispatches, at the exact
shapes it dispatches them, each held against its plain version on the card
(port of posetraj_tpu/tools/kernel_sweep.py).

The smoke's phase 2 and the card tests hold each kernel at a few timed
shapes; a fault at another shape the model dispatches could hide below a
whole step's bf16 noise. This module closes that gap:

  1. RECORD: every kernel wrapper in TARGETS is replaced by a recorder, and
     one eager generate() (one Euler step: every step dispatches the same
     shapes) runs on the card at each resolution, full width, 14 frames,
     CFG, under the bundle's KernelConfig. The port's dispatch gates read
     the tensor's device (`is_cuda`: kernels 5-8 and the GroupNorm path),
     so a run on `meta` tensors would decline them: the record runs on the
     card, on tools/fill.py weights. The recording is exactly the set of
     (kernel, shapes, strides, dtypes, static arguments) instances the
     program contains; nothing is a hand-kept shape list.
  2. REPLAY: each unique instance gets seeded operands of its recorded
     shapes, strides and dtypes and runs through its wrapper on the card
     (the kernel, or an error: a wrapper never falls back to its plain
     version), and the result is held against the plain version on the same
     operands with phase 2's tolerance for that kernel (TOLERANCES). One
     instance at a time on the current stream: kernel A's per-device
     workspace admits no two A calls at once.

A skip-cache under build/ records every instance that passed on a card,
keyed by a hash of posetraj_torch/ops/*.py and posetraj_torch/csrc/** and by
the card's name and compute capability (a run on the CPU, where every
wrapper is its plain version, neither reads nor writes it); `deadline_s`
sheds the instances still pending when the clock runs out. Each is reported
(CACHED, SHED), never silent.

    python -m posetraj_torch.tools.kernel_sweep [--resolutions 576x1024,320x576] [--unfused] [--no-cache]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP_CACHE_PATH = os.path.join(_REPO_ROOT, "build", "kernel_sweep_ok.json")

# Every kernel wrapper the models reach. Each is called through its module
# attribute at call time (models/transformer.py: mlp., qkvt., temporal.;
# ops/primitives.py: gn_kernel., ln_kernel.; ops/attention.py: flash.), so
# replacing the attribute intercepts every call.
TARGETS = (
    ("posetraj_torch.ops.qkvt", "attn_sublayer"),
    ("posetraj_torch.ops.temporal", "temporal_attn_sublayer"),
    ("posetraj_torch.ops.mlp", "geglu_mlp"),
    ("posetraj_torch.ops.groupnorm", "group_norm"),
    ("posetraj_torch.ops.layernorm", "layer_norm"),
    ("posetraj_torch.ops.flash", "flash_attention"),
    ("posetraj_torch.ops.flash", "flash_attention_tq"),
    ("posetraj_torch.ops.flash", "flash_attention_qkv"),
)

# Each kernel's tolerance against its plain version, which chip_smoke.py's
# phase 2 reads too: the max abs error within `tol` times the reference's
# max, the error's RMS within `rms` of the reference's RMS; for the residual
# sub-layers the reference is the branch, out minus the residual term.
TOLERANCES = {
    "qkvt.attn_sublayer": (3e-2, 1e-2),
    "temporal.temporal_attn_sublayer": (3e-2, 1e-2),
    "mlp.geglu_mlp": (3e-2, 1e-2),
    "groupnorm.group_norm": (2e-2, None),
    "layernorm.layer_norm": (1e-2, 2e-3),  # float32 x: (1e-5, 1e-6)
    "flash.flash_attention": (3e-2, 1e-2),
    "flash.flash_attention_tq": (3e-2, 1e-2),
    "flash.flash_attention_qkv": (3e-2, 1e-2),
}
FLOAT32_LAYERNORM_TOLERANCE = (1e-5, 1e-6)


def code_hash() -> str:
    """Hash of posetraj_torch/ops/*.py and every file under
    posetraj_torch/csrc: the code part of the skip-cache key. Any edit of a
    wrapper or a kernel source invalidates every cached OK."""
    pkg = os.path.join(_REPO_ROOT, "posetraj_torch")
    files = [os.path.join(pkg, "ops", n) for n in os.listdir(os.path.join(pkg, "ops")) if n.endswith(".py")]
    for root, _, names in os.walk(os.path.join(pkg, "csrc")):
        files += [os.path.join(root, n) for n in names]
    h = hashlib.sha256()
    for path in sorted(files):
        with open(path, "rb") as f:
            h.update(os.path.relpath(path, pkg).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def cache_key(device: torch.device) -> Optional[str]:
    """The skip-cache key of a sweep on `device`: code_hash() with the
    card's name and compute capability; None off the card, where each
    wrapper is its plain version and a pass proves nothing of a kernel."""
    if device.type != "cuda":
        return None
    major, minor = torch.cuda.get_device_capability(device)
    return f"{code_hash()}/{torch.cuda.get_device_name(device)}/sm_{major}{minor}"


def _load_cache(key: str) -> set:
    try:
        with open(SWEEP_CACHE_PATH) as f:
            data = json.load(f)
        if data.get("key") == key:
            return set(data.get("ok", []))
    except (OSError, ValueError):
        pass
    return set()


def _save_cache(key: str, ok_keys: set) -> None:
    try:
        os.makedirs(os.path.dirname(SWEEP_CACHE_PATH), exist_ok=True)
        with open(SWEEP_CACHE_PATH, "w") as f:
            json.dump({"key": key, "ok": sorted(ok_keys)}, f, indent=0)
    except OSError:
        pass  # a read-only checkout: the cache saves time, nothing needs it


@dataclass(frozen=True)
class TensorSpec:
    """What a replay needs of a recorded tensor: shape, strides, storage
    offset (views of a packed projection keep theirs), dtype."""

    shape: tuple
    stride: tuple
    offset: int
    dtype: torch.dtype

    def __repr__(self) -> str:
        name = str(self.dtype).removeprefix("torch.")
        contiguous = self.stride == torch.empty(self.shape, device="meta").stride()
        layout = "" if contiguous else f"/s{list(self.stride)}+{self.offset}"
        return f"{name}{list(self.shape)}{layout}"


def _spec(v):
    if isinstance(v, torch.Tensor):
        return TensorSpec(tuple(v.shape), tuple(v.stride()), v.storage_offset(), v.dtype)
    if callable(v):
        return "<callable>"
    return v


@dataclass
class Instance:
    name: str     # "module.function", a key of TOLERANCES
    args: tuple   # tensors as TensorSpec
    kwargs: dict

    def key(self) -> str:
        a = ",".join(repr(v) for v in self.args)
        k = ",".join(f"{n}={v!r}" for n, v in sorted(self.kwargs.items()))
        return f"{self.name}({a}{',' if k else ''}{k})"


@dataclass(frozen=True)
class Outcome:
    """One instance's result: OK or FAIL with the numbers of its comparison
    (max abs error, the reference's max, the tolerance factor, the error's
    RMS relative to the reference's), or a `note` where there are none (an
    exception, a non-finite output, CACHED, SHED)."""

    status: str
    err: float = math.nan
    scale: float = math.nan
    tol: float = math.nan
    rel_rms: float = math.nan
    note: str = ""

    @property
    def detail(self) -> str:
        if self.note:
            return self.note
        return (f"max_abs_err={self.err:.4g} (|ref|max {self.scale:.3g}, tol {self.tol:g}x) "
                f"rel_rms={self.rel_rms:.3g}")


@dataclass
class SweepResult:
    instances: list = field(default_factory=list)  # (key, Outcome)

    @property
    def failures(self):
        return [(k, o.detail) for k, o in self.instances if o.status == "FAIL"]

    def counts(self) -> Dict[str, int]:
        """Distinct instances a kernel (by TARGETS name)."""
        out: Dict[str, int] = {}
        for key, _ in self.instances:
            name = key.split("(", 1)[0]
            out[name] = out.get(name, 0) + 1
        return out


def _short(mod_name: str, attr: str) -> str:
    return f"{mod_name.rsplit('.', 1)[1]}.{attr}"


def _record_targets(records: dict) -> Callable[[], None]:
    """Replace TARGETS with recorders; returns the undo."""
    originals = []

    def make_wrapper(name, orig):
        def wrapper(*args, **kwargs):
            inst = Instance(name, tuple(_spec(a) for a in args), {k: _spec(v) for k, v in kwargs.items()})
            records.setdefault(inst.key(), inst)
            return orig(*args, **kwargs)

        return wrapper

    for mod_name, attr in TARGETS:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)
        originals.append((mod, attr, orig))
        setattr(mod, attr, make_wrapper(_short(mod_name, attr), orig))

    def undo():
        for mod, attr, orig in reversed(originals):
            setattr(mod, attr, orig)

    return undo


def _generate_once(bundle, params, height: int, width: int, frames: int, device, compute_dtype) -> None:
    """One eager generate() (one Euler step, CFG, the pipeline's decode of
    all frames in one chunk) on constant inputs."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import svd_controlnet as sc

    pcfg = PipelineConfig(height=height, width=width, num_frames=frames, num_inference_steps=1,
                          decode_chunk_size=frames)
    sched = make_schedule(bundle.scheduler, 1)
    sf, lc = bundle.vae.scale_factor, bundle.vae.latent_channels
    image = torch.full((1, height, width, 3), 0.5, device=device)
    control = torch.zeros((1, frames, height, width, 3), device=device)
    noises = {"latents": torch.ones((1, frames, height // sf, width // sf, lc), device=device),
              "image_aug": torch.zeros((1, height, width, 3), device=device)}
    graphed = sc.denoise
    sc.denoise = lambda *a, graph=None, **k: sc.denoise_eager(*a, **k)
    try:
        sc.generate(params, bundle, pcfg, image, control, noises, sc.added_time_ids_inference(pcfg), sched.sigmas,
                    sched.timesteps, frames, device=device, compute_dtype=compute_dtype)
    finally:
        sc.denoise = graphed


def record_instances(resolutions=((576, 1024), (320, 576)), kernels=None, frames: int = 14, bundle=None,
                     params=None, device=None, compute_dtype=None) -> Dict[str, Instance]:
    """The unique kernel instances generate() dispatches at each (height,
    width), `frames` frames, CFG, under `kernels` (a KernelConfig; None: the
    bundle's, or the POSETRAJ_* variables). bundle: default the flagship
    ModelBundle(); params: the bundle's parameters on `device` (default:
    tools/fill.py's pattern, made here)."""
    import dataclasses

    from posetraj_torch.core.init import default_compute_dtype, resolve_device
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline.svd_controlnet import init_params

    device = resolve_device(device)
    dt = compute_dtype or default_compute_dtype(device)
    bundle = bundle or ModelBundle()
    if kernels is not None:
        bundle = dataclasses.replace(bundle, kernels=kernels)
    if params is None:
        from posetraj_torch.tools.fill import fill_like

        params = fill_like(init_params(bundle, device="meta", compute_dtype=dt), dt, device)
    records: Dict[str, Instance] = {}
    undo = _record_targets(records)
    try:
        for h, w in resolutions:
            _generate_once(bundle, params, h, w, frames, device, dt)
    finally:
        undo()
    return records


def _plain(name: str) -> Callable:
    """The plain PyTorch version of a TARGET, taking the wrapper's
    arguments."""
    from posetraj_torch.ops import flash, groupnorm, layernorm, mlp, qkvt, temporal

    return {
        "qkvt.attn_sublayer": qkvt.attn_sublayer_plain,
        "temporal.temporal_attn_sublayer": temporal.temporal_attn_sublayer_plain,
        "mlp.geglu_mlp": mlp.geglu_mlp_plain,
        "groupnorm.group_norm": groupnorm.group_norm_plain,
        "layernorm.layer_norm": layernorm.layer_norm_plain,
        "flash.flash_attention": flash.flash_attention_tq_plain,
        "flash.flash_attention_tq": flash.flash_attention_tq_plain,
        "flash.flash_attention_qkv": lambda qkv, num_heads, scale: flash.flash_qkv_plain(qkv, num_heads, scale)[0],
    }[name]


def _residual(inst: Instance, args: tuple, kwargs: dict) -> Optional[torch.Tensor]:
    """The residual term of a sub-layer's output (C, D: x; B with
    residual=True: x plus its addend), else None."""
    from posetraj_torch.ops import mlp

    if inst.name in ("qkvt.attn_sublayer", "temporal.temporal_attn_sublayer"):
        return args[0]
    if inst.name == "mlp.geglu_mlp":
        names = ("x", "w1", "b1", "w2", "b2", "ln_w", "ln_b", "eps", "residual", "add")
        bound = dict(zip(names, args), **kwargs)
        if not bound.get("residual", False):
            return None
        add = bound.get("add")
        return mlp.broadcast_add_rows(bound["x"], add) if add is not None else bound["x"]
    return None


def _materialize(v, gen: torch.Generator, device):
    """Seeded operands: a floating tensor N(0, 0.1^2) at its recorded
    shape, strides and offset (a buffer of the extent it spans), integer
    tensors zero; other arguments as recorded."""
    if not isinstance(v, TensorSpec):
        return v
    extent = v.offset + 1 + sum((n - 1) * s for n, s in zip(v.shape, v.stride)) if all(v.shape) else 0
    if v.dtype.is_floating_point:
        base = (torch.randn(extent, generator=gen, device=device) * 0.1).to(v.dtype)
    else:
        base = torch.zeros(extent, device=device, dtype=v.dtype)
    return base.as_strided(v.shape, v.stride, v.offset)


def compare(got: torch.Tensor, want: torch.Tensor, tol: float, base=None, rms_tol=None):
    """Kernel output `got` against the plain output `want`: (max abs error,
    the reference's max, the error's RMS relative to the reference's, ok).
    ok: the max abs error within `tol` times the reference's max and the
    relative RMS within `rms_tol`. With `base` (a sub-layer's residual term)
    the reference is the branch want - base, not the whole output, so a
    residual larger than the branch cannot hide a wrong branch."""
    want = want.float()
    ref = want - base.float() if base is not None else want
    diff = got.float() - want
    err, scale = float(diff.abs().max()), float(ref.abs().max())
    rel_rms = float(diff.norm() / ref.norm()) if float(ref.norm()) > 0 else float(diff.norm())
    ok = math.isfinite(err) and err <= tol * scale and (rms_tol is None or rel_rms <= rms_tol)
    return err, scale, rel_rms, ok


def replay(inst: Instance, fn: Callable, gen: torch.Generator, device) -> Outcome:
    """One instance's Outcome: its wrapper on seeded operands, held against
    the plain version; an exception, a non-finite output or an error beyond
    TOLERANCES is a FAIL."""
    try:
        with torch.inference_mode():
            args = tuple(_materialize(a, gen, device) for a in inst.args)
            kwargs = {k: _materialize(v, gen, device) for k, v in inst.kwargs.items()}
            out = fn(*args, **kwargs)
            want = _plain(inst.name)(*args, **kwargs)
            tol, rms_tol = TOLERANCES[inst.name]
            if inst.name == "layernorm.layer_norm" and args[0].dtype == torch.float32:
                tol, rms_tol = FLOAT32_LAYERNORM_TOLERANCE
            if not bool(torch.isfinite(out).all()):
                return Outcome("FAIL", note="non-finite output")
            err, scale, rel_rms, ok = compare(out, want, tol, _residual(inst, args, kwargs), rms_tol)
        return Outcome("OK" if ok else "FAIL", err, scale, tol, rel_rms)
    except Exception as e:  # a build, launch or runtime failure is a FAIL
        return Outcome("FAIL", note=f"{type(e).__name__}: {str(e)[:500]}")


def replay_records(records: Dict[str, Instance], device, cached_ok=frozenset(), deadline_s: Optional[float] = None,
                   t0: Optional[float] = None, verbose: bool = True) -> SweepResult:
    """Replay every recorded instance in key order on `device`, one at a
    time: CACHED where its key is in `cached_ok`, SHED once `deadline_s`
    seconds have passed since `t0` (default: now), else replay()'s OK or
    FAIL. Operands come from one device generator seeded with 0."""
    t0 = time.perf_counter() if t0 is None else t0
    fns = {_short(m, a): getattr(importlib.import_module(m), a) for m, a in TARGETS}
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    result = SweepResult()
    for k, inst in sorted(records.items()):
        if k in cached_ok:
            out = Outcome("CACHED", note="passed before on this card at this code hash")
        elif deadline_s is not None and time.perf_counter() - t0 > deadline_s:
            out = Outcome("SHED", note=f"{deadline_s:g} s deadline")
        else:
            out = replay(inst, fns[inst.name], gen, device)
        result.instances.append((k, out))
        if verbose:
            print(f"[kernel-sweep] {out.status:6s} {k}  {out.detail}", flush=True)
    return result


def run_sweep(resolutions=((576, 1024), (320, 576)), kernels=None, device=None, deadline_s: Optional[float] = None,
              verbose: bool = True, cache: bool = True) -> SweepResult:
    """Record (record_instances), then replay every instance on `device`
    (the card unless "cpu"; on the CPU each wrapper is its plain version,
    so only the sweep's logic is exercised). With `cache`, on the card,
    instances in the skip-cache under cache_key(device) are reported CACHED
    and not replayed, and the ones that pass are added to it; on the CPU
    the cache is neither read nor written. Those still pending `deadline_s`
    seconds after the call began are SHED. Raises RuntimeError listing
    every FAIL."""
    from posetraj_torch.core.init import resolve_device

    t0 = time.perf_counter()
    device = resolve_device(device)
    key = cache_key(device) if cache else None
    cached_ok = _load_cache(key) if key else set()
    records = record_instances(resolutions, kernels, device=device)
    result = replay_records(records, device, cached_ok, deadline_s, t0, verbose)
    ok_now = {k for k, o in result.instances if o.status == "OK"}
    if key and ok_now - cached_ok:
        _save_cache(key, cached_ok | ok_now)
    if result.failures:
        lines = "\n".join(f"  {k}: {d}" for k, d in result.failures)
        raise RuntimeError(f"kernel sweep: {len(result.failures)} kernel instance(s) failed:\n{lines}")
    if verbose:
        n = {s: sum(o.status == s for _, o in result.instances) for s in ("OK", "CACHED", "SHED")}
        print(f"[kernel-sweep] {len(result.instances)} instances on {device}: {n['OK']} OK, {n['CACHED']} cached, "
              f"{n['SHED']} shed; by kernel {result.counts()}", flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolutions", default="576x1024,320x576", help="comma-separated HxW")
    ap.add_argument("--unfused", action="store_true",
                    help="KernelConfig(qkvt_attn=False, temporal_attn=False, fused_ff_ln=False, fused_ln=True)")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--deadline", type=float, default=None)
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args()
    from posetraj_torch.configs import KernelConfig

    res = tuple(tuple(int(n) for n in r.split("x")) for r in a.resolutions.split(","))
    cfg = KernelConfig(qkvt_attn=False, temporal_attn=False, fused_ff_ln=False, fused_ln=True) if a.unfused else None
    run_sweep(res, cfg, device=a.device, deadline_s=a.deadline, cache=not a.no_cache)
