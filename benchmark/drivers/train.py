"""Training cells: whole accumulation windows of Trainer.step.

Set-up makes the weights on the card from the seed, builds one Trainer
(float32 masters of the ControlNet, AdamW, EMA; its draws seeded from the
run's seed) and a pool of distinct micro-batches made from the seed, and
drives the trainer through `check_windows` optimizer steps on the pool's
first batches through the window's own call: the first micro-step builds
the kernels and captures the micro-step graph; the others replay it, as
the window does. From those steps it keeps what the comparison needs:
each micro-step's loss and VAE-encoded latents (the output of the
trainer's _vae_encode_frames: on the card the captured graph's own
tensor, which each replay refills), each leaf's norm of the first
update's gradient (Adam's first moment after one step over 1 - beta1)
and, after the last, each leaf's norm of the masters' and the EMA's change.
The window then runs whole optimizer steps on the same trainer, cycling
through the pool, until --seconds have passed; s_per_opt_step is the
window's length over the steps finished in it.

Once the window has closed and the trainer is freed, the float32 reference
follows the same optimizer steps from the same weights, batches and draws
(the trainer's generator protocol, worked out again from the seed) and the
two are compared leaf by leaf.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from benchmark import config, inputs
from benchmark.harness import WINDOW_SPAN, Run, Spans, peak_bytes, synchronize, traced
from benchmark.reference import model as ref
from benchmark.reference.tree import leaves, tree_map
from benchmark.weights import Weights, sub_seed


def draw_seed(seed: int) -> int:
    return sub_seed(seed, "draws")


@torch.no_grad()
def _norms(tensors) -> np.ndarray:
    """Each tensor's norm, one leaf at a time (no copy of a whole tree)."""
    return np.array([float(torch.linalg.vector_norm(t.float())) for t in tensors])


class Program:
    """The trainer under test, its weights and its batches."""

    def __init__(self, run: Run):
        from posetraj_torch.pipeline.svd_controlnet import init_params
        from posetraj_torch.train import trainer as tm

        cfg, tr = run.cfg, run.traffic
        self.bundle = config.bundle(cfg)
        self.dtype = getattr(torch, cfg["compute_dtype"])
        run.phase("imports")
        template = init_params(self.bundle, device="meta", compute_dtype=self.dtype)
        template["vae"] = {"encoder": template["vae"]["encoder"]}  # the step never decodes
        self.weights = Weights(template, run.seed, run.device)
        w = self.weights.tree
        self.trainer = tm.Trainer(self.bundle, config.train_config(cfg, draw_seed(run.seed)),
                                  {k: w[k] for k in ("unet", "vae", "clip")}, w["controlnet"], device=run.device,
                                  compute_dtype=self.dtype)
        self.accum = cfg["train"]["gradient_accumulation_steps"]
        run.phase("weights, trainer")
        self.batches = [inputs.train_batch(run.seed, i, tr, run.device) for i in range(tr["pool"])]
        run.phase("batches")
        self.spans = Spans()
        self.spans.wrap(tm, "sync_step", "sync")
        self._encodes = []
        self.spans.wrap(tm, "_vae_encode_frames", "vae_encode", on_return=self._encodes.append)
        self.steps = 0

    def micro_step(self) -> dict:
        out = self.trainer.step(self.batches[self.steps % len(self.batches)])
        self.steps += 1
        return out

    def checked_micro_step(self, encoded: list) -> dict:
        """A micro-step; its encoded latents appended to `encoded`. A call
        that encodes (the eager first step, then its capture; every step
        off the card) gives its first output; a replay, the captured
        graph's output, kept alive so that the replay refills it."""
        n = len(self._encodes)
        out = self.micro_step()
        encoded.append((self._encodes[n] if len(self._encodes) > n else self._encodes[-1]).clone())
        del self._encodes[:-1]
        return out

    def first_steps(self, windows: int) -> dict:
        """The set-up's optimizer steps, and what the comparison reads of them."""
        st = self.trainer.state
        w0 = list(leaves(self.weights.tree["controlnet"]))
        losses, encoded, grad = [], [], None
        for i in range(windows):
            losses += [self.checked_micro_step(encoded)["loss"] for _ in range(self.accum)]
            if i == 0:
                beta1 = st.optimizer.param_groups[0]["betas"][0]
                moments = [st.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p)) for p in st.masters()]
                grad = _norms(moments) / (1.0 - beta1)
        update = _norms(m - w.float() for m, w in zip(st.masters(), w0))
        ema = _norms(e - w.float() for e, w in zip(leaves(st.ema_params), w0))
        return {"loss": np.array([float(x) for x in losses]), "grad": grad, "update": update, "ema": ema,
                "encode": encoded}

    def free(self) -> None:
        self.spans.restore()
        self.trainer = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def ema_decay(step: int, max_decay: float) -> float:
    """diffusers EMAModel's decay at optimizer step `step` (from 1), no warmup: 0 first."""
    s = step - 1
    return 0.0 if s <= 0 else min((1.0 + s) / (10.0 + s), max_decay)


def reference(run: Run, weights: Weights, windows: int, batches, fp8: bool = False, half: bool = False) -> dict:
    """The reference trainer (or the control, or a planted fault) over
    `windows` optimizer steps: mean of the micro-gradients, clipped by the
    global norm, AdamW with linear warmup from 0, the EMA. half: the
    fault "half of the batch left out": each step's gradient is the mean
    over its first micro-step alone."""
    ref.full_float32()
    cfg, t = run.cfg, run.cfg["train"]
    accum = t["gradient_accumulation_steps"]
    tree = weights.tree
    cn = tree_map(lambda x: x.detach().float().clone().requires_grad_(True), tree["controlnet"])
    params = list(leaves(cn))
    opt = torch.optim.AdamW(params, lr=t["learning_rate"], betas=(t["adam_beta1"], t["adam_beta2"]),
                            eps=t["adam_epsilon"], weight_decay=t["adam_weight_decay"])
    warm = t["lr_warmup_steps"]
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda n: min(1.0, n / warm) if warm > 0 else 1.0)
    ema = [p.detach().clone() for p in params]
    gen = torch.Generator(device=run.device)
    gen.manual_seed(draw_seed(run.seed))
    tr = run.traffic
    latent = (tr["height"] // 8, tr["width"] // 8, cfg["vae"]["latent_channels"])
    ops = ref.Ops(fp8=fp8, remat=True)
    losses, encoded, grad = [], [], None
    for w in range(windows):
        acc = [torch.zeros_like(p) for p in params]
        used = 0
        for j in range(accum):
            draws = ref.draw_step(gen, 1, tr["frames"], latent, run.device)
            keep = {}
            loss = ref.edm_loss(ops, cn, tree, cfg, t, batches[w * accum + j], draws, keep=keep)
            losses.append(float(loss.detach()))
            encoded.append(keep["encode"])
            if half and j > 0:
                continue
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            torch._foreach_add_(acc, [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])
            used += 1
        for p, a in zip(params, acc):
            p.grad = a / used
        torch.nn.utils.clip_grad_norm_(params, t["max_grad_norm"])
        if w == 0:
            grad = _norms([p.grad for p in params])
        opt.step()
        sched.step()
        opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            d = ema_decay(w + 1, t["ema_decay"])
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - d)
    w0 = list(leaves(tree["controlnet"]))
    update = _norms(p.detach() - w.float() for p, w in zip(params, w0))
    ema_change = _norms(e - w.float() for e, w in zip(ema, w0))
    size = np.array([w.numel() for w in w0])
    return {"loss": np.array(losses), "grad": grad, "update": update, "ema": ema_change,
            "rms0": _norms(w0) / np.sqrt(size), "size": size, "encode": encoded}


@torch.no_grad()
def encode_reference(run: Run, weights: Weights, windows: int, batches, lower: str = "") -> list:
    """The reference's encoded latents of the checked micro-steps alone,
    with the trainer's draws: float32, or the VAE encoder one step below it
    (lower "tf32" or "bf16": a control)."""
    ref.full_float32()
    tr = run.traffic
    latent = (tr["height"] // 8, tr["width"] // 8, run.cfg["vae"]["latent_channels"])
    gen = torch.Generator(device=run.device)
    gen.manual_seed(draw_seed(run.seed))
    ops = ref.Ops(bf16=lower == "bf16")
    out = []
    for i in range(windows * run.cfg["train"]["gradient_accumulation_steps"]):
        draws = ref.draw_step(gen, 1, tr["frames"], latent, run.device)
        with ref.tf32() if lower == "tf32" else contextlib.nullcontext():
            out.append(ref.encode_frames(ops, weights.tree, run.cfg, batches[i]["pixel_values"], draws["vae_eps"]))
    return out


def encode_gap(got: list, want: list) -> float:
    """The worst micro-step's relative RMS error of the encoded latents."""
    return max(float((g.double() - w.double()).norm() / w.double().norm()) for g, w in zip(got, want))


def leaf_gap(got: np.ndarray, want: np.ndarray, keep=None) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    if keep is not None:
        got, want = got[keep], want[keep]
    if not want.size:
        return float("nan")  # nothing to compare: no sound run reads so
    return float(np.max(np.abs(got - want) / np.maximum(want, np.median(want))))


# float32's spacing relative to a value: one unit in the last place, about.
F32_ULP = 2.0**-23


def moved(want: dict) -> np.ndarray:
    """The leaves whose change the comparison reads: those the update moves
    beyond rounding. Out go leaves whose reference gradient is under a
    thousandth of the median leaf's (Adam moves them by round-off alone) and
    leaves whose reference change is under 100 float32 units in the last
    place of their starting values' RMS: warmed up from a learning rate of 0,
    the first steps move a norm's scale or a blend factor (values near 1) by
    a unit or two, so its float32 master moves by rounding as much as by the
    update, and the norm of that change is off by about a unit either way."""
    return ((want["grad"] >= 1e-3 * np.median(want["grad"]))
            & (want["update"] >= 100.0 * F32_ULP * want["rms0"]))


def scalar_gap(got: np.ndarray, want: np.ndarray, size: np.ndarray) -> float:
    """leaf_gap over the one-element leaves, against the median of all leaves."""
    one = size == 1
    if not one.any():
        return float("nan")
    return float(np.max((np.abs(got - want) / np.maximum(want, np.median(want)))[one]))


def readings(got: dict, want: dict) -> dict:
    """Each micro-step's loss (the worst relative gap) and encoded latents
    (the worst relative RMS error: the float32 VAE encode), the first
    update's gradient, and the masters' and EMA's change after the steps,
    by the worst leaf (the changes over the `moved` leaves). The gradient
    has two numbers: the leaves of more than one element, and the
    one-element leaves (the blend factors), each one sum over the whole
    clip of products that cancel, whose bf16 rounding no norm over other
    elements averages out, so that they read higher; the changes leave the
    blend factors out (`moved`), so the second number is what holds them."""
    keep = moved(want)
    return {"loss_rel": float(np.max(np.abs(got["loss"] - want["loss"]) / np.abs(want["loss"]))),
            "encode_rel_rms": encode_gap(got["encode"], want["encode"]),
            "grad_gap": leaf_gap(got["grad"], want["grad"], want["size"] > 1),
            "grad_gap_scalar": scalar_gap(got["grad"], want["grad"], want["size"]),
            "update_gap": leaf_gap(got["update"], want["update"], keep),
            "ema_gap": leaf_gap(got["ema"], want["ema"], keep)}


def run(r: Run) -> None:
    from posetraj_torch.ops import _native

    windows = r.traffic["check_windows"]
    prog = Program(r)
    first = prog.first_steps(windows)
    synchronize(r.device)
    r.phase("first optimizer steps (kernels built, graph captured)")
    r.setup_s = time.perf_counter() - r.t0
    before = dict(_native.LAUNCHES)
    prog.spans.active = r.trace
    steps = 0
    with traced(r.trace) as box:
        with torch.profiler.record_function(WINDOW_SPAN):
            t_start = time.perf_counter()
            while not steps or time.perf_counter() - t_start < r.seconds:
                for _ in range(prog.accum):
                    float(prog.micro_step()["loss"])  # the training loop's log line: one sync a micro-step
                steps += 1
            synchronize(r.device)
            r.window_s = time.perf_counter() - t_start
    prog.spans.active = False
    r.trace_summary = box[0] if box else None
    r.spans = prog.spans.totals()
    r.launches = {k: _native.LAUNCHES[k] - before[k] for k in before}
    r.units = r.attempted = steps
    r.end_to_end["s_per_opt_step"] = (r.window_s / steps, "s")
    r.memory_peak_bytes = peak_bytes(r.device)
    r.end_to_end["peak_mem_gib"] = (r.memory_peak_bytes / 2**30, "GiB")
    r.end_to_end["setup_s"] = (r.setup_s, "s")
    batches = prog.batches
    prog.free()
    want = reference(r, prog.weights, windows, batches)
    for name, value in readings(first, want).items():
        r.check(name, value)
