"""The work a cell asks for, counted by the benchmark from shapes, whatever
implements it: the model's operations (torch.utils.flop_counter over the
float32 reference on `meta` tensors) and the least time of two kernels'
work on one H100 (operations at the bf16 peak or bytes at HBM bandwidth,
the larger).

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 3.35 TB/s
HBM3 (at the card's full 700 W).
"""

from __future__ import annotations

import functools
import json

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def least_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time of the work on the chip: operations at the peak or
    bytes at the bandwidth, the larger."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def geglu_ff(rows: int, c: int) -> tuple:
    """(operations, bytes) of a GEGLU feed-forward y = x + W2 (h * gelu(g)),
    [h | g] = W1 LN(x): W1 (8c, c), W2 (c, 4c), bf16. Bytes: x read once,
    y written once, the weights once."""
    flops = 2 * rows * c * 8 * c + 2 * rows * 4 * c * c
    return flops, BF16 * (2 * rows * c + 12 * c * c)


def attention_core(batch: int, heads: int, sq: int, sk: int, hd: int) -> tuple:
    """(operations, bytes) of softmax(Q K^T) V: two products, Q, K, V read
    once and O written once, bf16."""
    return 4 * batch * heads * sq * sk * hd, BF16 * batch * heads * hd * (2 * sq + 2 * sk)


def transformers_per_level(ucfg: dict) -> list:
    """Spatio-temporal transformers at each UNet level in one denoise step
    (ControlNet and UNet): down blocks' layers and the up blocks' layers + 1
    at the cross-attention levels, and the two mid blocks at the deepest."""
    n = len(ucfg["block_out_channels"])
    per = ucfg["transformer_layers_per_block"]
    counts = [0] * n
    for i, cross in enumerate(ucfg["cross_attention_levels"]):
        if cross:
            counts[i] += per * (2 * ucfg["layers_per_block"] + ucfg["layers_per_block"] + 1)
    counts[-1] += 2 * per
    return counts


def _levels(cfg: dict, traffic: dict):
    """(tokens, channels, transformers) of each level of the denoise step."""
    u = cfg["unet"]
    h, w = traffic["height"] // 8, traffic["width"] // 8
    for lvl, (c, n) in enumerate(zip(u["block_out_channels"], transformers_per_level(u))):
        yield (h >> lvl) * (w >> lvl), c, n


def step_least_s(cfg: dict, traffic: dict, kernel: str) -> float:
    """Least seconds of one denoise step's `kernel` work ("mlp": every GEGLU
    feed-forward, three a transformer; "attn": every spatial self-attention
    core), over the CFG batch of two videos."""
    rows_per_token = 2 * traffic["frames"]
    total = 0.0
    for s, c, n in _levels(cfg, traffic):
        if kernel == "mlp":
            total += 3 * n * least_s(*geglu_ff(rows_per_token * s, c))
        else:
            total += n * least_s(*attention_core(rows_per_token, c // 64, s, s, 64))
    return total


@functools.lru_cache(maxsize=None)
def _video_flops(cfg_json: str, traffic_json: str) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import model as ref

    cfg, traffic = json.loads(cfg_json), json.loads(traffic_json)
    params = meta_params(cfg)
    h, w, f = traffic["height"], traffic["width"], traffic["frames"]
    meta = lambda *shape: torch.empty(shape, device="meta")
    counts = []
    for steps in (1, 2):
        with FlopCounterMode(display=False) as fc:
            ref.sample_video(ref.Ops(), params, cfg, dict(traffic, steps=steps), meta(1, h, w, 3),
                             meta(1, f, h, w, 3), meta(1, f, h // 8, w // 8, 4), meta(1, h, w, 3))
        counts.append(fc.get_total_flops())
    step = counts[1] - counts[0]
    return float(counts[0] + (traffic["steps"] - 1) * step)


def video_flops(cfg: dict, traffic: dict) -> float:
    """Operations of one video: CLIP, the VAE encode, the hint, every denoise
    step (ControlNet and UNet on the CFG batch) and the chunked decode."""
    return _video_flops(json.dumps(cfg, sort_keys=True), json.dumps(traffic, sort_keys=True))


@functools.lru_cache(maxsize=None)
def _train_flops(cfg_json: str, traffic_json: str) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import model as ref
    from benchmark.reference.tree import leaves, tree_map

    cfg, traffic = json.loads(cfg_json), json.loads(traffic_json)
    params = meta_params(cfg)
    cn = tree_map(lambda t: torch.empty_like(t, device="meta").float().requires_grad_(True), params["controlnet"])
    h, w, f = traffic["height"], traffic["width"], traffic["frames"]
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, device="meta", dtype=dt)
    batch = {"pixel_values": meta(1, f, h, w, 3), "trajectories": meta(1, f, h, w, 3),
             "bbox_trajectories": meta(1, f, h, w, 3), "motion_values": meta(1)}
    lat = (h // 8, w // 8, 4)
    draws = {"vae_eps": meta(f, *lat), "u_sigma": meta(1), "noise": meta(1, f, *lat), "drop_p": meta(1),
             "frame_idx": torch.zeros(1, dtype=torch.long, device="meta")}
    with FlopCounterMode(display=False) as fc:
        loss = ref.edm_loss(ref.Ops(), cn, params, cfg, cfg["train"], batch, draws)
        torch.autograd.grad(loss, list(leaves(cn)), allow_unused=True)
    return float(fc.get_total_flops())


def micro_step_flops(cfg: dict, traffic: dict) -> float:
    """Operations of one training micro-step: the frozen encodes, the loss
    (ControlNet, UNet on the clip, UNet on one frame) and its backward to
    the ControlNet, without the recompute of gradient checkpointing."""
    return _train_flops(json.dumps(cfg, sort_keys=True), json.dumps(traffic, sort_keys=True))


def meta_params(cfg: dict) -> dict:
    """The program's parameter tree on `meta`: shapes only."""
    import torch

    from benchmark import config
    from posetraj_torch.pipeline.svd_controlnet import init_params

    return init_params(config.bundle(cfg), device="meta", compute_dtype=getattr(torch, cfg["compute_dtype"]))



def roofline_share(run, kernel: str, key: str, counter: str, per_call: int):
    """A kernel's share of its roofline over the traced window, %: the least
    time of the work it was given (step_least_s, from the cell's shapes)
    over the device time of its kernels (torch.profiler, by name), or None
    without a trace. `key` is a substring of the kernels' names, `counter`
    the program's launch counter of its calls, each of `per_call` device
    kernels. Where the profiler dropped some of a long window's records
    (fewer kernels than calls times per_call), the device time seen is
    scaled up by the ratio."""
    t = run.trace_summary
    calls = run.launches.get(counter, 0)
    if t is None or not run.units or not calls:
        return None
    device_s, seen = t.device_s(key)
    if not seen:
        return None
    device_s *= max(1.0, per_call * calls / seen)
    least = step_least_s(run.cfg, run.traffic, kernel) * run.traffic["steps"] * run.units
    return 100.0 * least / device_s
