"""Video cells: one closed-loop client of SVDControlNetPipeline.__call__.

Set-up makes the weights on the card from the seed, builds one pipeline
instance (kept across requests, as a server keeps it), makes a pool of
requests from the seed (images and control videos on the host, as a client
sends them; the noises on the card, handed in through `noises=`) and runs
one request, which builds the kernels and captures the denoise graph. The
window then sends the pool's requests in turn, each when the last returns,
until --seconds have passed; s_per_video is the window's length over the
whole videos finished in it.

The final latents of every request are kept (a wrapper around the
pipeline's decode_latents clones its input), and so is its conditioning
latents (the output of encode_image_vae, the float32 VAE encode). Once the
window has closed and the pipeline is freed, one finished request drawn
from the seed is run again by the float32 reference from the same inputs:
its conditioning latents, final latents and frames are compared with the
program's.
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
from benchmark.weights import Weights, sub_seed


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


class Program:
    """The system under test and the requests it serves."""

    def __init__(self, run: Run):
        from posetraj_torch.pipeline import svd_controlnet as sc

        cfg, tr = run.cfg, run.traffic
        self.bundle = config.bundle(cfg)
        self.dtype = getattr(torch, cfg["compute_dtype"])
        run.phase("imports")
        self.weights = Weights(sc.init_params(self.bundle, device="meta", compute_dtype=self.dtype), run.seed,
                               run.device)
        self.pipe = sc.SVDControlNetPipeline(self.weights.tree, self.bundle, device=run.device,
                                             compute_dtype=self.dtype)
        self.traffic = tr
        self.requests = [inputs.video_request(run.seed, i, tr) for i in range(tr["pool"])]
        self.noises = [inputs.video_noises(run.seed, i, tr, cfg["vae"]["latent_channels"], 8, run.device)
                       for i in range(tr["pool"])]
        self.latents = []
        self.encodes = []  # encode_image_vae's outputs (zeros, then the image's latents), one a request
        self.spans = Spans()
        self.spans.wrap(sc, "encode_image_clip", "clip")
        self.spans.wrap(sc, "encode_image_vae", "vae_encode", on_return=self.encodes.append)
        self.spans.wrap(sc, "denoise", "denoise")
        self.spans.wrap(sc, "decode_latents", "decode", on_call=lambda a, k: self.latents.append(a[2].clone()))

    def request(self, i: int) -> np.ndarray:
        tr, req = self.traffic, self.requests[i % len(self.requests)]
        return self.pipe(req["image"], req["control"], height=tr["height"], width=tr["width"],
                         num_frames=tr["frames"], num_inference_steps=tr["steps"],
                         min_guidance_scale=tr["min_guidance"], max_guidance_scale=tr["max_guidance"],
                         decode_chunk_size=tr["decode_chunk"], noises=self.noises[i % len(self.noises)])

    def free(self) -> None:
        """Drop the pipeline and its graph; the weights and inputs stay for the reference."""
        self.spans.restore()
        self.pipe = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def reference(run: Run, prog: Program, i: int, fp8: bool = False):
    """The float32 reference (or the fp8 control) on request i: (frames,
    final latents, conditioning latents)."""
    ref.full_float32()
    req, nz = prog.requests[i % len(prog.requests)], prog.noises[i % len(prog.noises)]
    dev = run.device
    keep = {}
    frames, latents = ref.sample_video(ref.Ops(fp8=fp8), prog.weights.tree, run.cfg, run.traffic,
                                       torch.from_numpy(req["image"]).to(dev), torch.from_numpy(req["control"]).to(dev),
                                       nz["latents"], nz["image_aug"], keep=keep)
    return frames, latents, keep["encode"]


def encode_reference(run: Run, prog: Program, i: int, lower: str = "") -> torch.Tensor:
    """The reference's conditioning latents of request i alone: float32, or
    the VAE encoder one step below it (lower "tf32" or "bf16": a control)."""
    ref.full_float32()
    req, nz = prog.requests[i % len(prog.requests)], prog.noises[i % len(prog.noises)]
    image = torch.from_numpy(req["image"]).to(run.device)
    with ref.tf32() if lower == "tf32" else contextlib.nullcontext(), torch.no_grad():
        return ref.encode_image(ref.Ops(bf16=lower == "bf16"), prog.weights.tree, run.cfg, image, nz["image_aug"])


def readings(frames: np.ndarray, latents: torch.Tensor, encoded: torch.Tensor, want_frames: torch.Tensor,
             want_latents: torch.Tensor, want_encoded: torch.Tensor):
    """The numbers compared, each a relative RMS error: the conditioning
    latents (the VAE encode), the final latents and the frames (on [-1, 1])."""
    got = torch.from_numpy(np.asarray(frames)).to(want_frames.device)
    return {"encode_rel_rms": rel_rms(encoded, want_encoded),
            "latents_rel_rms": rel_rms(latents, want_latents),
            "frames_rel_rms": rel_rms(got * 2.0 - 1.0, want_frames * 2.0 - 1.0)}


def run(r: Run) -> None:
    from posetraj_torch.ops import _native

    prog = Program(r)
    r.phase("weights, pipeline, requests")
    prog.request(0)
    synchronize(r.device)
    r.phase("first request (kernels built, graph captured)")
    r.setup_s = time.perf_counter() - r.t0
    prog.latents.clear()
    prog.encodes.clear()
    outputs = []
    before = dict(_native.LAUNCHES)
    prog.spans.active = r.trace
    with traced(r.trace) as box:
        with torch.profiler.record_function(WINDOW_SPAN):
            t_start = time.perf_counter()
            while not outputs or time.perf_counter() - t_start < r.seconds:
                outputs.append(prog.request(len(outputs)))
            r.window_s = time.perf_counter() - t_start
    prog.spans.active = False
    r.trace_summary = box[0] if box else None
    r.spans = prog.spans.totals()
    r.launches = {k: _native.LAUNCHES[k] - before[k] for k in before}
    r.units = r.attempted = len(outputs)
    r.end_to_end["s_per_video"] = (r.window_s / r.units, "s")
    r.memory_peak_bytes = peak_bytes(r.device)
    r.end_to_end["peak_mem_gib"] = (r.memory_peak_bytes / 2**30, "GiB")
    r.end_to_end["setup_s"] = (r.setup_s, "s")
    k = int(np.random.default_rng(sub_seed(r.seed, "sample")).integers(len(outputs)))
    latents, encoded = prog.latents[k], prog.encodes[k][1:]
    prog.free()
    for name, value in readings(outputs[k], latents, encoded, *reference(r, prog, k)).items():
        r.check(name, value)
