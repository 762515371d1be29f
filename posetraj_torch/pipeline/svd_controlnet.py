"""End-to-end trajectory-conditioned img2vid sampling (the reference's
StableVideoDiffusionPipelineControlNet): CLIP image embedding, float32 VAE
encode, the hint encoder once, Euler-Karras steps of ControlNet -> UNet on a
CFG-doubled batch, and a chunked VAE decode. On a CUDA device the steps
replay one captured CUDA graph (DenoiseGraph), the counterpart of the JAX
package's lax.scan; on the CPU they run as a Python loop.

Quirks preserved: Q2 per-frame guidance linspace(min -> max, num_frames);
Q3 added_time_ids hard-coded to (fps=6, motion=128, aug=0.02); Q8 the
antialias-resized [0, 1] image goes to CLIP without mean/std normalisation.
All Gaussian draws can be injected through `noises=` for parity tests.

Entry points run on `cuda` unless the caller passes `device="cpu"`. The
compute dtype is an argument: by default bf16 on the card and float32 on the
CPU, as the JAX package picks by backend. `generate()` runs under the
bundle's KernelConfig (`ModelBundle.kernels`; None takes the POSETRAJ_*
variables, read when the call starts). While a torch profiler records, the
request's stages and the graph's load and replays are spans and counters of
utils/profiling.py (request_span, the posetraj/* names).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from posetraj_torch.configs import (
    CLIPVisionConfig,
    ControlNetConfig,
    HintEncoderConfig,
    KernelConfig,
    PipelineConfig,
    SchedulerConfig,
    UNetConfig,
    VAEConfig,
    use_kernels,
)
from posetraj_torch.core.init import default_compute_dtype, make_init, resolve_device
from posetraj_torch.core.params import flatten_dict, leaves, tree_map
from posetraj_torch.diffusion.euler_karras import euler_step, make_schedule
from posetraj_torch.models import clip as clip_m
from posetraj_torch.models import controlnet as cn
from posetraj_torch.models import unet as unet_m
from posetraj_torch.models import vae as vae_m
from posetraj_torch.ops.primitives import set_float32_precision
from posetraj_torch.ops.resize import resize_antialias
from posetraj_torch.utils.profiling import TIMER, count, span


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """Model configs for one pipeline instance."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    controlnet: ControlNetConfig = dataclasses.field(default_factory=ControlNetConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    clip: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    fidelity_clip_unnormalized: bool = True  # Q8
    # Kernel dispatch switches for every call made under this bundle;
    # None = the POSETRAJ_* variables (KernelConfig.from_env).
    kernels: Optional[KernelConfig] = None

    @classmethod
    def tiny(cls, variant: str = "base") -> "ModelBundle":
        return cls(unet=UNetConfig.tiny(), controlnet=ControlNetConfig.tiny(variant), vae=VAEConfig.tiny(),
                   clip=CLIPVisionConfig.tiny())

    @classmethod
    def with_variant(cls, variant: str = "base") -> "ModelBundle":
        """Flagship configs with the hint encoder's `variant` (bbox, cam,
        rot, entity, temp)."""
        return cls(controlnet=ControlNetConfig(hint=HintEncoderConfig(variant=variant)))


def resolve_kernels(bundle: ModelBundle) -> ModelBundle:
    """The bundle with its KernelConfig pinned: None becomes
    KernelConfig.from_env() read now; an explicit config passes through."""
    if bundle.kernels is None:
        return dataclasses.replace(bundle, kernels=KernelConfig.from_env())
    return bundle


def init_params(bundle: ModelBundle, seed: int = 0, device=None, compute_dtype=None) -> Dict:
    """Random parameters for every model of the bundle, made on the device
    from `seed`: torch-default fan-in uniform weights, zero ControlNet heads,
    the ControlNet's encoder copied from the UNet (ControlNetSDVModel.from_unet).
    The VAE encoder is float32; everything else the compute dtype."""
    device = resolve_device(device)
    dt = compute_dtype or default_compute_dtype(device)
    ini = make_init(seed, device, dt)
    unet = unet_m.init_unet(ini, bundle.unet)
    controlnet = cn.controlnet_from_unet(cn.init_controlnet(ini, bundle.controlnet), unet)
    return {
        "unet": unet,
        "controlnet": controlnet,
        "vae": vae_m.init_vae(make_init(seed + 1, device, torch.float32), ini, bundle.vae),
        "clip": clip_m.init_clip_vision(ini, bundle.clip),
    }


def encode_image_clip(params: Dict, bundle: ModelBundle, image: torch.Tensor, compute_dtype) -> torch.Tensor:
    """[0, 1] RGB (B, H, W, 3) -> CFG-stacked CLIP embeddings (2B, 1, D):
    zeros (uncond) first, then cond."""
    resized = resize_antialias(image.float(), (bundle.clip.image_size, bundle.clip.image_size))
    if not bundle.fidelity_clip_unnormalized:
        resized = clip_m.clip_preprocess(resized, bundle.clip)
    emb = clip_m.clip_image_embeds(params["clip"], bundle.clip, resized, compute_dtype)
    emb = emb[:, None, :].to(compute_dtype)
    return torch.cat([torch.zeros_like(emb), emb], dim=0)


def encode_image_vae(params: Dict, bundle: ModelBundle, image: torch.Tensor, noise: torch.Tensor,
                     noise_aug_strength: float) -> torch.Tensor:
    """[-1, 1] image (B, H, W, 3) + noise-aug -> CFG-stacked cond latents
    (2B, h, w, 4): zeros first, then the .mode() latents, float32 encode."""
    mean, _ = vae_m.encode(params["vae"]["encoder"], bundle.vae, image + noise_aug_strength * noise,
                           compute_dtype=torch.float32)
    return torch.cat([torch.zeros_like(mean), mean], dim=0)


def added_time_ids_inference(pcfg: PipelineConfig) -> np.ndarray:
    """(1, 3) in the inference order [fps, motion_bucket, noise_aug] (Q3)."""
    if pcfg.fidelity_time_ids_override:
        return np.asarray([[6.0, 128.0, 0.02]], np.float32)
    return np.asarray([[pcfg.fps - 1, pcfg.motion_bucket_id, pcfg.noise_aug_strength]], np.float32)


def denoise(params: Dict, bundle: ModelBundle, pcfg: PipelineConfig, latents: torch.Tensor,
            image_latents: torch.Tensor, clip_embeddings: torch.Tensor, control_video: torch.Tensor,
            added_time_ids: torch.Tensor, sigmas: torch.Tensor, timesteps: torch.Tensor,
            guidance_scale: torch.Tensor, compute_dtype, camera_cond: Optional[torch.Tensor] = None,
            bbox_cond: Optional[torch.Tensor] = None, rot_id: Optional[torch.Tensor] = None,
            graph: Optional["DenoiseGraph"] = None) -> torch.Tensor:
    """The sampling loop, the counterpart of the JAX package's denoise_scan.
    latents (B, F, h, w, 4) float32; image_latents (2B, h, w, 4);
    control_video (2B, F, H, W, 3) in [-1, 1]; guidance_scale (F,);
    camera_cond, bbox_cond, rot_id: the hint variant's conditions, already
    doubled for CFG. On a CUDA device the steps replay one captured CUDA
    graph (DenoiseGraph): `graph` keeps it for later calls; without one, the
    module's own graph serves, kept for the next call of the same key as jit
    keeps a compiled program. On the CPU the steps run as the plain Python
    loop, `denoise_eager`."""
    if not latents.is_cuda:
        return denoise_eager(params, bundle, pcfg, latents, image_latents, clip_embeddings, control_video,
                             added_time_ids, sigmas, timesteps, guidance_scale, compute_dtype, camera_cond,
                             bbox_cond, rot_id)
    with span("posetraj/hint", device=latents.device):
        hint = _hint(params, bundle, control_video, latents.shape[1], compute_dtype, camera_cond, bbox_cond, rot_id)
    img_lat = _image_latents(image_latents, latents, compute_dtype)
    global _SHARED_GRAPH
    if graph is None:
        graph = _SHARED_GRAPH = _SHARED_GRAPH or DenoiseGraph()
    return graph.run(params, bundle, pcfg, latents, img_lat, clip_embeddings, added_time_ids, hint,
                     _guidance(guidance_scale), sigmas, timesteps, compute_dtype)


def denoise_eager(params: Dict, bundle: ModelBundle, pcfg: PipelineConfig, latents: torch.Tensor,
                  image_latents: torch.Tensor, clip_embeddings: torch.Tensor, control_video: torch.Tensor,
                  added_time_ids: torch.Tensor, sigmas: torch.Tensor, timesteps: torch.Tensor,
                  guidance_scale: torch.Tensor, compute_dtype, camera_cond: Optional[torch.Tensor] = None,
                  bbox_cond: Optional[torch.Tensor] = None, rot_id: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sampling loop as a plain Python loop over the sigma ladder, every
    op issued from the host: the CPU's path, and on the card the reference
    the captured graph is held against. Arguments as denoise's."""
    with span("posetraj/hint", device=latents.device):
        hint = _hint(params, bundle, control_video, latents.shape[1], compute_dtype, camera_cond, bbox_cond, rot_id)
    img_lat = _image_latents(image_latents, latents, compute_dtype)
    gs = _guidance(guidance_scale)
    lat = latents.float()
    count("denoise.eager_steps", timesteps.shape[0])
    for i in range(timesteps.shape[0]):
        lat = _denoise_step(params, bundle, pcfg, lat, img_lat, clip_embeddings, added_time_ids, hint, gs,
                            sigmas[i], sigmas[i + 1], timesteps[i], compute_dtype)
    return lat


def _hint(params, bundle, control_video, num_frames, dt, camera_cond, bbox_cond, rot_id) -> torch.Tensor:
    """The hint embedding: it depends only on the control video and the
    variant's conditions, so it is computed once a request."""
    return cn.hint_encoder(params["controlnet"]["controlnet_cond_embedding"], bundle.controlnet.hint,
                           control_video.to(dt), num_frames, camera_cond=camera_cond, bbox_cond=bbox_cond,
                           rot_id=rot_id, compute_dtype=dt)


def _image_latents(image_latents, latents, dt) -> torch.Tensor:
    return image_latents[:, None].expand(-1, latents.shape[1], -1, -1, -1).to(dt)


def _guidance(guidance_scale) -> torch.Tensor:
    return guidance_scale.reshape(1, -1, 1, 1, 1).float()


def _denoise_step(params, bundle, pcfg, lat, img_lat, clip_embeddings, added_time_ids, hint, gs, sigma, sigma_next,
                  t, dt) -> torch.Tensor:
    """One step of the loop: the scaled CFG input, ControlNet -> UNet, the
    per-frame guidance, the Euler update. Returns the float32 latents."""
    b = lat.shape[0]
    lat_in = (torch.cat([lat, lat], dim=0) / torch.sqrt(sigma**2 + 1.0)).to(dt)
    lat_in = torch.cat([lat_in, img_lat], dim=-1)
    down_res, mid_res = cn.controlnet_forward(
        params["controlnet"], bundle.controlnet, lat_in, t, clip_embeddings, added_time_ids,
        conditioning_scale=pcfg.controlnet_cond_scale, compute_dtype=dt, hint_embedding=hint,
    )
    noise_pred = unet_m.unet_forward(params["unet"], bundle.unet, lat_in, t, clip_embeddings, added_time_ids,
                                     down_res, mid_res, compute_dtype=dt).float()
    uncond, cond = noise_pred[:b], noise_pred[b:]
    noise_pred = uncond + gs * (cond - uncond)
    lat, _ = euler_step(noise_pred, lat, sigma, sigma_next, bundle.scheduler.prediction_type)
    return lat.float()


_SHARED_GRAPH: Optional["DenoiseGraph"] = None  # denoise()'s graph for calls that pass none


class DenoiseGraph:
    """The denoise step captured once in a CUDA graph and replayed for every
    step, as the JAX package compiles its loop into one lax.scan.

    Everything the step reads lives in static buffers (`buffers`): the
    latents, which the step overwrites, the image latents, CLIP embedding,
    time ids, hint embedding, guidance, the sigma ladder and timesteps, and
    a device step index that the step advances itself, so that a replay
    needs no write from the host. The first call runs step 0 eagerly on the
    capture stream (it builds the kernel libraries, sets their shared-memory
    limits, makes kernel A's workspace and lets cuBLAS and cuDNN choose),
    then captures step 1 and replays it for the rest. The graph is kept for
    later calls with the same key: the very parameter tensors it captured
    (their addresses are baked into it; it holds them weakly, so a dropped
    model is freed and its graph never replays), the same shapes, bundle,
    KernelConfig, dtype and conditioning scale; another key captures anew.
    It holds kernel A's workspace as captured (groupnorm.workspaces). Launch
    counts stay device launches (_native.capturing_launches). A failed
    capture raises."""

    def __init__(self):
        self._key = None
        self._params = ()  # weak references to the parameter tensors of the key
        self._held = ()    # device memory outside the graph's pool that its launches use
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self.buffers: Dict[str, torch.Tensor] = {}
        self._per_replay: Dict[str, int] = {}  # launches of one replay, by counter
        self.capture_s = 0.0  # host seconds of the last capture and instantiation

    def load(self, params, bundle, pcfg, dt, **inputs: torch.Tensor) -> bool:
        """Copy one call's inputs (latents, image_latents, clip, time_ids,
        hint, guidance, sigmas, timesteps) into the static buffers and set
        the step index to 0. Another key makes the buffers anew and drops
        the graph. Returns whether a captured graph can serve the call."""
        from posetraj_torch.configs import kernel_config

        tensors = list(leaves({k: params[k] for k in ("unet", "controlnet")}))
        key = (tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors), bundle, kernel_config(), dt,
               pcfg.controlnet_cond_scale, tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
        same = key == self._key and all(ref() is t for ref, t in zip(self._params, tensors))
        if not same:
            self._key, self._params, self._graph, self._per_replay = key, [weakref.ref(t) for t in tensors], None, {}
            self.buffers = {k: v.clone() for k, v in inputs.items()}
            self.buffers["step"] = torch.zeros(1, dtype=torch.long, device=inputs["latents"].device)
        else:
            for k, v in inputs.items():
                self.buffers[k].copy_(v)
            self.buffers["step"].zero_()
        return self._graph is not None

    def run(self, params, bundle, pcfg, latents, img_lat, clip_embeddings, added_time_ids, hint, gs, sigmas,
            timesteps, dt) -> torch.Tensor:
        """The loop over the ladder's steps on a CUDA device; returns the
        final float32 latents."""
        from posetraj_torch.ops import _native, groupnorm

        n = timesteps.shape[0]
        if n == 0:
            return latents.float()
        with span("posetraj/denoise/load"):
            ready = self.load(params, bundle, pcfg, dt, latents=latents.float(), image_latents=img_lat,
                              clip=clip_embeddings, time_ids=added_time_ids, hint=hint, guidance=gs, sigmas=sigmas,
                              timesteps=timesteps)
        step = lambda: graph_step(params, bundle, pcfg, self.buffers, dt)
        done = 0
        if not ready:
            stream = torch.cuda.Stream(device=latents.device)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                step()
            torch.cuda.current_stream().wait_stream(stream)
            done = 1
            count("denoise.eager_steps")
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with _native.capturing_launches() as per_replay, torch.cuda.graph(graph, stream=stream):
                step()
            self.capture_s = time.perf_counter() - t0
            self._graph, self._per_replay, self._held = graph, per_replay, groupnorm.workspaces()
        with span("posetraj/denoise/replay", device=latents.device):
            for _ in range(done, n):
                self._graph.replay()
                _native.add_launches(self._per_replay)
        count("denoise.replays", n - done)
        return self.buffers["latents"].clone()


def graph_step(params, bundle, pcfg, buffers: Dict[str, torch.Tensor], dt) -> None:
    """The step DenoiseGraph captures, on its static buffers: reads
    sigmas[i], sigmas[i + 1] and timesteps[i] at the device step index i,
    writes the next latents in place and advances i. It runs eagerly as well
    (the first step of a capture, and the CPU tests)."""
    i = buffers["step"]
    sigma = buffers["sigmas"].index_select(0, i).reshape(())
    sigma_next = buffers["sigmas"].index_select(0, i + 1).reshape(())
    t = buffers["timesteps"].index_select(0, i).reshape(())
    lat = _denoise_step(params, bundle, pcfg, buffers["latents"], buffers["image_latents"], buffers["clip"],
                        buffers["time_ids"], buffers["hint"], buffers["guidance"], sigma, sigma_next, t, dt)
    buffers["latents"].copy_(lat)
    i.add_(1)


def decode_latents(params: Dict, bundle: ModelBundle, latents: torch.Tensor, decode_chunk_size: int,
                   compute_dtype) -> torch.Tensor:
    """(B, F, h, w, 4) -> (B, F, H, W, 3) float32 in [-1, 1]; frames decoded
    in chunks of `decode_chunk_size`, each chunk one video to the decoder."""
    b, f = latents.shape[:2]
    flat = latents.reshape(b * f, *latents.shape[2:]) / bundle.vae.scaling_factor
    outs = []
    for i in range(0, b * f, decode_chunk_size):
        chunk = flat[i : i + decode_chunk_size]
        outs.append(vae_m.decode(params["vae"]["decoder"], bundle.vae, chunk, chunk.shape[0], compute_dtype).float())
    frames = torch.cat(outs, dim=0)
    return frames.reshape(b, f, *frames.shape[1:])


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device=device, dtype=dtype)


@contextlib.contextmanager
def request_span():
    """The span `posetraj/request` and the count `requests` (while a torch
    profiler records) around a request: the pipeline's call, or generate()
    or generate_sharded() called alone; inside an open span, nothing."""
    if TIMER.depth:
        yield
        return
    with span("posetraj/request"):
        count("requests")
        yield


@torch.inference_mode()
@request_span()
def generate(params: Dict, bundle: ModelBundle, pcfg: PipelineConfig, image, control_video, noises: Dict,
             added_time_ids, sigmas, timesteps, num_frames: int, camera_cond=None, bbox_cond=None, rot_id=None,
             output_latent: bool = False, device=None, compute_dtype=None,
             graph: Optional["DenoiseGraph"] = None) -> torch.Tensor:
    """Full image -> video program.

    image (B, H, W, 3) in [0, 1]; control_video (B, F, H, W, 3) in [0, 1];
    noises {"latents": (B, F, h, w, 4), "image_aug": (B, H, W, 3)} standard
    normal. The hint variant's conditions: camera_cond (B, F, camera_dim),
    bbox_cond (B, F, H, W, 3) in [0, 1], rot_id (B,); each is doubled for
    CFG, bbox_cond mapped to [-1, 1] first (the entity variant's map is not
    taken here, so that variant raises). Returns (B, F, H, W, 3) float32 in
    [0, 1], or the final latents (B, F, h, w, 4) if output_latent. `params`
    must already be on `device`. Runs under the bundle's KernelConfig
    (resolve_kernels). On a CUDA device the denoise loop replays a captured
    CUDA graph, kept in `graph` for later calls, or without one in the
    module's graph for the next call of the same key (see denoise)."""
    with use_kernels(resolve_kernels(bundle).kernels):
        device = resolve_device(device)
        if device.type == "cuda":
            set_float32_precision()
        dt = compute_dtype or default_compute_dtype(device)
        with span("posetraj/prepare"):
            image = _as_tensor(image, device)
            control_video = _as_tensor(control_video, device)
            sigmas = _as_tensor(sigmas, device)
            timesteps = _as_tensor(timesteps, device)
            time_ids = _as_tensor(added_time_ids, device)
            image_aug = _as_tensor(noises["image_aug"], device)
            noise = _as_tensor(noises["latents"], device)
            camera_cond = None if camera_cond is None else _as_tensor(camera_cond, device)
            bbox_cond = None if bbox_cond is None else _as_tensor(bbox_cond, device)
            rot_id = None if rot_id is None else _as_tensor(rot_id, device, torch.long)

        with span("posetraj/clip", device=device):
            clip_emb = encode_image_clip(params, bundle, image, dt)
        with span("posetraj/vae_encode", device=device):
            image_latents = encode_image_vae(params, bundle, image * 2.0 - 1.0, image_aug, pcfg.noise_aug_strength)
        init_sigma = sigmas[0] if bundle.scheduler.timestep_spacing in ("linspace", "trailing") \
            else torch.sqrt(sigmas[0] ** 2 + 1.0)
        latents = noise * init_sigma
        control = (control_video * 2.0 - 1.0).to(dt)
        control = torch.cat([control, control], dim=0)
        guidance = torch.linspace(pcfg.min_guidance_scale, pcfg.max_guidance_scale, num_frames, device=device)
        time_ids = torch.cat([time_ids, time_ids], dim=0)
        cfg2 = lambda x: None if x is None else torch.cat([x, x], dim=0)
        camera_cond = cfg2(camera_cond)
        if bbox_cond is not None:
            bbox_cond = cfg2(bbox_cond * 2.0 - 1.0).to(dt)
        rot_id = cfg2(rot_id)
        latents = denoise(params, bundle, pcfg, latents, image_latents, clip_emb, control, time_ids, sigmas, timesteps,
                          guidance, dt, camera_cond, bbox_cond, rot_id, graph=graph)
        if output_latent:
            return latents
        with span("posetraj/decode", device=device):
            frames = decode_latents(params, bundle, latents, pcfg.decode_chunk_size, dt)
        return (frames / 2.0 + 0.5).clamp(0.0, 1.0)


class SVDControlNetPipeline:
    """User-facing wrapper mirroring the reference __call__ surface.
    params: {"unet", "controlnet", "vae": {"encoder", "decoder"}, "clip"},
    already on `device`. On a CUDA device the instance keeps its denoise
    loop's CUDA graph: a later request of the same shapes, parameters and
    switches replays it without capturing anew."""

    def __init__(self, params: Dict, bundle: ModelBundle = ModelBundle(), device=None, compute_dtype=None,
                 mesh=None, serve_mesh=None):
        """serve_mesh: a ("cfg", "sp") parallel.spmd.ServeMesh
        (parallel/serve.make_serve_mesh) for single-video sharded serving:
        batch-1 calls run parallel/serve.generate_sharded on it, on its
        device.

        mesh: a ("data", "model") parallel.mesh.Mesh for batched serving,
        on every rank of the job: each call draws the global batch's noises
        from the seed, runs generate() on the rank's data rows and
        all-gathers the frames over "data", so every rank returns the whole
        batch. The ControlNet's leaves that param_shardings splits over
        "model" are kept as this rank's blocks and all-gathered into
        whole-weight buffers once a call, before the denoise graph; the
        frozen models stay whole. The two meshes cannot be combined."""
        if mesh is not None and serve_mesh is not None:
            raise ValueError("mesh (batched) and serve_mesh (single-video) are mutually exclusive")
        self.mesh = mesh
        self.serve_mesh = serve_mesh
        self.device = (serve_mesh.device if serve_mesh is not None else mesh.device if mesh is not None
                       else resolve_device(device))
        self._blocks = []  # (Sharding, this rank's block, whole-weight buffer) of each split leaf
        self._rows = None  # the Q7 context of a batch split over "data", at fixed addresses for the graph
        if mesh is not None:
            from posetraj_torch.parallel.mesh import param_shardings

            ctrl = params["controlnet"]
            shardings = list(flatten_dict(param_shardings(ctrl, mesh)).values())
            flat = [torch.empty_like(t) if sh.sharded else t for sh, t in zip(shardings, leaves(ctrl))]
            self._blocks = [(sh, sh.local(t), w) for sh, t, w in zip(shardings, leaves(ctrl), flat) if sh.sharded]
            it = iter(flat)
            params = dict(params, controlnet=tree_map(lambda _: next(it), ctrl))
        self.params = params
        self.bundle = bundle
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        self.graph = DenoiseGraph()

    @request_span()
    def __call__(self, image, controlnet_condition, height: int = 576, width: int = 1024, num_frames: int = 14,
                 num_inference_steps: int = 25, min_guidance_scale: float = 1.0, max_guidance_scale: float = 3.0,
                 fps: int = 7, motion_bucket_id: int = 127, noise_aug_strength: float = 0.02,
                 controlnet_cond_scale: float = 1.0, decode_chunk_size: Optional[int] = None, camera_cond=None,
                 bbox_condition=None, rot_id=None, seed: int = 0, noises: Optional[Dict] = None,
                 output_type: str = "np"):
        pcfg = PipelineConfig(
            height=height, width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
            min_guidance_scale=min_guidance_scale, max_guidance_scale=max_guidance_scale, fps=fps,
            motion_bucket_id=motion_bucket_id, noise_aug_strength=noise_aug_strength,
            controlnet_cond_scale=controlnet_cond_scale, decode_chunk_size=decode_chunk_size or num_frames,
        )
        with span("posetraj/prepare"):
            image = _to_float_array(image)
            control = _to_float_array(controlnet_condition)
            if control.ndim == 4:
                control = control[None]
            b = image.shape[0]
            sf = self.bundle.vae.scale_factor
            lat_shape = (b, num_frames, height // sf, width // sf, self.bundle.vae.latent_channels)
            if noises is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                noises = {
                    "latents": torch.randn(lat_shape, generator=gen, device=self.device),
                    "image_aug": torch.randn(image.shape, generator=gen, device=self.device),
                }
            sched = make_schedule(self.bundle.scheduler, num_inference_steps)
            time_ids = np.tile(added_time_ids_inference(pcfg), (b, 1))
            bbox = None if bbox_condition is None else _to_float_array(bbox_condition)
        args = (self.params, self.bundle, pcfg, image, control, noises, time_ids, sched.sigmas, sched.timesteps,
                num_frames)
        kw = dict(camera_cond=camera_cond, rot_id=rot_id, output_latent=(output_type == "latent"), bbox_cond=bbox,
                  compute_dtype=self.compute_dtype)
        if self.mesh is not None:
            frames = self._call_mesh(pcfg, image, control, noises, time_ids, sched, camera_cond, bbox, rot_id,
                                     output_type)
        elif self.serve_mesh is not None and b == 1:
            from posetraj_torch.parallel.serve import generate_sharded

            frames = generate_sharded(*args, self.serve_mesh, **kw)
        else:
            frames = generate(*args, device=self.device, graph=self.graph, **kw)
        with span("posetraj/output"):
            return self._postprocess(frames.cpu().numpy(), output_type)

    def _call_mesh(self, pcfg, image, control, noises, time_ids, sched, camera_cond, bbox, rot_id, output_type):
        """A batched call over the mesh: the split ControlNet leaves
        gathered whole, generate() on this rank's rows of every batched
        input, the frames (or latents) gathered over "data"."""
        from posetraj_torch.parallel.mesh import BatchRows, batch_sharding, gather_batch_rows, global_batch_rows

        with torch.no_grad():
            for sh, block, whole in self._blocks:
                sh.gather(block, out=whole)
        rows = batch_sharding(self.mesh, 1)
        local = lambda x: None if x is None else rows.local(torch.as_tensor(x))
        image = local(image)
        layout = None
        if rows.sharded:
            # Quirk Q7 reads the whole CFG batch's CLIP context: each rank's
            # CLIP rows (computed here and again inside generate(), a small
            # encode) gathered over "data" into buffers the graph reads.
            with torch.inference_mode(), span("posetraj/clip", device=self.device):
                clip = encode_image_clip(self.params, self.bundle, _as_tensor(image, self.device), self.compute_dtype)
            ctx = gather_batch_rows(self.mesh, clip, groups=2)
            if self._rows is None or self._rows.table.shape != ctx.table.shape:
                self._rows = BatchRows(ctx.table.clone(), ctx.rows.clone())
            else:
                self._rows.table.copy_(ctx.table)
            layout = self._rows
        with global_batch_rows(layout):
            frames = generate(self.params, self.bundle, pcfg, image, local(control),
                              {k: local(v) for k, v in noises.items()}, local(time_ids), sched.sigmas,
                              sched.timesteps, pcfg.num_frames, camera_cond=local(camera_cond), bbox_cond=local(bbox),
                              rot_id=local(rot_id), output_latent=(output_type == "latent"), device=self.device,
                              compute_dtype=self.compute_dtype, graph=self.graph)
        return rows.gather(frames)

    @staticmethod
    def _postprocess(frames: np.ndarray, output_type: str):
        """The array for output_type "np" and "latent"; for "pil", a list
        per video of PIL images, one a frame (PIL is imported only here)."""
        if output_type == "pil":
            from PIL import Image

            return [[Image.fromarray((fr * 255).round().astype(np.uint8)) for fr in vid] for vid in frames]
        return frames


def _to_float_array(x) -> np.ndarray:
    """PIL image / list of PIL / numpy -> float32 [0, 1] channels-last with a batch dim."""
    try:
        from PIL import Image

        if isinstance(x, Image.Image):
            x = np.asarray(x, np.float32)[None] / 255.0
        elif isinstance(x, (list, tuple)) and x and isinstance(x[0], Image.Image):
            x = np.stack([np.asarray(im, np.float32) for im in x]) / 255.0
    except ImportError:
        pass
    x = np.asarray(x, np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    if x.ndim == 3:
        x = x[None]
    return x
