"""Single-video sharded serving over a ("cfg", "sp") mesh, one process per
device (port of posetraj_tpu/parallel/serve.py on torch.distributed).

One 14-frame 576x1024 video cannot be sharded by batch. This module shards
the inside of the denoise step instead:

  cfg (1 or 2): the classifier-free-guidance pair. The uncond and cond
            ControlNet + UNet branches run on disjoint ranks; the per-frame
            guidance combine uncond + g (cond - uncond) becomes one small
            all-reduce of coefficient-weighted branch outputs a step.
  sp:       blocks of the latent W axis. Convolutions exchange halo
            columns, GroupNorm sums its statistics, spatial self-attention
            all-gathers K/V; temporal ops are local per pixel
            (parallel/spmd.py has the op-level contract).

Every rank is called with the same full inputs and slices its own block.
CLIP and the VAE encode run replicated on every rank. The hint encoder and
the denoise loop run on the rank's (cfg, sp) block, eagerly (no CUDA graph:
the loop's NCCL collectives are not captured). The latents are then
all-gathered over sp, and the decode spreads frame chunks over every rank
(the chunks are independent by the reference's own decode_chunk_size) and
all-gathers the frames: every rank returns the full video. On a (1, 1)
mesh every collective is a no-op, so the same code runs on one device.

The process group is the caller's: `torch.distributed.init_process_group`
with one process per device (NCCL on the card, gloo for CPU tensors), then
`make_serve_mesh` on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from posetraj_torch.configs import PipelineConfig, use_kernels
from posetraj_torch.core.init import default_compute_dtype
from posetraj_torch.diffusion.euler_karras import euler_step
from posetraj_torch.models import controlnet as cn
from posetraj_torch.models import unet as unet_m
from posetraj_torch.models import vae as vae_m
from posetraj_torch.ops.primitives import set_float32_precision
from posetraj_torch.parallel import spmd
from posetraj_torch.parallel.spmd import ServeMesh
from posetraj_torch.pipeline import svd_controlnet as pipe_m
from posetraj_torch.utils.profiling import count, span


def make_serve_mesh(n_cfg: int = 2, n_sp: int = 4, device=None) -> ServeMesh:
    """The ("cfg", "sp") mesh over every process of the default group, which
    must hold n_cfg * n_sp of them, rank r at (r // n_sp, r % n_sp) (without
    a process group, the mesh must be (1, 1)). Every process calls this, in
    the same order as its other collectives: it makes the process groups of
    every row and column. device: where this process's tensors live, by
    default the current CUDA device; NCCL for CUDA, gloo for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("posetraj_torch runs on a CUDA device; none is available. "
                               "Pass device='cpu' to run on the CPU.")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_cfg * n_sp != 1:
            raise RuntimeError(f"a ({n_cfg}, {n_sp}) mesh needs torch.distributed initialised with "
                               f"{n_cfg * n_sp} processes")
        return ServeMesh(n_cfg, n_sp, 0, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_cfg * n_sp:
        raise ValueError(f"a ({n_cfg}, {n_sp}) mesh needs {n_cfg * n_sp} processes, the group has {world}")
    backend = str(dist.get_backend())
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"tensors on {device} cannot use the {backend} backend: NCCL for CUDA, gloo for the CPU")
    sp_group = cfg_group = None
    if n_sp > 1:
        for i in range(n_cfg):
            g = dist.new_group([i * n_sp + j for j in range(n_sp)])
            if i == rank // n_sp:
                sp_group = g
    if n_cfg > 1:
        for j in range(n_sp):
            g = dist.new_group([i * n_sp + j for i in range(n_cfg)])
            if j == rank % n_sp:
                cfg_group = g
    return ServeMesh(n_cfg, n_sp, rank, device, sp_group, cfg_group)


def _check_divisible(pcfg: PipelineConfig, bundle, num_frames: int, n_cfg: int, n_sp: int) -> tuple:
    """Check the mesh against the resolution ladder and find the levels that
    run replicated. Returns (replicated_h, replicated_s) for SpmdCtx.

    A UNet level stays W-sharded until a downsample's local width goes odd;
    every deeper level runs replicated (the downsampler into it gathers W,
    the matching upsampler scatters it). That lets 320x576 (latent W 72 ->
    36 -> 18 -> 9) serve over sp = 2: levels 0-2 shard, the 5x9 level
    replicates. Level 0 not dividing over sp is an error, and so is a ladder
    whose replicated extents collide with sharded ones (the ops key their
    collectives on H and on token counts)."""
    if n_cfg not in (1, 2):
        raise ValueError(f"cfg axis must be 1 or 2 (CFG pair), got {n_cfg}")
    if num_frames % pcfg.decode_chunk_size != 0:
        raise ValueError("sharded decode requires decode_chunk_size | num_frames "
                         f"({pcfg.decode_chunk_size} vs {num_frames}) so chunk boundaries match the unsharded "
                         "chunked decode exactly")
    if n_sp == 1:
        return frozenset(), frozenset()
    sf = bundle.vae.scale_factor
    w_lat, h_lat = pcfg.width // sf, pcfg.height // sf
    if w_lat % n_sp != 0:
        raise ValueError(f"latent width {w_lat} does not divide over sp={n_sp}; choose a width whose latent is a "
                         f"multiple of {n_sp}")
    # The hint encoder's pixel ladder: log2(sf) stride-2 convs from the pixel
    # width down to the latent width, each needing an even local block.
    sharded_h, sharded_s = set(), set()
    for i in range((sf - 1).bit_length()):
        if ((pcfg.width >> i) // n_sp) % 2 != 0:
            raise ValueError(f"hint-encoder width {pcfg.width >> i} has an odd local block under sp={n_sp}")
        sharded_h.add(pcfg.height >> i)
    replicated_h, replicated_s = set(), set()
    h, w, sharded = h_lat, w_lat, True
    for lvl in range(bundle.unet.num_levels):
        if sharded:
            sharded_h.add(h)
            sharded_s.add(h * (w // n_sp))
        else:
            replicated_h.add(h)
            replicated_s.add(h * w)
        if lvl < bundle.unet.num_levels - 1:
            if sharded and (w // n_sp) % 2 != 0:
                sharded = False
            h, w = -(-h // 2), -(-w // 2)
    if replicated_h & sharded_h or replicated_s & sharded_s:
        raise ValueError(f"ambiguous ladder: replicated levels (H {sorted(replicated_h)}, S {sorted(replicated_s)}) "
                         f"collide with sharded extents under sp={n_sp} at {pcfg.height}x{pcfg.width}")
    return frozenset(replicated_h), frozenset(replicated_s)


def _cfg_rows(x: Optional[torch.Tensor], mesh: ServeMesh) -> Optional[torch.Tensor]:
    """This rank's rows of a CFG-doubled batch (uncond first)."""
    if x is None or mesh.n_cfg == 1:
        return x
    b = x.shape[0] // mesh.n_cfg
    return x[mesh.cfg_rank * b:(mesh.cfg_rank + 1) * b]


@torch.inference_mode()
@pipe_m.request_span()
def generate_sharded(params: Dict, bundle, pcfg: PipelineConfig, image, control_video, noises: Dict,
                     added_time_ids, sigmas, timesteps, num_frames: int, mesh: ServeMesh, camera_cond=None,
                     bbox_cond=None, rot_id=None, output_latent: bool = False, compute_dtype=None) -> torch.Tensor:
    """The sharded twin of pipeline.generate for one video (batch 1), with
    generate's arguments plus `mesh`; `params` already on mesh.device. Every
    rank returns the full (1, F, H, W, 3) video, or the full latents with
    `output_latent`. The numbers are generate()'s up to the order of sums:
    the GroupNorm statistics, the gathered-K/V softmax and the CFG combine,
    sum_b coeff_b pred_b in place of uncond + g (cond - uncond)."""
    with use_kernels(pipe_m.resolve_kernels(bundle).kernels):
        device = mesh.device
        if device.type == "cuda":
            set_float32_precision()
        dt = compute_dtype or default_compute_dtype(device)
        with span("posetraj/prepare"):
            image = pipe_m._as_tensor(image, device)
            if image.shape[0] != 1:
                raise ValueError(f"single-video serving takes batch 1, got {image.shape[0]}")
            replicated_h, replicated_s = _check_divisible(pcfg, bundle, num_frames, mesh.n_cfg, mesh.n_sp)
            ctx = spmd.SpmdCtx(mesh, replicated_h, replicated_s)
            sigmas = pipe_m._as_tensor(sigmas, device)
            timesteps = pipe_m._as_tensor(timesteps, device)
            image_aug = pipe_m._as_tensor(noises["image_aug"], device)
            noise = pipe_m._as_tensor(noises["latents"], device)
            control_video = pipe_m._as_tensor(control_video, device)
            time_ids = pipe_m._as_tensor(added_time_ids, device)
            camera_cond = None if camera_cond is None else pipe_m._as_tensor(camera_cond, device)
            bbox_cond = None if bbox_cond is None else pipe_m._as_tensor(bbox_cond, device)
            rot_id = None if rot_id is None else pipe_m._as_tensor(rot_id, device, torch.long)

        # Encode, replicated on every rank.
        with span("posetraj/clip", device=device):
            clip_emb = pipe_m.encode_image_clip(params, bundle, image, dt)
        with span("posetraj/vae_encode", device=device):
            image_latents = pipe_m.encode_image_vae(params, bundle, image * 2.0 - 1.0, image_aug,
                                                    pcfg.noise_aug_strength)
        init_sigma = sigmas[0] if bundle.scheduler.timestep_spacing in ("linspace", "trailing") \
            else torch.sqrt(sigmas[0] ** 2 + 1.0)
        latents = noise * init_sigma
        control = (control_video * 2.0 - 1.0).to(dt)
        guidance = torch.linspace(pcfg.min_guidance_scale, pcfg.max_guidance_scale, num_frames, device=device)
        cfg2 = lambda x: None if x is None else torch.cat([x, x], dim=0)
        camera_cond = cfg2(camera_cond)
        if bbox_cond is not None:
            bbox_cond = cfg2(bbox_cond * 2.0 - 1.0).to(dt)
        rot_id = cfg2(rot_id)

        # This rank's (cfg, sp) block of every input of the loop.
        w_block = lambda x: None if x is None else spmd.scatter_w(x, ctx)
        latents = _denoise_sharded(
            params, bundle, pcfg, ctx, w_block(latents.float()), w_block(_cfg_rows(image_latents, mesh)),
            _cfg_rows(clip_emb, mesh), w_block(_cfg_rows(torch.cat([control, control], dim=0), mesh)),
            _cfg_rows(torch.cat([time_ids, time_ids], dim=0), mesh), sigmas, timesteps, guidance, dt,
            _cfg_rows(camera_cond, mesh), w_block(_cfg_rows(bbox_cond, mesh)), _cfg_rows(rot_id, mesh))
        latents = spmd.gather_w(latents, ctx)
        if output_latent:
            return latents
        with span("posetraj/decode", device=device):
            frames = _decode_sharded(params, bundle, latents, pcfg.decode_chunk_size, mesh, dt)
        return (frames / 2.0 + 0.5).clamp(0.0, 1.0)


def _denoise_sharded(params, bundle, pcfg, ctx: spmd.SpmdCtx, lat, img_lat, clip, control, time_ids, sigmas,
                     timesteps, guidance, dt, camera_cond, bbox_cond, rot_id) -> torch.Tensor:
    """The hint encoder and the Euler loop on this rank's block: lat (1, F,
    h, w/sp, 4) float32, img_lat (2/cfg, h, w/sp, 4), clip (2/cfg, 1, D),
    control (2/cfg, F, H, W/sp, 3). Returns the rank's float32 latents."""
    b_loc, f = img_lat.shape[0], lat.shape[1]
    img5 = img_lat[:, None].expand(-1, f, -1, -1, -1).to(dt)
    gs = guidance.reshape(1, f, 1, 1, 1).float()
    # Global CFG branch of each local row: 0 uncond, 1 cond.
    ids = ctx.mesh.cfg_rank * b_loc + torch.arange(b_loc, device=lat.device)
    coeff = torch.where(ids.reshape(-1, 1, 1, 1, 1) == 0, 1.0 - gs, gs)  # (b_loc, F, 1, 1, 1)
    with spmd.spatial_sharding(ctx):
        with span("posetraj/hint", device=lat.device):
            hint = cn.hint_encoder(params["controlnet"]["controlnet_cond_embedding"], bundle.controlnet.hint,
                                   control, f, camera_cond=camera_cond, bbox_cond=bbox_cond, rot_id=rot_id,
                                   compute_dtype=dt)
        count("denoise.eager_steps", timesteps.shape[0])
        for i in range(timesteps.shape[0]):
            lat_in = (lat.expand(b_loc, -1, -1, -1, -1) / torch.sqrt(sigmas[i] ** 2 + 1.0)).to(dt)
            lat_in = torch.cat([lat_in, img5], dim=-1)
            down_res, mid_res = cn.controlnet_forward(
                params["controlnet"], bundle.controlnet, lat_in, timesteps[i], clip, time_ids,
                conditioning_scale=pcfg.controlnet_cond_scale, compute_dtype=dt, hint_embedding=hint,
            )
            pred = unet_m.unet_forward(params["unet"], bundle.unet, lat_in, timesteps[i], clip, time_ids,
                                       down_res, mid_res, compute_dtype=dt).float()
            # The CFG combine over the global branch set: sum_b coeff_b pred_b
            # = uncond + g (cond - uncond).
            noise_pred = spmd.psum_cfg((coeff * pred).sum(dim=0, keepdim=True), ctx)
            lat, _ = euler_step(noise_pred, lat, sigmas[i], sigmas[i + 1], bundle.scheduler.prediction_type)
            lat = lat.float()
    return lat


def _decode_sharded(params, bundle, latents: torch.Tensor, chunk: int, mesh: ServeMesh, dt) -> torch.Tensor:
    """(1, F, h, w, 4) -> (1, F, H, W, 3) float32 in [-1, 1]: the chunked
    VAE decode with the chunks spread over every rank of the mesh, then the
    frames all-gathered (chunks are independent, so nothing else moves)."""
    b, f = latents.shape[:2]
    flat = latents.reshape(b * f, *latents.shape[2:]) / bundle.vae.scaling_factor
    n_chunks = (b * f) // chunk
    per = -(-n_chunks // mesh.size)
    outs = [vae_m.decode(params["vae"]["decoder"], bundle.vae, flat[i * chunk:(i + 1) * chunk], chunk, dt).float()
            for i in range(mesh.rank * per, min(n_chunks, (mesh.rank + 1) * per))]
    if mesh.size > 1:
        sf = bundle.vae.scale_factor
        shape = (chunk, flat.shape[1] * sf, flat.shape[2] * sf, bundle.vae.out_channels)
        outs += [torch.zeros(shape, device=flat.device)] * (per - len(outs))  # equal blocks for the all-gather
    frames = spmd.all_gather_mesh(torch.cat(outs, dim=0), mesh)[: b * f]
    return frames.reshape(b, f, *frames.shape[1:])
