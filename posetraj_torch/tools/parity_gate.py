"""Golden-latent parity gate (port of posetraj_tpu/tools/parity_gate.py): one
command that checks a diffusers-layout checkpoint generates, through the
port, the latents the reference implementation generates.

    python -m posetraj_torch.tools.parity_gate /path/to/svd-checkpoint \\
        [--controlnet /path/to/posetraj-checkpoint/controlnet] \\
        [--height 256 --width 384 --frames 14 --steps 4] [--out latents.npz] \\
        [--device cpu] [--reference-repo /path/to/reference]

What it does:
  1. `verify_against_expected`: every config.json against the recorded
     constants (tools/hub_configs.py EXPECTED); a divergence fails the gate
     unless --allow-config-divergence.
  2. Builds the port's configs from the checkpoint's config.json files
     (from_pretrained semantics) and loads every model's weights with
     tools/convert_weights.params_from_diffusers onto `meta` templates.
  3. Runs the port's generate() on `device` (the card unless --device cpu)
     on fixed inputs with injected noise, and keeps the final latents.
  4. Unless --skip-reference, builds the reference pipeline from the
     reference repository's own files (--reference-repo, or the
     POSETRAJ_REFERENCE_REPO variable), as run_inference_vipseg_json_repro.py
     assembles it, runs it on the same noise with torch on the CPU, and
     requires the latents to agree within --tolerance. Without a reference
     repository or diffusers that branch reports itself unavailable.

The reference branch needs `diffusers` importable: the real package or the
test stand-in under tests/ref_oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from posetraj_torch.configs import ControlNetConfig, HintEncoderConfig
from posetraj_torch.tools import hub_configs as hc
from posetraj_torch.tools.convert_weights import load_diffusers_model_dir, params_from_diffusers


# ---------------------------------------------------------------------------
# Deterministic inputs
# ---------------------------------------------------------------------------


def make_gate_inputs(height: int, width: int, frames: int, seed: int):
    """Deterministic image, control video and noises shared by both sides:
    the JAX version's, drawn from the same torch CPU generators, so the
    reference pipeline can consume the identical streams. Returned noises
    are channels-last for the port's pipeline; the reference branch takes
    the NCHW / NCFHW draws."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    image = np.stack([yy / height, xx / width, (yy + xx) / (height + width)], axis=-1)[None]
    # On the uint8 grid once, so that the PIL round trip of the reference
    # branch sees the pixels the port's side takes.
    image = np.round(image * 255.0) / 255.0
    # Control video: a bright diagonal streak sweeping across the frames.
    control = np.zeros((1, frames, height, width, 3), np.float32)
    for f in range(frames):
        c = int((f + 1) * width / (frames + 1))
        control[0, f, :, max(0, c - 2) : c + 2, 0] = 1.0

    aug = torch.randn((1, 3, height, width), generator=torch.Generator().manual_seed(seed)).numpy()
    lat = torch.randn((1, frames, 4, height // 8, width // 8),
                      generator=torch.Generator().manual_seed(seed + 1)).numpy()
    noises = {
        "image_aug": np.ascontiguousarray(aug.transpose(0, 2, 3, 1)),
        "latents": np.ascontiguousarray(lat.transpose(0, 1, 3, 4, 2)),
    }
    return image, control, noises, {"aug_nchw": aug, "lat_ncfhw": lat}


def controlnet_config_from_json(cfg: Dict, unet_cfg) -> ControlNetConfig:
    """ControlNetConfig from a controlnet checkpoint's config.json
    (ControlNetSDVModel registers conditioning_embedding_out_channels,
    controlnet_sdv.py:201-240)."""
    hint = HintEncoderConfig(
        block_out_channels=tuple(cfg.get("conditioning_embedding_out_channels", (16, 32, 96, 256))),
        conditioning_channels=cfg.get("conditioning_channels", 3),
        embedding_channels=unet_cfg.block_out_channels[0],
    )
    return ControlNetConfig(unet=unet_cfg, hint=hint)


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------


def run_ours(checkpoint_dir: str, controlnet_dir: Optional[str], height: int, width: int, frames: int, steps: int,
             seed: int, device=None, compute_dtype=None) -> np.ndarray:
    """The port's final latents (1, F, h, w, 4), float32, for the gate's
    inputs. The configs come from the checkpoint's config.json files; every
    model's weights are converted onto a `meta` template of the port's
    layouts (names and shapes checked) and placed on `device` (the card
    unless "cpu") as pipeline.init_params lays them out (compute dtype,
    float32 norms and VAE encoder); then generate(..., output_latent=True)
    with the injected noises."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.core.init import default_compute_dtype, resolve_device
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference, generate, init_params

    device = resolve_device(device)
    dt = compute_dtype or default_compute_dtype(device)
    unet_cfg = hc.unet_config_from_json(hc.load_config_json(checkpoint_dir, "unet"))
    vae_cfg = hc.vae_config_from_json(hc.load_config_json(checkpoint_dir, "vae"))
    clip_cfg = hc.clip_config_from_json(hc.load_config_json(checkpoint_dir, "image_encoder"))
    sched_cfg = hc.scheduler_config_from_json(hc.load_config_json(checkpoint_dir, "scheduler"))
    cn_dir = controlnet_dir or os.path.join(checkpoint_dir, "controlnet")
    with open(os.path.join(cn_dir, "config.json")) as f:
        cn_cfg = controlnet_config_from_json(json.load(f), unet_cfg)
    bundle = ModelBundle(unet=unet_cfg, controlnet=cn_cfg, vae=vae_cfg, clip=clip_cfg, scheduler=sched_cfg)
    like = init_params(bundle, device="meta", compute_dtype=dt)
    dirs = {"unet": os.path.join(checkpoint_dir, "unet"), "controlnet": cn_dir,
            "vae": os.path.join(checkpoint_dir, "vae"), "clip": os.path.join(checkpoint_dir, "image_encoder")}
    params = {name: params_from_diffusers(load_diffusers_model_dir(d), like[name], name, device=device)
              for name, d in dirs.items()}

    pcfg = PipelineConfig(height=height, width=width, num_frames=frames, num_inference_steps=steps,
                          decode_chunk_size=frames)
    image, control, noises, _ = make_gate_inputs(height, width, frames, seed)
    sched = make_schedule(sched_cfg, steps)
    latents = generate(params, bundle, pcfg, image, control, noises, added_time_ids_inference(pcfg), sched.sigmas,
                       sched.timesteps, frames, output_latent=True, device=device, compute_dtype=dt)
    return latents.float().cpu().numpy()


# ---------------------------------------------------------------------------
# The reference side (torch + diffusers, on the CPU)
# ---------------------------------------------------------------------------


def run_reference(checkpoint_dir: str, controlnet_dir: Optional[str], height: int, width: int, frames: int,
                  steps: int, seed: int, reference_repo: str) -> np.ndarray:
    """Execute the reference's own pipeline file on the same inputs, as
    run_inference_vipseg_json_repro.py:335-338 assembles it with
    from_pretrained, here through from_config + load_state_dict (no hub
    machinery, so it also runs on the tests/ref_oracle stand-in)."""
    from PIL import Image

    if reference_repo not in sys.path:
        sys.path.insert(0, reference_repo)
    sys.path.insert(0, os.path.join(reference_repo, "pipeline"))
    try:
        from transformers import CLIPImageProcessor, CLIPVisionModelWithProjection

        from pipeline_stable_video_diffusion_controlnet import StableVideoDiffusionPipelineControlNet
        from models.controlnet_sdv import ControlNetSDVModel
        from models.unet_spatio_temporal_condition_controlnet import UNetSpatioTemporalConditionControlNetModel
        from utils.scheduling_euler_discrete_karras_fix import EulerDiscreteScheduler
        from diffusers.models import AutoencoderKLTemporalDecoder
    finally:
        sys.path.pop(0)

    def build(cls, subdir):
        with open(os.path.join(subdir, "config.json")) as f:
            cfg = json.load(f)
        model = cls.from_config({k: v for k, v in cfg.items() if not k.startswith("_")})
        sd = {k: torch.from_numpy(np.asarray(v)) for k, v in load_diffusers_model_dir(subdir).items()}
        model.load_state_dict(sd)
        return model.eval()

    cn_dir = controlnet_dir or os.path.join(checkpoint_dir, "controlnet")
    unet = build(UNetSpatioTemporalConditionControlNetModel, os.path.join(checkpoint_dir, "unet"))
    cnet = build(ControlNetSDVModel, cn_dir)
    vae = build(AutoencoderKLTemporalDecoder, os.path.join(checkpoint_dir, "vae"))
    image_encoder = CLIPVisionModelWithProjection.from_pretrained(checkpoint_dir, subfolder="image_encoder").eval()
    with open(os.path.join(checkpoint_dir, "scheduler", "scheduler_config.json")) as f:
        scheduler = EulerDiscreteScheduler.from_config({k: v for k, v in json.load(f).items() if not k.startswith("_")})

    pipe = StableVideoDiffusionPipelineControlNet(
        vae=vae, image_encoder=image_encoder, unet=unet, controlnet=cnet, scheduler=scheduler,
        feature_extractor=CLIPImageProcessor(),
    )
    image, control, _, torch_noise = make_gate_inputs(height, width, frames, seed)
    image_pil = Image.fromarray((image[0] * 255).round().astype(np.uint8))
    control_t = torch.from_numpy(np.ascontiguousarray(control[0].transpose(0, 3, 1, 2)))  # (F, 3, H, W)
    out = pipe(
        image_pil, controlnet_condition=control_t, height=height, width=width, num_frames=frames,
        num_inference_steps=steps, decode_chunk_size=frames,
        generator=torch.Generator().manual_seed(seed),  # consumed by the aug-noise draw
        latents=torch.from_numpy(torch_noise["lat_ncfhw"]), output_type="latent", return_dict=False,
    )
    lat = out.detach().cpu().float().numpy()  # (1, F, 4, h, w)
    return np.ascontiguousarray(lat.transpose(0, 1, 3, 4, 2))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint_dir", help="SVD checkpoint directory (diffusers layout)")
    ap.add_argument("--controlnet", default=None, help="ControlNet dir (default: <checkpoint_dir>/controlnet)")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tolerance", type=float, default=5e-2, help="max |ours - reference| on final latents")
    ap.add_argument("--out", default=None, help="save latents to this .npz")
    ap.add_argument("--skip-reference", action="store_true", help="only run the port (no reference comparison)")
    ap.add_argument("--allow-config-divergence", action="store_true")
    ap.add_argument("--reference-repo", default=os.environ.get("POSETRAJ_REFERENCE_REPO"),
                    help="the reference repository (default: $POSETRAJ_REFERENCE_REPO)")
    ap.add_argument("--device", default=None, help="the port's device (default: the card; 'cpu' to ask for the CPU)")
    args = ap.parse_args(argv)

    issues = hc.verify_against_expected(args.checkpoint_dir)
    for line in issues:
        print("config divergence:", line)
    if issues and not args.allow_config_divergence:
        print("FAIL: config.json diverges from recorded constants "
              "(fix tools/hub_configs.py EXPECTED + configs.py, or pass "
              "--allow-config-divergence for a non-SVD checkpoint)")
        return 1

    ours = run_ours(args.checkpoint_dir, args.controlnet, args.height, args.width, args.frames, args.steps, args.seed,
                    device=args.device)
    print(f"ours: latents {ours.shape} mean={ours.mean():+.5f} std={ours.std():.5f}")

    theirs = None
    if not args.skip_reference:
        if not args.reference_repo:
            print("reference branch unavailable: no --reference-repo (or POSETRAJ_REFERENCE_REPO) given")
        else:
            try:
                theirs = run_reference(args.checkpoint_dir, args.controlnet, args.height, args.width, args.frames,
                                       args.steps, args.seed, args.reference_repo)
            except ImportError as e:
                print(f"reference branch unavailable (torch/diffusers): {e}")

    if args.out:
        data = {"ours": ours}
        if theirs is not None:
            data["reference"] = theirs
        np.savez(args.out, **data)
        print("saved", args.out)

    if theirs is not None:
        diff = np.abs(ours - theirs)
        print(f"reference: latents {theirs.shape} mean={theirs.mean():+.5f} std={theirs.std():.5f}")
        print(f"|diff| max={diff.max():.6f} mean={diff.mean():.6f}")
        if diff.max() > args.tolerance:
            print(f"FAIL: max diff {diff.max():.6f} > tolerance {args.tolerance}")
            return 1
        print("PASS: latents agree within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
