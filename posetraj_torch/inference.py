"""Batch inference drivers over validation splits (port of
posetraj_tpu/inference.py).

Rebuild of the reference's three driver scripts as one configurable CLI
(scripts/run_inference_vipseg_json_repro.py:321-456 — VIPSeg JSON
trajectories; infer/run_inference_blender.py:311-420 — pre-rendered Blender
control frames; infer/run_inference_vipseg_json_cam_concat_repro.py:485-496 —
camera variant fed zero camera at inference). Replaces their inlined config
dicts and hard-coded paths with arguments.

Usage:
    python -m posetraj_torch.inference --mode vipseg --data_root ... \\
        --checkpoint ... --out_dir results/ [--height 320 --width 576]

Each driver splits into its file I/O (`run_vipseg`, `run_blender`: reading,
resizing, rasterizing with cv2, writing) and a function of one sample that
takes arrays and returns the video (`vipseg_sample`, `blender_sample`).
Runs on `cuda`; `--platform cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np


def build_pipeline(checkpoint: Optional[str], svd_root: Optional[str], variant: str = "base",
                   tiny: bool = False, device=None):
    """Assemble an SVDControlNetPipeline on `device` (default cuda).

    checkpoint: dir with diffusers-format controlnet weights (the reference's
    checkpoint-*/controlnet layout); svd_root: local SVD model dir with unet/
    vae/ image_encoder/ subfolders. Without weights the parameters are random
    from seeded torch generators (pipeline.init_params, seed 0), so the
    pipeline still runs for smoke and timing runs."""
    from posetraj_torch.core.init import resolve_device
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params
    from posetraj_torch.tools.convert_weights import load_diffusers_model_dir, params_from_diffusers

    device = resolve_device(device)
    bundle = ModelBundle.tiny(variant) if tiny else ModelBundle.with_variant(variant)
    params = init_params(bundle, seed=0, device=device)
    if svd_root:
        for name, sub in (("unet", "unet"), ("vae", "vae"), ("clip", "image_encoder")):
            params[name] = params_from_diffusers(load_diffusers_model_dir(os.path.join(svd_root, sub)),
                                                 params[name], name)
    if checkpoint:
        params["controlnet"] = params_from_diffusers(load_diffusers_model_dir(checkpoint), params["controlnet"],
                                                     "controlnet")
    return SVDControlNetPipeline(params, bundle, device=device)


def vipseg_sample(pipe, image: np.ndarray, control: np.ndarray, args) -> np.ndarray:
    """One VIPSeg video: image (H, W, 3) and control (F, H, W, 3), float32 in
    [0, 1] -> (F, H, W, 3) float32 in [0, 1]. The cam variant runs with a
    zero camera, as the reference's cam driver does."""
    return pipe(
        image[None],
        control[None],
        height=args.height,
        width=args.width,
        num_frames=args.num_frames,
        num_inference_steps=args.steps,
        motion_bucket_id=args.motion_bucket_id,
        controlnet_cond_scale=args.cond_scale,
        seed=args.seed,
    )[0]


def run_vipseg(args, pipe):
    """Per-video: first frame + CoTracker JSON -> rasterized control video ->
    pipeline -> PNG frames + side-by-side GIF
    (run_inference_vipseg_json_repro.py:365-455)."""
    from PIL import Image

    from posetraj_torch.data import export
    from posetraj_torch.data.trajectories import load_cotracker_json, scale_to_target, trajectories_to_array
    from posetraj_torch.ops.rasterize import rasterize_cv2

    with open(args.split_file) as f:
        vids = [line.strip() for line in f if line.strip()]
    os.makedirs(args.out_dir, exist_ok=True)

    for name in vids[: args.limit] if args.limit else vids:
        img_dir = os.path.join(args.data_root, "imgs", name)
        frame_files = sorted(os.listdir(img_dir))
        first = Image.open(os.path.join(img_dir, frame_files[0])).convert("RGB")
        src_hw = (first.height, first.width)
        first_resized = first.resize((args.width, args.height), Image.BILINEAR)

        traj_path = os.path.join(args.data_root, "trajectory_CoTracker_all", f"{name}.json")
        traj = trajectories_to_array(load_cotracker_json(traj_path))
        if traj.shape[1] < args.num_frames:
            continue
        pts = scale_to_target(traj[:, : args.num_frames], src_hw, (args.height, args.width))
        control = rasterize_cv2(pts, args.num_frames, (args.height, args.width)).astype(np.float32) / 255.0

        t0 = time.time()
        out = vipseg_sample(pipe, np.asarray(first_resized, np.float32) / 255.0, control, args)
        dt = time.time() - t0

        vid_dir = os.path.join(args.out_dir, name)
        export.export_to_images(out, os.path.join(vid_dir, "pred"))
        gt = [
            np.asarray(Image.open(os.path.join(img_dir, f)).convert("RGB").resize(
                (args.width, args.height), Image.BILINEAR), np.float32) / 255.0
            for f in frame_files[: args.num_frames]
        ]
        export.export_to_images(gt, os.path.join(vid_dir, "gt"))
        export.save_side_by_side_gif([gt, control, out], os.path.join(vid_dir, "side_by_side.gif"))
        print(f"{name}: {dt:.1f}s -> {vid_dir}")


def blender_sample(pipe, sample: Dict[str, np.ndarray], args) -> np.ndarray:
    """One Blender video from a TrajectoryBlenderDataset sample (its
    pixel_values, trajectories and, with --bbox, bbox_trajectories in
    [-1, 1]) -> (F, H, W, 3) float32 in [0, 1]."""
    image = (sample["pixel_values"][0] + 1.0) / 2.0
    control = (sample["trajectories"] + 1.0) / 2.0
    return pipe(
        image[None], control[None], height=args.height, width=args.width,
        num_frames=args.num_frames, num_inference_steps=args.steps, seed=args.seed,
        bbox_condition=((sample["bbox_trajectories"][None] + 1.0) / 2.0 if args.bbox else None),
    )[0]


def run_blender(args, pipe):
    """Blender eval: pre-rendered traj frames as control; --bbox additionally
    feeds rendered 3D-bbox wireframe maps to the dual-branch hint encoder
    (infer/run_inference_blender.py:311-420; controlnet_sdv_bbox.py:110-136)."""
    from posetraj_torch.data import TrajectoryBlenderDataset, export

    ds = TrajectoryBlenderDataset(
        args.data_root, sample_size=(args.height, args.width),
        frame_length=args.num_frames, repeat_times=1, return_bbox=args.bbox, seed=0,
    )
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(len(ds), args.limit) if args.limit else len(ds)
    for i in range(n):
        s = ds[i]
        out = blender_sample(pipe, s, args)
        vid_dir = os.path.join(args.out_dir, s["img_key"])
        export.export_to_images(out, os.path.join(vid_dir, "pred"))
        export.save_side_by_side_gif(
            [(s["pixel_values"] + 1) / 2, (s["trajectories"] + 1) / 2, out],
            os.path.join(vid_dir, "side_by_side.gif"),
        )
        print(f"{s['img_key']} -> {vid_dir}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["vipseg", "blender", "vipseg_cam"], default="vipseg")
    p.add_argument("--bbox", action="store_true",
                   help="blender mode: dual-branch bbox ControlNet fed rendered 3D-bbox maps")
    p.add_argument("--data_root", required=True)
    p.add_argument("--split_file", default=None)
    p.add_argument("--checkpoint", default=None, help="diffusers-format controlnet dir")
    p.add_argument("--svd_root", default=None, help="local SVD model dir (unet/vae/image_encoder)")
    p.add_argument("--out_dir", default="results")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=576)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--motion_bucket_id", type=int, default=10)
    p.add_argument("--cond_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="tiny bundle for smoke runs")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="default: the CUDA device (raises without one); cpu: run on the CPU")
    return p.parse_args(argv)


def variant_of(args) -> str:
    """The hint variant a mode runs: cam for vipseg_cam, bbox for --bbox."""
    return "cam" if args.mode == "vipseg_cam" else ("bbox" if args.bbox else "base")


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    pipe = build_pipeline(args.checkpoint, args.svd_root, variant_of(args), tiny=args.tiny, device=device)
    if args.mode in ("vipseg", "vipseg_cam"):
        if not args.split_file:
            args.split_file = os.path.join(args.data_root, "val.txt")
        run_vipseg(args, pipe)
    else:
        run_blender(args, pipe)


if __name__ == "__main__":
    main()
