"""Training CLI: stage-1 Blender pretrain / stage-2 VIPSeg finetune / camera
finetune as one entry point (port of posetraj_tpu/train/cli.py).

Replaces the reference's accelerate-launched script trio + shell configs
(start_pretrain.sh / start_ft.sh / start_ft_cam.sh; SURVEY.md 2.16, 2.21):

    python -m posetraj_torch.train.cli --stage pretrain --video_folder <10k> \\
        --output_dir out/ [--images_bbox]
    python -m posetraj_torch.train.cli --stage ft --video_folder <vipseg> \\
        --split_file train.txt --controlnet_init <diffusers controlnet dir>
    python -m posetraj_torch.train.cli --stage ft_cam ... --cam_path <4dhumans> \\
        --cam_mask_ratio 0.5

Writes: checkpoints (checkpoint-<step>/ with the trainer's state, and the
ControlNet and its EMA twin in the diffusers layout, rotated), rec_para.txt
parameter audit (train...blender_14.py:1029-1038), metrics JSONL
(+TensorBoard), validation side-by-side GIFs every --validation_steps
(:1418-1495).

One device: `cuda`, or the CPU with --platform cpu. The parallel layer's
data- and tensor-parallel mesh (the JAX package's parallel/mesh.py) is not
in the port yet, so --distributed and --n_model_shards > 1 raise
NotImplementedError.

`main` builds the trainer and the datasets; `train_loop` runs the epochs
(loading, steps, logging, checkpoints, exports, validation renders) and can
be called on a trainer and datasets built elsewhere.
"""

from __future__ import annotations

import argparse
import os

NO_PARALLEL = ("the parallel layer's data- and tensor-parallel mesh (parallel/mesh.py) is not in the port "
               "yet: the training CLI runs on one device")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--stage", choices=["pretrain", "ft", "ft_cam"], required=True)
    p.add_argument("--video_folder", required=True)
    p.add_argument("--split_file", default=None, help="VIPSeg train split (ft stages)")
    p.add_argument("--output_dir", default="runs/posetraj")
    p.add_argument("--svd_root", default=None, help="diffusers SVD weights dir; random init if absent")
    p.add_argument("--controlnet_init", default=None,
                   help="diffusers-format ControlNet weights dir to init the ControlNet from")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=576)
    p.add_argument("--num_frames", type=int, default=14)
    p.add_argument("--per_device_batch_size", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--num_train_epochs", type=int, default=6)
    p.add_argument("--max_train_steps", type=int, default=0)
    p.add_argument("--checkpointing_steps", type=int, default=10000)
    p.add_argument("--checkpoints_total_limit", type=int, default=2)
    p.add_argument("--validation_steps", type=int, default=2500)
    p.add_argument("--validation_folder", default=None,
                   help="held-out video folder (same layout as --video_folder) for "
                        "validation renders — the reference validates from a dedicated "
                        "directory (train_svd_traj_blender_14.py:740-748); falls back "
                        "to training samples if absent")
    p.add_argument("--validation_split_file", default=None,
                   help="VIPSeg val split list (ft stages); default <folder>/val.txt")
    p.add_argument("--num_validation_samples", type=int, default=2,
                   help="videos rendered per validation pass "
                        "(reference --num_validation_images)")
    p.add_argument("--num_inference_steps", type=int, default=25,
                   help="denoise steps for validation renders")
    p.add_argument("--conditioning_dropout_prob", type=float, default=0.1)
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--num_workers", type=int, default=8,
                   help="prefetch loader threads (reference DataLoader num_workers=8)")
    p.add_argument("--images_bbox", action="store_true", help="stage-1 bbox-composited targets")
    p.add_argument("--bbox_supervision", action="store_true",
                   help="stage-1 dual-branch bbox ControlNet: rendered 3D-bbox wireframe "
                        "maps feed the second hint branch (controlnet_sdv_bbox.py:95-136; "
                        "BASELINE configs[2])")
    p.add_argument("--filter_num", type=int, default=-1)
    p.add_argument("--cut_num", type=int, default=-1)
    p.add_argument("--cam_path", default=None)
    p.add_argument("--cam_mask_ratio", type=float, default=0.5)
    p.add_argument("--cam_norm", action="store_true")
    p.add_argument("--rasterizer", default="cv2", choices=("cv2", "native", "auto"),
                   help="host trajectory rasterizer: cv2 = exact reference parity "
                        "(quirk Q5); native = the port's dependency-free C++ library "
                        "(ops/host_rasterize.py); auto = native when it builds")
    p.add_argument("--seed", type=int, default=23123134)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--distributed", action="store_true",
                   help="multi-process run: not supported by the port yet (raises)")
    p.add_argument("--coordinator_address", default=None, help="with --distributed (not supported yet)")
    p.add_argument("--num_processes", type=int, default=None, help="with --distributed (not supported yet)")
    p.add_argument("--process_id", type=int, default=None, help="with --distributed (not supported yet)")
    p.add_argument("--n_model_shards", type=int, default=1, help="model-parallel shards: 1 (more raise)")
    p.add_argument("--no_gradient_checkpointing", action="store_true")
    # Memory options (TrainConfig docstrings).
    p.add_argument("--adam_mu_bf16", action="store_true",
                   help="bf16 Adam moments (stands in for the reference's --use_8bit_adam)")
    p.add_argument("--grad_accum_dtype", default=None, choices=(None, "float32", "bfloat16"),
                   help="storage dtype of the grad-accumulation buffer (default: fp32)")
    p.add_argument("--encode_outside_step", action="store_true",
                   help="run the frozen VAE/CLIP conditioning encodes before the micro-step")
    p.add_argument("--grads_bf16", action="store_true",
                   help="carry gradients in bf16 (fp32 masters stay in the optimizer)")
    p.add_argument("--tiny", action="store_true", help="tiny model bundle (smoke runs)")
    p.add_argument("--platform", choices=["default", "cpu"], default="default",
                   help="default: the CUDA device (raises without one); cpu: run on the CPU")
    return p.parse_args(argv)


def build_dataset(args, root: str = None, split_file: str = None):
    """Training dataset by default; pass `root` (+ optional `split_file`) to
    build the held-out validation dataset over a different folder with the
    same stage-specific layout."""
    from posetraj_torch.data import TrajectoryBlenderDataset, TrajectoryVIPSegDataset

    root = root or args.video_folder
    size = (args.height, args.width)
    if args.stage == "pretrain":
        return TrajectoryBlenderDataset(
            root, sample_size=size, frame_length=args.num_frames,
            images_bbox=args.images_bbox, return_bbox=args.bbox_supervision,
            filter_num=args.filter_num, cut_num=args.cut_num, seed=args.seed,
        )
    split = split_file or args.split_file or os.path.join(root, "train.txt")
    return TrajectoryVIPSegDataset(
        root, split, sample_size=size, frame_length=args.num_frames,
        return_cam=(args.stage == "ft_cam"), camera_path=args.cam_path,
        cam_mask_ratio=args.cam_mask_ratio if args.stage == "ft_cam" else 0.0,
        cam_norm=args.cam_norm, rasterizer=args.rasterizer, seed=args.seed,
    )


def variant_of(args) -> str:
    """The hint variant a stage trains: cam for ft_cam, bbox with
    --bbox_supervision, else base."""
    if args.stage == "ft_cam":
        return "cam"
    return "bbox" if args.bbox_supervision else "base"


def train_config(args):
    from posetraj_torch.configs import TrainConfig

    return TrainConfig(
        learning_rate=args.learning_rate,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        per_device_batch_size=args.per_device_batch_size,
        num_frames=args.num_frames,
        height=args.height,
        width=args.width,
        conditioning_dropout_prob=args.conditioning_dropout_prob,
        use_ema=args.use_ema,
        cam_mask_ratio=args.cam_mask_ratio,
        cam_norm=args.cam_norm,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        seed=args.seed,
        gradient_checkpointing=not args.no_gradient_checkpointing,
        adam_mu_bf16=args.adam_mu_bf16,
        grad_accum_dtype=args.grad_accum_dtype,
        encode_outside_step=args.encode_outside_step,
        grads_bf16=args.grads_bf16,
    )


def build_trainer(args, device=None):
    """(trainer, frozen params, controlnet dtypes): random parameters from
    args.seed (pipeline.init_params, whose ControlNet copies the UNet's
    encoder), frozen weights from --svd_root and the ControlNet from
    --controlnet_init where given."""
    from posetraj_torch.core.params import tree_map
    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.pipeline import ModelBundle, init_params
    from posetraj_torch.tools.convert_weights import load_diffusers_model_dir, params_from_diffusers
    from posetraj_torch.train import Trainer

    variant = variant_of(args)
    bundle = ModelBundle.tiny(variant) if args.tiny else ModelBundle.with_variant(variant)
    params = init_params(bundle, seed=args.seed, device=device)
    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    cn_params = params["controlnet"]
    if args.svd_root:
        for name, sub in (("unet", "unet"), ("vae", "vae"), ("clip", "image_encoder")):
            frozen[name] = params_from_diffusers(load_diffusers_model_dir(os.path.join(args.svd_root, sub)),
                                                 frozen[name], name)
        # from_unet weight copy for fresh ControlNets (controlnet_sdv.py:698-707)
        cn_params = cn.controlnet_from_unet(cn_params, frozen["unet"])
    if args.controlnet_init:
        cn_params = params_from_diffusers(load_diffusers_model_dir(args.controlnet_init), cn_params, "controlnet")
    trainer = Trainer(bundle, train_config(args), frozen, cn_params, device=device)
    return trainer, frozen, tree_map(lambda t: t.dtype, cn_params)


def write_param_audit(path: str, trainer, frozen) -> None:
    """rec_para.txt: trainable and frozen counts, then one line a ControlNet
    leaf."""
    from posetraj_torch.core.params import count_params, param_audit

    cn_params = trainer.state.controlnet_params
    with open(path, "w") as f:
        f.write(f"controlnet (trainable): {count_params(cn_params):,} params\n")
        f.write(f"frozen: {sum(count_params(v) for v in frozen.values()):,} params\n\n")
        f.write(param_audit(cn_params))


def train_loop(args, trainer, frozen, cn_dtypes, dataset, val_dataset, logger) -> int:
    """The epochs: batches from a PrefetchLoader over `dataset`,
    Trainer.step, a metrics line a micro-step, checkpoints with the
    diffusers exports every --checkpointing_steps, validation renders from
    `val_dataset` every --validation_steps, and a final checkpoint (unless
    the last step's was just written: the same state). Resumes the data
    order from trainer.state.step. Returns the last step."""
    from posetraj_torch.data.datasets import PrefetchLoader, epoch_batches
    from posetraj_torch.train import checkpoints as ckpt

    global_batch = args.per_device_batch_size
    loader = PrefetchLoader(dataset, global_batch, num_workers=args.num_workers)
    step = int(trainer.state.step)
    saved = None
    print(f"dataset: {len(dataset)} samples; batch {global_batch}; device {trainer.device}")

    def save_and_export(current_step: int):
        """The trainer's state + the diffusers-layout ControlNet AND its EMA
        twin — the reference's save hook writes both controlnet/ and
        controlnet_ema/ (train...blender_14.py:940-947)."""
        cdir = ckpt.save_checkpoint(args.output_dir, current_step, trainer, args.checkpoints_total_limit)
        ckpt.export_diffusers(trainer.state.controlnet_params, "controlnet", os.path.join(cdir, "controlnet"))
        if trainer.state.ema_params is not None:
            ckpt.export_diffusers(trainer.state.ema_params, "controlnet", os.path.join(cdir, "controlnet_ema"))

    try:
        # Resume fast-forward: continue the data order of an uninterrupted run
        # by skipping already-consumed batches of the restored epoch
        # (train...blender_14.py:1174-1197, 1209-1212). One batch == one
        # trainer micro-step, so the restored step count maps onto batches.
        bpe = epoch_batches(len(dataset), global_batch)
        start_epoch, skip = divmod(step, bpe)
        for epoch in range(start_epoch, args.num_train_epochs):
            for batch in loader.epoch(seed=args.seed + epoch, skip_batches=skip if epoch == start_epoch else 0):
                metrics = trainer.step(batch)
                step = int(trainer.state.step)
                logger.log(step, metrics)
                if step % 50 == 0:
                    print(f"step {step} loss {float(metrics['loss']):.4f}")
                if step and step % args.checkpointing_steps == 0:
                    save_and_export(step)
                    saved = step
                if args.validation_steps and step and step % args.validation_steps == 0:
                    run_validation(args, trainer, frozen, cn_dtypes, val_dataset, step)
                if args.max_train_steps and step >= args.max_train_steps:
                    break
            if args.max_train_steps and step >= args.max_train_steps:
                break
    finally:
        loader.close()
    if saved != step:  # the state of `step` is on disk already if it was just saved
        ckpt.save_checkpoint(args.output_dir, step, trainer, args.checkpoints_total_limit)
    print(f"done at step {step}")
    return step


def validation_params(trainer, frozen, cn_dtypes):
    """The pipeline's parameters from the trainer: the frozen models and the
    EMA (else the live) ControlNet, its float32 masters cast back to the
    dtypes the ControlNet was built in."""
    import torch

    from posetraj_torch.core.params import cast_like

    st = trainer.state
    controlnet = st.ema_params if st.ema_params is not None else st.controlnet_params
    with torch.no_grad():
        controlnet = cast_like(controlnet, cn_dtypes)
    return {"unet": frozen["unet"], "vae": frozen["vae"], "clip": frozen["clip"], "controlnet": controlnet}


def validation_sample(pipe, sample, args):
    """One validation render: a dataset sample (arrays in [-1, 1]) ->
    (F, H, W, 3) float32 in [0, 1]."""
    return pipe(
        (sample["pixel_values"][:1] + 1.0) / 2.0, (sample["trajectories"][None] + 1.0) / 2.0,
        height=args.height, width=args.width, num_frames=args.num_frames,
        num_inference_steps=args.num_inference_steps,
        camera_cond=(sample["cam_parameter"][None] if "cam_parameter" in sample else None),
        bbox_condition=((sample["bbox_trajectories"][None] + 1.0) / 2.0 if "bbox_trajectories" in sample else None),
        seed=args.seed,
    )[0]


def run_validation(args, trainer, frozen, cn_dtypes, val_dataset, current_step: int) -> str:
    """Render held-out samples (val_dataset, --validation_folder) with the
    in-training ControlNet and save side-by-side GIFs (the reference's
    eyeball-validation loop, train_svd_traj_blender_14.py:1418-1495).
    Returns the directory written."""
    from posetraj_torch.data import export
    from posetraj_torch.pipeline import SVDControlNetPipeline

    pipe = SVDControlNetPipeline(validation_params(trainer, frozen, cn_dtypes), trainer.bundle,
                                 device=trainer.device, compute_dtype=trainer.compute_dtype)
    vdir = os.path.join(args.output_dir, f"validation-{current_step}")
    for i in range(min(args.num_validation_samples, len(val_dataset))):
        s = val_dataset[i]
        out = validation_sample(pipe, s, args)
        export.save_side_by_side_gif(
            [(s["pixel_values"] + 1) / 2, (s["trajectories"] + 1) / 2, out],
            os.path.join(vdir, f"sample{i}.gif"),
        )
    print(f"validation GIFs -> {vdir}")
    return vdir


def main(argv=None):
    args = parse_args(argv)
    if args.distributed or args.n_model_shards > 1:
        raise NotImplementedError(f"--distributed / --n_model_shards {args.n_model_shards}: {NO_PARALLEL}")
    from posetraj_torch.train import checkpoints as ckpt
    from posetraj_torch.utils import MetricsLogger

    device = "cpu" if args.platform == "cpu" else None
    trainer, frozen, cn_dtypes = build_trainer(args, device)
    os.makedirs(args.output_dir, exist_ok=True)
    write_param_audit(os.path.join(args.output_dir, "rec_para.txt"), trainer, frozen)
    logger = MetricsLogger(args.output_dir)

    if args.resume_from_checkpoint:
        path = (
            ckpt.latest_checkpoint(args.output_dir)
            if args.resume_from_checkpoint == "latest"
            else args.resume_from_checkpoint
        )
        if path:
            ckpt.restore_checkpoint(path, trainer)
            print(f"resumed from {path} at step {int(trainer.state.step)}")

    dataset = build_dataset(args)
    if args.validation_folder:
        val_split = args.validation_split_file or (
            None if args.stage == "pretrain"
            else os.path.join(args.validation_folder, "val.txt")
        )
        val_dataset = build_dataset(args, root=args.validation_folder, split_file=val_split)
        if hasattr(val_dataset, "cam_mask_ratio"):
            val_dataset.cam_mask_ratio = 0.0  # no random cam dropout at eval
    else:
        # Reference behavior is a dedicated held-out folder; rendering train
        # samples cannot reveal overfitting — warn but stay usable.
        print("WARNING: no --validation_folder; validation renders use TRAINING samples")
        val_dataset = dataset
    try:
        train_loop(args, trainer, frozen, cn_dtypes, dataset, val_dataset, logger)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
