"""The port's two drivers on the CPU with the tiny bundle (--platform cpu), no
JAX compile: the inference driver (posetraj_torch/inference.py) and the
training CLI (posetraj_torch/train/cli.py). They are held against the
port's own pipeline and Trainer, which the other tests hold against the
JAX package, fed the JAX package's preprocessing and loader:

* inference, vipseg mode: pred/, gt/ and the GIF are written, and the
  predicted frames are those of a direct pipeline call on the JAX driver's
  inputs (the PIL-resized first frame, the JAX rasterize_cv2 control),
  bitwise; blender mode with --bbox likewise, against a direct call with
  bbox_condition on the JAX package's TrajectoryBlenderDataset sample, and
  vipseg_cam against the cam variant called with a zero camera.
* training: rec_para.txt, the JSONL, checkpoints rotated to
  --checkpoints_total_limit, the controlnet/ and controlnet_ema/ exports
  and a validation GIF are written; the final state is bitwise that of a
  Trainer fed the JAX PrefetchLoader's batches of the same fixture, and the
  exports are its parameters; a run resumed at step 2 ends bitwise at the
  uninterrupted run's step-4 state; --n_model_shards 2 without
  --distributed, and --distributed without a coordinator or torchrun's
  environment, raise (tests/test_torch_mesh.py runs --distributed).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_cli import _make_fixture
from test_data import _make_blender_fixture
from test_inference_cli import _make_vipseg_fixture

SEED = 23123134


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_inference_vipseg_matches_a_direct_pipeline_call(tmp_path):
    from posetraj_tpu.data.export import _to_uint8
    from posetraj_torch.inference import main
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params

    data, out = tmp_path / "data", tmp_path / "results"
    _make_vipseg_fixture(str(data))
    main(["--mode", "vipseg", "--data_root", str(data), "--out_dir", str(out), "--tiny", "--height", "64",
          "--width", "64", "--num_frames", "2", "--steps", "2", "--limit", "1", "--platform", "cpu"])
    vid = out / "vid_x"
    pred = sorted(os.listdir(vid / "pred"))
    assert len(pred) == 2 and len(os.listdir(vid / "gt")) == 2 and (vid / "side_by_side.gif").exists()

    image, control = _vipseg_inputs(data)
    bundle = ModelBundle.tiny()
    pipe = SVDControlNetPipeline(init_params(bundle, seed=0, device="cpu"), bundle, device="cpu")
    want = pipe(image[None], control[None], height=64, width=64, num_frames=2, num_inference_steps=2,
                motion_bucket_id=10, controlnet_cond_scale=1.0, seed=SEED)[0]
    for i, name in enumerate(pred):
        assert np.array_equal(_png(vid / "pred" / name), _to_uint8(want[i]))


def _live_init_params(bundle, seed=0, device=None, compute_dtype=None):
    """pipeline.init_params with the ControlNet's zero convs, its hint
    stacks' zero conv_out and the cam variant's identity projection made
    random from `seed`, so that the control video and the variant's
    condition reach the frames (with the init's zeros they cannot)."""
    from posetraj_torch.pipeline.svd_controlnet import init_params

    params = init_params(bundle, seed=seed, device=device, compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(seed + 100)
    cp = params["controlnet"]
    hint = cp["controlnet_cond_embedding"]
    layers = cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"]]
    layers += [hint[k]["conv_out"] for k in ("stack", "stack_2") if k in hint]
    layers += [hint["cc_projection"]] if "cc_projection" in hint else []
    for layer in layers:
        w = layer["weight"]
        layer["weight"] = (torch.randn(w.shape, generator=gen) * 0.05).to(w.dtype)
    return params


def _vipseg_inputs(data):
    """The JAX driver's preprocessing of the VIPSeg fixture
    (posetraj_tpu/inference.py run_vipseg): the PIL-resized first frame and
    the rasterize_cv2 control, 64x64, 2 frames."""
    from posetraj_tpu.data.trajectories import load_cotracker_json, scale_to_target, trajectories_to_array
    from posetraj_tpu.ops.rasterize import rasterize_cv2

    first = Image.open(data / "imgs" / "vid_x" / "0000.jpg").convert("RGB")
    image = np.asarray(first.resize((64, 64), Image.BILINEAR), np.float32) / 255.0
    traj = trajectories_to_array(load_cotracker_json(str(data / "trajectory_CoTracker_all" / "vid_x.json")))
    pts = scale_to_target(traj[:, :2], (first.height, first.width), (64, 64))
    return image, rasterize_cv2(pts, 2, (64, 64)).astype(np.float32) / 255.0


def test_inference_blender_bbox_runs(tmp_path, monkeypatch):
    """blender --bbox: the bbox variant's frames are, bitwise, those of a
    direct pipeline call with bbox_condition on the JAX package's
    TrajectoryBlenderDataset sample (return_bbox, the driver's arguments).
    The driver's parameters are made with live ControlNet heads, so the bbox
    maps reach the frames: zero maps give another video."""
    import posetraj_torch.pipeline
    from posetraj_tpu.data import TrajectoryBlenderDataset
    from posetraj_tpu.data.export import _to_uint8
    from posetraj_torch.inference import main
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline

    monkeypatch.setattr(posetraj_torch.pipeline, "init_params", _live_init_params)

    data, out = tmp_path / "data", tmp_path / "results"
    _make_blender_fixture(str(data), n_videos=1, n_frames=3)
    vdir = data / "obj_0_circle"
    os.makedirs(vdir / "bbox")
    for i in range(4):
        Image.fromarray(np.full((48, 80, 3), 40 * i, np.uint8)).save(vdir / "bbox" / f"{i:04d}.png")
    main(["--mode", "blender", "--bbox", "--data_root", str(data), "--out_dir", str(out), "--tiny", "--height",
          "64", "--width", "64", "--num_frames", "2", "--steps", "2", "--limit", "1", "--platform", "cpu"])
    (key,) = os.listdir(out)
    assert key.startswith("obj_0_circle_0_")
    pred = sorted(os.listdir(out / key / "pred"))
    assert len(pred) == 2 and (out / key / "side_by_side.gif").exists()

    s = TrajectoryBlenderDataset(str(data), sample_size=(64, 64), frame_length=2, repeat_times=1, return_bbox=True,
                                 seed=0)[0]
    assert s["img_key"] == key
    bundle = ModelBundle.tiny("bbox")
    pipe = SVDControlNetPipeline(_live_init_params(bundle, seed=0, device="cpu"), bundle, device="cpu")
    call = lambda bbox: pipe(((s["pixel_values"][0] + 1.0) / 2.0)[None], ((s["trajectories"] + 1.0) / 2.0)[None],
                             height=64, width=64, num_frames=2, num_inference_steps=2, seed=SEED,
                             bbox_condition=bbox[None])[0]
    want = call((s["bbox_trajectories"] + 1.0) / 2.0)
    for i, name in enumerate(pred):
        assert np.array_equal(_png(out / key / "pred" / name), _to_uint8(want[i]))
    assert not np.array_equal(_to_uint8(call(np.zeros_like(s["bbox_trajectories"]))), _to_uint8(want))


def test_inference_vipseg_cam_runs(tmp_path, monkeypatch):
    """vipseg_cam: the cam variant, fed no camera, as the reference's cam
    driver: bitwise a direct pipeline call of the cam variant with a zero
    camera on the JAX driver's inputs. With live ControlNet heads and a
    random camera projection the camera reaches the frames: another camera
    gives another video."""
    import posetraj_torch.pipeline
    from posetraj_tpu.data.export import _to_uint8
    from posetraj_torch.inference import main
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline

    monkeypatch.setattr(posetraj_torch.pipeline, "init_params", _live_init_params)

    data, out = tmp_path / "data", tmp_path / "results"
    _make_vipseg_fixture(str(data))
    main(["--mode", "vipseg_cam", "--data_root", str(data), "--out_dir", str(out), "--tiny", "--height", "64",
          "--width", "64", "--num_frames", "2", "--steps", "2", "--platform", "cpu"])
    pred = sorted(os.listdir(out / "vid_x" / "pred"))
    assert len(pred) == 2 and (out / "vid_x" / "side_by_side.gif").exists()

    image, control = _vipseg_inputs(data)
    bundle = ModelBundle.tiny("cam")
    pipe = SVDControlNetPipeline(_live_init_params(bundle, seed=0, device="cpu"), bundle, device="cpu")
    call = lambda cam: pipe(image[None], control[None], height=64, width=64, num_frames=2, num_inference_steps=2,
                            motion_bucket_id=10, controlnet_cond_scale=1.0, seed=SEED, camera_cond=cam[None])[0]
    want = call(np.zeros((2, bundle.controlnet.hint.camera_dim), np.float32))
    for i, name in enumerate(pred):
        assert np.array_equal(_png(out / "vid_x" / "pred" / name), _to_uint8(want[i]))
    other = call(np.full((2, bundle.controlnet.hint.camera_dim), 2.0, np.float32))
    assert not np.array_equal(_to_uint8(other), _to_uint8(want))


def test_drivers_load_diffusers_weight_dirs(tmp_path):
    """--svd_root (unet/, vae/, image_encoder/) and --checkpoint /
    --controlnet_init (a ControlNet dir) in the diffusers layout reach the
    pipeline's and the trainer's parameters, bitwise."""
    from safetensors.numpy import save_file

    from posetraj_torch.core.params import leaves
    from posetraj_torch.inference import build_pipeline
    from posetraj_torch.pipeline import ModelBundle, init_params
    from posetraj_torch.tools.convert_weights import params_to_diffusers
    from posetraj_torch.train import cli

    src = init_params(ModelBundle.tiny(), seed=5, device="cpu")
    for name, sub in (("unet", "svd/unet"), ("vae", "svd/vae"), ("clip", "svd/image_encoder"),
                      ("controlnet", "cn")):
        os.makedirs(tmp_path / sub)
        save_file(params_to_diffusers(src[name], name), str(tmp_path / sub / "model.safetensors"))

    def same(a, b):
        la, lb = list(leaves(a)), list(leaves(b))
        return len(la) == len(lb) > 0 and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))

    pipe = build_pipeline(str(tmp_path / "cn"), str(tmp_path / "svd"), tiny=True, device="cpu")
    assert all(same(pipe.params[k], src[k]) for k in src)
    args = cli.parse_args(["--stage", "pretrain", "--video_folder", str(tmp_path), "--tiny", "--platform", "cpu",
                           "--svd_root", str(tmp_path / "svd"), "--controlnet_init", str(tmp_path / "cn")])
    trainer, frozen, _ = cli.build_trainer(args, "cpu")
    assert all(same(frozen[k], src[k]) for k in frozen)
    assert same(trainer.state.controlnet_params, src["controlnet"])


def _train_args(data, out, *extra):
    return ["--stage", "pretrain", "--video_folder", str(data), "--output_dir", str(out), "--tiny",
            "--height", "64", "--width", "64", "--num_frames", "2", "--cut_num", "1", "--num_train_epochs", "3",
            "--learning_rate", "1e-3", "--checkpointing_steps", "2", "--num_inference_steps", "2",
            "--num_validation_samples", "1", "--num_workers", "2", "--seed", str(SEED), "--platform", "cpu", *extra]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The training CLI for 4 micro-steps (two optimizer updates, over two
    epochs of the fixture's one video, repeat 2): checkpoints every 2, at
    most one kept, a validation render at step 4."""
    from posetraj_torch.train.cli import main

    root = tmp_path_factory.mktemp("train")
    _make_fixture(str(root / "data"))
    main(_train_args(root / "data", root / "out", "--max_train_steps", "4", "--validation_steps", "4",
                     "--checkpoints_total_limit", "1"))
    return root


def _state(path):
    from posetraj_torch.train.checkpoints import load_checkpoint

    return load_checkpoint(str(path), map_location="cpu")


def _assert_state_equal(a, b):
    from posetraj_torch.core.params import leaves

    assert a["step"] == b["step"]
    for k in ("controlnet", "ema", "grad_acc"):
        la, lb = list(leaves(a[k])), list(leaves(b[k]))
        assert len(la) == len(lb) > 0
        assert all(torch.equal(x, y) for x, y in zip(la, lb)), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["param_groups"] == ob["param_groups"] and list(oa["state"]) == list(ob["state"])
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])), (i, k)
    assert a["scheduler"] == b["scheduler"]
    assert torch.equal(a["generator"], b["generator"])


def test_train_cli_writes_its_outputs(uninterrupted):
    out = uninterrupted / "out"
    audit = (out / "rec_para.txt").read_text()
    assert audit.startswith("controlnet (trainable): ") and "\ncontrolnet_cond_embedding" not in audit and " controlnet_cond_embedding." in audit
    lines = [json.loads(x) for x in (out / "posetraj.metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    assert all(np.isfinite(x["loss"]) and {"loss", "grad_norm", "time"} <= set(x) for x in lines)
    ckpts = sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))
    assert ckpts == ["checkpoint-4"]  # checkpoint-2 rotated away (limit 1)
    assert sorted(os.listdir(out / "checkpoint-4")) == ["controlnet.safetensors", "controlnet_ema.safetensors",
                                                        "state.pt"]
    assert (out / "validation-4" / "sample0.gif").exists()
    assert os.listdir(out / "tb" / "posetraj")


def test_train_cli_state_is_a_trainer_fed_the_jax_loader(uninterrupted):
    from safetensors.numpy import load_file

    from posetraj_tpu.data import TrajectoryBlenderDataset
    from posetraj_tpu.data.datasets import PrefetchLoader
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.pipeline import ModelBundle, init_params
    from posetraj_torch.tools.convert_weights import params_to_diffusers
    from posetraj_torch.train import Trainer

    bundle = ModelBundle.tiny("base")
    p = init_params(bundle, seed=SEED, device="cpu")
    trainer = Trainer(bundle, TrainConfig(learning_rate=1e-3, num_frames=2, height=64, width=64, seed=SEED),
                      {k: p[k] for k in ("unet", "vae", "clip")}, p["controlnet"], device="cpu")
    ds = TrajectoryBlenderDataset(str(uninterrupted / "data"), sample_size=(64, 64), frame_length=2, cut_num=1,
                                  seed=SEED)
    loader = PrefetchLoader(ds, 1, num_workers=2)
    try:
        for epoch in (0, 1):
            for batch in loader.epoch(seed=SEED + epoch):
                trainer.step(batch)
    finally:
        loader.close()
    assert trainer.state.step == 4
    ckpt = uninterrupted / "out" / "checkpoint-4"
    _assert_state_equal(_state(ckpt), trainer.state_dict())
    for name, params in (("controlnet", trainer.state.controlnet_params), ("controlnet_ema", trainer.state.ema_params)):
        got, want = load_file(str(ckpt / f"{name}.safetensors")), params_to_diffusers(params, "controlnet")
        assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want), name


def test_train_cli_resume_is_bitwise(uninterrupted, tmp_path):
    from posetraj_torch.train.cli import main

    out = tmp_path / "out"
    main(_train_args(uninterrupted / "data", out, "--max_train_steps", "2", "--validation_steps", "0"))
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) == ["checkpoint-2"]
    main(_train_args(uninterrupted / "data", out, "--max_train_steps", "4", "--validation_steps", "0",
                     "--resume_from_checkpoint", "latest"))
    _assert_state_equal(_state(out / "checkpoint-4"), _state(uninterrupted / "out" / "checkpoint-4"))
    lines = [json.loads(x) for x in (out / "posetraj.metrics.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (uninterrupted / "out" / "posetraj.metrics.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in x.items() if k != "time"} for x in lines] == [
        {k: v for k, v in x.items() if k != "time"} for x in want]


@pytest.mark.parametrize("flag", [["--distributed"], ["--n_model_shards", "2"]], ids=["distributed", "shards"])
def test_train_cli_refuses_parallel_runs(tmp_path, monkeypatch, flag):
    """Model shards without --distributed (one process, one device), and
    --distributed with neither a coordinator nor torchrun's environment."""
    from posetraj_torch.train.cli import main

    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--distributed|coordinator"):
        main(_train_args(tmp_path / "data", tmp_path / "out", *flag))
