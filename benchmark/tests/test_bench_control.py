"""The controls must come out not correct against the cells' limits: the
reference with fp8 operands in the program's place (the bfloat16 compute
one step lower), and the reference's VAE encoder one step below the
float32 the configuration states (bfloat16 operands here; TF32 products
on the card, where TF32 exists). At the small size on the CPU here; at the
cells' own sizes on the card (marked cuda), through benchmark/calibrate.py,
which the limits were set from."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.config import ROOT
from benchmark.drivers import train, video
from benchmark.harness import Check
from benchmark.reference import model as ref
from benchmark.tests import tiny


def _limits(cell):
    return json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())


def _fails(values, cell):
    return any(not Check(k, v, lim).ok for k, (v, lim) in ((k, (values[k], l)) for k, l in _limits(cell).items()))


def test_video_control_is_not_correct():
    from posetraj_torch.pipeline.svd_controlnet import ModelBundle, init_params

    from benchmark.weights import Weights

    w = Weights(init_params(ModelBundle.tiny(), device="meta", compute_dtype=torch.float32), 8, "cpu")
    tr, cfg = tiny.VIDEO, tiny.cfg("base")
    req, nz = inputs.video_request(8, 0, tr), inputs.video_noises(8, 0, tr, 4, 8, "cpu")
    args = (w.tree, cfg, tr, torch.from_numpy(req["image"]), torch.from_numpy(req["control"]), nz["latents"],
            nz["image_aug"])
    want, got = {}, {}
    want_frames, want_latents = ref.sample_video(ref.Ops(), *args, keep=want)
    frames, latents = ref.sample_video(ref.Ops(fp8=True), *args, keep=got)
    assert _fails(video.readings(frames.numpy(), latents, got["encode"], want_frames, want_latents, want["encode"]),
                  "base.video-576x1024")


@pytest.mark.parametrize("cell", ["base.video-576x1024", "base.video-320x576"])
def test_video_encode_control_is_not_correct(cell):
    r = tiny.run(cell)
    prog = video.Program(r)
    want = video.encode_reference(r, prog, 0)
    got = video.encode_reference(r, prog, 0, "bf16")
    assert not Check("encode_rel_rms", video.rel_rms(got, want), _limits(cell)["encode_rel_rms"]).ok


def test_training_encode_control_is_not_correct():
    r = tiny.run("bbox.train-320x576")
    prog = train.Program(r)
    batches, weights = prog.batches, prog.weights
    prog.free()
    want = train.encode_reference(r, weights, 1, batches)
    got = train.encode_reference(r, weights, 1, batches, "bf16")
    assert not Check("encode_rel_rms", train.encode_gap(got, want), _limits("bbox.train-320x576")["encode_rel_rms"]).ok


def test_training_control_is_not_correct():
    r = tiny.run("bbox.train-320x576")
    prog = train.Program(r)
    batches, weights = prog.batches, prog.weights
    prog.free()
    want = train.reference(r, weights, 1, batches)
    got = train.reference(r, weights, 1, batches, fp8=True)
    assert _fails({**train.readings(got, want), "update_gap": 0.0, "ema_gap": 0.0}, "bbox.train-320x576")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["base.video-320x576", "bbox.train-320x576"])
def test_control_at_the_cells_size_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell, "--seeds", "5",
                          "--mode", "control"], cwd=ROOT, capture_output=True, text=True, check=True)
    values = json.loads(out.stdout.strip().splitlines()[0])
    assert _fails(values, cell)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["base.video-320x576", "bbox.train-320x576"])
def test_tf32_encode_control_at_the_cells_size_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 and the cell's own size")
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell, "--seeds", "5",
                          "--mode", "encode"], cwd=ROOT, capture_output=True, text=True, check=True)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["control_fails_every_seed"]["tf32.encode_rel_rms"]
    assert summary["max"]["encode_rel_rms"] <= _limits(cell)["encode_rel_rms"]
