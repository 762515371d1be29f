"""The float32 reference against the program's plain path (its CPU
versions of every kernel, float32) at the small configurations: a video
(every stage of the pipeline) and a training micro-step (loss and the
gradient of every ControlNet leaf)."""

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import model as ref
from benchmark.reference.tree import leaves, tree_map
from benchmark.tests import tiny
from benchmark.weights import Weights


def _weights(variant):
    from posetraj_torch.pipeline.svd_controlnet import ModelBundle, init_params

    bundle = ModelBundle.tiny(variant)
    return bundle, Weights(init_params(bundle, device="meta", compute_dtype=torch.float32), 5, "cpu")


def test_video_matches_the_program():
    from posetraj_torch.pipeline.svd_controlnet import SVDControlNetPipeline

    bundle, w = _weights("base")
    tr = tiny.VIDEO
    req = inputs.video_request(3, 0, tr)
    nz = inputs.video_noises(3, 0, tr, 4, 8, "cpu")
    pipe = SVDControlNetPipeline(w.tree, bundle, device="cpu")
    kw = dict(height=tr["height"], width=tr["width"], num_frames=tr["frames"], num_inference_steps=tr["steps"],
              decode_chunk_size=tr["decode_chunk"], noises=nz)
    frames = torch.from_numpy(pipe(req["image"], req["control"], **kw))
    latents = torch.from_numpy(np.asarray(pipe(req["image"], req["control"], output_type="latent", **kw)))
    want_frames, want_latents = ref.sample_video(ref.Ops(), w.tree, tiny.cfg("base"), tr,
                                                 torch.from_numpy(req["image"]), torch.from_numpy(req["control"]),
                                                 nz["latents"], nz["image_aug"])
    # Both sides in float32 (eps 1.2e-7), summed in other orders, and the
    # sampler carries each step's rounding into the next: 1e-3. The fp8
    # control reads ~0.3 here.
    assert float((latents - want_latents).norm() / want_latents.norm()) < 1e-3
    assert float((frames - want_frames).norm() / (want_frames * 2 - 1).norm()) < 1e-3


def test_training_micro_step_matches_the_program():
    from posetraj_torch.train.trainer import Trainer

    bundle, w = _weights("bbox")
    cfg = tiny.cfg("bbox")
    tcfg = __import__("benchmark.config", fromlist=["train_config"]).train_config(cfg, 7)
    trainer = Trainer(bundle, tcfg, {k: w.tree[k] for k in ("unet", "vae", "clip")}, w.tree["controlnet"],
                      device="cpu")
    batch = inputs.train_batch(3, 0, tiny.TRAIN, "cpu")
    loss = float(trainer.step(batch)["loss"])
    gen = torch.Generator("cpu")
    gen.manual_seed(7)
    draws = ref.draw_step(gen, 1, tiny.TRAIN["frames"], (16, 16, 4), "cpu")
    cn = tree_map(lambda t: t.detach().float().clone().requires_grad_(True), w.tree["controlnet"])
    want = ref.edm_loss(ref.Ops(remat=True), cn, w.tree, cfg, cfg["train"], batch, draws)
    grads = torch.autograd.grad(want, list(leaves(cn)), allow_unused=True)  # to_q, to_k: one key
    assert abs(loss - float(want)) < 1e-5 * abs(float(want))
    norms = np.array([0.0 if g is None else float(g.norm()) for g in grads])
    got = np.array([float(a.norm()) for a in trainer.state.grad_acc])
    assert np.max(np.abs(got - norms) / np.maximum(norms, np.median(norms))) < 1e-3
