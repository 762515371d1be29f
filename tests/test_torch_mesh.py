"""The port's ("data", "model") mesh (parallel/mesh.py) under Trainer(mesh=),
the checkpoints, SVDControlNetPipeline(mesh=) and the training CLI's
--distributed / --n_model_shards, on gloo CPU processes, in float32.

The shard rule is held to the JAX package's param_shardings on the tiny
trees, leaf by leaf through the bridge's layout map (no JAX compile). The
rest is held to the port's own unsharded Trainer, pipeline and CLI, which
tests/test_torch_train.py, test_torch_pipeline.py and test_torch_drivers.py
hold to the JAX package; tests/test_train.py holds the JAX package's
sharded trainer to its unsharded one.

Ranks: tests/helpers/torch_mesh_rank.py, four processes on (2, 2), then two
on (2, 1) and (1, 2) and the CLI (never more than four at once), one torch
thread each, 60 s process-group timeouts, each group killed after
RANKS_TIMEOUT_S; this process computes the references while they run.
The model is the two-level one of test_torch_train.py (its deepest level
4x4) with the ControlNet's zero convs made random, so that gradients reach
the split transformer weights; global batch 4, accumulation 2, two
optimizer updates.

Tolerances: losses, update norms, masters, EMA and checkpoint tensors
within 1e-5 of the reference (per leaf, relative to its largest entry);
Adam moments within 1e-5 of the tree's largest moment of their kind (a
leaf whose gradient nearly cancels keeps the float32 noise of its summed
terms); frames within the spread of the unsharded pipeline from initial
latents one float32 ulp apart, measured here (1.5e-4 on this model; the
batch split moved them by 1.8e-5; the first Euler step's float32
cancellation at sigma_max = 700 amplifies any reordering, see
tests/test_torch_pipeline.py; the JAX package's sharded serving test
allows 2e-3). The batch split changes float32 summation orders only; every
rank's state is bitwise the same.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_cli import _make_fixture

REPO = Path(__file__).resolve().parents[1]
RANK = REPO / "tests" / "helpers" / "torch_mesh_rank.py"
RANKS_TIMEOUT_S = 240
B, F, H, W = 4, 2, 64, 64
TOL = 1e-5
UNET_KW = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 4),
               layers_per_block=1, cross_attention_dim=16, addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=24, num_frames=F)
HINT_KW = dict(block_out_channels=(4, 8, 8, 16), embedding_channels=32)
TRAIN_KW = dict(num_frames=F, height=H, width=W, gradient_accumulation_steps=2, lr_warmup_steps=2,
                learning_rate=1e-3, adam_epsilon=1e-4, gradient_checkpointing=False)
SEED = 23123134


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(root: Path):
    """The models, TrainConfig, four global batches, the pipeline's inputs
    and the CLI's arguments (over a Blender-layout folder under root)."""
    from posetraj_torch import configs
    from posetraj_torch.pipeline import ModelBundle, init_params

    u = configs.UNetConfig(**UNET_KW)
    bundle = ModelBundle(unet=u, controlnet=configs.ControlNetConfig(unet=u, hint=configs.HintEncoderConfig(**HINT_KW)),
                         vae=configs.VAEConfig.tiny(), clip=configs.CLIPVisionConfig.tiny())
    params = init_params(bundle, seed=3, device="cpu")
    cp = params["controlnet"]
    rng = np.random.RandomState(300)
    with torch.no_grad():
        for head in cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"],
                                                   cp["controlnet_cond_embedding"]["stack"]["conv_out"]]:
            for t in head.values():
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.05))
    rng = np.random.RandomState(0)
    batches = [{"pixel_values": (rng.rand(B, F, H, W, 3) * 2 - 1).astype(np.float32),
                "trajectories": (rng.rand(B, F, H, W, 3) * 2 - 1).astype(np.float32),
                "motion_values": rng.uniform(60, 200, (B,)).astype(np.float32)} for _ in range(4)]
    serve = (rng.rand(B, H, W, 3).astype(np.float32), rng.rand(B, F, H, W, 3).astype(np.float32),
             dict(height=H, width=W, num_frames=F, num_inference_steps=2, seed=5))
    _make_fixture(str(root / "data"))
    cli_args = ["--stage", "pretrain", "--video_folder", str(root / "data"), "--tiny", "--height", "64",
                "--width", "64", "--num_frames", "2", "--cut_num", "1", "--num_train_epochs", "3",
                "--learning_rate", "1e-3", "--checkpointing_steps", "2", "--max_train_steps", "2",
                "--validation_steps", "0", "--num_workers", "2", "--seed", str(SEED), "--platform", "cpu"]
    return {"bundle": bundle, "tcfg": configs.TrainConfig(**TRAIN_KW), "params": params, "controlnet": cp,
            "frozen": {k: params[k] for k in ("unet", "vae", "clip")}, "batches": batches, "serve": serve,
            "cli_args": cli_args}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(root: Path, world: int, port: int = 0):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(root / f"rank{world}_{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(RANK), "--dir", str(root), "--world", str(world),
                                        "--rank", str(r), "--port", str(port)], env=env, cwd=str(REPO),
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(root: Path, world: int, procs):
    """Every rank's output; kills the group and fails on a rank's error or
    on overrun."""
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (root / f"rank{world}_{bad[0]}.log").read_text()[-3000:]
        pytest.fail(f"mesh ranks {bad} of world {world} failed or overran:\n{tail}")
    return [torch.load(root / f"out{world}_{r}.pt", weights_only=False) for r in range(world)]


def _nudged_serve(inp):
    """The unsharded pipeline from initial latents one float32 ulp above
    the seed's: the spread of float32 noise through the denoise loop."""
    from posetraj_torch.pipeline import SVDControlNetPipeline

    image, control, kw = inp["serve"]
    gen = torch.Generator()
    gen.manual_seed(kw["seed"])
    lat = torch.randn((B, F, H // 8, W // 8, 4), generator=gen)
    noises = {"latents": torch.nextafter(lat, torch.full_like(lat, np.inf)),
              "image_aug": torch.randn(image.shape, generator=gen)}
    pipe = SVDControlNetPipeline(inp["params"], inp["bundle"], device="cpu")
    return pipe(image, control, noises=noises, **{k: v for k, v in kw.items() if k != "seed"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' outputs and the unsharded references."""
    sys.path.insert(0, str(RANK.parent))
    import torch_mesh_rank as helper

    from posetraj_torch.train import restore_checkpoint, save_checkpoint

    root = tmp_path_factory.mktemp("mesh")
    inp = _inputs(root)
    torch.save(inp, root / "inputs.pt")
    ref = {}
    four = _launch(root, 4)
    try:
        trainer, ref["train"] = helper.train(inp, None, range(2))
        save_checkpoint(str(root / "ref_ckpt"), 2, trainer)
        _, rest = helper.train(inp, None, range(2, 4), trainer)
        for k, v in rest.items():
            ref["train"][k] += v
        ref["serve"] = helper.serve(inp, None)
        ref["serve_floor"] = float(np.abs(_nudged_serve(inp) - ref["serve"]).max())
    finally:
        out4 = _wait(root, 4, four)
    two = _launch(root, 2, _free_port())
    try:
        resumed = helper.train(inp, None, range(0))[0]
        restore_checkpoint(str(root / "ckpt" / "checkpoint-2"), resumed)
        ref["resumed_none"] = helper.train(inp, None, range(2, 4), resumed)[1]
        ref["cli_rows"] = helper.cli_run(inp["cli_args"] + ["--output_dir", str(root / "cli_one")])
    finally:
        out2 = _wait(root, 2, two)
    return {"inp": inp, "ref": ref, "out4": out4, "out2": out2, "root": root}


def _close(got, want, what, scale=None):
    """|got - want| within TOL of want's largest entry (or of `scale`)."""
    got, want = torch.as_tensor(got).detach().double(), torch.as_tensor(want).detach().double()
    assert got.shape == want.shape, what
    if not want.numel():
        return
    err, scale = float((got - want).abs().max()), scale or float(want.abs().max())
    assert err <= TOL * max(scale, 1e-30), f"{what}: {err:.3g} off, scale {scale:.3g}"


def _moment_scales(moments):
    """The largest entry of each kind of Adam moment over the tree: a leaf
    whose gradient nearly cancels carries the float32 noise of the terms
    summed into it, which the tree's scale bounds, not the leaf's."""
    kinds = {k for e in moments.values() for k in e}
    return {k: max(float(e[k].abs().max()) for e in moments.values() if k in e) for k in kinds}


def _same_state(got, want, what):
    for k in ("controlnet", "ema", "grad_acc"):
        assert len(got[k]) == len(want[k]) > 0
        for i, (g, w) in enumerate(zip(got[k], want[k])):
            _close(g, w, f"{what} {k}[{i}]")
    assert got["moments"].keys() == want["moments"].keys()
    scales = _moment_scales(want["moments"])
    for i, entry in want["moments"].items():
        for k, w in entry.items():
            _close(got["moments"][i][k], w, f"{what} moment {i}.{k}", scales[k])


def _same_run(got, want, what, grad_norm=True):
    """Metrics of every micro-step, update norms, and the state after every
    update."""
    assert len(got["metrics"]) == len(want["metrics"])
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        keys = set(w) if grad_norm else set(w) - {"grad_norm"}
        assert keys <= set(g), (what, i)
        for k in keys:
            _close(g[k], w[k], f"{what} micro-step {i + 1} {k}")
    for i, (g, w) in enumerate(zip(got["update_norm"], want["update_norm"])):
        _close(g, w, f"{what} update norm {i + 1}")
    assert len(got["snapshots"]) == len(want["snapshots"])
    for i, (g, w) in enumerate(zip(got["snapshots"], want["snapshots"])):
        _same_state(g, w, f"{what} after update {i + 1}")


def _bitwise_alike(outs, key):
    """Every rank's run (its state_dict after each update) bitwise rank 0's."""
    first = outs[0][key]["snapshots"]
    for r, o in enumerate(outs[1:], 1):
        for a, b in zip(o[key]["snapshots"], first):
            for k in ("controlnet", "ema", "grad_acc"):
                assert all(torch.equal(x, y) for x, y in zip(a[k], b[k])), (key, r, k)


def _jax_name_map(flat_jax):
    """JAX leaf name -> (port name, part): kernel/scale -> weight; an attn1's
    to_q / to_k / to_v kernels -> its wqkv."""
    out = {}
    for name in flat_jax:
        path = name.split(".")
        if len(path) >= 3 and path[-3] == "attn1" and path[-2] in ("to_q", "to_k", "to_v"):
            out[name] = (".".join(path[:-2] + ["wqkv"]), path[-2])
        elif path[-1] in ("kernel", "scale"):
            out[name] = (".".join(path[:-1] + ["weight"]), None)
        else:
            out[name] = (name, None)
    return out


@pytest.mark.parametrize("model", ["unet", "controlnet"])
def test_param_shardings_match_jax(model):
    """The port's rule on the port's layout of ModelBundle.tiny()'s tree is
    JAX's param_shardings(tree, make_mesh(4, 2)) leaf by leaf: the JAX
    column axis (-1) is dim 0, the row axis (-2) dim 1, wqkv split in its
    three parts wherever to_q, to_k and to_v are."""
    import jax
    from jax.sharding import PartitionSpec as P

    from posetraj_torch.core.bridge import params_from_jax
    from posetraj_torch.core.params import flatten_dict
    from posetraj_torch.parallel.mesh import Mesh, param_shardings
    from posetraj_tpu.core.params import flatten_dict as jflatten
    from posetraj_tpu.models import controlnet as jcn, unet as ju
    from posetraj_tpu.parallel.mesh import make_mesh as jmake_mesh, param_shardings as jparam_shardings
    from posetraj_tpu.pipeline.svd_controlnet import ModelBundle

    bundle = ModelBundle.tiny()
    key = jax.random.PRNGKey(0)
    tree = ju.init_unet(key, bundle.unet) if model == "unet" else jcn.init_controlnet(key, bundle.controlnet)
    want_specs = {k: v.spec for k, v in jflatten(jparam_shardings(tree, jmake_mesh(4, 2))).items()}
    shapes = {k: np.shape(v) for k, v in jflatten(tree).items()}
    port = params_from_jax(tree)
    got = {k: (s.axis, s.dim, s.parts) if s.sharded else None
           for k, s in flatten_dict(param_shardings(port, Mesh(4, 2, 0, torch.device("cpu")))).items()}
    want = {}
    for name, (port_name, part) in _jax_name_map(want_specs).items():
        spec, ndim = want_specs[name], len(shapes[name])
        if spec == P():
            expect = None
        elif part is not None:
            assert spec == P(None, "model"), name
            expect = ("model", 0, 3)
        else:
            axis = [i for i, a in enumerate(spec) if a == "model"]
            assert len(axis) == 1, (name, spec)
            expect = ("model", {ndim - 1: 0, ndim - 2: 1}[axis[0]] if ndim > 1 else 0, 1)
        assert want.setdefault(port_name, expect) == expect, port_name  # to_q, to_k, to_v alike
    assert got == want
    assert sum(v is not None for v in got.values()) > 20


def test_sharding_blocks():
    """Sharding.local on each model coordinate: wqkv's block is
    [Wq_m; Wk_m; Wv_m], a row split takes columns, and the blocks of every
    coordinate rebuild the whole (what Sharding.gather assembles); a batch
    that n_data does not divide raises."""
    from posetraj_torch.parallel.mesh import Mesh, Sharding, batch_sharding

    c = 8
    wqkv = torch.arange(3 * c * c, dtype=torch.float32).reshape(3 * c, c)
    out = torch.arange(c * 2 * c, dtype=torch.float32).reshape(c, 2 * c)
    for m in range(2):
        mesh = Mesh(1, 2, m, torch.device("cpu"))
        block = Sharding(mesh, "model", 0, 3).local(wqkv)
        want = torch.cat([part[m * c // 2:(m + 1) * c // 2] for part in wqkv.split(c)])
        assert torch.equal(block, want)
        assert torch.equal(Sharding(mesh, "model", 1).local(out), out[:, m * c:(m + 1) * c])
    blocks = [Sharding(Mesh(1, 2, m, torch.device("cpu")), "model", 0, 3).local(wqkv) for m in range(2)]
    whole = torch.stack([b.unflatten(0, (3, -1)) for b in blocks], dim=1).flatten(0, 2)
    assert torch.equal(whole, wqkv)
    with pytest.raises(ValueError, match="does not divide"):
        batch_sharding(Mesh(2, 1, 0, torch.device("cpu")), 1).local(torch.zeros(3, 4))


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "2x2"])
def test_mesh_training_matches_unsharded(runs, mesh):
    """Four micro-steps, two updates, on the global batch: loss and its
    parts, the update norms, masters, EMA and Adam moments as the unsharded
    Trainer's; grad_norm too where n_data is 1 (at n_data 2 the global
    micro-gradient is never formed); every rank's state bitwise alike."""
    outs = runs["out4"] if mesh == "2x2" else runs["out2"]
    key = f"train_{mesh}"
    _same_run(outs[0][key], runs["ref"]["train"], mesh, grad_norm=mesh == "1x2")
    if mesh != "1x2":
        assert all("grad_norm" not in m for m in outs[0][key]["metrics"])
    _bitwise_alike(outs, key)
    if mesh != "2x1":  # split leaves: each rank's masters at rest are smaller than the whole
        shards, whole = outs[1][key]["snapshots"][-1]["shards"], outs[1][key]["snapshots"][-1]["controlnet"]
        assert sum(s.numel() for s in shards) < sum(w.numel() for w in whole)


def test_checkpoint_under_mesh_is_the_unsharded_file(runs):
    """Rank 0 of (2, 2) writes, at step 2, the file the unsharded trainer
    writes: the same keys, step, scheduler and generator state, tensors
    within TOL."""
    from posetraj_torch.core.params import leaves
    from posetraj_torch.train.checkpoints import load_checkpoint

    got = load_checkpoint(str(runs["root"] / "ckpt" / "checkpoint-2"), map_location="cpu")
    want = load_checkpoint(str(runs["root"] / "ref_ckpt" / "checkpoint-2"), map_location="cpu")
    assert got.keys() == want.keys() and got["step"] == want["step"] == 2
    assert got["scheduler"] == want["scheduler"] and torch.equal(got["generator"], want["generator"])
    for k in ("controlnet", "ema", "grad_acc"):
        lg, lw = list(leaves(got[k])), list(leaves(want[k]))
        assert len(lg) == len(lw) > 0
        for i, (g, w) in enumerate(zip(lg, lw)):
            _close(g, w, f"{k}[{i}]")
    og, ow = got["optimizer"], want["optimizer"]
    assert og["param_groups"] == ow["param_groups"] and og["state"].keys() == ow["state"].keys()
    scales = _moment_scales({i: {k: v for k, v in e.items() if v.ndim} for i, e in ow["state"].items()})
    for i, entry in ow["state"].items():
        for k, v in entry.items():
            _close(og["state"][i][k], v, f"optimizer {i}.{k}", scales.get(k))


@pytest.mark.parametrize("into", ["1x2", "none"])
def test_checkpoint_restores_into_any_mesh(runs, into):
    """The (2, 2) checkpoint of step 2, restored into (1, 2) and into no
    mesh: micro-steps 3-4 and the update after them as the uninterrupted
    unsharded run's."""
    got = runs["out2"][0]["resumed_1x2"] if into == "1x2" else runs["ref"]["resumed_none"]
    want = runs["ref"]["train"]
    tail = {"metrics": want["metrics"][2:], "update_norm": want["update_norm"][1:],
            "snapshots": want["snapshots"][1:]}
    _same_run(got, tail, into)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_batched_serving_matches_unsharded(runs, mesh):
    """SVDControlNetPipeline(mesh=) on a batch of 4, 2 steps: every rank
    returns the whole batch, the unsharded pipeline's frames within the
    spread of a one-ulp change of the initial latents (module docstring)."""
    outs = runs["out4"] if mesh == "2x2" else runs["out2"]
    want, floor = runs["ref"]["serve"], runs["ref"]["serve_floor"]
    assert want.shape == (B, F, H, W, 3) and 0 < floor < 1e-3
    for o in outs:
        assert np.array_equal(o[f"serve_{mesh}"], outs[0][f"serve_{mesh}"])
        np.testing.assert_allclose(o[f"serve_{mesh}"], want, rtol=0, atol=floor)


def test_training_cli_distributed(runs):
    """--distributed --n_model_shards 2 on two ranks, a (1, 2) mesh: both
    ranks' loaders read the one data coordinate's rows, those of a
    one-process run; rank 0's logged losses and its checkpoint are the
    one-process run's."""
    import json

    from posetraj_torch.core.params import leaves
    from posetraj_torch.train.checkpoints import load_checkpoint

    root = runs["root"]
    rows = [o["cli_rows"] for o in runs["out2"]]
    assert rows[0] == rows[1] == runs["ref"]["cli_rows"] and len(rows[0]) == 2
    read = lambda d: [json.loads(x) for x in (d / "posetraj.metrics.jsonl").read_text().splitlines()]
    got, want = read(root / "cli_mesh"), read(root / "cli_one")
    assert [x["step"] for x in got] == [x["step"] for x in want] == [1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "loss_video", "loss_spatial"):
            _close(g[k], w[k], f"step {w['step']} {k}")
    sg = load_checkpoint(str(root / "cli_mesh" / "checkpoint-2"), map_location="cpu")
    sw = load_checkpoint(str(root / "cli_one" / "checkpoint-2"), map_location="cpu")
    for k in ("controlnet", "ema"):
        for i, (g, w) in enumerate(zip(leaves(sg[k]), leaves(sw[k]))):
            _close(g, w, f"{k}[{i}]")


@pytest.mark.parametrize("case", ["world", "batch", "serve_mesh"])
def test_mesh_guards(case):
    """A mesh that is not the job's size, a global batch that n_data does
    not divide (trainer and pipeline), and mesh with serve_mesh raise."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.parallel import make_serve_mesh
    from posetraj_torch.parallel.mesh import Mesh, make_mesh
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params
    from posetraj_torch.train import Trainer

    if case == "world":
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_mesh(2, 1, device="cpu")
        return
    bundle = ModelBundle.tiny()
    params = init_params(bundle, seed=0, device="cpu")
    if case == "serve_mesh":
        with pytest.raises(ValueError, match="mutually exclusive"):
            SVDControlNetPipeline(params, bundle, mesh=make_mesh(device="cpu"),
                                  serve_mesh=make_serve_mesh(1, 1, device="cpu"))
        return
    mesh = Mesh(2, 1, 0, torch.device("cpu"))  # no process group: the guard raises before any collective
    rng = np.random.RandomState(0)
    batch = {"pixel_values": rng.rand(3, 2, 64, 64, 3).astype(np.float32),
             "trajectories": rng.rand(3, 2, 64, 64, 3).astype(np.float32),
             "motion_values": np.full((3,), 127.0, np.float32)}
    trainer = Trainer(bundle, TrainConfig(num_frames=2, height=64, width=64), {k: params[k] for k in
                      ("unet", "vae", "clip")}, params["controlnet"], mesh=mesh)
    with pytest.raises(ValueError, match="does not divide"):
        trainer.step(batch)
    with pytest.raises(ValueError, match="does not divide"):
        SVDControlNetPipeline(params, bundle, mesh=mesh)(batch["pixel_values"][:, 0], batch["trajectories"],
                                                         height=64, width=64, num_frames=2, num_inference_steps=1)
