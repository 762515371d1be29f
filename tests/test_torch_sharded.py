"""Single-video sharded serving of the port (parallel/serve.py, spmd.py) on
gloo CPU processes, against the JAX package.

Two groups of ranks run tests/helpers/torch_sharded_rank.py at once, each
process with a process-group timeout of 60 s, joined through a FileStore
under tmp_path; the test waits at most RANKS_TIMEOUT_S for them and kills
them on overrun. Two ranks: every op contract over sp = 2 and
generate_sharded on a (1, 2) mesh; four ranks: the op contracts over sp = 4
and generate_sharded on (2, 2). While they run, this process computes the
references: the JAX package's unsharded ops, JAX generate_sharded on a
(2, 2) mesh of the 8 virtual CPU devices with output_latent (the file's one
JAX compile), and the port's own generate(). Float32 throughout.

Tolerances:
* op contracts against the JAX unsharded functions: 1e-5 for convolutions,
  2e-5 for GroupNorm and attention (sums in another order; the JAX
  package's own test of these contracts);
* the port's sharded latents against JAX generate_sharded's: 3e-3 of their
  max, the port-vs-JAX tolerance of tests/test_torch_pipeline.py (the first
  Euler step's float32 cancellation at sigma_max = 700);
* the port's sharded frames against its own generate(): atol 5e-4, rtol
  1e-3, the JAX package's sharded-vs-unsharded tolerance (GroupNorm
  statistics, gathered softmax and the CFG combine summed in another
  order);
* the port's temp hint embedding over sp = 2 against the JAX package's
  unsharded one: 2e-5.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.core.bridge import params_from_jax

REPO = Path(__file__).resolve().parents[1]
RANK = REPO / "tests" / "helpers" / "torch_sharded_rank.py"
# The whole of both rank groups' work, each well under it (seconds on one
# core each); a hung rendezvous fails here, not at the suite's limit.
RANKS_TIMEOUT_S = 240
H, F, STEPS = 64, 2, 2
WIDTH, WIDTH_REPLICATED = 256, 192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_inputs(width, seed=0):
    """The JAX package's test inputs (test_sharded_single_video._tiny_inputs),
    as numpy."""
    rng = np.random.default_rng(seed)
    image = rng.random((1, H, width, 3), np.float32)
    control = rng.random((1, F, H, width, 3), np.float32)
    noises = {"latents": rng.standard_normal((1, F, H // 8, width // 8, 4)).astype(np.float32),
              "image_aug": rng.standard_normal(image.shape).astype(np.float32)}
    return image, control, noises


def _jax_params():
    """The JAX test's tiny parameters (PRNGKey 7), with the zero convs made
    random so that the control video and the hint encoder's halo convs
    reach the output."""
    from posetraj_tpu.models import clip as jc, controlnet as jcn, unet as ju, vae as jv
    from posetraj_tpu.pipeline.svd_controlnet import ModelBundle

    bundle = ModelBundle.tiny()
    key = jax.random.PRNGKey(7)
    params = {"unet": ju.init_unet(key, bundle.unet), "controlnet": jcn.init_controlnet(key, bundle.controlnet),
              "vae": jv.init_vae(key, bundle.vae), "clip": jc.init_clip_vision(key, bundle.clip)}
    rng = np.random.RandomState(40)
    cp = params["controlnet"]
    for zc in cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"],
                                              cp["controlnet_cond_embedding"]["stack"]["conv_out"]]:
        zc["kernel"] = jnp.asarray(rng.randn(*zc["kernel"].shape).astype(np.float32) * 0.05)
    return params


def _op_inputs():
    """Numpy inputs of the op contracts: convolutions at the JAX test's
    geometries (weights OIHW for the port; the JAX side transposes), two
    GroupNorm+SiLU with an addend, q/k/v, and the replicated-level
    boundary."""
    rng = np.random.RandomState(11)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    convs = {
        "s1": (r(2, 8, 16, 6), r(8, 6, 3, 3) * 0.3, r(8), 1, ((1, 1), (1, 1))),
        "s2": (r(2, 8, 16, 6), r(8, 6, 3, 3) * 0.3, r(8), 2, ((1, 1), (1, 1))),
        "s2_asymmetric": (r(2, 8, 16, 6), r(8, 6, 3, 3) * 0.3, r(8), 2, ((0, 1), (0, 1))),
        "same": (r(3, 5, 8, 4), r(4, 4, 3, 3) * 0.3, r(4), 1, "SAME"),
        "1x1": (r(2, 4, 8, 4), r(6, 4, 1, 1) * 0.3, r(6), 1, "SAME"),
    }
    group_norms = {
        "per_sample": (r(2, 6, 8, 8) * 3 + 1, r(8) * 0.3 + 1, r(8) * 0.3, r(2, 8), 4),
        "per_frame": (r(2, 3, 4, 8, 8) * 3 + 1, r(8) * 0.3 + 1, r(8) * 0.3, r(2, 3, 8), 4),
    }
    q, k, v = r(3, 2, 32, 16)
    boundary = (r(2, 8, 16, 6), r(8, 6, 3, 3) * 0.3, r(8), r(6, 8, 3, 3) * 0.3, r(6))
    return {"convs": convs, "group_norms": group_norms, "attention": (q, k, v, 2), "boundary": boundary}


def _jax_op_refs(ops):
    """The JAX package's unsharded functions on the op inputs."""
    from posetraj_tpu.ops import primitives as jp
    from posetraj_tpu.ops.attention import attention

    conv = lambda w, b: {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)), "bias": jnp.asarray(b)}
    refs = {}
    for name, (x, w, b, stride, pad) in ops["convs"].items():
        refs[f"conv_{name}"] = jp.conv2d(conv(w, b), jnp.asarray(x), stride=stride, padding=pad)
    for name, (x, scale, bias, add, groups) in ops["group_norms"].items():
        refs[f"gn_{name}"] = jp.group_norm_silu({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                                jnp.asarray(x), groups, add=jnp.asarray(add))
    q, k, v, heads = ops["attention"]
    refs["attention"] = attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    x, down_w, down_b, up_w, up_b = ops["boundary"]
    down = jp.downsample_2x(conv(down_w, down_b), jnp.asarray(x))
    refs["boundary_down"] = down
    refs["boundary_up"] = jp.upsample_nearest_2x(conv(up_w, up_b), down)
    return {k: np.asarray(v) for k, v in refs.items()}


def _temp_hint_inputs():
    """The temp variant's hint encoder (JAX tiny parameters, conv_out made
    random) and a CFG-doubled control video; the JAX package's unsharded
    hint on them."""
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_tpu.models import controlnet as jcn
    from posetraj_tpu.pipeline import svd_controlnet as jpipe

    jcfg = jpipe.ModelBundle.tiny("temp").controlnet
    hint = jcn.init_controlnet(jax.random.PRNGKey(5), jcfg)["controlnet_cond_embedding"]
    conv_out = hint["stack"]["conv_out"]
    conv_out["kernel"] = jax.random.normal(jax.random.PRNGKey(6), conv_out["kernel"].shape) * 0.05
    control = np.random.RandomState(12).rand(2, F, H, WIDTH, 3).astype(np.float32) * 2 - 1
    want = np.asarray(jcn.hint_encoder(hint, jcfg.hint, jnp.asarray(control), F))
    return (params_from_jax(hint), ModelBundle.tiny("temp").controlnet.hint, control, F), want


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Starts both rank groups, computes the references while they run,
    waits for them; returns (outputs by world size, references)."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.pipeline import ModelBundle

    jparams = _jax_params()
    params = {name: params_from_jax(p) for name, p in jparams.items()}
    runs = {}
    for name, width in (("main", WIDTH), ("replicated", WIDTH_REPLICATED)):
        pcfg = PipelineConfig(height=H, width=width, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=1)
        runs[name] = (pcfg, *_tiny_inputs(width))
    ops = _op_inputs()
    temp_inputs, temp_want = _temp_hint_inputs()
    inputs = dict(ops, params=params, bundle=ModelBundle.tiny(), runs=runs, temp_hint=temp_inputs)
    procs, dirs = [], {}
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for world in (2, 4):
        d = dirs[world] = tmp_path_factory.mktemp(f"ranks{world}")
        torch.save(inputs, d / "inputs.pt")
        for rank in range(world):
            log = open(d / f"log_{rank}.txt", "w")
            procs.append((subprocess.Popen([sys.executable, str(RANK), "--dir", str(d), "--world", str(world),
                                            "--rank", str(rank)], stdout=log, stderr=subprocess.STDOUT, env=env,
                                           cwd=str(REPO)), log, d / f"log_{rank}.txt"))
    try:
        refs = {"ops": _jax_op_refs(ops), "temp_hint": temp_want}
        refs.update(_references(jparams, params, runs))
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        for proc, _, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, log, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    failed = [(p.returncode, path.read_text()[-3000:]) for p, _, path in procs if p.returncode != 0]
    assert not failed, failed
    outs = {world: [torch.load(dirs[world] / f"out_{r}.pt", weights_only=False) for r in range(world)]
            for world in (2, 4)}
    return outs, refs


def _references(jparams, params, runs):
    """JAX generate_sharded's latents on a (2, 2) mesh; the port's
    generate() latents and frames of both runs."""
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference
    from posetraj_tpu.parallel.serve import generate_sharded, make_serve_mesh
    from posetraj_tpu.pipeline import svd_controlnet as jpipe

    refs = {}
    pcfg, image, control, noises = runs["main"]
    jbundle = jpipe.ModelBundle.tiny()
    jpcfg = jpipe.PipelineConfig(height=H, width=WIDTH, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=1)
    jsched = jpipe.make_schedule(jbundle.scheduler, STEPS)
    refs["jax_latents"] = np.asarray(generate_sharded(
        jparams, jbundle, jpcfg, jnp.asarray(image), jnp.asarray(control), noises,
        jnp.asarray(jpipe.added_time_ids_inference(jpcfg)), jnp.asarray(jsched.sigmas), jnp.asarray(jsched.timesteps),
        F, make_serve_mesh(2, 2, devices=jax.devices()[:4]), output_latent=True))
    bundle = ModelBundle.tiny()
    sched = make_schedule(bundle.scheduler, STEPS)
    for name, (pcfg, image, control, noises) in runs.items():
        for latent in (True, False):
            refs[(name, latent)] = generate(params, bundle, pcfg, image, control, noises,
                                            added_time_ids_inference(pcfg), sched.sigmas, sched.timesteps, F,
                                            output_latent=latent, device="cpu").numpy()
    return refs


OPS = ["conv_s1", "conv_s2", "conv_s2_asymmetric", "conv_same", "conv_1x1", "gn_per_sample", "gn_per_frame",
       "attention", "boundary_down", "boundary_up"]
# Ops whose output is replicated on every rank rather than W-sharded.
REPLICATED_OPS = ("boundary_down",)


@pytest.mark.parametrize("world", [2, 4], ids=["sp2", "sp4"])
@pytest.mark.parametrize("op", OPS)
def test_op_contract_matches_jax_unsharded(sharded, world, op):
    outs, refs = sharded
    want = refs["ops"][op]
    blocks = [o["ops"][op].numpy() for o in outs[world]]
    if op in REPLICATED_OPS:
        assert all(np.array_equal(b, blocks[0]) for b in blocks)
        got = blocks[0]
    else:
        got = np.concatenate(blocks, axis=1 if op == "attention" else -2)
    assert got.shape == want.shape
    tol = 1e-5 if op.startswith("conv") else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("world", [2, 4], ids=["mesh1x2", "mesh2x2"])
def test_generate_sharded_latents_match_jax(sharded, world):
    outs, refs = sharded
    want = refs["jax_latents"]
    for o in outs[world]:  # every rank returns the full latents
        got = o["latents"].numpy()
        assert got.shape == want.shape == (1, F, H // 8, WIDTH // 8, 4)
        err = float(np.abs(got - want).max())
        assert err <= 3e-3 * float(np.abs(want).max()), err


@pytest.mark.parametrize("world", [2, 4], ids=["mesh1x2", "mesh2x2"])
def test_generate_sharded_frames_match_generate(sharded, world):
    outs, refs = sharded
    want = refs[("main", False)]
    frames = [o["frames"].numpy() for o in outs[world]]
    assert all(np.array_equal(f, frames[0]) for f in frames)  # every rank returns the same video
    assert frames[0].shape == want.shape == (1, F, H, WIDTH, 3)
    np.testing.assert_allclose(frames[0], want, atol=5e-4, rtol=1e-3)


def test_replicated_deepest_level_matches_generate(sharded):
    """Width 192 on (2, 2): latent W 24 -> 12 -> 6 -> 3, so the deepest level
    and the mid block run replicated (the downsampler into them gathers W,
    the upsampler out scatters it); the frames still match generate()."""
    outs, refs = sharded
    want = refs[("replicated", False)]
    got = outs[4][0]["replicated_frames"].numpy()
    assert got.shape == want.shape == (1, F, H, WIDTH_REPLICATED, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)


def test_collectives_a_step(sharded):
    """The collectives of one denoise step on (2, 2), counted by call: a
    halo exchange for each of the 76 3x3 convolutions of ControlNet + UNet,
    an all-reduce of A's statistics for each of the 152 GroupNorms, a K and
    a V all-gather for each of the 23 spatial self-attentions, the Q7 table
    gathered over cfg in each of the 23 transformers, one CFG all-reduce.
    The tiny bundle has the flagship's topology, so these are the flagship's
    counts over (2, 4) too; no level replicates here (no gather_w)."""
    outs, _ = sharded
    want = {"halo_exchange_w": 76, "psum_spatial": 152, "all_gather_tokens": 46, "gather_w": 0,
            "all_gather_cfg": 23, "psum_cfg": 1}
    assert all(o["collectives"] == want for o in outs[4]), [o["collectives"] for o in outs[4]]


def test_temp_hint_matches_unsharded(sharded):
    """The temp variant's hint over sp = 2 against the JAX package's
    unsharded hint: its GroupNorm sums statistics over the whole video on
    both ranks, and its frame transformer runs with the spatial context
    suspended."""
    outs, refs = sharded
    want = refs["temp_hint"]
    got = np.concatenate([o["temp_hint"].numpy() for o in outs[2]], axis=-2)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_generate_sharded_1x1_in_process(sharded):
    """A (1, 1) mesh needs no process group and runs the same code: equal to
    generate() up to the CFG combine's rounding, and to JAX
    generate_sharded's latents within the port-vs-JAX tolerance."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.parallel import generate_sharded, make_serve_mesh
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference

    _, refs = sharded
    params = {name: params_from_jax(p) for name, p in _jax_params().items()}
    image, control, noises = _tiny_inputs(WIDTH)
    pcfg = PipelineConfig(height=H, width=WIDTH, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=1)
    bundle = ModelBundle.tiny()
    sched = make_schedule(bundle.scheduler, STEPS)
    mesh = make_serve_mesh(1, 1, device="cpu")
    run = lambda latent: generate_sharded(params, bundle, pcfg, image, control, noises,
                                          added_time_ids_inference(pcfg), sched.sigmas, sched.timesteps, F, mesh,
                                          output_latent=latent).numpy()
    latents, frames = run(True), run(False)
    np.testing.assert_allclose(latents, refs[("main", True)], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(frames, refs[("main", False)], atol=5e-4, rtol=1e-3)
    want = refs["jax_latents"]
    assert float(np.abs(latents - want).max()) <= 3e-3 * float(np.abs(want).max())


def test_pipeline_with_serve_mesh_matches_plain_pipeline():
    """SVDControlNetPipeline(serve_mesh=) sends a batch-1 call through
    generate_sharded: on a (1, 1) mesh the same video as without it."""
    from posetraj_torch.parallel import make_serve_mesh
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params

    bundle = ModelBundle.tiny()
    params = init_params(bundle, seed=3, device="cpu")
    image, control, _ = _tiny_inputs(64)
    call = lambda pipe: pipe(image, control, height=H, width=64, num_frames=F, num_inference_steps=STEPS, seed=7)
    want = call(SVDControlNetPipeline(params, bundle, device="cpu"))
    got = call(SVDControlNetPipeline(params, bundle, serve_mesh=make_serve_mesh(1, 1, device="cpu")))
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
