"""The whole slice: the port's `generate()` against the JAX package's, at the
tiny bundle, 2 Euler steps, on the same parameters (params_from_jax) and the
same injected noise, float32 on the CPU; again with the cam hint variant and
a camera, on the same parameters. Plus the port's entry-point rules:
it imports nothing of JAX, and without a GPU it runs on the CPU only when
asked to.

Tolerance for the slice: 3e-3 of the latents' max and 3e-3 absolute on the
[0, 1] frames, where single modules and the composed step agree to ~3e-6.
The first Euler step starts from latents of size sqrt(700^2 + 1) and returns
O(1) latents as a difference of two ~700-sized float32 values (ulp 6e-5), so
each framework's own rounding leaves ~1e-4 on O(1) latents, and the per-frame
guidance (up to 3x cond - uncond) amplifies it into the second step;
measured 4.7e-4 relative on the latents and 6.9e-4 on the frames.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.core.bridge import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

H = W = 64
F = 2
STEPS = 2


@pytest.fixture(scope="module")
def slice_inputs():
    from posetraj_tpu.models import clip as jc, controlnet as jcn, unet as ju, vae as jv
    from posetraj_tpu.pipeline.svd_controlnet import ModelBundle

    bundle = ModelBundle.tiny()
    key = jax.random.PRNGKey(0)
    params = {
        "unet": ju.init_unet(key, bundle.unet),
        "controlnet": jcn.init_controlnet(jax.random.PRNGKey(1), bundle.controlnet),
        "vae": jv.init_vae(key, bundle.vae),
        "clip": jc.init_clip_vision(key, bundle.clip),
    }
    # Randomise the zero convs so the control video reaches the output.
    rng = np.random.RandomState(40)
    cp = params["controlnet"]
    for zc in cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"], cp["controlnet_cond_embedding"]["stack"]["conv_out"]]:
        zc["kernel"] = jnp.asarray(rng.randn(*zc["kernel"].shape).astype(np.float32) * 0.05)
    rng = np.random.RandomState(41)
    data = {
        "image": rng.rand(1, H, W, 3).astype(np.float32),
        "control": rng.rand(1, F, H, W, 3).astype(np.float32),
        "noises": {"latents": rng.randn(1, F, H // 8, W // 8, 4).astype(np.float32),
                   "image_aug": rng.randn(1, H, W, 3).astype(np.float32)},
    }
    return bundle, params, data


@pytest.fixture(scope="module")
def jax_outputs(slice_inputs):
    from posetraj_tpu.configs import PipelineConfig
    from posetraj_tpu.diffusion.euler_karras import make_schedule
    from posetraj_tpu.pipeline.svd_controlnet import added_time_ids_inference, decode_latents, generate

    bundle, params, d = slice_inputs
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=F)
    sched = make_schedule(bundle.scheduler, STEPS)
    latents = generate(params, bundle, pcfg, d["image"], d["control"], d["noises"], added_time_ids_inference(pcfg),
                       sched.sigmas, sched.timesteps, F, output_latent=True)
    # generate() decodes the same latents in float32 on the CPU; run that
    # tail alone rather than compiling the whole program a second time.
    frames = jax.jit(decode_latents, static_argnums=(1, 3))(params, bundle, latents, F)
    return np.asarray(latents), np.asarray(jnp.clip(frames / 2.0 + 0.5, 0.0, 1.0))


def _port_generate(slice_inputs, output_latent):
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference

    _, params, d = slice_inputs
    bundle = ModelBundle.tiny()
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=F)
    sched = make_schedule(bundle.scheduler, STEPS)
    tparams = {name: params_from_jax(p) for name, p in params.items()}
    out = generate(tparams, bundle, pcfg, d["image"], d["control"], d["noises"], added_time_ids_inference(pcfg),
                   sched.sigmas, sched.timesteps, F, output_latent=output_latent, device="cpu")
    return out.numpy()


def test_generate_latents_match_jax(slice_inputs, jax_outputs):
    got, want = _port_generate(slice_inputs, True), jax_outputs[0]
    assert got.shape == want.shape == (1, F, H // 8, W // 8, 4)
    err = float(np.abs(got - want).max())
    assert err <= 3e-3 * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def test_generate_frames_match_jax(slice_inputs, jax_outputs):
    got, want = _port_generate(slice_inputs, False), jax_outputs[1]
    assert got.shape == want.shape == (1, F, H, W, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=3e-3, rtol=0)


def test_cam_generate_matches_jax(slice_inputs):
    """The cam hint variant through generate(), on the slice's parameters
    with a random camera projection cc_projection (332 -> 320 at full
    width; the identity init would hide a transposed or shifted camera
    block) and a non-zero camera_cond, against the JAX package's. The
    camera moves the latents by more than the tolerance."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference
    from posetraj_tpu.pipeline import svd_controlnet as jpipe

    _, base, d = slice_inputs
    jbundle = jpipe.ModelBundle.tiny("cam")
    hint_cfg = jbundle.controlnet.hint
    rng = np.random.RandomState(42)
    cc = {"kernel": jnp.asarray(rng.randn(hint_cfg.embedding_channels + hint_cfg.camera_dim,
                                          hint_cfg.embedding_channels).astype(np.float32) * 0.1),
          "bias": jnp.asarray(rng.randn(hint_cfg.embedding_channels).astype(np.float32) * 0.1)}
    controlnet = dict(base["controlnet"], controlnet_cond_embedding=dict(base["controlnet"]["controlnet_cond_embedding"],
                                                                        cc_projection=cc))
    params = dict(base, controlnet=controlnet)
    camera = rng.randn(1, F, hint_cfg.camera_dim).astype(np.float32)
    jpcfg = jpipe.PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=F)
    jsched = jpipe.make_schedule(jbundle.scheduler, STEPS)
    want = np.asarray(jpipe.generate(params, jbundle, jpcfg, d["image"], d["control"], d["noises"],
                                     jpipe.added_time_ids_inference(jpcfg), jsched.sigmas, jsched.timesteps, F,
                                     camera_cond=jnp.asarray(camera), output_latent=True))

    bundle = ModelBundle.tiny("cam")
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=F)
    sched = make_schedule(bundle.scheduler, STEPS)
    tparams = {name: params_from_jax(p) for name, p in params.items()}
    run = lambda cam: generate(tparams, bundle, pcfg, d["image"], d["control"], d["noises"],
                               added_time_ids_inference(pcfg), sched.sigmas, sched.timesteps, F, camera_cond=cam,
                               output_latent=True, device="cpu").numpy()
    got = run(camera)
    assert got.shape == want.shape == (1, F, H // 8, W // 8, 4)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 3e-3 * scale, (err, scale)
    assert float(np.abs(run(None) - got).max()) > 3e-2 * scale


@pytest.mark.parametrize("reload", [False, True])
def test_graph_step_matches_denoise(slice_inputs, reload):
    """DenoiseGraph's captured step (graph_step), run eagerly on the CPU on
    the graph's static buffers over a 2-step ladder, equals the eager loop
    bit for bit: the buffers, the device step index and its reads of
    sigmas[i], sigmas[i + 1] and timesteps[i]. With reload, the buffers are
    first loaded with other latents and then refilled, as a later request
    refills them."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline import svd_controlnet as pipe

    _, params, d = slice_inputs
    bundle = ModelBundle.tiny()
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=STEPS, decode_chunk_size=F)
    sched = make_schedule(bundle.scheduler, STEPS)
    tparams = {name: params_from_jax(p) for name, p in params.items()}
    rng = np.random.RandomState(43)
    t = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))
    latents = t(1, F, H // 8, W // 8, 4) * float(sched.sigmas[0])
    image_latents, clip, ids = t(2, H // 8, W // 8, 4), t(2, 1, bundle.clip.projection_dim), t(2, 3)
    control = torch.from_numpy(d["control"] * 2 - 1).repeat(2, 1, 1, 1, 1)
    sigmas, timesteps = torch.from_numpy(sched.sigmas), torch.from_numpy(sched.timesteps)
    guidance = torch.linspace(1.0, 3.0, F)
    dt = torch.float32
    with torch.inference_mode():
        want = pipe.denoise(tparams, bundle, pcfg, latents, image_latents, clip, control, ids, sigmas, timesteps,
                            guidance, dt)
        graph = pipe.DenoiseGraph()
        hint = pipe._hint(tparams, bundle, control, F, dt, None, None, None)
        img_lat, gs = pipe._image_latents(image_latents, latents, dt), pipe._guidance(guidance)
        for lat in ([latents + 1.0] if reload else []) + [latents]:
            ready = graph.load(tparams, bundle, pcfg, dt, latents=lat, image_latents=img_lat, clip=clip,
                               time_ids=ids, hint=hint, guidance=gs, sigmas=sigmas, timesteps=timesteps)
        assert not ready  # nothing was captured on the CPU
        for _ in range(STEPS):
            pipe.graph_step(tparams, bundle, pcfg, graph.buffers, dt)
    assert int(graph.buffers["step"]) == STEPS
    assert torch.equal(graph.buffers["latents"], want)


def test_graph_key_holds_the_parameters_weakly():
    """DenoiseGraph's key: the same parameter tensors refill the static
    buffers (a captured graph would serve); equal copies at other addresses
    make them anew (a graph would capture anew); and the key holds the
    tensors only weakly, so a dropped parameter tree is freed."""
    import gc
    import weakref

    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.core.params import leaves
    from posetraj_torch.pipeline import ModelBundle, init_params
    from posetraj_torch.pipeline import svd_controlnet as pipe

    bundle = ModelBundle.tiny()
    params = init_params(bundle, seed=3, device="cpu")
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=STEPS)
    inputs = {"latents": torch.zeros(1, F, H // 8, W // 8, 4), "sigmas": torch.ones(STEPS + 1)}
    graph = pipe.DenoiseGraph()
    graph.load(params, bundle, pcfg, torch.float32, **inputs)
    buffers = graph.buffers["latents"]
    graph.load(params, bundle, pcfg, torch.float32, **inputs)
    assert graph.buffers["latents"] is buffers
    clone = lambda tree: ({k: clone(v) for k, v in tree.items()} if isinstance(tree, dict)
                          else [clone(v) for v in tree] if isinstance(tree, list) else tree.clone())
    copy = clone(params)
    graph.load(copy, bundle, pcfg, torch.float32, **inputs)
    assert graph.buffers["latents"] is not buffers
    dropped = weakref.ref(next(leaves(copy["unet"])))
    del copy
    gc.collect()
    assert dropped() is None


def test_capture_launch_accounting():
    """A capture launches nothing: what the wrappers counted during it comes
    back out of LAUNCHES as the launches of one replay."""
    from posetraj_torch.ops import _native

    _native.reset_launches()
    _native.LAUNCHES["mlp"] += 2
    with _native.capturing_launches() as per_replay:
        _native.LAUNCHES["mlp"] += 3
        _native.LAUNCHES["groupnorm"] += 1
    assert _native.LAUNCHES["mlp"] == 2 and _native.LAUNCHES["groupnorm"] == 0
    assert per_replay["mlp"] == 3 and per_replay["groupnorm"] == 1 and per_replay["layernorm"] == 0
    for _ in range(4):
        _native.add_launches(per_replay)
    assert _native.LAUNCHES["mlp"] == 14 and _native.LAUNCHES["groupnorm"] == 4
    _native.reset_launches()


def test_pipeline_call_runs_on_cpu_when_asked():
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params

    bundle = ModelBundle.tiny()
    pipe = SVDControlNetPipeline(init_params(bundle, seed=3, device="cpu"), bundle, device="cpu")
    image = np.random.RandomState(0).rand(1, H, W, 3).astype(np.float32)
    control = np.random.RandomState(1).rand(1, F, H, W, 3).astype(np.float32)
    a = pipe(image, control, height=H, width=W, num_frames=F, num_inference_steps=STEPS, seed=7)
    b = pipe(image, control, height=H, width=W, num_frames=F, num_inference_steps=STEPS, seed=7)
    assert a.shape == (1, F, H, W, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    lat = pipe(image, control, height=H, width=W, num_frames=F, num_inference_steps=STEPS, output_type="latent")
    assert lat.shape == (1, F, H // 8, W // 8, 4)


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    """No GPU and no device=: the entry points raise instead of running on
    the CPU."""
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, generate, init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = ModelBundle.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(bundle, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        SVDControlNetPipeline({}, bundle)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate({}, bundle, None, None, None, {}, None, None, None, F)


def test_port_imports_no_jax():
    """Importing every port module loads neither jax nor posetraj_tpu."""
    code = (
        "import sys; before = set(sys.modules)\n"
        "import posetraj_torch.pipeline, posetraj_torch.core.bridge, posetraj_torch.ops._native\n"
        "import posetraj_torch.ops.groupnorm, posetraj_torch.ops.mlp, posetraj_torch.ops.qkvt, posetraj_torch.ops.temporal\n"
        "import posetraj_torch.ops.flash, posetraj_torch.ops.layernorm, posetraj_torch.ops.attention\n"
        "import posetraj_torch.configs, posetraj_torch.train, posetraj_torch.parallel, posetraj_torch.parallel.serve\n"
        "import posetraj_torch.utils, posetraj_torch.utils.profiling, posetraj_torch.tools.fill\n"
        "import posetraj_torch.tools.bench_train, posetraj_torch.tools.hub_configs, posetraj_torch.tools.parity_gate\n"
        "import posetraj_torch.tools.kernel_sweep, posetraj_torch.tools.convert_weights\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'posetraj_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parents[1]))
    assert res.returncode == 0, res.stdout + res.stderr
