"""The hint encoder's variants (bbox, cam, rot, entity, temp) in the port
against the JAX package's, float32 on the CPU, at the tiny configs, on the
same parameters (params_from_jax) and the same numpy inputs; their
conditions through generate() and the pipeline.

Every zero-initialised leaf of the hint encoder (conv_out, stack_2's
conv_out, entity_in, entity_out) and the camera projection are given random
values, so each condition reaches the output: with the identity init of
cc_projection a transposed or shifted camera block would not show.

Tolerance: the hint embedding within 1e-5 of its max (float32 summation
order through a conv stack and, for temp, a GroupNorm and a transformer
block). The cam variant's generate() against the JAX package's is in
test_torch_pipeline.py, which shares that file's JAX parameters.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.core.bridge import params_from_jax

VARIANTS = ["base", "bbox", "cam", "rot", "entity", "temp"]
B, F, H, W = 2, 2, 64, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(p: dict, seed: int) -> dict:
    """The JAX hint-encoder tree `p`, given random weights in place in every
    zero-init leaf and in the camera projection."""
    rng = np.random.RandomState(seed)
    rnd = lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.1)
    nodes = [p["stack"]["conv_out"]] + [p[k] for k in ("entity_in", "entity_out", "cc_projection") if k in p]
    if "stack_2" in p:
        nodes.append(p["stack_2"]["conv_out"])
    for node in nodes:
        node["kernel"], node["bias"] = rnd(node["kernel"]), rnd(node["bias"])
    return p


def _conditions(cfg, seed: int = 7) -> dict:
    rng = np.random.RandomState(seed)
    return {
        "cond": rng.rand(B, F, H, W, 3).astype(np.float32) * 2 - 1,
        "bbox_cond": rng.rand(B, F, H, W, 3).astype(np.float32) * 2 - 1,
        "camera_cond": rng.randn(B, F, cfg.camera_dim).astype(np.float32),
        "rot_id": np.array([1, 0], np.int32),
        "entity_cond": rng.randn(1, H // 8, W // 8, cfg.embedding_channels).astype(np.float32),
    }


def _jax_hint(variant, fidelity=False):
    from posetraj_tpu.configs import ControlNetConfig
    from posetraj_tpu.models import controlnet as jcn

    cfg = ControlNetConfig.tiny(variant).hint
    params = _randomise(jcn.init_hint_encoder(jax.random.PRNGKey(3), cfg), 11)
    d = _conditions(cfg)
    run = jax.jit(partial(jcn.hint_encoder, fidelity_shared_conv_out=fidelity), static_argnums=(1, 3))
    want = run(params, cfg, jnp.asarray(d["cond"]), F, bbox_cond=jnp.asarray(d["bbox_cond"]),
               camera_cond=jnp.asarray(d["camera_cond"]), rot_id=jnp.asarray(d["rot_id"]),
               entity_cond=jnp.asarray(d["entity_cond"]))
    return params, d, np.asarray(want)


def _port_hint(params, d, variant, fidelity=False, **override):
    from posetraj_torch.configs import ControlNetConfig
    from posetraj_torch.models import controlnet as tcn

    kw = {k: torch.from_numpy(d[k]) for k in ("bbox_cond", "camera_cond", "entity_cond")}
    kw["rot_id"] = torch.from_numpy(d["rot_id"]).long()
    kw.update(override)
    return tcn.hint_encoder(params, ControlNetConfig.tiny(variant).hint, torch.from_numpy(d["cond"]), F,
                            fidelity_shared_conv_out=fidelity, **kw).numpy()


@pytest.mark.parametrize("variant,fidelity", [(v, False) for v in VARIANTS] + [("bbox", True)])
def test_hint_encoder_matches_jax(variant, fidelity):
    from posetraj_torch.models import controlnet as tcn

    jparams, d, want = _jax_hint(variant, fidelity)
    tparams = params_from_jax(jparams)
    got = _port_hint(tparams, d, variant, fidelity)
    assert got.shape == want.shape == (B * F, H // 8, W // 8, 32)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), (err, float(np.abs(want).max()))
    if variant != "base":
        # The variant's own part reaches the output: it is not the conv
        # stack alone.
        stack = tcn._conv_stack(tparams["stack"], torch.from_numpy(d["cond"]).reshape(B * F, H, W, 3)).numpy()
        assert float(np.abs(got - stack).max()) > 1e-2 * float(np.abs(stack).max())


@pytest.mark.parametrize("variant,missing", [("bbox", "bbox_cond"), ("rot", "rot_id"), ("entity", "entity_cond")])
def test_hint_encoder_raises_without_its_condition(variant, missing):
    from posetraj_torch.configs import ControlNetConfig
    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as tcn

    cfg = ControlNetConfig.tiny(variant).hint
    params = tcn.init_hint_encoder(make_init(0, torch.device("cpu"), torch.float32), cfg)
    with pytest.raises(ValueError, match=f"{variant} variant requires {missing}"):
        _port_hint(params, _conditions(cfg), variant, **{missing: None})


def test_unknown_hint_variant_raises():
    from posetraj_torch.configs import ControlNetConfig
    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as tcn

    base = ControlNetConfig.tiny().hint
    params = tcn.init_hint_encoder(make_init(0, torch.device("cpu"), torch.float32), base)
    bad = dataclasses.replace(base, variant="depth")
    with pytest.raises(ValueError, match="unknown hint variant depth"):
        tcn.init_hint_encoder(make_init(0, torch.device("cpu"), torch.float32), bad)
    with pytest.raises(ValueError, match="unknown hint variant depth"):
        tcn.hint_encoder(params, bad, torch.zeros(1, 1, H, W, 3), 1)


def test_cam_without_camera_is_zero_camera_and_identity_init_ignores_it():
    """A missing camera_cond means zeros, as in JAX; with the port's own
    identity init of cc_projection the camera does not move the embedding
    (the conv stack's output passes through)."""
    from posetraj_torch.configs import ControlNetConfig
    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as tcn

    cfg = ControlNetConfig.tiny("cam").hint
    params = tcn.init_hint_encoder(make_init(0, torch.device("cpu"), torch.float32), cfg)
    co = params["stack"]["conv_out"]
    co["weight"] = torch.randn(co["weight"].shape, generator=torch.Generator().manual_seed(1)) * 0.1
    d = _conditions(cfg)
    none = _port_hint(params, d, "cam", camera_cond=None)
    zeros = _port_hint(params, d, "cam", camera_cond=torch.zeros(B, F, cfg.camera_dim))
    fives = _port_hint(params, d, "cam", camera_cond=torch.full((B, F, cfg.camera_dim), 5.0))
    np.testing.assert_array_equal(none, zeros)
    np.testing.assert_allclose(fives, zeros, atol=1e-6)
    assert float(np.abs(zeros).max()) > 0
    w = params["cc_projection"]["weight"]
    assert w.shape == (cfg.embedding_channels, cfg.embedding_channels + cfg.camera_dim)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}.{i}")
    else:
        yield prefix, tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("size", ["tiny", "flagship"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_params_from_jax_tree_matches_init(variant, size):
    """ModelBundle.tiny(v) / with_variant(v) give the same hint config in
    both packages, and params_from_jax of the JAX init has the structure,
    shapes and dtypes of the port's own init."""
    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as tcn
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_tpu.models import controlnet as jcn
    from posetraj_tpu.pipeline.svd_controlnet import ModelBundle as JaxBundle

    make = (lambda m: m.tiny(variant)) if size == "tiny" else (lambda m: m.with_variant(variant))
    cfg, jcfg = make(ModelBundle).controlnet.hint, make(JaxBundle).controlnet.hint
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = sorted(_paths(params_from_jax(jcn.init_hint_encoder(jax.random.PRNGKey(0), jcfg))))
    want = sorted(_paths(tcn.init_hint_encoder(make_init(0, torch.device("cpu"), torch.float32), cfg)))
    assert got == want


# --------------------------------------------------------------------------
# generate() and the pipeline (the cam variant's generate() against the JAX
# package's is in test_torch_pipeline.py, on that file's parameters)
# --------------------------------------------------------------------------


def test_generate_doubles_the_conditions_for_cfg(monkeypatch):
    """generate() hands the hint encoder bbox_cond mapped to [-1, 1], and
    camera_cond and rot_id, each doubled for the CFG batch."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate, init_params
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    class Seen(Exception):
        pass

    seen = {}

    def hint_encoder(params, cfg, cond, f, **kw):
        seen.update(kw, cond=cond, f=f)
        raise Seen

    monkeypatch.setattr(pipe_m.cn, "hint_encoder", hint_encoder)
    bundle = ModelBundle.tiny("bbox")
    rng = np.random.RandomState(5)
    image, control = rng.rand(1, H, W, 3).astype(np.float32), rng.rand(1, F, H, W, 3).astype(np.float32)
    bbox, camera = rng.rand(1, F, H, W, 3).astype(np.float32), rng.randn(1, F, 12).astype(np.float32)
    noises = {"latents": rng.randn(1, F, H // 8, W // 8, 4).astype(np.float32),
              "image_aug": rng.randn(1, H, W, 3).astype(np.float32)}
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=1)
    sched = make_schedule(bundle.scheduler, 1)
    with pytest.raises(Seen):
        generate(init_params(bundle, seed=0, device="cpu"), bundle, pcfg, image, control, noises,
                 pipe_m.added_time_ids_inference(pcfg), sched.sigmas, sched.timesteps, F, camera_cond=camera,
                 bbox_cond=bbox, rot_id=np.array([1]), device="cpu")
    mapped = bbox * 2 - 1
    np.testing.assert_allclose(seen["bbox_cond"].numpy(), np.concatenate([mapped, mapped]), atol=1e-6)
    np.testing.assert_array_equal(seen["camera_cond"].numpy(), np.concatenate([camera, camera]))
    assert seen["rot_id"].dtype == torch.long and seen["rot_id"].tolist() == [1, 1]
    np.testing.assert_allclose(seen["cond"].numpy(), np.concatenate([control, control]) * 2 - 1, atol=1e-6)
    assert seen["f"] == F


def test_entity_variant_raises_in_generate():
    """generate() takes no entity map (nor does the JAX package's), so the
    entity variant raises there."""
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate, init_params
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference

    bundle = ModelBundle.tiny("entity")
    rng = np.random.RandomState(6)
    noises = {"latents": rng.randn(1, F, H // 8, W // 8, 4).astype(np.float32),
              "image_aug": rng.randn(1, H, W, 3).astype(np.float32)}
    pcfg = PipelineConfig(height=H, width=W, num_frames=F, num_inference_steps=1)
    sched = make_schedule(bundle.scheduler, 1)
    with pytest.raises(ValueError, match="entity variant requires entity_cond"):
        generate(init_params(bundle, seed=0, device="cpu"), bundle, pcfg, rng.rand(1, H, W, 3), rng.rand(1, F, H, W, 3),
                 noises, added_time_ids_inference(pcfg), sched.sigmas, sched.timesteps, F, device="cpu")


def test_postprocess_pil_matches_jax():
    from posetraj_torch.pipeline import SVDControlNetPipeline
    from posetraj_tpu.pipeline.svd_controlnet import SVDControlNetPipeline as JaxPipeline

    frames = np.random.RandomState(3).rand(2, F, 8, 12, 3).astype(np.float32)
    got, want = SVDControlNetPipeline._postprocess(frames, "pil"), JaxPipeline._postprocess(frames, "pil")
    assert len(got) == len(want) == 2 and [len(v) for v in got] == [len(v) for v in want] == [F, F]
    for gv, wv in zip(got, want):
        for g, w in zip(gv, wv):
            assert g.size == w.size == (12, 8) and g.mode == w.mode
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for kind in ("np", "latent"):
        np.testing.assert_array_equal(SVDControlNetPipeline._postprocess(frames, kind),
                                      JaxPipeline._postprocess(frames, kind))


@pytest.mark.parametrize("variant", ["bbox", "cam", "rot", "temp"])
def test_pipeline_call_takes_the_variant_conditions(variant):
    """SVDControlNetPipeline with each variant on the CPU, one Euler step:
    the condition's argument reaches the latents (temp takes none: two
    calls agree); the cam variant's frames come back as PIL images."""
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params

    bundle = ModelBundle.tiny(variant)
    params = init_params(bundle, seed=3, device="cpu")
    hint = params["controlnet"]["controlnet_cond_embedding"]
    g = torch.Generator().manual_seed(9)
    for node in [hint["stack"]["conv_out"]] + ([hint["stack_2"]["conv_out"]] if variant == "bbox" else []):
        node["weight"] = torch.randn(node["weight"].shape, generator=g) * 0.1
    if variant == "cam":
        hint["cc_projection"]["weight"] = torch.randn(hint["cc_projection"]["weight"].shape, generator=g) * 0.1
    for zc in params["controlnet"]["controlnet_down_blocks"] + [params["controlnet"]["controlnet_mid_block"]]:
        zc["weight"] = torch.randn(zc["weight"].shape, generator=g) * 0.05
    pipe = SVDControlNetPipeline(params, bundle, device="cpu")
    rng = np.random.RandomState(2)
    image, control = rng.rand(1, H, W, 3).astype(np.float32), rng.rand(1, F, H, W, 3).astype(np.float32)
    extra = {"bbox": lambda s: {"bbox_condition": np.random.RandomState(s).rand(1, F, H, W, 3).astype(np.float32)},
             "cam": lambda s: {"camera_cond": np.random.RandomState(s).randn(1, F, 12).astype(np.float32)},
             "rot": lambda s: {"rot_id": np.array([s % 2])},
             "temp": lambda s: {}}[variant]
    run = lambda s, output_type="latent": pipe(image, control, height=H, width=W, num_frames=F,
                                               num_inference_steps=1, seed=7, output_type=output_type, **extra(s))
    a = run(0)
    assert a.shape == (1, F, H // 8, W // 8, 4) and np.isfinite(a).all()
    if variant == "cam":
        frames = run(1, "pil")
        assert len(frames) == 1 and len(frames[0]) == F and frames[0][0].size == (W, H)
        b = pipe(image, control, height=H, width=W, num_frames=F, num_inference_steps=1, seed=7,
                 output_type="latent", camera_cond=None)
    else:
        b = run(1)
    if variant == "temp":
        np.testing.assert_array_equal(a, b)
    else:
        assert float(np.abs(a - b).max()) > 1e-4
