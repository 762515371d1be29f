"""The port's primitives, scheduler and model modules against their JAX twins,
at tiny configs, in float32 on the CPU, after `params_from_jax` of the same
JAX-initialised parameters and on the same numpy inputs.

Tolerances: float32 summation-order noise, scaled to each output's size —
2e-5 for single ops, norms and the tiny CLIP tower, 1e-4 for blocks (a few
chained matmuls and convolutions). The VAE is in test_torch_vae.py, the
composed ControlNet -> UNet step in test_torch_step.py.
"""

from functools import partial

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


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _rel_close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = float(np.abs(g - w).max())
    assert err <= tol * max(float(np.abs(w).max()), 1e-6), (err, float(np.abs(w).max()))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _key(i):
    return jax.random.PRNGKey(i)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["linear", "conv_same", "conv_down", "conv_down_asym", "conv_temporal",
                                "upsample", "layer_norm", "geglu"])
def test_primitive_matches_jax(op):
    from posetraj_tpu.core.init import conv_init, linear_init, norm_init
    from posetraj_tpu.ops import primitives as jp
    from posetraj_torch.ops import primitives as tp

    x4 = _rand(0, 2, 9, 11, 16)
    if op == "linear":
        p = linear_init(_key(0), 16, 24)
        want, got = jp.linear(p, jnp.asarray(x4)), tp.linear(params_from_jax(p), _t(x4))
    elif op == "conv_same":
        p = conv_init(_key(1), (3, 3, 16, 8))
        want, got = jp.conv2d(p, jnp.asarray(x4)), tp.conv2d(params_from_jax(p), _t(x4))
    elif op in ("conv_down", "conv_down_asym"):
        p = conv_init(_key(2), (3, 3, 16, 16))
        asym = op == "conv_down_asym"
        want = jp.downsample_2x(p, jnp.asarray(x4), asymmetric_pad=asym)
        got = tp.downsample_2x(params_from_jax(p), _t(x4), asymmetric_pad=asym)
    elif op == "conv_temporal":
        p = conv_init(_key(3), (3, 1, 1, 16, 8))
        x5 = _rand(1, 2, 4, 5, 6, 16)
        want, got = jp.conv3d_temporal(p, jnp.asarray(x5)), tp.conv3d_temporal(params_from_jax(p), _t(x5))
    elif op == "upsample":
        p = conv_init(_key(4), (3, 3, 16, 16))
        want, got = jp.upsample_nearest_2x(p, jnp.asarray(x4)), tp.upsample_nearest_2x(params_from_jax(p), _t(x4))
    elif op == "layer_norm":
        p = norm_init(16)
        p = {"scale": p["scale"] * 1.3, "bias": p["bias"] + 0.2}
        want, got = jp.layer_norm(p, jnp.asarray(x4)), tp.layer_norm(params_from_jax(p), _t(x4))
    else:
        p = linear_init(_key(5), 16, 64)
        want, got = jp.geglu(p, jnp.asarray(x4)), tp.geglu(params_from_jax(p), _t(x4))
    _close(got, want, 2e-5, 2e-5)


@pytest.mark.parametrize("channels,act", [(64, True), (16, False)])  # 16 < 32 groups: gcd fallback
def test_group_norm_silu_matches_jax(channels, act):
    from posetraj_tpu.ops import primitives as jp
    from posetraj_torch.ops import primitives as tp

    x = _rand(2, 2, 6, 7, channels, scale=2.0)
    p = {"scale": _rand(3, channels) + 1.0, "bias": _rand(4, channels)}
    want = jp.group_norm_silu({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), eps=1e-6, act=act)
    got = tp.group_norm_silu(params_from_jax(p), _t(x), eps=1e-6, act=act)
    _close(got, want, 2e-5, 2e-5)


def test_attention_core_matches_jax():
    from posetraj_tpu.ops.attention import attention as jatt
    from posetraj_torch.ops.attention import attention as tatt

    q, k, v = (_rand(i, 2, 17, 32) for i in range(3))
    _close(tatt(_t(q), _t(k), _t(v), 2), jatt(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, backend="xla"),
           2e-5, 2e-5)


def test_resize_antialias_matches_jax():
    from posetraj_tpu.ops.resize import resize_antialias as jr
    from posetraj_torch.ops.resize import resize_antialias as tr

    x = np.random.RandomState(5).rand(2, 96, 80, 3).astype(np.float32)
    _close(tr(_t(x), (28, 28)), jr(jnp.asarray(x), (28, 28)), 2e-5, 2e-5)


# --------------------------------------------------------------------------
# Scheduler
# --------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [2, 25])
def test_scheduler_matches_jax(steps):
    from posetraj_tpu.configs import SchedulerConfig as JCfg
    from posetraj_tpu.diffusion import euler_karras as je
    from posetraj_torch.configs import SchedulerConfig
    from posetraj_torch.diffusion import euler_karras as te

    js, ts = je.make_schedule(JCfg(), steps), te.make_schedule(SchedulerConfig(), steps)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.init_noise_sigma == js.init_noise_sigma
    out, sample = _rand(6, 2, 3, 4), _rand(7, 2, 3, 4, scale=10.0)
    sig, nxt = float(ts.sigmas[0]), float(ts.sigmas[1])
    want, want_x0 = je.euler_step(jnp.asarray(out), jnp.asarray(sample), sig, nxt)
    got, got_x0 = te.euler_step(_t(out), _t(sample), sig, nxt)
    _rel_close(got, want, 1e-6)
    _rel_close(got_x0, want_x0, 1e-6)
    _close(te.scale_model_input(_t(sample), sig), je.scale_model_input(jnp.asarray(sample), sig), 1e-6, 1e-6)
    _close(te.sigma_to_timestep(torch.tensor(ts.sigmas[:-1])), je.sigma_to_timestep(jnp.asarray(js.sigmas[:-1])),
           1e-6, 1e-6)


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def test_embeddings_match_jax():
    from posetraj_tpu.models import embeddings as je
    from posetraj_torch.models import embeddings as te

    t = np.asarray([0.5, -1.2, 3.0], np.float32)
    _close(te.sinusoidal_timestep_embedding(_t(t), 33), je.sinusoidal_timestep_embedding(jnp.asarray(t), 33),
           2e-5, 2e-5)
    p = je.init_timestep_embedding(_key(6), 16, 32, 8)
    x = _rand(8, 3, 16)
    _close(te.timestep_embedding(params_from_jax(p), _t(x)), je.timestep_embedding(p, jnp.asarray(x)), 2e-5, 2e-5)


@pytest.mark.parametrize("block", ["resnet2d", "temporal_resnet", "spatio_temporal"])
def test_resnet_blocks_match_jax(block):
    from posetraj_tpu.models import resnet as jr
    from posetraj_torch.models import resnet as tr

    b, f, h, w = 2, 3, 6, 5
    if block == "resnet2d":
        p = jr.init_resnet_block_2d(_key(7), 32, 64, 24)
        x, temb = _rand(9, b * f, h, w, 32), _rand(10, b * f, 24)
        want = jr.resnet_block_2d(p, jnp.asarray(x), jnp.asarray(temb), eps=1e-6)
        got = tr.resnet_block_2d(params_from_jax(p), _t(x), _t(temb), eps=1e-6)
    elif block == "temporal_resnet":
        p = jr.init_temporal_resnet_block(_key(8), 32, 32, 24)
        x, temb = _rand(11, b, f, h, w, 32), _rand(12, b, f, 24)
        want = jr.temporal_resnet_block(p, jnp.asarray(x), jnp.asarray(temb))
        got = tr.temporal_resnet_block(params_from_jax(p), _t(x), _t(temb))
    else:
        p = jr.init_spatio_temporal_res_block(_key(9), 32, 32, 24, merge_factor=0.3)
        x, temb = _rand(13, b * f, h, w, 32), _rand(14, b * f, 24)
        ind = np.zeros((b, f), np.float32)
        want = jr.spatio_temporal_res_block(p, jnp.asarray(x), jnp.asarray(temb), f, jnp.asarray(ind))
        got = tr.spatio_temporal_res_block(params_from_jax(p), _t(x), _t(temb), f, _t(ind))
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("block", ["basic", "basic_long_context", "temporal", "temporal_long_context",
                                   "spatio_temporal"])
def test_transformer_blocks_match_jax(block):
    from posetraj_tpu.models import transformer as jt
    from posetraj_torch.models import transformer as tt

    b, f, s, c, heads, cross = 2, 3, 12, 32, 2, 16
    if block.startswith("basic"):
        # a 1-token context takes the single-key shortcut; 5 tokens the full path
        p = jt.init_basic_transformer_block(_key(10), c, heads, cross)
        x, ctx = _rand(15, b * f, s, c), _rand(16, b * f, 5 if block.endswith("context") else 1, cross)
        want = jt.basic_transformer_block(p, jnp.asarray(x), heads, context=jnp.asarray(ctx))
        got = tt.basic_transformer_block(params_from_jax(p), _t(x), heads, context=_t(ctx))
    elif block.startswith("temporal"):
        p = jt.init_temporal_basic_transformer_block(_key(11), c, heads, cross)
        fk = f if block.endswith("context") else 1
        x, ctx, emb = _rand(17, b * f, s, c), _rand(18, b, fk, s, cross), _rand(19, b * f, 1, c)
        want = jt.temporal_basic_transformer_block(p, jnp.asarray(x), f, heads, context=jnp.asarray(ctx),
                                                   add=jnp.asarray(emb))
        got = tt.temporal_basic_transformer_block(params_from_jax(p), _t(x), f, heads, context=_t(ctx), add=_t(emb))
    else:
        p = jt.init_transformer_spatio_temporal(_key(12), c, heads, 1, cross)
        x, ctx = _rand(20, b * f, 3, 4, c), _rand(21, b * f, 1, cross)
        ind = np.zeros((b, f), np.float32)
        want = jt.transformer_spatio_temporal(p, jnp.asarray(x), jnp.asarray(ctx), f, heads, jnp.asarray(ind))
        got = tt.transformer_spatio_temporal(params_from_jax(p), _t(x), _t(ctx), f, heads, _t(ind))
    _close(got, want, 1e-4, 1e-4)


# --------------------------------------------------------------------------
# Whole models: CLIP, VAE, and one ControlNet -> UNet step
# --------------------------------------------------------------------------


def test_clip_image_embeds_match_jax():
    from posetraj_tpu.configs import CLIPVisionConfig as JCfg
    from posetraj_tpu.models import clip as jc
    from posetraj_torch.configs import CLIPVisionConfig
    from posetraj_torch.models import clip as tc

    p = jc.init_clip_vision(_key(13), JCfg.tiny())
    x = np.random.RandomState(22).rand(2, 28, 28, 3).astype(np.float32)
    want = jax.jit(partial(jc.clip_image_embeds, compute_dtype=jnp.float32), static_argnums=(1,))(
        p, JCfg.tiny(), jnp.asarray(x))
    got = tc.clip_image_embeds(params_from_jax(p), CLIPVisionConfig.tiny(), _t(x), torch.float32)
    _rel_close(got, want, 2e-5)


def test_bridge_matches_native_init_structure():
    """params_from_jax of a JAX init and the port's own init give the same
    tree: keys, shapes and dtypes."""
    from posetraj_tpu.pipeline.svd_controlnet import ModelBundle as JBundle
    from posetraj_tpu.models import clip as jc, controlnet as jcn, unet as ju, vae as jv
    from posetraj_torch.pipeline import ModelBundle, init_params

    jb = JBundle.tiny()
    jparams = {"unet": ju.init_unet(_key(0), jb.unet), "controlnet": jcn.init_controlnet(_key(0), jb.controlnet),
               "clip": jc.init_clip_vision(_key(0), jb.clip)}
    native = init_params(ModelBundle.tiny(), seed=0, device="cpu")

    def shape_tree(node):
        if isinstance(node, dict):
            return {k: shape_tree(v) for k, v in node.items()}
        if isinstance(node, list):
            return [shape_tree(v) for v in node]
        return (tuple(node.shape), node.dtype)

    for name in jparams:
        assert shape_tree(params_from_jax(jparams[name])) == shape_tree(native[name]), name
    jvae = jv.init_vae(_key(0), jb.vae)
    assert shape_tree(params_from_jax(jvae["decoder"])) == shape_tree(native["vae"]["decoder"])
    assert shape_tree(params_from_jax(jvae["encoder"])) == shape_tree(native["vae"]["encoder"])
