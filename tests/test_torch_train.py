"""The training slice of the port (posetraj_torch/train, diffusion/edm.py,
core/params.py, the autograd Functions of kernels A-D, remat) against the
JAX package, on the CPU in float32 at tiny sizes.

* EDM math and the EMA helpers: 1e-6 relative (a few float32 operations).
* Each of kernels A-D as a torch.autograd.Function (plain forward on the
  CPU, backward by recompute) against jax.vjp of the JAX `_ref_*`
  formulation: gradients within 1e-4 of the largest gradient entry plus
  1e-4 relative (float32 summation order through two chained matmuls).
* Four micro-steps of the port's trainer (accumulation 2, so two optimizer
  updates; warmup, clipping, weight decay and EMA active) against the JAX
  Trainer (make_train_step), each micro-step fed JAX's own five draws. The
  model is a small two-level SVD UNet + ControlNet (every block kind of the
  flagship) with the zero-conv heads and the hint conv_out perturbed, so
  that every residual path is live; JAX's trees are mapped to the port's
  layout by params_from_jax. Micro-step 1: loss and its parts within 1e-5
  relative, the ControlNet gradient (read from optax.MultiSteps'
  accumulator) within 1e-3 relative RMS over the tree and per leaf within
  1e-3 of (that leaf's max + the tree's max): float32 noise through the VAE
  encode, ControlNet, two UNet passes and back. Every micro-step's loss and
  grad_norm within 1e-4; params and EMA after each update within 1e-6 (an
  Adam step of lr <= 1e-3 on them; Adam's epsilon is 1e-4, see STEP_KW).
* The update path alone (accumulation, clip, AdamW at the default epsilon
  1e-8, EMA) against optax on the same four micro-gradients: params and
  EMA within 1e-6.
* remat=False, True and "unit" give the same gradients (port only).

The model's deepest level is 4x4 at the 8x8 latent: the tiny four-level
config would make it 1x1, where a GroupNorm sees two values per group and
its backward turns float32 rounding into gradient differences of tens of
percent between any two implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.core.bridge import params_from_jax

B, F, H, W = 2, 2, 64, 64  # pixels; latent 8x8 after the VAE's x8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(requires_grad)


def _np(t):
    """A numpy copy (never a view of a tensor that may be updated in place)."""
    return t.detach().float().numpy().copy() if isinstance(t, torch.Tensor) else np.array(t, np.float32)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def jax_draws(rng, b, f, latent):
    """The five draws of the JAX step, as edm_training_loss makes them from
    its key, in draw_step_randoms' dict."""
    k_vae, k_sigma, k_noise, k_drop, k_frame = jax.random.split(rng, 5)
    return {
        "vae_eps": _t(jax.random.normal(k_vae, (b * f, *latent), jnp.float32)),
        "u_sigma": _t(jax.random.uniform(k_sigma, (b,), jnp.float32)),
        "noise": _t(jax.random.normal(k_noise, (b, f, *latent), jnp.float32)),
        "drop_p": _t(jax.random.uniform(k_drop, (b,))),
        "frame_idx": torch.tensor([int(jax.random.randint(k_frame, (), 0, f))]),
    }


# A two-level model (UNet widths 32, 64; the first level with attention,
# the second plain; one layer per block) beside the tiny VAE and CLIP: it
# runs every block kind of the flagship (cross-attention and plain down and
# up blocks, the mid block, the hint encoder) in a third of the tiny
# four-level model's compile time.
UNET_KW = dict(block_out_channels=(32, 64), cross_attention_levels=(True, False), num_attention_heads=(2, 4),
               layers_per_block=1, cross_attention_dim=16, addition_time_embed_dim=8,
               projection_class_embeddings_input_dim=24, num_frames=F)
HINT_KW = dict(block_out_channels=(4, 8, 8, 16), embedding_channels=32)


def small_bundle(configs, bundle_cls):
    u = configs.UNetConfig(**UNET_KW)
    return bundle_cls(unet=u, controlnet=configs.ControlNetConfig(unet=u, hint=configs.HintEncoderConfig(**HINT_KW)),
                      vae=configs.VAEConfig.tiny(), clip=configs.CLIPVisionConfig.tiny())


def make_jax_models(seed=0):
    """Small JAX bundle, frozen params and a ControlNet copied from the UNet
    with every zero conv and the hint conv_out perturbed."""
    from posetraj_tpu import configs
    from posetraj_tpu.models import clip as clip_m, controlnet as cn, unet as unet_m, vae as vae_m
    from posetraj_tpu.pipeline import ModelBundle

    bundle = small_bundle(configs, ModelBundle)
    key = jax.random.PRNGKey(seed)
    frozen = {
        "unet": unet_m.init_unet(key, bundle.unet),
        "vae": vae_m.init_vae(jax.random.PRNGKey(seed + 1), bundle.vae),
        "clip": clip_m.init_clip_vision(jax.random.PRNGKey(seed + 2), bundle.clip),
    }
    cp = cn.controlnet_from_unet(cn.init_controlnet(jax.random.PRNGKey(seed + 3), bundle.controlnet), frozen["unet"])
    heads = cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"],
                                           cp["controlnet_cond_embedding"]["stack"]["conv_out"]]
    for i, zc in enumerate(heads):
        zc["kernel"] = jnp.asarray(_rand(300 + i, *zc["kernel"].shape, scale=0.05))
        zc["bias"] = jnp.asarray(_rand(400 + i, *zc["bias"].shape, scale=0.05))
    return bundle, frozen, cp


def make_batch(b=B, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "pixel_values": (rng.rand(b, F, H, W, 3) * 2 - 1).astype(np.float32),
        "trajectories": (rng.rand(b, F, H, W, 3) * 2 - 1).astype(np.float32),
        "motion_values": np.full((b,), 127.0, np.float32),
    }


def port_models(frozen, cp):
    from posetraj_torch import configs
    from posetraj_torch.pipeline import ModelBundle

    return (small_bundle(configs, ModelBundle), {k: params_from_jax(v) for k, v in frozen.items()},
            params_from_jax(cp))


# --------------------------------------------------------------------------
# EDM math, EMA, configuration
# --------------------------------------------------------------------------


def test_edm_math_matches_jax():
    from posetraj_tpu.diffusion import edm as jedm
    from posetraj_torch.diffusion import edm

    sig = np.asarray([0.002, 0.3, 1.0, 12.0, 700.0], np.float32)
    for got, want in zip(edm.edm_scalings(_t(sig)), jedm.edm_scalings(jnp.asarray(sig))):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(_np(edm.edm_loss_weight(_t(sig))), np.asarray(jedm.edm_loss_weight(sig)), rtol=1e-6)
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (6,), jnp.float32))
    want = jedm.rand_cosine_interpolated(key, (6,))
    np.testing.assert_allclose(_np(edm.rand_cosine_interpolated(_t(u))), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(edm.stratified_uniform(_t(u))), np.asarray(jedm.stratified_uniform(key, (6,))),
                               rtol=1e-6)


def test_ema_helpers_match_jax():
    from posetraj_tpu.core import params as jparams
    from posetraj_torch.core import params

    for step in range(0, 6):
        assert params.ema_decay_schedule(step, 0.9999) == pytest.approx(
            float(jparams.ema_decay_schedule(jnp.asarray(step), 0.9999)), rel=1e-6)
    assert params.ema_decay_schedule(10**6, 0.9999) == 0.9999
    ema, new = [_rand(1, 3, 4), {"b": _rand(2, 5)}], [_rand(3, 3, 4), {"b": _rand(4, 5)}]
    want = jparams.ema_update(ema, new, 0.25)
    got = [_t(ema[0]), {"b": _t(ema[1]["b"])}]
    params.ema_update(got, [_t(new[0]), {"b": _t(new[1]["b"])}], 0.25)
    for (_, g), (_, w) in zip(_paths(got), _paths(want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    assert params.count_params(got) == jparams.count_params(want) == 17


def test_train_config_matches_jax_defaults():
    import dataclasses

    from posetraj_tpu.configs import EDMConfig as JEDM, TrainConfig as JTrain
    from posetraj_torch.configs import EDMConfig, TrainConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrain())
    assert dataclasses.asdict(EDMConfig()) == dataclasses.asdict(JEDM())


@pytest.mark.parametrize("option", [{"lr_scheduler": "cosine"}])
def test_options_not_in_the_port_raise(option):
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import make_optimizer

    with pytest.raises(NotImplementedError):
        make_optimizer(TrainConfig(**option), [torch.zeros(2, requires_grad=True)])


def test_trainer_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(None, TrainConfig(), {}, {})
    with pytest.raises(NotImplementedError, match="parallel"):
        Trainer(None, TrainConfig(), {}, {}, mesh=object(), device="cpu")


def test_added_time_ids_train_order():
    from posetraj_torch.train.trainer import added_time_ids_train

    np.testing.assert_allclose(_np(added_time_ids_train(torch.tensor([127.0, 3.0]))),
                               [[6.0, 0.02, 127.0], [6.0, 0.02, 3.0]], rtol=1e-6)


# --------------------------------------------------------------------------
# Kernels A-D as autograd Functions against jax.vjp of the JAX reference
# --------------------------------------------------------------------------


def _vjp_check(jfn, jargs, tfn, targs, relayout, ct):
    """jax.vjp of jfn at jargs against autograd of tfn at targs (leaves that
    need grad), with cotangent ct; relayout[i] maps JAX's gradient i to the
    port's layout."""
    out, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(a) for a in jargs))
    want = vjp(jnp.asarray(ct))
    got = tfn(*targs)
    np.testing.assert_allclose(_np(got), np.asarray(out), atol=1e-4, rtol=1e-4)
    got.backward(_t(ct))
    for t, w, f in zip([a for a in targs if isinstance(a, torch.Tensor)], want, relayout):
        w = f(np.asarray(w))
        np.testing.assert_allclose(_np(t.grad), w, atol=1e-4 * float(np.abs(w).max()), rtol=1e-4)


_same = lambda a: a  # noqa: E731
_tr = lambda a: a.T  # noqa: E731


def test_group_norm_function_grads_match_jax_vjp():
    from posetraj_tpu.ops.pallas_groupnorm import _ref_group_norm
    from posetraj_torch.ops import groupnorm

    x, add = _rand(1, 2, 3, 4, 4, 64, scale=2.0), _rand(2, 2, 3, 64)
    w, b = _rand(3, 64) * 0.2 + 1.0, _rand(4, 64)
    targs = [_t(a, True) for a in (x, w, b, add)]
    _vjp_check(lambda x, w, b, a: _ref_group_norm(x, w, b, 32, 1e-6, True, add=a), (x, w, b, add),
               lambda x, w, b, a: groupnorm.group_norm(x, w, b, 32, 1e-6, True, a), targs, [_same] * 4,
               _rand(5, *x.shape))


@pytest.mark.parametrize("variant", ["plain", "ln", "ln_res", "ln_res_add"])
def test_geglu_mlp_function_grads_match_jax_vjp(variant):
    from posetraj_tpu.ops import pallas_mlp as pm
    from posetraj_torch.ops import mlp

    m, k, n = 64, 64, 128
    x, ln_s, ln_b = _rand(6, m, k), _rand(7, k) * 0.1 + 1.0, _rand(8, k) * 0.1
    w1, b1, w2, b2 = _rand(9, k, 2 * n) * 0.1, _rand(10, 2 * n) * 0.1, _rand(11, n, k) * 0.1, _rand(12, k) * 0.1
    add = _rand(13, 4, 1, k)
    ln, res = variant != "plain", variant in ("ln_res", "ln_res_add")
    j = {"plain": lambda x, s, b_, w1, b1, w2, b2, a: pm._ref_geglu_mlp(x, w1, b1, w2, b2),
         "ln": lambda x, s, b_, w1, b1, w2, b2, a: pm._ref_ln_geglu_mlp(x, s, b_, w1, b1, w2, b2),
         "ln_res": lambda x, s, b_, w1, b1, w2, b2, a: pm._ref_ln_geglu_mlp_res(x, s, b_, w1, b1, w2, b2),
         "ln_res_add": pm._ref_ln_geglu_mlp_res_add}[variant]
    targs = [_t(a, True) for a in (x, ln_s, ln_b, w1.T, b1, w2.T, b2, add)]

    def port(x, s, b_, w1, b1, w2, b2, a):
        return mlp.geglu_mlp(x, w1, b1, w2, b2, s if ln else None, b_ if ln else None, 1e-5, res,
                             a if variant == "ln_res_add" else None)

    ct = _rand(14, m, k)
    out, vjp = jax.vjp(jax.jit(j), *(jnp.asarray(a) for a in (x, ln_s, ln_b, w1, b1, w2, b2, add)))
    want = vjp(jnp.asarray(ct))
    got = port(*targs)
    np.testing.assert_allclose(_np(got), np.asarray(out), atol=1e-4, rtol=1e-4)
    got.backward(_t(ct))
    for t, w, f, used in zip(targs, want, [_same, _same, _same, _tr, _same, _tr, _same, _same],
                             [True, ln, ln, True, True, True, True, variant == "ln_res_add"]):
        w = f(np.asarray(w))
        if not used:
            assert t.grad is None and not np.abs(w).any()
            continue
        np.testing.assert_allclose(_np(t.grad), w, atol=1e-4 * float(np.abs(w).max()), rtol=1e-4)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_attention_sublayer_function_grads_match_jax_vjp(kind):
    from posetraj_tpu.ops.pallas_qkvt import _ref_attn_sublayer
    from posetraj_tpu.ops.pallas_temporal import _ref_temporal_sublayer
    from posetraj_torch.ops import qkvt, temporal

    c, n = 128, 2
    shape = (2, 200, c) if kind == "spatial" else (1, 3, 64, c)  # S = 200: ragged
    x = _rand(20, *shape)
    ln_s, ln_b = _rand(21, c) * 0.1 + 1.0, _rand(22, c) * 0.1
    wqkv, wo, bo = _rand(23, c, 3 * c) / np.sqrt(c), _rand(24, c, c) / np.sqrt(c), _rand(25, c) * 0.1
    jfn = _ref_attn_sublayer if kind == "spatial" else _ref_temporal_sublayer
    tfn = qkvt.attn_sublayer if kind == "spatial" else temporal.temporal_attn_sublayer
    targs = [_t(a, True) for a in (x, ln_s, ln_b, wqkv.T, wo.T, bo)]
    _vjp_check(lambda *a: jfn(*a, n, 1e-5), (x, ln_s, ln_b, wqkv, wo, bo), lambda *a: tfn(*a, n), targs,
               [_same, _same, _same, _tr, _tr, _same], _rand(26, *shape))


# --------------------------------------------------------------------------
# Four micro-steps (two optimizer updates) against the JAX trainer
# --------------------------------------------------------------------------

# Accumulation 2, warmup over 2 updates from lr 0, lr 1e-3 so that the
# second update moves the params visibly; weight decay, max_grad_norm 1.0
# (the micro-gradients' norms are above it, so clipping acts), EMA,
# conditioning dropout 0.1 and the spatial loss at their defaults. Adam's
# epsilon is 1e-4, not 1e-8: six leaves have a gradient that is zero but
# for float32 noise, the level-0 resnets' conv1.bias, time_emb_proj.weight
# and time_emb_proj.bias (spatial and temporal), which add a per-channel
# constant right before a GroupNorm of one channel per group. JAX's max |g|
# there is 1.4e-10 to 1.9e-9, 5e-9 to 7e-8 of the tree's max (measured on
# micro-step 1); at eps 1e-8 Adam turns that noise into updates of +-lr
# whose sign differs between any two implementations. The update path at
# eps 1e-8 is checked on its own, on shared gradients, below.
STEP_KW = dict(gradient_accumulation_steps=2, lr_warmup_steps=2, learning_rate=1e-3, adam_epsilon=1e-4)
STEPS = 4


def _snapshot(tree):
    return {k: _np(v) for k, v in _paths(tree)}


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX Trainer (one compile of make_train_step for the module) over
    four micro-steps: metrics of each, the micro-gradient of the first (read
    from optax.MultiSteps' accumulator), params and EMA after each update."""
    from posetraj_tpu.configs import TrainConfig as JTrain
    from posetraj_tpu.train import Trainer as JTrainer

    bundle, frozen, cp = make_jax_models()
    tcfg = JTrain(gradient_checkpointing=False, **STEP_KW)
    trainer = JTrainer(bundle, tcfg, frozen, cp, compute_dtype=jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    out = {"metrics": [], "params": {}, "ema": {}, "frozen": frozen, "cp": cp, "seed": tcfg.seed}
    for i in range(STEPS):
        m = trainer.step(batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        st = trainer.state
        if i == 0:
            out["grads"] = _snapshot(params_from_jax(jax.tree_util.tree_map(np.asarray, st.opt_state.acc_grads)))
        if i % 2 == 1:
            out["params"][i] = _snapshot(params_from_jax(jax.tree_util.tree_map(np.asarray, st.controlnet_params)))
            out["ema"][i] = _snapshot(params_from_jax(jax.tree_util.tree_map(np.asarray, st.ema_params)))
    return out


@pytest.fixture(scope="module")
def port_steps(jax_steps):
    """The port's Trainer on the same weights and batch, each micro-step fed
    the JAX step's draws (fold_in(PRNGKey(seed), step), split in five)."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import Trainer, train_step

    bundle, frozen, cp = port_models(jax_steps["frozen"], jax_steps["cp"])
    tcfg = TrainConfig(**STEP_KW)  # unit-granularity remat, the default
    trainer = Trainer(bundle, tcfg, frozen, cp, device="cpu")
    batch = {k: _t(v) for k, v in make_batch().items()}
    out = {"metrics": [], "params": {}, "ema": {}, "bundle": bundle, "frozen": trainer.frozen_params, "cp": cp,
           "batch": batch, "randoms": []}
    for i in range(STEPS):
        randoms = jax_draws(jax.random.fold_in(jax.random.PRNGKey(jax_steps["seed"]), i), B, F, (H // 8, W // 8, 4))
        out["randoms"].append(randoms)
        m = train_step(trainer.state, trainer.frozen_params, bundle, tcfg, batch, randoms, torch.float32)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {k: _np(a) for (k, _), a in zip(_paths(trainer.state.controlnet_params),
                                                           trainer.state.grad_acc)}
        if i % 2 == 1:
            out["params"][i] = _snapshot(trainer.state.controlnet_params)
            out["ema"][i] = _snapshot(trainer.state.ema_params)
    return out


def _tree_close(got, want, rms_tol, leaf_tol, what):
    assert set(got) == set(want), what
    gmax = max(float(np.abs(w).max()) for w in want.values())
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    den = sum(float((w**2).sum()) for w in want.values())
    assert (num / den) ** 0.5 <= rms_tol, (what, (num / den) ** 0.5)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=leaf_tol * (float(np.abs(w).max()) + gmax), rtol=0,
                                   err_msg=f"{what}: {k}")


def test_training_loss_and_grads_match_jax(jax_steps, port_steps):
    """Micro-step 1: loss, its parts and the ControlNet gradient."""
    got, want = port_steps["metrics"][0], jax_steps["metrics"][0]
    for k in ("loss", "loss_video", "loss_spatial", "sigma_mean"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    _tree_close(port_steps["grads"], jax_steps["grads"], 1e-3, 1e-3, "micro-gradient")
    live = sum(bool(np.abs(w).max() > 0) for w in jax_steps["grads"].values())
    assert live > 0.9 * len(jax_steps["grads"])  # the perturbed heads make nearly every leaf live


def test_two_accumulated_updates_match_jax(jax_steps, port_steps):
    """grad_norm and loss of every micro-step; params and EMA after each of
    the two updates. The first update runs at the warmup's first lr, 0 (as
    optax's schedule at count 0): it moves Adam's moments, not the params;
    the second moves them."""
    for i in range(STEPS):
        for k in ("loss", "grad_norm"):
            assert port_steps["metrics"][i][k] == pytest.approx(jax_steps["metrics"][i][k], rel=1e-4), (i, k)
    for i in (1, 3):
        _tree_close(port_steps["params"][i], jax_steps["params"][i], 1e-6, 1e-6, f"params after step {i + 1}")
        _tree_close(port_steps["ema"][i], jax_steps["ema"][i], 1e-6, 1e-6, f"EMA after step {i + 1}")
    moved = max(float(np.abs(port_steps["params"][3][k] - port_steps["params"][1][k]).max())
                for k in port_steps["params"][1])
    assert moved > 1e-5


def test_updates_at_default_adam_epsilon_match_optax(jax_steps, port_steps):
    """The update path alone at Adam's default epsilon, 1e-8: the port's
    apply_micro_grads (accumulation 2, clip of the mean, AdamW with warmup,
    EMA) against optax.MultiSteps over the JAX make_optimizer and the JAX
    step's EMA. Both get the same four micro-gradients (micro-step 1's JAX
    gradient, rescaled and perturbed per micro-step), so a gradient that is
    float32 noise is the same noise on both sides. Params and EMA after each
    update within 1e-6, as in the test above."""
    import optax
    from posetraj_tpu.configs import TrainConfig as JTrain
    from posetraj_tpu.core.params import ema_decay_schedule as jdecay, ema_update as jema
    from posetraj_tpu.train.trainer import make_optimizer as jmake
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train.trainer import TrainState, apply_micro_grads, make_optimizer

    kw = dict(STEP_KW, adam_epsilon=1e-8)
    assert TrainConfig().adam_epsilon == JTrain().adam_epsilon == 1e-8
    init = {k: _np(v) for k, v in _paths(port_steps["cp"])}
    g0 = jax_steps["grads"]
    micro = [{k: (0.5 + 0.5 * i) * g + _rand(500 + i, *g.shape, scale=0.1 * float(np.abs(g).max()))
              for k, g in g0.items()} for i in range(STEPS)]

    jcfg = JTrain(gradient_checkpointing=False, **kw)
    tx = jmake(jcfg)

    @jax.jit
    def jstep(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    # optax runs on the tree flattened into one vector: every update is
    # element-wise and the clip reads the global norm, so it is the same
    # function, compiled for one leaf instead of a few hundred.
    keys = list(init)

    def flat(tree):
        return {"all": jnp.asarray(np.concatenate([np.asarray(tree[k], np.float32).ravel() for k in keys]))}

    def unflat(tree):
        parts = np.split(np.asarray(tree["all"]), np.cumsum([init[k].size for k in keys])[:-1])
        return {k: p.reshape(init[k].shape) for k, p in zip(keys, parts)}

    params = flat(init)
    ema, opt_state, want = params, tx.init(params), []
    for i, g in enumerate(micro):
        params, opt_state = jstep(flat(g), opt_state, params)
        if i % 2 == 1:
            ema = jema(ema, params, jdecay((i + 1) // 2, jcfg.ema_decay))
            want.append((unflat(params), unflat(ema)))

    tcfg = TrainConfig(**kw)
    masters = {k: _t(v, True) for k, v in init.items()}
    opt, sched = make_optimizer(tcfg, masters.values())
    state = TrainState(step=0, controlnet_params=masters, ema_params={k: _t(v) for k, v in init.items()},
                       optimizer=opt, scheduler=sched)
    for i, g in enumerate(micro):
        apply_micro_grads(state, tcfg, [_t(g[k]) for k in masters])
        if i % 2 == 1:
            wp, we = want[i // 2]
            _tree_close(_snapshot(state.controlnet_params), wp, 1e-6, 1e-6, f"params after step {i + 1}")
            _tree_close(_snapshot(state.ema_params), we, 1e-6, 1e-6, f"EMA after step {i + 1}")
    moved = max(float(np.abs(wp[k] - init[k]).max()) for k in init)
    assert moved > 1e-5


def port_loss_and_grads(run, **tcfg_kw):
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train import edm_training_loss

    cp = {k: v for k, v in run["cp"].items()}
    leaves = dict(_paths(cp))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, metrics = edm_training_loss(cp, run["frozen"], run["bundle"], TrainConfig(**tcfg_kw), run["batch"],
                                      run["randoms"][0], torch.float32)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), {k: (torch.zeros_like(t) if g is None else g) for (k, t), g in zip(leaves.items(),
                                                                                                     grads)}


def test_remat_gives_the_same_grads(port_steps):
    """Checkpointing recomputes, it does not change the numbers: remat=False,
    True (whole blocks) and "unit" agree."""
    base = port_loss_and_grads(port_steps, gradient_checkpointing=False)
    for kw in ({"remat_granularity": "unit"}, {"remat_granularity": "block"}):
        got = port_loss_and_grads(port_steps, **kw)
        assert got[0] == pytest.approx(base[0], rel=1e-6)
        for k, g in got[1].items():
            np.testing.assert_allclose(_np(g), _np(base[1][k]), atol=1e-6 * float(base[1][k].abs().max()) + 1e-12,
                                       rtol=1e-5, err_msg=k)


def test_frozen_unet_down_path_builds_no_graph(port_steps, monkeypatch):
    """The UNet's down path and mid block take no input that needs a
    gradient, so autograd records nothing there; the ControlNet residuals
    join only at the skips and after the mid block."""
    from posetraj_torch.models import unet as unet_m

    seen = []
    real_down, real_mid = unet_m.down_block, unet_m.mid_block

    def down(*a, **k):
        x, skips = real_down(*a, **k)
        seen.append(x.requires_grad or any(s.requires_grad for s in skips))
        return x, skips

    def mid(*a, **k):
        x = real_mid(*a, **k)
        seen.append(x.requires_grad)
        return x

    monkeypatch.setattr(unet_m, "down_block", down)
    monkeypatch.setattr(unet_m, "mid_block", mid)
    port_loss_and_grads(port_steps)
    assert len(seen) == 2 * 3 and not any(seen)  # video and spatial passes: 2 down blocks + mid each
