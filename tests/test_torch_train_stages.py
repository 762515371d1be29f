"""The three training stages in the port: the hint variants' training
conditions, training under the un-fused KernelConfig, the memory options
of TrainConfig, checkpoints, and the small functions they use
(core/params.py's cast, flatten_dict, unflatten_dict, param_audit;
diffusion/euler_karras.py's add_noise, training_sigmas_grid and the
gamma-churn Euler step). On the CPU in float32 at small sizes.

* The bbox variant's loss and ControlNet gradient under the un-fused
  KernelConfig against jax.value_and_grad of the JAX edm_training_loss
  under the same switches (one JAX compile, which also makes the draws
  of test_torch_train.py's jax_draws): that file's two-level model, the
  frozen encodes given as latents and
  clip_emb (encode_outside_step's batch) and no spatial loss, so that the
  compiled program is the ControlNet, the UNet and their backward. Loss
  within 1e-5 relative, the gradient within 1e-3 relative RMS over the tree
  and per leaf within 1e-3 of (the leaf's max + the tree's max), as in
  test_torch_train.py.
* cam, rot, temp: another value of the condition moves the loss, and every
  leaf of the variant's own branch has a finite, non-zero gradient after a
  Trainer.step; a cam step without cam_parameter is bitwise a step with a
  zero camera. bbox and rot without their condition, and every entity step
  (its map is no batch key), raise the JAX package's ValueError.
* adam_mu_bf16, grad_accum_dtype="bfloat16" and both, against the JAX
  make_optimizer (_scale_by_adam_bf16, _multi_steps_acc) called eagerly on
  the same four micro-gradients of a small tree: params and EMA after each
  of two updates within 1e-6 (an Adam step of lr 1e-3 on values ~1).
* grads_bf16: the gradient of one micro-step within 1e-2 relative RMS of
  the float32 one (the forward sees bf16-rounded weights, 2^-8 relative).
* encode_outside_step: bitwise the fused step (the same encodes, the same
  VAE draw).
* Checkpoints: rotation, latest_checkpoint, and a run saved after its
  third micro-step and restored into a new Trainer whose next two
  micro-steps (an optimizer update among them) are bitwise those of the
  run that went on, with the default and the bf16 optimizer state.
* MicroStepGraph's key and static buffers (the graph itself runs on the
  card only: tests/test_torch_cuda.py, chip_smoke.py phase 5(e)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.core.bridge import params_from_jax
from test_torch_train import HINT_KW, STEP_KW, UNET_KW, _np, _paths, _rand, _snapshot, _t, _tree_close

UNFUSED = dict(qkvt_attn=False, temporal_attn=False, fused_ff_ln=False, fused_ln=True)
F, H, W = 2, 64, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bundle_of(configs, bundle_cls, variant, **kw):
    """test_torch_train's two-level model with the hint variant `variant`."""
    u = configs.UNetConfig(**UNET_KW)
    hint = configs.HintEncoderConfig(variant=variant, **HINT_KW)
    return bundle_cls(unet=u, controlnet=configs.ControlNetConfig(unet=u, hint=hint), vae=configs.VAEConfig.tiny(),
                      clip=configs.CLIPVisionConfig.tiny(), **kw)


def live(tree, seed):
    """Every all-zero leaf (the zero-conv heads, the hint's conv_out) given
    small random values, and the cam variant's identity-padded projection
    perturbed, so that the hint and its condition reach the loss."""
    rng = np.random.RandomState(seed)

    def fill(path, t):
        if isinstance(t, dict):
            return {k: fill(f"{path}.{k}", v) for k, v in t.items()}
        if isinstance(t, list):
            return [fill(f"{path}.{i}", v) for i, v in enumerate(t)]
        noise = torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.05).to(t.dtype)
        if bool((t == 0).all()):
            return noise
        return t + noise if "cc_projection" in path else t

    return fill("", tree)


def batch_of(b=1, seed=0, hw=H, **extra):
    rng = np.random.RandomState(seed)
    out = {"pixel_values": (rng.rand(b, F, hw, hw, 3) * 2 - 1).astype(np.float32),
           "trajectories": (rng.rand(b, F, hw, hw, 3) * 2 - 1).astype(np.float32),
           "motion_values": np.full((b,), 127.0, np.float32)}
    out.update(extra)
    return out


def port_trainer(variant="base", seed=0, kernels=None, **tcfg_kw):
    """A port Trainer on the CPU over the two-level model, its heads live."""
    from posetraj_torch import configs
    from posetraj_torch.pipeline import ModelBundle, init_params
    from posetraj_torch.train import Trainer

    bundle = bundle_of(configs, ModelBundle, variant, kernels=kernels)
    p = init_params(bundle, seed=seed, device="cpu")
    return Trainer(bundle, configs.TrainConfig(**tcfg_kw), {k: p[k] for k in ("unet", "vae", "clip")},
                   live(p["controlnet"], seed + 100), device="cpu")


def acc_snapshot(trainer):
    return {k: _np(a) for (k, _), a in zip(_paths(trainer.state.controlnet_params), trainer.state.grad_acc)}


# --------------------------------------------------------------------------
# The bbox variant under the un-fused KernelConfig against the JAX package
# --------------------------------------------------------------------------


def test_bbox_unfused_loss_and_grads_match_jax():
    from posetraj_tpu import configs as jc
    from posetraj_tpu.models import controlnet as jcn, unet as ju
    from posetraj_tpu.pipeline import ModelBundle as JBundle
    from posetraj_tpu.train.trainer import edm_training_loss as jloss
    from posetraj_torch import configs
    from posetraj_torch.configs import use_kernels
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.train import edm_training_loss

    jbundle = bundle_of(jc, JBundle, "bbox", kernels=jc.KernelConfig(**UNFUSED))
    frozen = {"unet": ju.init_unet(jax.random.PRNGKey(0), jbundle.unet)}
    cp = jcn.controlnet_from_unet(jcn.init_controlnet(jax.random.PRNGKey(3), jbundle.controlnet), frozen["unet"])
    emb = cp["controlnet_cond_embedding"]
    heads = cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"], emb["stack"]["conv_out"],
                                           emb["stack_2"]["conv_out"]]
    for i, zc in enumerate(heads):
        zc["kernel"] = jnp.asarray(_rand(300 + i, *zc["kernel"].shape, scale=0.05))
        zc["bias"] = jnp.asarray(_rand(400 + i, *zc["bias"].shape, scale=0.05))
    b, lat = 2, (H // 8, W // 8, 4)
    batch = batch_of(b, bbox_trajectories=(np.random.RandomState(9).rand(b, F, H, W, 3) * 2 - 1).astype(np.float32),
                     latents=_rand(10, b, F, *lat), clip_emb=_rand(11, b, 1, jbundle.unet.cross_attention_dim))
    kw = dict(STEP_KW, gradient_checkpointing=False, use_spatial_loss=False)
    rng = jax.random.PRNGKey(7)

    def jstep(p, fr, bt):
        """The loss, its gradient and the five draws the loss makes from
        rng, in one program (jax_draws' random calls would compile apart)."""
        (loss, _), grads = jax.value_and_grad(jloss, has_aux=True)(p, fr, jbundle, jc.TrainConfig(**kw), bt, rng,
                                                                   jnp.float32)
        k_vae, k_sigma, k_noise, k_drop, k_frame = jax.random.split(rng, 5)
        draws = {"vae_eps": jax.random.normal(k_vae, (b * F, *lat)), "u_sigma": jax.random.uniform(k_sigma, (b,)),
                 "noise": jax.random.normal(k_noise, (b, F, *lat)), "drop_p": jax.random.uniform(k_drop, (b,)),
                 "frame_idx": jax.random.randint(k_frame, (), 0, F)}
        return loss, grads, draws

    args = (cp, frozen, {k: jnp.asarray(v) for k, v in batch.items()})
    with jc.use_kernels(jbundle.kernels):
        # The LLVM backend's cheap setting: half the compile time, the same
        # IEEE float32 arithmetic.
        compiled = jax.jit(jstep).lower(*args).compile(
            compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    want_loss, want_g, draws = compiled(*args)
    randoms = {k: _t(v) for k, v in draws.items() if k != "frame_idx"}
    randoms["frame_idx"] = torch.tensor([int(draws["frame_idx"])])

    tbundle = bundle_of(configs, ModelBundle, "bbox", kernels=configs.KernelConfig(**UNFUSED))
    tcp = params_from_jax(cp)
    leaves = dict(_paths(tcp))
    for t in leaves.values():
        t.requires_grad_(True)
    with use_kernels(tbundle.kernels):
        loss, _ = edm_training_loss(tcp, {"unet": params_from_jax(frozen["unet"])}, tbundle,
                                    configs.TrainConfig(**kw), {k: _t(v) for k, v in batch.items()},
                                    randoms, torch.float32)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    got = {k: np.zeros(t.shape, np.float32) if g is None else _np(g) for (k, t), g in zip(leaves.items(), grads)}
    want = _snapshot(params_from_jax(jax.tree_util.tree_map(np.asarray, want_g)))
    _tree_close(got, want, 1e-3, 1e-3, "bbox micro-gradient under the un-fused switches")
    assert float(np.abs(want["controlnet_cond_embedding.stack_2.conv_in.weight"]).max()) > 0  # the bbox stack is live


# --------------------------------------------------------------------------
# The other variants: their conditions, their gradients, their errors
# --------------------------------------------------------------------------

VARIANT_CASES = {
    # variant: (the key of its condition, two values of it)
    "cam": ("cam_parameter", _rand(20, 1, F, 12), _rand(21, 1, F, 12)),
    "rot": ("rot_id", np.array([0]), np.array([1])),
    "temp": ("trajectories", batch_of(seed=1)["trajectories"], batch_of(seed=2)["trajectories"]),
}
BRANCH = {"cam": "cc_projection", "rot": "rot_embed", "temp": "temp", "bbox": "stack_2"}


@pytest.mark.parametrize("variant", sorted(VARIANT_CASES))
def test_hint_variant_trains(variant):
    """Its condition moves the loss (same weights, same draws); a
    Trainer.step leaves every leaf of the variant's branch a finite,
    non-zero gradient."""
    from posetraj_torch.train import draw_step_randoms, edm_training_loss

    key, v1, v2 = VARIANT_CASES[variant]
    trainer = port_trainer(variant, use_spatial_loss=False)
    g = torch.Generator().manual_seed(5)
    randoms = draw_step_randoms(g, 1, F, (H // 8, W // 8, 4))

    def loss(v):
        batch = {k: torch.as_tensor(x) for k, x in batch_of(**{key: v}).items()}
        with torch.no_grad():
            return float(edm_training_loss(trainer.state.controlnet_params, trainer.frozen_params, trainer.bundle,
                                           trainer.tcfg, batch, randoms, torch.float32)[0])

    assert loss(v1) != loss(v2)
    m = trainer.step(batch_of(**{key: v1}))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    branch = {k: v for k, v in acc_snapshot(trainer).items()
              if k.startswith(f"controlnet_cond_embedding.{BRANCH[variant]}.")}
    assert branch
    for k, v in branch.items():
        assert np.isfinite(v).all() and np.abs(v).max() > 0, k


def test_cam_without_its_parameter_is_a_zero_camera():
    """The JAX hint encoder's default: no cam_parameter is a zero camera."""
    a = port_trainer("cam", use_spatial_loss=False)
    b = port_trainer("cam", use_spatial_loss=False)
    ma = a.step(batch_of())
    mb = b.step(batch_of(cam_parameter=np.zeros((1, F, 12), np.float32)))
    assert float(ma["loss"]) == float(mb["loss"])
    for x, y in zip(a.state.grad_acc, b.state.grad_acc):
        assert torch.equal(x, y)


@pytest.mark.parametrize("variant,match", [("bbox", "bbox variant requires bbox_cond"),
                                           ("rot", "rot variant requires rot_id"),
                                           ("entity", "entity variant requires entity_cond")])
def test_hint_variant_raises_without_its_condition(variant, match):
    """The JAX package's ValueError, raised in the step's hint encoder, not
    when the Trainer is built. The entity map is no batch key, so the JAX
    step and the port's raise for every entity batch."""
    trainer = port_trainer(variant, use_spatial_loss=False)
    with pytest.raises(ValueError, match=match):
        trainer.step(batch_of(hw=32))


# --------------------------------------------------------------------------
# The memory options
# --------------------------------------------------------------------------

OPTION_CASES = {"adam_mu_bf16": dict(adam_mu_bf16=True), "grad_accum_bf16": dict(grad_accum_dtype="bfloat16"),
                "both": dict(adam_mu_bf16=True, grad_accum_dtype="bfloat16")}


@pytest.mark.parametrize("option", sorted(OPTION_CASES))
def test_memory_options_match_optax(option):
    """The port's update path (accumulation 2, clip, AdamW with warmup, EMA)
    under the option against the JAX make_optimizer under it, called
    eagerly, and the JAX step's EMA, on the same four micro-gradients of a
    small tree. The bf16 moments and accumulator round on both sides."""
    from posetraj_tpu.configs import TrainConfig as JTrain
    from posetraj_tpu.core.params import ema_decay_schedule as jdecay, ema_update as jema
    from posetraj_tpu.train.trainer import make_optimizer as jmake
    import optax
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.train.trainer import TrainState, apply_micro_grads, make_optimizer

    kw = dict(STEP_KW, adam_epsilon=1e-8, **OPTION_CASES[option])
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}
    init = {k: _rand(600 + i, *s) for i, (k, s) in enumerate(shapes.items())}
    micro = [{k: _rand(700 + 10 * j + i, *s, scale=0.5 + 0.5 * j) for i, (k, s) in enumerate(shapes.items())}
             for j in range(4)]

    jcfg = JTrain(gradient_checkpointing=False, **kw)
    tx = jmake(jcfg)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    ema, opt_state, want = params, tx.init(params), []
    for i, g in enumerate(micro):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        if i % 2 == 1:
            ema = jema(ema, params, jdecay((i + 1) // 2, jcfg.ema_decay))
            want.append(({k: np.asarray(v) for k, v in params.items()}, {k: np.asarray(v) for k, v in ema.items()}))

    tcfg = TrainConfig(**kw)
    masters = {k: _t(v, True) for k, v in init.items()}
    opt, sched = make_optimizer(tcfg, masters.values())
    state = TrainState(step=0, controlnet_params=masters, ema_params={k: _t(v) for k, v in init.items()},
                       optimizer=opt, scheduler=sched)
    for i, g in enumerate(micro):
        apply_micro_grads(state, tcfg, [_t(g[k]) for k in masters])
        if i % 2 == 1:
            wp, we = want[i // 2]
            _tree_close(_snapshot(state.controlnet_params), wp, 1e-6, 1e-6, f"{option}: params after {i + 1}")
            _tree_close(_snapshot(state.ema_params), we, 1e-6, 1e-6, f"{option}: EMA after {i + 1}")
        if i == 0:
            want_dtype = torch.bfloat16 if "grad_accum_dtype" in OPTION_CASES[option] else torch.float32
            assert all(a.dtype == want_dtype for a in state.grad_acc)
    moments = [t for st in opt.state.values() for k, t in st.items() if k.startswith("exp_avg")]
    assert moments and all(t.dtype == (torch.bfloat16 if tcfg.adam_mu_bf16 else torch.float32) for t in moments)
    assert max(float(np.abs(wp[k] - init[k]).max()) for k in init) > 1e-5


def test_grads_bf16_close_to_float32():
    """grads_bf16 differentiates against bf16 copies of the masters: bf16
    gradients, within 1e-2 relative RMS of the float32 ones."""
    ref = port_trainer(use_spatial_loss=False)
    half = port_trainer(use_spatial_loss=False, grads_bf16=True)
    ref.step(batch_of())
    half.step(batch_of())
    assert all(t.dtype == torch.bfloat16 for t in _paths_values(half.state.loss_params))
    got, want = acc_snapshot(half), acc_snapshot(ref)
    num = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
    den = sum(float((w**2).sum()) for w in want.values())
    assert 0 < (num / den) ** 0.5 <= 1e-2


def _paths_values(tree):
    return [v for _, v in _paths(tree)]


def test_encode_outside_step_is_bitwise_the_fused_step():
    """The frozen encodes before the step, with the step's VAE draw: four
    micro-steps (two updates) give bitwise the fused step's
    metrics, params, EMA and moments; the step keeps only the UNet."""
    fused = port_trainer(use_spatial_loss=False, **STEP_KW)
    outside = port_trainer(use_spatial_loss=False, encode_outside_step=True, **STEP_KW)
    assert set(outside.frozen_params) == {"unet"} and set(outside.encode_params) == {"vae", "clip"}
    for i in range(4):
        a, b = fused.step(batch_of(seed=i)), outside.step(batch_of(seed=i))
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    for x, y in zip(state_tensors(fused), state_tensors(outside)):
        assert torch.equal(x, y)


def state_tensors(trainer):
    """Masters, EMA, accumulator and optimizer moments, in a fixed order."""
    st = trainer.state
    out = [*_paths_values(st.controlnet_params), *_paths_values(st.ema_params), *st.grad_acc]
    for p in _paths_values(st.controlnet_params):
        out += [v for k, v in sorted(st.optimizer.state[p].items()) if isinstance(v, torch.Tensor)]
    return out


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------


def test_checkpoint_rotation_and_latest(tmp_path):
    from posetraj_torch.train import latest_checkpoint, save_checkpoint

    root = str(tmp_path / "run")
    assert latest_checkpoint(root) is None
    for step in (5, 10, 100, 20):
        save_checkpoint(root, step, {"step": step, "x": torch.full((2,), float(step))}, keep_total_limit=2)
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == ["checkpoint-100", "checkpoint-20"]
    assert latest_checkpoint(root) == str(tmp_path / "run" / "checkpoint-100")
    (tmp_path / "run" / "checkpoint-x").mkdir()  # not a checkpoint name
    assert latest_checkpoint(root).endswith("checkpoint-100")


@pytest.mark.parametrize("options", [{}, {"adam_mu_bf16": True, "grad_accum_dtype": "bfloat16"}])
def test_resume_is_bitwise_uninterrupted(tmp_path, options):
    """A run saved after its third micro-step (one update behind it, one
    micro-gradient in the accumulator) and restored into a new Trainer: its
    next two micro-steps (the first an update) give bitwise the metrics and
    state of the run that went on, draws included.
    The checkpoint holds masters, EMA, accumulator, moments (bf16 ones stay
    bf16), scheduler, step and generator."""
    from posetraj_torch.train import restore_checkpoint, save_checkpoint
    from posetraj_torch.train.checkpoints import load_checkpoint

    kw = dict(STEP_KW, use_spatial_loss=False, **options)
    run = port_trainer(**kw)
    for i in range(3):
        run.step(batch_of(seed=i))
    path = save_checkpoint(str(tmp_path), run.state.step, run, keep_total_limit=1)
    sd = load_checkpoint(path)
    assert sd["step"] == 3 and set(sd) == {"step", "controlnet", "ema", "grad_acc", "optimizer", "scheduler",
                                           "generator"}
    resumed = port_trainer(**kw)
    with torch.no_grad():
        for t in state_tensors(resumed):
            t.add_(1.0)  # whatever the trainer held, the checkpoint's values replace it
    restore_checkpoint(path, resumed)
    for i in (3, 4):
        a, b = run.step(batch_of(seed=i)), resumed.step(batch_of(seed=i))
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}, i
    assert run.state.step == resumed.state.step == 5
    for x, y in zip(state_tensors(run), state_tensors(resumed), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert resumed.state.scheduler.last_epoch == run.state.scheduler.last_epoch == 2


# --------------------------------------------------------------------------
# The micro-step graph's key and buffers (the capture needs the card)
# --------------------------------------------------------------------------


def test_micro_step_graph_key_and_buffers():
    """load() copies a call's batch and draws into the same static buffers
    while the key holds, so a captured graph would serve it; another batch
    shape, TrainConfig or KernelConfig drops the graph and makes buffers
    anew."""
    from posetraj_torch.configs import KernelConfig, use_kernels
    from posetraj_torch.train import MicroStepGraph

    trainer = port_trainer(use_spatial_loss=False)
    graph = MicroStepGraph()
    batch, randoms = trainer._prepare(batch_of(seed=0))
    assert graph.load(trainer, batch, randoms) is False
    buffers = {k: v.data_ptr() for k, v in graph.buffers["batch"].items()}
    graph._graph = object()  # stands in for a capture
    batch2, randoms2 = trainer._prepare(batch_of(seed=1))
    assert graph.load(trainer, batch2, randoms2) is True
    assert {k: v.data_ptr() for k, v in graph.buffers["batch"].items()} == buffers
    assert torch.equal(graph.buffers["batch"]["pixel_values"], batch2["pixel_values"])
    assert torch.equal(graph.buffers["randoms"]["noise"], randoms2["noise"])
    assert graph.buffers["randoms"]["noise"].data_ptr() != randoms2["noise"].data_ptr()
    with use_kernels(KernelConfig(**UNFUSED)):
        assert graph.load(trainer, batch2, randoms2) is False
    assert graph.load(trainer, batch2, randoms2) is False  # the default config again: another key
    graph._graph = object()
    assert graph.load(trainer, batch2, randoms2) is True
    trainer.tcfg = dataclasses.replace(trainer.tcfg, use_spatial_loss=True)
    assert graph.load(trainer, batch2, randoms2) is False
    graph._graph = object()
    small, small_r = trainer._prepare(batch_of(seed=0, hw=32))
    assert graph.load(trainer, small, small_r) is False


# --------------------------------------------------------------------------
# Scheduler and parameter-tree helpers against the JAX functions
# --------------------------------------------------------------------------


def test_add_noise_and_training_sigmas_grid_match_jax():
    from posetraj_tpu.configs import SchedulerConfig as JSched
    from posetraj_tpu.diffusion import euler_karras as jek
    from posetraj_torch.configs import SchedulerConfig
    from posetraj_torch.diffusion import euler_karras as ek

    grid = ek.training_sigmas_grid(SchedulerConfig())
    assert grid.dtype == np.float32 and grid.shape == (1000,)
    np.testing.assert_array_equal(grid, jek.training_sigmas_grid(JSched()))
    x, n, s = _rand(1, 3, 2, 4, 4), _rand(2, 3, 2, 4, 4), np.abs(_rand(3, 3)) + 0.1
    np.testing.assert_allclose(_np(ek.add_noise(_t(x), _t(n), _t(s))), np.asarray(jek.add_noise(x, n, s)), rtol=1e-6)


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_euler_step_gamma_churn_matches_jax(prediction_type):
    from posetraj_tpu.diffusion import euler_karras as jek
    from posetraj_torch.diffusion import euler_karras as ek

    out, sample, noise = _rand(4, 2, 3, 4, 4), _rand(5, 2, 3, 4, 4), _rand(6, 2, 3, 4, 4)
    for gamma in (0.0, 0.3):
        got = ek.euler_step(_t(out), _t(sample), 2.5, 1.2, prediction_type, gamma=gamma, noise=_t(noise), s_noise=1.1)
        want = jek.euler_step(out, sample, 2.5, 1.2, prediction_type, gamma=gamma, noise=noise, s_noise=1.1)
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="noise"):
        ek.euler_step(_t(out), _t(sample), 2.5, 1.2, gamma=0.3)


def test_param_tree_helpers_match_jax():
    from posetraj_tpu.core import params as jp
    from posetraj_torch.core import params as tp

    tree = {"b": [_rand(1, 2, 3), {"w": _rand(2, 4)}], "a": {"k": _rand(3, 5), "n": [_rand(4, 1)]}}
    ttree = {"b": [_t(tree["b"][0]), {"w": _t(tree["b"][1]["w"])}], "a": {"k": _t(tree["a"]["k"]),
                                                                          "n": [_t(tree["a"]["n"][0])]}}
    flat, jflat = tp.flatten_dict(ttree), jp.flatten_dict(tree)
    assert list(flat) == list(jflat)
    for k in flat:
        np.testing.assert_array_equal(_np(flat[k]), jflat[k])
    back = tp.unflatten_dict(flat)
    assert [k for k, _ in _paths(back)] == [k for k, _ in _paths(jp.unflatten_dict(jflat))]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(_paths(back), _paths(ttree)))
    half = tp.cast(ttree, torch.bfloat16)
    jhalf = dict(_paths(jp.cast(tree, jnp.bfloat16)))  # jax.tree_util sorts dict keys
    for k, x in _paths(half):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.float().numpy(), np.asarray(jhalf[k], np.float32))
    jhalf = jp.cast(tree, jnp.bfloat16)
    trainable = lambda name: name.startswith("a.")  # noqa: E731
    assert tp.param_audit(half, trainable) == jp.param_audit(jhalf, trainable)
    assert tp.param_audit(ttree) == jp.param_audit(tree)
