"""The port under the JAX package's KernelConfig switches, and the plain
versions of kernels 6, 7 and 8, against the JAX package on the CPU in
float32.

* Kernel 7's plain version (flash_attention_tq_plain) against the Pallas
  flash_attention_tq and flash_attention in interpret mode, kernel 6's
  (flash_qkv_plain: o and the base-2 lse) against _flash_qkv_fwd_impl, at a
  ragged S = 200, head_dim 64 and 128, Skv = 2 Sq for kernel 7: 2e-5
  absolute and 1e-4 relative (float32 summation order over a few hundred
  keys). FlashAttentionQKV's backward against jax.grad of
  flash_attention_qkv (its _flash_bwd interpreted): the same.
* Kernel 8's plain version against fused_layer_norm in interpret mode:
  1e-5 absolute and relative.
* KernelConfig.from_env against the JAX one under the same variables.
* One tiny ControlNet -> UNet step under the un-fused config against the
  JAX step (tests/test_torch_step.py's case; off the TPU the JAX package
  takes these very fallback paths): 2e-4 of the output's max, as the
  default-config step. The un-fused path calls no version of kernels C and
  D, and GroupNorm with fused_groupnorm off takes the JAX XLA formulation.
* The dispatch gates of kernels 6, 7, 8 and B (kernel 8's declining any
  input a gradient flows through), the scoping of the config by
  generate(), and the wrappers' refusals. Training under these switches
  is held against the JAX package in tests/test_torch_train_stages.py.

The CUDA kernels are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.configs import KernelConfig, kernel_config, use_kernels
from posetraj_torch.ops import _native, flash, layernorm, mlp, qkvt, temporal
from test_torch_step import _np, _rel_close, port_step, step_case  # noqa: F401  (step_case is a fixture)

UNFUSED = KernelConfig(qkvt_attn=False, temporal_attn=False, fused_ff_ln=False, fused_ln=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol, rtol=rtol)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------
# Plain versions of kernels 7, 6 and 8 against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,d", [(200, 200, 64), (200, 400, 64), (200, 200, 128)])
def test_flash_tq_plain_matches_pallas_interpret(sq, skv, d):
    """Both forward-only Pallas variants, 128-row blocks so that the ragged
    S spans several of them."""
    from posetraj_tpu.ops.pallas_attention import flash_attention, flash_attention_tq

    q, k, v = _rand(sq, 2, sq, 2, d), _rand(skv, 2, skv, 2, d), _rand(d, 2, skv, 2, d)
    scale = d**-0.5
    got = flash.flash_attention_tq_plain(_t(q), _t(k), _t(v), scale)
    for fn in (flash_attention_tq, flash_attention):
        want = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, block_q=128, block_k=128, interpret=True)
        _close(got, want, 2e-5, 1e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_qkv_plain_matches_pallas_interpret(d):
    from posetraj_tpu.ops.pallas_attention import _flash_qkv_fwd_impl

    n, s = 2, 200
    qkv = _rand(d + 1, 2, s, 3 * n * d)
    scale = d**-0.5
    want_o, want_lse = _flash_qkv_fwd_impl(jnp.asarray(qkv), n, scale, interpret=True)
    o, lse = flash.flash_qkv_plain(_t(qkv), n, scale)
    _close(o, want_o, 2e-5, 1e-4)
    assert lse.shape == want_lse.shape == (2, n, s)
    _close(lse, want_lse, 2e-5, 1e-4)


def test_flash_qkv_backward_matches_jax_grad():
    """FlashAttentionQKV (plain forward, kernel 5's plain backward on the
    CPU) against jax.grad through the Pallas flash_attention_qkv, whose
    custom_vjp runs _flash_bwd interpreted."""
    from posetraj_tpu.ops.pallas_attention import flash_attention_qkv

    n, s, d = 2, 200, 128
    qkv, do = _rand(7, 1, s, 3 * n * d), _rand(8, 1, s, n * d)
    scale = d**-0.5
    want = jax.grad(lambda x: (flash_attention_qkv(x, n, scale) * jnp.asarray(do)).sum())(jnp.asarray(qkv))
    leaf = _t(qkv).requires_grad_(True)
    flash.flash_attention_qkv(leaf, n, scale).backward(_t(do))
    _close(leaf.grad, want, 2e-5, 1e-4)


@pytest.mark.parametrize("m,c", [(300, 320), (40, 1280)])
def test_layer_norm_plain_matches_pallas_interpret(m, c):
    from posetraj_tpu.ops.pallas_groupnorm import fused_layer_norm

    x = _rand(m, m, c, scale=2.0) + 0.5
    w, b = _rand(c, c) * 0.1 + 1.0, _rand(c + 1, c) * 0.1
    want = fused_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5, interpret=True)
    _close(layernorm.layer_norm(_t(x), _t(w), _t(b), 1e-5), want, 1e-5, 1e-5)


# --------------------------------------------------------------------------
# KernelConfig
# --------------------------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"POSETRAJ_FUSED_LN": "1", "POSETRAJ_QKVT_ATTN": "0"},
                                 {"POSETRAJ_TEMPORAL_ATTN": "0", "POSETRAJ_FUSED_FF_LN": "0",
                                  "POSETRAJ_FUSED_GROUPNORM": "0", "POSETRAJ_ATTN_NO_MAX": "0"},
                                 {"POSETRAJ_FUSED_FF": "0", "POSETRAJ_FUSED_FF_WIDE": "false"}])
def test_kernel_config_from_env_matches_jax(env, monkeypatch):
    from posetraj_tpu.configs import KernelConfig as JK

    for f in dataclasses.fields(KernelConfig):
        monkeypatch.delenv(f"POSETRAJ_{f.name.upper()}", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(KernelConfig.from_env()) == dataclasses.asdict(JK.from_env())
    assert dataclasses.asdict(KernelConfig()) == dataclasses.asdict(JK())
    assert kernel_config() == KernelConfig.from_env()
    with use_kernels(UNFUSED):
        assert kernel_config() == UNFUSED
        with use_kernels(None):
            assert kernel_config() == UNFUSED
    assert kernel_config() == KernelConfig.from_env()


# --------------------------------------------------------------------------
# The un-fused step against the JAX step
# --------------------------------------------------------------------------


def _refuse(*_a, **_k):
    raise AssertionError("kernel C or D (or its plain version) was called")


def test_unfused_step_matches_jax(step_case, monkeypatch):
    """The tiny ControlNet -> UNet step under UNFUSED: spatial attention
    through attention_module, temporal through _frame_axis_attention, the
    FF's LayerNorm standalone before kernel B's plain version (at the
    64-wide levels; the 32-wide one is outside kernel B's limits and takes
    plain GEGLU). No version of C or D is called."""
    for mod, names in ((qkvt, ("attn_sublayer", "attn_sublayer_plain", "attn_sublayer_kernel")),
                       (temporal, ("temporal_attn_sublayer", "temporal_attn_sublayer_plain",
                                   "temporal_attn_sublayer_kernel"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    calls = []
    real = mlp.geglu_mlp
    monkeypatch.setattr(mlp, "geglu_mlp", lambda *a, **k: calls.append(a[5] if len(a) > 5 else k.get("ln_w"))
                        or real(*a, **k))
    with use_kernels(UNFUSED):
        down0, got = port_step(step_case)
    assert float(np.abs(_np(down0)).max()) > 0
    _rel_close(got, step_case["want"], 2e-4)
    assert calls and all(ln is None for ln in calls)  # kernel B without its LayerNorm


def _gates_take_head_dim_16(monkeypatch):
    """Kernels C and D take head_dim 64 only, and their gates decline the
    tiny config's 16: let the gates take 16, so that only the KernelConfig
    switches decide."""
    monkeypatch.setattr(qkvt, "HEAD_DIM", 16)
    monkeypatch.setattr(temporal, "HEAD_DIM", 16)


def test_default_step_calls_kernels_c_and_d(step_case, monkeypatch):
    """The other side of the check above: under the default config the same
    step does reach C and D where their gates take the head size, so
    refusing them would be seen."""
    _gates_take_head_dim_16(monkeypatch)
    seen = []
    for mod, name in ((qkvt, "attn_sublayer"), (temporal, "temporal_attn_sublayer")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: seen.append(_n) or _r(*a))
    with use_kernels(KernelConfig()):
        port_step(step_case)
    assert {"attn_sublayer", "temporal_attn_sublayer"} <= set(seen)


def test_unfused_switches_keep_c_and_d_off_where_the_gates_take_the_shape(step_case, monkeypatch):
    """With the gates taking the tiny head size, the un-fused switches alone
    keep every version of C and D out of the step."""
    _gates_take_head_dim_16(monkeypatch)
    for mod, names in ((qkvt, ("attn_sublayer", "attn_sublayer_plain", "attn_sublayer_kernel")),
                       (temporal, ("temporal_attn_sublayer", "temporal_attn_sublayer_plain",
                                   "temporal_attn_sublayer_kernel"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    with use_kernels(UNFUSED):
        port_step(step_case)


@pytest.mark.parametrize("add", [None, "per_sample", "per_frame"])
def test_group_norm_silu_unfused_matches_jax(add, monkeypatch):
    """fused_groupnorm off: the port takes the JAX package's XLA path (the
    addend in x's dtype, float32 statistics, SiLU after the cast)."""
    from posetraj_tpu.ops.primitives import group_norm_silu as jgn
    from posetraj_torch.ops import groupnorm, primitives

    x = _rand(1, 2, 3, 4, 4, 64, scale=2.0)
    w, b = _rand(2, 64) * 0.2 + 1.0, _rand(3, 64)
    a = {None: None, "per_sample": _rand(4, 2, 64), "per_frame": _rand(5, 2, 3, 64)}[add]
    monkeypatch.setattr(groupnorm, "group_norm", _refuse)
    with use_kernels(KernelConfig(fused_groupnorm=False)):
        got = primitives.group_norm_silu({"weight": _t(w), "bias": _t(b)}, _t(x), 32, 1e-6, True,
                                         None if a is None else _t(a))
    want = jgn({"scale": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x), 32, 1e-6, True,
               None if a is None else jnp.asarray(a))
    _close(got, want, 2e-5, 2e-5)


def test_group_norm_kernel_taken_for_giant_activations(monkeypatch):
    """fused_groupnorm off, but an activation of at least 2^28 elements (the
    VAE decode) takes kernel A's wrapper anyway; shown with the threshold
    lowered to this input's size."""
    from posetraj_torch.ops import groupnorm, primitives

    x = torch.randn(2, 8, 8, 64)
    p = {"weight": torch.ones(64), "bias": torch.zeros(64)}
    seen = []
    real = groupnorm.group_norm
    monkeypatch.setattr(groupnorm, "group_norm", lambda *a: seen.append(1) or real(*a))
    with use_kernels(KernelConfig(fused_groupnorm=False)):
        primitives.group_norm_silu(p, x)
        assert not seen
        monkeypatch.setattr(primitives, "GN_KERNEL_ALWAYS", x.numel())
        primitives.group_norm_silu(p, x)
    assert seen == [1]


# --------------------------------------------------------------------------
# Dispatch gates, scoping, refusals
# --------------------------------------------------------------------------


class _OnCard:
    """Stands in for a CUDA tensor of a given shape in a dispatch rule."""

    is_cuda = True
    requires_grad = False

    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("shape,fused_ln,taken", [
    ((28, 2880, 320), True, True),     # norm1 at level 0 of 14x320x576
    ((2, 14, 180, 1280), True, True),  # temporal norm1 at level 2: 5040 rows
    ((28, 45, 1280), True, False),     # the mid block: 1260 rows
    ((28, 2880, 320), False, False),   # the default config
    ((8192, 2056), True, False),       # C > 2048
    ((8192, 324), True, False),        # C % 8 != 0
])
def test_layer_norm_gate(shape, fused_ln, taken):
    with use_kernels(KernelConfig(fused_ln=fused_ln)):
        assert layernorm.fused_layer_norm_applicable(_OnCard(*shape)) is taken
        assert layernorm.fused_layer_norm_applicable(torch.zeros((1,) * len(shape)).expand(shape)) is False  # CPU


def test_layer_norm_gate_declines_under_grad():
    """Kernel 8 has no backward: its gate declines while grad mode is on
    and x, the weight or the bias requires grad, and still admits the same
    shape where no gradient is asked for."""
    x, w = _OnCard(28, 2880, 320), torch.ones(320)
    needs = _OnCard(28, 2880, 320)
    needs.requires_grad = True
    with use_kernels(KernelConfig(fused_ln=True)):
        assert layernorm.fused_layer_norm_applicable(x, w, w)
        assert not layernorm.fused_layer_norm_applicable(needs, w, w)
        assert not layernorm.fused_layer_norm_applicable(x, w.requires_grad_(True), w)
        with torch.no_grad():
            assert layernorm.fused_layer_norm_applicable(needs, w, w)


@pytest.mark.parametrize("s,heads,c,taken", [
    (2880, 5, 640, True),    # head_dim 128
    (600, 2, 256, True),     # ragged S: masked on the card
    (2880, 5, 320, False),   # SVD's head_dim 64: split, then kernel 7
    (400, 2, 256, False),    # S < 512
])
def test_flash_qkv_gate(s, heads, c, taken):
    assert flash.flash_qkv_applicable(_OnCard(2, s, 3 * c), heads) is taken


@pytest.mark.parametrize("cfg,k,taken", [
    (KernelConfig(), 320, True), (KernelConfig(), 1280, True), (KernelConfig(fused_ff=False), 320, False),
    (KernelConfig(fused_ff_wide=False), 640, True), (KernelConfig(fused_ff_wide=False), 1280, False),
    (KernelConfig(), 32, False),  # outside kernel B's limits (K % 64)
])
def test_geglu_gate(cfg, k, taken):
    with use_kernels(cfg):
        assert mlp.geglu_applicable(torch.zeros(8 * k, k), torch.zeros(k, 4 * k)) is taken


def test_self_attention_qkv_on_cpu_is_the_split_attention():
    from posetraj_torch.ops.attention import dot_product_attention, self_attention_qkv

    qkv = _t(_rand(3, 2, 600, 3 * 128))
    _native.reset_launches()
    got = self_attention_qkv(qkv, 2)
    q, k, v = (t.reshape(2, 600, 2, 64) for t in qkv.split(128, dim=-1))
    _close(got, dot_product_attention(q, k, v, 0.125).reshape(2, 600, 128), 1e-6, 1e-6)
    assert all(n == 0 for n in _native.LAUNCHES.values())


def test_generate_runs_under_the_bundle_kernels(monkeypatch):
    """generate() scopes ModelBundle.kernels (None: the POSETRAJ_* variables
    read at the call)."""
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline import svd_controlnet as pipe_m

    seen = []

    def denoise(params, bundle, pcfg, latents, *a, **k):
        seen.append(kernel_config())
        return latents

    monkeypatch.setattr(pipe_m, "denoise", denoise)
    monkeypatch.setattr(pipe_m, "encode_image_clip", lambda *a: torch.zeros(2, 1, 4))
    monkeypatch.setattr(pipe_m, "encode_image_vae", lambda *a: torch.zeros(2, 2, 2, 4))
    args = (None, None, np.zeros((1, 16, 16, 3)), np.zeros((1, 2, 16, 16, 3)),
            {"latents": np.zeros((1, 2, 2, 2, 4)), "image_aug": np.zeros((1, 16, 16, 3))}, [[6.0, 128.0, 0.02]],
            [1.0, 0.0], [0.5], 2)
    for f in dataclasses.fields(KernelConfig):
        monkeypatch.delenv(f"POSETRAJ_{f.name.upper()}", raising=False)
    monkeypatch.setenv("POSETRAJ_FUSED_LN", "1")
    for bundle, want in ((ModelBundle(kernels=UNFUSED), UNFUSED), (ModelBundle(), KernelConfig(fused_ln=True))):
        pipe_m.generate(args[0], bundle, pipe_m.PipelineConfig(), *args[2:], output_latent=True, device="cpu")
        assert seen[-1] == want
    assert kernel_config() == KernelConfig.from_env()


def test_wrappers_refuse_tensors_that_require_grad():
    """Kernel 8 has no backward: its wrapper refuses, naming fused_ln. The
    raw launchers of kernels 6 and 7 refuse, under grad mode, before they
    look at the device."""
    x = torch.randn(4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_ln"):
        layernorm.layer_norm(x, torch.ones(64), torch.zeros(64))
    with torch.no_grad():
        layernorm.layer_norm(x, torch.ones(64), torch.zeros(64))  # no gradient asked for: the plain version
    q = torch.randn(1, 64, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash._launch_fwd(q, q.detach(), q.detach(), 0.125, False, "flash_tq")
    with pytest.raises(RuntimeError, match="requires grad"):
        flash.flash_qkv_kernel(torch.randn(1, 64, 384, dtype=torch.bfloat16, requires_grad=True), 1, 0.125)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash._launch_fwd(q, q, q, 0.125, False, "flash_tq")  # without grad mode: refused for the device
