"""The port's four kernel modules (posetraj_torch/ops/{groupnorm,mlp,qkvt,
temporal}.py) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
against the JAX `_ref_*` formulation and against the Pallas kernel itself in
interpret mode, in float32, on the same numpy inputs. Tolerances are float32
summation-order noise: 2e-5 for the norms, 1e-4 abs / 1e-4 rel for the
matmul sub-layers (K up to 256 products per output, two chained matmuls).

The CUDA kernels are checked against the same plain versions on the card
(tests/test_torch_cuda.py, skipped without a GPU, and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.ops import _native, groupnorm, mlp, qkvt, temporal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and oversubscribed torch thread pools stall each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().cpu().float().numpy(), np.asarray(want), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# Kernel A: GroupNorm
# --------------------------------------------------------------------------

GN_CASES = [
    # (x shape, addend shape or None, act)
    ((2, 8, 8, 64), None, False),
    ((2, 8, 8, 64), None, True),
    ((2, 8, 8, 64), (2, 64), True),         # per-sample temb fold (resnet_block_2d)
    ((2, 3, 8, 8, 64), (2, 3, 64), True),   # per-frame fold (temporal_resnet_block)
    ((3, 5, 7, 32), None, True),            # odd spatial size
]


@pytest.mark.parametrize("shape,add_shape,act", GN_CASES)
def test_group_norm_plain_matches_jax_ref(shape, add_shape, act):
    from posetraj_tpu.ops.pallas_groupnorm import _ref_group_norm

    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    c = shape[-1]
    w, b = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    add = rng.randn(*add_shape).astype(np.float32) if add_shape else None
    want = _ref_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-5, act,
                           add=None if add is None else jnp.asarray(add))
    got = groupnorm.group_norm(_t(x), _t(w), _t(b), 32, 1e-5, act, None if add is None else _t(add))
    _close(got, want, 2e-5, 2e-5)


def test_group_norm_plain_matches_pallas_interpret():
    from posetraj_tpu.ops.pallas_groupnorm import fused_group_norm

    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 8, 8, 64).astype(np.float32)
    add = rng.randn(2, 3, 64).astype(np.float32)
    w, b = rng.rand(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = fused_group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-5, act=True, interpret=True,
                            add=jnp.asarray(add))
    got = groupnorm.group_norm(_t(x), _t(w), _t(b), 32, 1e-5, True, _t(add))
    _close(got, want, 2e-5, 2e-5)


def test_group_norm_rows_per_block_covers_flagship():
    # VAE decode chunk at 576x1024: (14, 589824 rows, 128) > 2^28 elements.
    rpb = groupnorm.rows_per_block(14, 576 * 1024)
    assert rpb >= 32 and -(-576 * 1024 // rpb) * 14 >= 1024


# --------------------------------------------------------------------------
# Kernel B: fused LN + GEGLU MLP
# --------------------------------------------------------------------------


def _mlp_inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.randn(m, k).astype(np.float32),
        ln_s=(1.0 + 0.1 * rng.randn(k)).astype(np.float32),
        ln_b=(0.1 * rng.randn(k)).astype(np.float32),
        w1=(rng.randn(k, 2 * n) * 0.05).astype(np.float32),
        b1=(rng.randn(2 * n) * 0.1).astype(np.float32),
        w2=(rng.randn(n, k) * 0.05).astype(np.float32),
        b2=(rng.randn(k) * 0.1).astype(np.float32),
    )


def _mlp_port(d, ln, residual, add=None):
    return mlp.geglu_mlp(
        _t(d["x"]), _t(d["w1"].T.copy()), _t(d["b1"]), _t(d["w2"].T.copy()), _t(d["b2"]),
        _t(d["ln_s"]) if ln else None, _t(d["ln_b"]) if ln else None, 1e-5, residual,
        None if add is None else _t(add),
    )


@pytest.mark.parametrize("variant", ["plain", "ln", "ln_res", "ln_res_add_sample", "ln_res_add_pixel"])
def test_geglu_mlp_plain_matches_jax_ref(variant):
    from posetraj_tpu.ops import pallas_mlp as pm

    m, k, n = 256, 64, 128
    d = _mlp_inputs(m, k, n, seed=2)
    j = {key: jnp.asarray(v) for key, v in d.items()}
    args = (j["x"], j["ln_s"], j["ln_b"], j["w1"], j["b1"], j["w2"], j["b2"])
    if variant == "plain":
        want, got = pm._ref_geglu_mlp(j["x"], j["w1"], j["b1"], j["w2"], j["b2"]), _mlp_port(d, False, False)
    elif variant == "ln":
        want, got = pm._ref_ln_geglu_mlp(*args), _mlp_port(d, True, False)
    elif variant == "ln_res":
        want, got = pm._ref_ln_geglu_mlp_res(*args), _mlp_port(d, True, True)
    else:
        # (G, S_a, K): per-sample vector (spatial attn2 fast path) or a
        # per-pixel slab shared over frames (temporal attn2 fast path)
        g, s_a = (8, 1) if variant == "ln_res_add_sample" else (2, 32)
        add = np.random.RandomState(3).randn(g, s_a, k).astype(np.float32)
        want = pm._ref_ln_geglu_mlp_res_add(*args, jnp.asarray(add))
        got = _mlp_port(d, True, True, add)
    _close(got, want, 1e-4, 1e-4)


def test_geglu_mlp_plain_matches_pallas_interpret():
    from posetraj_tpu.ops.pallas_mlp import _fused_impl

    m, k, n = 256, 64, 128
    d = _mlp_inputs(m, k, n, seed=4)
    add = np.random.RandomState(5).randn(2, 1, k).astype(np.float32)
    j = {key: jnp.asarray(v) for key, v in d.items()}
    want = _fused_impl(j["x"], j["w1"], j["b1"], j["w2"], j["b2"], ln_s=j["ln_s"], ln_b=j["ln_b"],
                       block_m=128, block_n=128, interpret=True, residual=True, add=jnp.asarray(add))
    _close(_mlp_port(d, True, True, add), want, 1e-4, 1e-4)


# --------------------------------------------------------------------------
# Kernels C and D: spatial and temporal attention sub-layers
# --------------------------------------------------------------------------


def _sublayer_inputs(shape, n, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (
        rng.randn(*shape).astype(np.float32),
        rng.rand(c).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
        (rng.randn(c, 3 * c) / np.sqrt(c)).astype(np.float32),
        (rng.randn(c, c) / np.sqrt(c)).astype(np.float32),
        (rng.randn(c) * 0.1).astype(np.float32),
        n,
    )


def _port_args(a):
    x, ln_s, ln_b, wqkv, wo, bo, n = a
    return _t(x), _t(ln_s), _t(ln_b), _t(wqkv.T.copy()), _t(wo.T.copy()), _t(bo), n


@pytest.mark.parametrize("s", [128, 200])  # 200: a ragged S, like 2880 at 320x576
def test_attn_sublayer_plain_matches_jax_ref(s):
    from posetraj_tpu.ops.pallas_qkvt import _ref_attn_sublayer

    a = _sublayer_inputs((2, s, 128), 2, seed=6)
    want = _ref_attn_sublayer(*[jnp.asarray(v) for v in a[:6]], a[6], 1e-5)
    _close(qkvt.attn_sublayer(*_port_args(a)), want, 1e-4, 1e-4)


def test_attn_sublayer_plain_matches_pallas_interpret():
    from posetraj_tpu.ops.pallas_qkvt import attn_sublayer

    a = _sublayer_inputs((1, 128, 128), 2, seed=7)
    want = attn_sublayer(*[jnp.asarray(v) for v in a[:6]], a[6])
    _close(qkvt.attn_sublayer(*_port_args(a)), want, 1e-4, 1e-4)


def test_attn_sublayer_plain_chunks_the_batch(monkeypatch):
    """The plain version walks the batch in chunks to bound its logits."""
    a = _port_args(_sublayer_inputs((3, 64, 128), 2, seed=8))
    whole = qkvt.attn_sublayer_plain(*a)
    monkeypatch.setattr(qkvt, "_PLAIN_LOGIT_BYTES", 1)
    _close(qkvt.attn_sublayer_plain(*a), whole.numpy(), 1e-6, 1e-6)


@pytest.mark.parametrize("f", [3, 14])
def test_temporal_sublayer_plain_matches_jax_ref(f):
    from posetraj_tpu.ops.pallas_temporal import _ref_temporal_sublayer

    a = _sublayer_inputs((2, f, 64, 128), 2, seed=9)
    want = _ref_temporal_sublayer(*[jnp.asarray(v) for v in a[:6]], a[6], 1e-5)
    _close(temporal.temporal_attn_sublayer(*_port_args(a)), want, 1e-4, 1e-4)


def test_temporal_sublayer_plain_matches_pallas_interpret():
    from posetraj_tpu.ops.pallas_temporal import temporal_attn_sublayer

    a = _sublayer_inputs((1, 3, 128, 128), 2, seed=10)
    want = temporal_attn_sublayer(*[jnp.asarray(v) for v in a[:6]], a[6])
    _close(temporal.temporal_attn_sublayer(*_port_args(a)), want, 1e-4, 1e-4)


# --------------------------------------------------------------------------
# Dispatch: plain only for CPU tensors, never a silent fallback
# --------------------------------------------------------------------------


def test_cpu_tensors_run_plain_and_count_no_launch():
    _native.reset_launches()
    x = torch.randn(2, 4, 4, 64)
    groupnorm.group_norm(x, torch.ones(64), torch.zeros(64), 32, 1e-5, True)
    qkvt.attn_sublayer(*_port_args(_sublayer_inputs((1, 16, 128), 2, seed=11)))
    assert all(v == 0 for v in _native.LAUNCHES.values())


@pytest.mark.parametrize("call", ["groupnorm", "mlp", "qkvt", "temporal"])
def test_kernel_entry_refuses_cpu_tensors(call):
    """The kernel paths take CUDA tensors or raise; nothing runs on the CPU
    in their place."""
    with pytest.raises(ValueError):
        if call == "groupnorm":
            groupnorm.group_norm_kernel(torch.randn(2, 4, 64), torch.ones(64), torch.zeros(64), 32, 1e-5, True)
        elif call == "mlp":
            d = _mlp_inputs(64, 64, 64, seed=12)
            mlp.geglu_mlp_kernel(*(_t(d[k]).to(torch.bfloat16) for k in ("x",)),
                                 _t(d["w1"].T.copy()).bfloat16(), _t(d["b1"]).bfloat16(),
                                 _t(d["w2"].T.copy()).bfloat16(), _t(d["b2"]).bfloat16())
        elif call == "qkvt":
            x, ln_s, ln_b, wqkv, wo, bo, n = _port_args(_sublayer_inputs((1, 64, 128), 2, seed=13))
            qkvt.attn_sublayer_kernel(x.bfloat16(), ln_s, ln_b, wqkv.bfloat16(), wo.bfloat16(), bo.bfloat16(), n)
        else:
            x, ln_s, ln_b, wqkv, wo, bo, n = _port_args(_sublayer_inputs((1, 2, 64, 128), 2, seed=14))
            temporal.temporal_attn_sublayer_kernel(x.bfloat16(), ln_s, ln_b, wqkv.bfloat16(), wo.bfloat16(),
                                                   bo.bfloat16(), n)
