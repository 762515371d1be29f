"""One composed ControlNet -> UNet denoise step of the port against the JAX
package at the tiny config, float32 on the CPU, after `params_from_jax` of the
same JAX-initialised parameters. Tolerance 2e-4 of the output's max: float32
summation-order noise over dozens of chained layers."""

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


def _rel_close(got, want, tol):
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


@pytest.fixture(scope="module")
def step_case():
    """One composed ControlNet -> UNet step at the tiny config on a CFG batch
    of 2, with every zero conv randomised so the residual path (and the Q1
    in-loop re-add) reaches the output: the JAX step's output (off the TPU
    every kernel gate of the JAX package is closed, so it is the same under
    any KernelConfig) and the port's parameters and inputs."""
    from posetraj_tpu.configs import ControlNetConfig as JCn, UNetConfig as JU
    from posetraj_tpu.models import controlnet as jcn, unet as ju

    ucfg, ccfg = JU.tiny(), JCn.tiny()
    up = ju.init_unet(_key(16), ucfg)
    cp = jcn.controlnet_from_unet(jcn.init_controlnet(_key(17), ccfg), up)
    for i, zc in enumerate(cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"]]):
        zc["kernel"] = jnp.asarray(_rand(30 + i, *zc["kernel"].shape, scale=0.05))
    co = cp["controlnet_cond_embedding"]["stack"]["conv_out"]
    co["kernel"] = jnp.asarray(_rand(50, *co["kernel"].shape, scale=0.05))

    b, f, h, w = 2, 2, 8, 8
    sample = _rand(25, b, f, h, w, 8)
    ctx = _rand(26, b, 1, ucfg.cross_attention_dim)
    ids = np.asarray([[6.0, 128.0, 0.02]] * b, np.float32)
    cond = np.random.RandomState(27).rand(b, f, 8 * h, 8 * w, 3).astype(np.float32) * 2 - 1
    t = np.float32(0.25 * np.log(700.0))

    def jstep(cp_, up_, sample_, ctx_, ids_, cond_):
        down, mid = jcn.controlnet_forward(cp_, ccfg, sample_, t, ctx_, ids_, controlnet_cond=cond_,
                                           compute_dtype=jnp.float32)
        return ju.unet_forward(up_, ucfg, sample_, t, ctx_, ids_, down, mid, compute_dtype=jnp.float32)

    want = jax.jit(jstep)(cp, up, *(jnp.asarray(a) for a in (sample, ctx, ids, cond)))
    return {"cp": params_from_jax(cp), "up": params_from_jax(up), "inputs": (sample, t, ctx, ids, cond),
            "want": np.asarray(want)}


def port_step(case):
    """The port's step on the case's parameters and inputs: (ControlNet's
    first residual, output)."""
    from posetraj_torch.configs import ControlNetConfig, UNetConfig
    from posetraj_torch.models import controlnet as tcn, unet as tu

    sample, t, ctx, ids, cond = case["inputs"]
    down, mid = tcn.controlnet_forward(case["cp"], ControlNetConfig.tiny(), _t(sample), t, _t(ctx), _t(ids),
                                       controlnet_cond=_t(cond), compute_dtype=torch.float32)
    out = tu.unet_forward(case["up"], UNetConfig.tiny(), _t(sample), t, _t(ctx), _t(ids), down, mid,
                          compute_dtype=torch.float32)
    return down[0], out


def test_controlnet_unet_step_matches_jax(step_case):
    """The step under the default KernelConfig."""
    down0, got = port_step(step_case)
    assert float(np.abs(_np(down0)).max()) > 0  # the residual path is live
    _rel_close(got, step_case["want"], 2e-4)
