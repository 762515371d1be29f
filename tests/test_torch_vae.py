"""The port's VAE (encode, and decode with the mid-block zip semantics)
against the JAX package at tiny configs, in float32 on the CPU, after
`params_from_jax` of the same JAX-initialised parameters and on the same
numpy inputs.

Tolerance: 1e-4 of the output's max, float32 summation-order noise over
the decoder's chained convolutions.
"""

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


@pytest.fixture(scope="module")
def tiny_vae():
    from posetraj_tpu.configs import VAEConfig as JCfg
    from posetraj_tpu.models import vae as jv

    p = jv.init_vae(_key(14), JCfg.tiny())
    return p, params_from_jax(p)


def test_vae_encode_matches_jax(tiny_vae):
    from posetraj_tpu.configs import VAEConfig as JCfg
    from posetraj_tpu.models import vae as jv
    from posetraj_torch.configs import VAEConfig
    from posetraj_torch.models import vae as tv

    jp, tp = tiny_vae
    x = np.random.RandomState(23).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    mean, logvar = jax.jit(jv.encode, static_argnums=(1,))(jp["encoder"], JCfg.tiny(), jnp.asarray(x))
    tmean, tlogvar = tv.encode(tp["encoder"], VAEConfig.tiny(), _t(x))
    _rel_close(tmean, mean, 1e-4)
    _rel_close(tlogvar, logvar, 1e-4)


@pytest.mark.parametrize("layers", [1, 2])  # 1: the mid-block attention is never applied
def test_vae_decode_matches_jax(layers):
    import dataclasses

    from posetraj_tpu.configs import VAEConfig as JCfg
    from posetraj_tpu.models import vae as jv
    from posetraj_torch.models import vae as tv

    jcfg = dataclasses.replace(JCfg.tiny(), layers_per_block=layers)
    p = jv.init_vae(_key(15), jcfg)
    for blk in p["decoder"]["mid_block"]["resnets"] + sum((u["resnets"] for u in p["decoder"]["up_blocks"]), []):
        blk["time_mixer"]["mix_factor"] = jnp.asarray([0.3])  # exercise the temporal branch
    z = _rand(24, 4, 4, 4, 4)
    want = jax.jit(jv.decode, static_argnums=(1, 3))(p["decoder"], jcfg, jnp.asarray(z), 2)
    from posetraj_torch.configs import VAEConfig

    got = tv.decode(params_from_jax(p["decoder"]), VAEConfig(**dataclasses.asdict(jcfg)), _t(z), 2)
    _rel_close(got, want, 1e-4)
