"""Kernel 5 of the port (posetraj_torch/ops/flash.py) against the JAX
package, on the CPU in float32.

* flash_fwd_plain / flash_bwd_plain against the Pallas _flash_fwd_lse and
  _flash_bwd in interpret mode at a ragged shape (S = 200 is padded to the
  128-row blocks on the JAX side; its lse is compared after slicing the
  padding off). Tolerances 2e-5 abs / 1e-4 rel: float32 summation order over
  200 keys.
* FlashAttention.backward on the CPU against autograd of the plain
  dot_product_attention, rectangular Skv = 2 Sq included; 1e-5 abs / 1e-4 rel.
* The attention() dispatch rule and the raw launchers' refusal of tensors
  that require grad.

The CUDA kernels are checked against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posetraj_torch.ops import _native, flash, groupnorm, mlp, qkvt, temporal
from posetraj_torch.ops.attention import attention, dot_product_attention


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


def _fold(a):
    """(B, S, N, H) numpy -> (B*N, S, H) torch."""
    b, s, n, h = a.shape
    return _t(a.transpose(0, 2, 1, 3).reshape(b * n, s, h))


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def ragged():
    """q, k, v, do (B, S, N, H) = (1, 200, 2, 64) and the Pallas forward and
    backward of them in interpret mode, 128-row blocks."""
    from posetraj_tpu.ops.pallas_attention import _flash_bwd, _flash_fwd_lse

    rng = np.random.RandomState(8)
    q, k, v, do = (rng.randn(1, 200, 2, 64).astype(np.float32) for _ in range(4))
    scale = 64**-0.5
    out, lse = _flash_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, block_q=128, block_k=128,
                              interpret=True)
    grads = _flash_bwd(*(jnp.asarray(a) for a in (q, k, v)), out, lse, jnp.asarray(do), scale, block_q=128,
                       block_k=128, interpret=True)
    return (q, k, v, do, scale), (np.asarray(out), np.asarray(lse)), tuple(np.asarray(g) for g in grads)


def test_flash_fwd_plain_matches_pallas_interpret(ragged):
    (q, k, v, _, scale), (out, lse), _ = ragged
    o, lse_t = flash.flash_fwd_plain(_fold(q), _fold(k), _fold(v), scale)
    _close(o, out.transpose(0, 2, 1, 3).reshape(2, 200, 64), 2e-5, 1e-4)
    assert lse.shape == (2, 256)  # padded to the q-block grid
    _close(lse_t, lse[:, :200], 2e-5, 1e-4)


def test_flash_bwd_plain_matches_pallas_interpret(ragged):
    (q, k, v, do, scale), (out, lse), grads = ragged
    o_t = _fold(out)
    got = flash.flash_bwd_plain(_fold(q), _fold(k), _fold(v), o_t, _t(lse[:, :200]), _fold(do), scale)
    for g, want in zip(got, grads):
        _close(g, want.transpose(0, 2, 1, 3).reshape(2, 200, 64), 2e-5, 1e-4)


def test_flash_lse_is_base_2():
    """lse = log2 of the row sums of exp2 of the logits scaled by scale *
    log2(e): log-sum-exp of the natural logits times log2(e)."""
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(2, 40, 64)) for _ in range(3))
    _, lse = flash.flash_fwd_plain(q, k, v, 0.125)
    nat = torch.logsumexp(q @ k.transpose(1, 2) * 0.125, dim=-1)
    _close(lse, (nat * flash.LOG2E).numpy(), 1e-5, 1e-5)


@pytest.mark.parametrize("sq,skv,d", [(200, 200, 64), (96, 192, 64), (50, 50, 128)])
def test_flash_autograd_matches_plain_attention_grads(sq, skv, d):
    """FlashAttention.backward (the plain flash backward on the CPU) against
    autograd through dot_product_attention."""
    rng = np.random.RandomState(sq + d)
    b, n = 2, 2
    q, k, v = (_t(rng.randn(b, s, n, d)) for s in (sq, skv, skv))
    do = _t(rng.randn(b, sq, n, d))
    scale = d**-0.5

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash.flash_attention(*leaves, scale).backward(do)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dot_product_attention(*ref, scale).backward(do)
    for got, want in zip(leaves, ref):
        _close(got.grad, want.grad.numpy(), 1e-5, 1e-4)
    _close(flash.flash_attention(q, k, v, scale), dot_product_attention(q, k, v, scale).numpy(), 1e-5, 1e-4)


class _OnCard:
    """Stands in for a CUDA tensor of a given shape in the dispatch rule."""

    is_cuda = True

    def __init__(self, *shape):
        self.shape = shape


@pytest.mark.parametrize("sq,skv,hd,taken", [
    (2880, 2880, 64, True),    # 320x576 level 0 (training's spatial attention)
    (720, 720, 64, True),      # level 1
    (720, 1440, 128, True),    # gathered K/V, head_dim 128
    (180, 180, 64, False),     # level 2: short
    (257, 257, 80, False),     # CLIP ViT-H
    (4608, 4608, 512, False),  # VAE mid-block, one head of 512
    (2880, 1, 64, False),      # cross-attention over the CLIP token
    (1024, 512, 64, False),    # fewer keys than queries
])
def test_flash_dispatch_rule(sq, skv, hd, taken):
    assert flash.flash_applicable(_OnCard(1, sq, hd), skv, hd) is taken


def test_attention_on_cpu_is_plain_and_launches_nothing():
    rng = np.random.RandomState(4)
    q, k, v = (_t(rng.randn(1, 600, 128)) for _ in range(3))
    _native.reset_launches()
    out = attention(q, k, v, 2)
    want = dot_product_attention(*(t.reshape(1, 600, 2, 64) for t in (q, k, v)), 0.125).reshape(1, 600, 128)
    _close(out, want.numpy(), 0, 0)
    assert all(v == 0 for v in _native.LAUNCHES.values())
    assert set(_native.LAUNCHES) == set(_native.COUNTERS) >= {"flash_fwd", "flash_bwd"}


@pytest.mark.parametrize("call", ["groupnorm", "mlp", "qkvt", "temporal", "flash_fwd", "flash_bwd"])
def test_raw_launchers_refuse_tensors_that_require_grad(call):
    """A raw kernel launcher writes outputs autograd knows nothing of; under
    grad mode it refuses an input that requires grad, before it looks at the
    device, so the refusal shows here too."""
    bf = torch.bfloat16
    x = torch.randn(2, 64, 128, dtype=bf, requires_grad=True)
    w, b = torch.ones(128, requires_grad=True), torch.zeros(128)
    wq, wo, bo = torch.zeros(384, 128, dtype=bf), torch.zeros(128, 128, dtype=bf), torch.zeros(128, dtype=bf)
    with pytest.raises(RuntimeError, match="requires grad"):
        if call == "groupnorm":
            groupnorm.group_norm_kernel(x, w, b, 32, 1e-5, True)
        elif call == "mlp":
            mlp.geglu_mlp_kernel(x.reshape(-1, 128), torch.zeros(512, 128, dtype=bf), torch.zeros(512, dtype=bf),
                                 torch.zeros(128, 256, dtype=bf), torch.zeros(128, dtype=bf))
        elif call == "qkvt":
            qkvt.attn_sublayer_kernel(x, w, b, wq, wo, bo, 2)
        elif call == "temporal":
            temporal.temporal_attn_sublayer_kernel(x.reshape(1, 2, 64, 128), w, b, wq, wo, bo, 2)
        elif call == "flash_fwd":
            flash.flash_fwd_kernel(x, x.detach(), x.detach(), 0.125)
        else:
            d = x.detach()
            flash.flash_bwd_kernel(d, d, d, d, torch.zeros(2, 64), x, 0.125)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash.flash_fwd_kernel(x, x, x, 0.125)  # without grad mode: refused for the device alone
