"""The port's four CUDA kernels against their plain PyTorch versions, on the
card (bf16). Skipped without a GPU.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_cuda.py

For the residual sub-layers (B, C, D) the error is measured on the branch,
out minus the residual term, against the branch's own size: the residual is
made small and the attention peaked, so a wrong attention core cannot hide
under the residual. Tolerances: max abs error within 2e-2 (A) or 3e-2 (B-D)
of the reference's max, and for B-D an error RMS within 1e-2 of the branch's
RMS (a few bf16 roundings on the way; bf16 keeps 8 bits).
"""

import math

import pytest
import torch

from posetraj_torch.ops import groupnorm, mlp, qkvt, temporal


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")


def _check(got, want, tol, base=None, rms_tol=None):
    want = want.float()
    ref = want - base.float() if base is not None else want
    diff = got.float() - want
    err, scale = float(diff.abs().max()), float(ref.abs().max())
    rel_rms = float(diff.norm() / ref.norm())
    assert err <= tol * scale, (err, scale)
    if rms_tol is not None:
        assert rel_rms <= rms_tol, rel_rms


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    _need_cuda()
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    x = rnd(2, 3, 16, 16, 64)
    w, b = rnd(64, dtype=torch.float32).abs() + 0.5, rnd(64, dtype=torch.float32)
    add = rnd(2, 3, 64)
    _check(groupnorm.group_norm_kernel(x, w, b, 32, 1e-6, True, add),
           groupnorm.group_norm_plain(x, w, b, 32, 1e-6, True, add), 2e-2)

    m, k, n = 1000, 320, 1280
    args = (rnd(m, k), rnd(2 * n, k, scale=k**-0.5), rnd(2 * n, scale=0.1), rnd(k, n, scale=n**-0.5),
            rnd(k, scale=0.1), rnd(k, dtype=torch.float32) + 1, rnd(k, dtype=torch.float32))
    addm = rnd(10, 1, k)
    _check(mlp.geglu_mlp_kernel(*args, 1e-5, True, addm), mlp.geglu_mlp_plain(*args, 1e-5, True, addm), 3e-2,
           mlp.broadcast_add_rows(args[0], addm), 1e-2)

    def sublayer(shape, sigma):
        # logits q.k/8 of standard deviation sigma; x small beside the branch
        c = shape[-1]
        wqkv = rnd(3 * c, c, scale=c**-0.5)
        wqkv[: 2 * c] *= sigma**0.5
        return (rnd(*shape, scale=0.1), rnd(c, dtype=torch.float32) * 0.1 + 1, rnd(c, dtype=torch.float32) * 0.1,
                wqkv, rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), c // 64)

    # 576: whole tiles; 200 and 180: ragged key and query tiles, where a key
    # mask that let the padded keys in would move the branch by 4-14%.
    for s in (576, 200, 180):
        a = sublayer((2, s, 320), math.sqrt(max(1.0, math.log(s / 64))))
        _check(qkvt.attn_sublayer_kernel(*a), qkvt.attn_sublayer_plain(*a), 3e-2, a[0], 1e-2)

    a = sublayer((2, 14, 100, 320), 1.0)
    _check(temporal.temporal_attn_sublayer_kernel(*a), temporal.temporal_attn_sublayer_plain(*a), 3e-2, a[0], 1e-2)
