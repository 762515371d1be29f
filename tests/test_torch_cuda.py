"""The port's CUDA kernels (A-D, the flash attention of kernel 5 forward and
backward, kernel 6's packed-QKV and kernel 7's forward-only flash attention,
kernel 8's row LayerNorm) against their plain PyTorch versions, on the card
(bf16, and float32 for kernel 8). Skipped without a GPU.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_cuda.py

For the residual sub-layers (B, C, D) the error is measured on the branch,
out minus the residual term, against the branch's own size: the residual is
made small and the attention peaked, so a wrong attention core cannot hide
under the residual. Tolerances: max abs error within 2e-2 (A) or 3e-2 (B-D)
of the reference's max, and for B-D an error RMS within 1e-2 of the branch's
RMS (a few bf16 roundings on the way; bf16 keeps 8 bits). Kernel 5: o, dq,
dk and dv within 3e-2 of the reference's max and 1e-2 in relative RMS, the
base-2 lse within 2e-3 absolute (float32 logits of bf16 inputs on both
sides). A dq from a kernel that dropped log2(e) would be off by far more.
Kernels 6 and 7 take kernel 5's tolerances, as does the one Hopper
forward that C, 5, 6 and 7 share, held on each caller's layout with and
without lse (test_cuda_flash_forward_layouts). Kernel 8: within 1e-2 of the
reference's max and 2e-3 rel RMS in bf16 (one rounding apart), 1e-5 and
1e-6 in float32 (summation order).
"""

import math

import pytest
import torch

from posetraj_torch.ops import _native, flash, groupnorm, layernorm, mlp, qkvt, temporal


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


def _flash_inputs(g, bn, sq, skv, d, sigma):
    """bf16 q (bn, sq, d), k, v (bn, skv, d) and do, with logits of standard
    deviation sigma, so that a few dozen keys carry each query's weight."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    return (rnd(bn, sq, d, scale=sigma**0.5), rnd(bn, skv, d, scale=sigma**0.5), rnd(bn, skv, d),
            rnd(bn, sq, d))


# (BN, Sq, Skv, d): ragged S = 200 and 180 for the 128-row blocks and the
# 64- and 128-row tiles, a rectangular Skv = 2 Sq, d = 64 and 128; then
# ragged Sq and Skv that differ both ways (144, 333, 600) and the training
# shape's S = 2880.
FLASH_CASES = [(6, 200, 200, 64), (6, 180, 180, 64), (5, 180, 180, 128), (4, 200, 200, 128), (3, 256, 512, 64),
               (2, 576, 576, 64), (3, 144, 600, 64), (2, 600, 144, 64), (2, 333, 200, 128), (2, 200, 333, 128),
               (1, 2880, 2880, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("bn,sq,skv,d", FLASH_CASES)
def test_cuda_flash_matches_plain(bn, sq, skv, d):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sq + d)
    q, k, v, do = _flash_inputs(g, bn, sq, skv, d, math.sqrt(max(1.0, math.log(skv / 64))))
    scale = d**-0.5
    o, lse = flash.flash_fwd_kernel(q, k, v, scale)
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, scale)
    torch.cuda.synchronize()
    _check(o, o_ref, 3e-2, rms_tol=1e-2)
    assert float((lse - lse_ref).abs().max()) <= 2e-3
    got = flash.flash_bwd_kernel(q, k, v, o_ref, lse_ref, do, scale)
    want = flash.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, scale)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _check(a, b, 3e-2, rms_tol=1e-2)


@pytest.mark.cuda
def test_cuda_flash_autograd_counts_launches():
    """FlashAttention.apply on the card: one forward and one backward
    launch, and gradients that match the plain backward."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = _flash_inputs(g, 3, 600, 600, 64, 2.0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _native.reset_launches()
    out = flash.FlashAttention.apply(*leaves, 0.125)
    out.backward(do)
    assert _native.LAUNCHES["flash_fwd"] == 1 and _native.LAUNCHES["flash_bwd"] == 1
    o_ref, lse_ref = flash.flash_fwd_plain(q, k, v, 0.125)
    for t, want in zip(leaves, flash.flash_bwd_plain(q, k, v, o_ref, lse_ref, do, 0.125)):
        _check(t.grad, want, 3e-2, rms_tol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["groupnorm", "mlp", "qkvt", "temporal", "flash_fwd", "flash_bwd"])
def test_cuda_raw_launchers_refuse_tensors_that_require_grad(call):
    """A raw kernel launcher writes outputs autograd knows nothing of: under
    grad mode it refuses an input that requires grad instead of cutting
    the gradient."""
    _need_cuda()
    dev, bf = "cuda", torch.bfloat16
    x = torch.randn(2, 64, 128, device=dev, dtype=bf, requires_grad=True)
    w = torch.ones(128, device=dev, requires_grad=True)
    b = torch.zeros(128, device=dev)
    wq = torch.randn(384, 128, device=dev, dtype=bf) * 0.05
    wo = torch.randn(128, 128, device=dev, dtype=bf) * 0.05
    bo = torch.zeros(128, device=dev, dtype=bf)
    with pytest.raises(RuntimeError, match="requires grad"):
        if call == "groupnorm":
            groupnorm.group_norm_kernel(x, w, b, 32, 1e-5, True)
        elif call == "mlp":
            mlp.geglu_mlp_kernel(x.reshape(-1, 128), torch.randn(512, 128, device=dev, dtype=bf),
                                 torch.zeros(512, device=dev, dtype=bf), torch.randn(128, 256, device=dev, dtype=bf),
                                 torch.zeros(128, device=dev, dtype=bf))
        elif call == "qkvt":
            qkvt.attn_sublayer_kernel(x, w, b, wq, wo, bo, 2)
        elif call == "temporal":
            temporal.temporal_attn_sublayer_kernel(x.reshape(1, 2, 64, 128), w, b, wq, wo, bo, 2)
        elif call == "flash_fwd":
            flash.flash_fwd_kernel(x, x.detach(), x.detach(), 0.125)
        else:
            d = x.detach()
            flash.flash_bwd_kernel(d, d, d, d, torch.zeros(2, 64, device=dev), x, 0.125)


# (B, Sq, Skv, N, d) for kernel 7: the packed-projection views at ragged
# S = 200 and 600, a rectangular Skv = 2 Sq, d = 128.
TQ_CASES = [(2, 200, 200, 5, 64), (2, 600, 600, 2, 64), (3, 200, 400, 2, 64), (2, 180, 180, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,n,d", TQ_CASES)
def test_cuda_flash_tq_matches_plain(b, sq, skv, n, d):
    """Kernel 7 on strided q, k, v views (split of a packed projection where
    Sq == Skv) against the plain version; one launch counted per call."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sq + skv + d)
    sigma = math.sqrt(max(1.0, math.log(skv / 64)))
    c = n * d
    if sq == skv:
        qkv = (torch.randn(b, sq, 3 * c, generator=g, device="cuda") * sigma**0.5).to(torch.bfloat16)
        q, k, v = (t.unflatten(-1, (n, d)) for t in qkv.split(c, dim=-1))
    else:
        q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda").to(torch.bfloat16) for s in (sq, skv, skv))
    _native.reset_launches()
    got = flash.flash_attention_tq(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["flash_tq"] == 1 and got.shape == (b, sq, n, d)
    _check(got, flash.flash_attention_tq_plain(q, k, v, d**-0.5), 3e-2, rms_tol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,n", [(2, 600, 2), (1, 200, 3)])
def test_cuda_flash_qkv_matches_plain(b, s, n):
    """Kernel 6 at head_dim 128: o and lse against the plain version, and
    the gradient of qkv through FlashAttentionQKV against autograd of the
    plain attention."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(s + n)
    c, d = n * 128, 128
    qkv = (torch.randn(b, s, 3 * c, generator=g, device="cuda") * 1.3).to(torch.bfloat16)
    do = torch.randn(b, s, c, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = flash.flash_qkv_kernel(qkv, n, d**-0.5)
    o_ref, lse_ref = flash.flash_qkv_plain(qkv, n, d**-0.5)
    torch.cuda.synchronize()
    _check(o, o_ref, 3e-2, rms_tol=1e-2)
    assert float((lse - lse_ref).abs().max()) <= 2e-3
    leaf = qkv.clone().requires_grad_(True)
    _native.reset_launches()
    flash.flash_attention_qkv(leaf, n, d**-0.5).backward(do)
    assert _native.LAUNCHES["flash_qkv"] == 1 and _native.LAUNCHES["flash_bwd"] == 1
    ref = qkv.float().requires_grad_(True)
    q, k, v = (t.unflatten(-1, (n, d)) for t in ref.split(c, dim=-1))
    torch.nn.functional.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                                                     ).transpose(1, 2).reshape(b, s, c).backward(do.float())
    for got, want in zip(leaf.grad.split(c, dim=-1), ref.grad.split(c, dim=-1)):
        _check(got, want, 3e-2, rms_tol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,dtype", [(4096, 320, torch.bfloat16), (1000, 640, torch.bfloat16),
                                       (300, 1280, torch.bfloat16), (77, 2048, torch.float32),
                                       (513, 136, torch.float32)])
def test_cuda_layer_norm_matches_plain(m, c, dtype):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(m + c)
    x = (torch.randn(m, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = torch.randn(c, generator=g, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=g, device="cuda") * 0.1
    _native.reset_launches()
    got = layernorm.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["layernorm"] == 1
    tol, rms_tol = (1e-2, 2e-3) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    _check(got, layernorm.layer_norm_plain(x, w, b, 1e-5), tol, rms_tol=rms_tol)
    with pytest.raises(RuntimeError, match="fused_ln"):
        layernorm.layer_norm(x, w.requires_grad_(True), b, 1e-5)


def _forward_operands(g, layout, b, sq, skv, n, d):
    """q (b, sq, n, d), k, v (b, skv, n, d) bf16 in one of the four layouts
    the forward is launched on, logits of sd sqrt(ln(skv / 64)):
    "folded" (kernel 5: head-folded (B*N, S, d) seen as (B*N, S, 1, d)),
    "views" (kernel 7: (B, S, N, d) views of q, k, v tensors cut from wider
    rows), "packed" (kernel 6: q, k, v views of one (B, S, 3C) projection)
    and "scratch" (kernel C: slices of a (3, B, N, S, d) scratch)."""
    sigma = math.sqrt(max(1.0, math.log(skv / 64)))

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    if layout == "folded":
        q, k, v = (rnd(b * n, s, d)[:, :, None] for s in (sq, skv, skv))
    elif layout == "views":
        q, k, v = (rnd(b, s, n, d + 16)[..., 8 : 8 + d] for s in (sq, skv, skv))
    elif layout == "packed":
        q, k, v = (t.unflatten(-1, (n, d)) for t in rnd(b, sq, 3 * n * d).split(n * d, dim=-1))
    else:
        q, k, v = (t.permute(0, 2, 1, 3) for t in rnd(3, b, n, sq, d))
    return q * sigma**0.5, k * sigma**0.5, v


# (layout, B, Sq, Skv, N, d): C's scratch at the attention's S of both
# resolutions (9216, 2880, 720, 180, 144 and a ragged 200), every layout at
# d 64 and 128, Sq != Skv both ways.
FORWARD_CASES = [("scratch", 1, s, s, 2, 64) for s in (9216, 2880, 720, 180, 144, 200)] + [
    ("folded", 2, 720, 720, 2, 128), ("folded", 2, 200, 456, 2, 64), ("views", 2, 456, 200, 3, 64),
    ("views", 1, 180, 180, 2, 128), ("packed", 2, 144, 144, 2, 128), ("packed", 2, 600, 600, 3, 64),
    ("scratch", 2, 200, 200, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("layout,b,sq,skv,n,d", FORWARD_CASES)
def test_cuda_flash_forward_layouts(layout, b, sq, skv, n, d, with_lse):
    """The one Hopper forward (kernels C, 5, 6, 7) on each caller's layout,
    with and without lse, against the plain forward on head-folded copies;
    o written as (B, Sq, N, d), which is (B, Sq, C) with head h at column
    h d, as kernel C's out-projection reads it."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sq + skv + d + n)
    q, k, v = _forward_operands(g, layout, b, sq, skv, n, d)
    o, lse = flash._launch_fwd(q, k, v, d**-0.5, with_lse, "flash_tq")
    torch.cuda.synchronize()
    o_ref, lse_ref = flash.flash_fwd_plain(*(flash._fold(t) for t in (q, k, v)), d**-0.5)
    _check(flash._fold(o), o_ref, 3e-2, rms_tol=1e-2)
    assert o.shape == q.shape and o.is_contiguous()
    if with_lse:
        assert float((lse - lse_ref).abs().max()) <= 2e-3
    else:
        assert lse is None

