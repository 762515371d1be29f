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
1e-6 in float32 (summation order), also at every width of its launch plan's
sweep and at ragged row counts. generate() and the pipeline, whose denoise
loop replays a captured CUDA graph on the card, are held bit for bit
against the eager loop (or within the eager loop's own spread, should two
eager runs differ), with the same launch counts. The Hopper GEMM of B, C and D
(csrc/gemm.cuh), held on B's variants and alone on each epilogue at ragged
M, N and K, takes B's tolerances. D's frame attention alone takes D's
tolerances; blocks whose gates decline C and D are held to the step's
(3e-2 relative RMS of the all-plain block: bf16 roundings along a block).
The temp hint encoder (A, then B in each of its blocks) is held to B's
tolerances on its branch, the output minus the conv stack's. Kernel A's
split form (the statistics of two W blocks summed, then the apply of each)
takes A's tolerance, its float64 sums within 1e-4 of the plain float32
statistics; generate_sharded on a (1, 1) mesh launches what generate()
launches with C and D off and lands within 2e-2 relative RMS of its
latents.
"""

import math

import pytest
import torch

from posetraj_torch.ops import _native, flash, gemm, groupnorm, layernorm, mlp, qkvt, temporal


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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 40, 320, 328, 640, 1280, 2040, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", ["1", "7", "wave+1"])
def test_cuda_layer_norm_plan_widths(c, dtype, rows):
    """Kernel 8 at every width of its plan's sweep (even and ragged lane
    groups, one to sixteen vectors a lane) and at 1, 7 and one more row
    than the persistent grid takes in one pass of its warps."""
    _need_cuda()
    vecs = layernorm.layout(c, dtype.itemsize)[1]
    p = layernorm.plan(1 << 30, c, dtype, *layernorm.occupancy(torch.device("cuda", 0), dtype, vecs))
    m = {"1": 1, "7": 7, "wave+1": p.grid * layernorm.THREADS // 32 * p.rows + 1}[rows]
    g = torch.Generator(device="cuda").manual_seed(m + c)
    x = (torch.randn(m, c, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    w = torch.randn(c, generator=g, device="cuda") * 0.1 + 1
    b = torch.randn(c, generator=g, device="cuda") * 0.1
    got = layernorm.layer_norm_kernel(x, w, b, 1e-5)
    torch.cuda.synchronize()
    tol, rms_tol = (1e-2, 2e-3) if dtype == torch.bfloat16 else (1e-5, 1e-6)
    _check(got, layernorm.layer_norm_plain(x, w, b, 1e-5), tol, rms_tol=rms_tol)


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



# (rows, K, variant) for kernel B on the Hopper GEMM: every variant of the
# four JAX entry points ("plain": no LayerNorm; "ln"; "ln_res"; "add1" and
# "addS": LayerNorm, residual and an addend (G, 1, K) or (G, S_a, K)), K of
# the three UNet levels, rows that leave a ragged 128-row tile (1000, 520)
# and the 320x576 level-1 shape 28 * 720.
MLP_CASES = [(1000, 320, "plain"), (1000, 320, "ln"), (1000, 320, "ln_res"), (1000, 320, "add1"),
             (1000, 640, "addS"), (520, 1280, "add1"), (28 * 720, 640, "addS")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,variant", MLP_CASES)
def test_cuda_geglu_mlp_variants(m, k, variant):
    """Kernel B (the row pre-pass and two GEMM launches) against its plain
    version on the branch, one `mlp` launch a call."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(m + k)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    n = 4 * k
    args = [rnd(m, k), rnd(2 * n, k, scale=k**-0.5), rnd(2 * n, scale=0.1), rnd(k, n, scale=n**-0.5),
            rnd(k, scale=0.1), rnd(k, dtype=torch.float32) * 0.1 + 1, rnd(k, dtype=torch.float32) * 0.1]
    if variant == "plain":
        args[5:] = [None, None]
    residual = variant not in ("plain", "ln")
    add = {"add1": lambda: rnd(10 if m == 1000 else 4, 1, k), "addS": lambda: rnd(2, 100 if m == 1000 else 720, k)
           }.get(variant, lambda: None)()
    _native.reset_launches()
    got = mlp.geglu_mlp_kernel(*args, 1e-5, residual, add)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["mlp"] == 1 and got.shape == (m, k)
    base = (mlp.broadcast_add_rows(args[0], add) if add is not None else args[0]) if residual else None
    _check(got, mlp.geglu_mlp_plain(*args, 1e-5, residual, add), 3e-2, base, 1e-2)


# (M, N, K, bias, residual) for the GEMM alone: C's and D's QKV and
# out-projection widths; N that pads its last tile (200, 72); K that is not
# a multiple of the 64-column stage (72, 200); M that leaves the second
# warpgroup of the last tile one row or none (1000, 65, 64).
GEMM_CASES = [(1000, 960, 320, False, False), (333, 320, 1280, True, True), (777, 1920, 640, False, False),
              (129, 200, 64, True, False), (65, 128, 72, False, True), (64, 72, 200, True, True),
              (300, 3840, 1280, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,bias,residual", GEMM_CASES)
def test_cuda_gemm_epilogues(m, n, k, bias, residual):
    """The Hopper GEMM alone (store, bias, bias + residual) against
    F.linear, one `gemm` launch a call."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(m + n + k)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    a, w = rnd(m, k), rnd(n, k, scale=k**-0.5)
    b = rnd(n, scale=0.1) if bias else None
    r = rnd(m, n, scale=0.1) if residual else None
    _native.reset_launches()
    got = gemm.linear_kernel(a, w, b, r)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["gemm"] == 1 and got.shape == (m, n)
    _check(got, gemm.linear_plain(a, w, b, r), 3e-2, r, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [("qkvt", (3, 45, 128)), ("qkvt", (2, 130, 192)), ("temporal", (2, 3, 45, 128))])
def test_cuda_sublayer_gemm_epilogues(kind, shape):
    """C's per-head scatter where S < 64 (one warpgroup's 64 rows span two
    or more batches, stored by TMA at negative S coordinates) and at a
    ragged S, and D's plain store, on the branch; two `gemm` launches a
    call."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    c = shape[-1]

    def rnd(*s, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*s, generator=g, device="cuda") * scale).to(dtype)

    a = (rnd(*shape, scale=0.1), rnd(c, dtype=torch.float32) * 0.1 + 1, rnd(c, dtype=torch.float32) * 0.1,
         rnd(3 * c, c, scale=c**-0.5) * 1.5, rnd(c, c, scale=c**-0.5), rnd(c, scale=0.1), c // 64)
    mod, kern, plain = ((qkvt, qkvt.attn_sublayer_kernel, qkvt.attn_sublayer_plain) if kind == "qkvt" else
                        (temporal, temporal.temporal_attn_sublayer_kernel, temporal.temporal_attn_sublayer_plain))
    _native.reset_launches()
    got = kern(*a)
    torch.cuda.synchronize()
    assert _native.LAUNCHES[kind] == 1 and _native.LAUNCHES["gemm"] == 2
    _check(got, plain(*a), 3e-2, a[0], 1e-2)


# Kernel A's schedule boundaries (ops/groupnorm.schedule): N = 1, 2 and 28;
# rows per sample that do not divide among a team's CTAs; samples above the
# L2 budget (one team, second read from HBM); float32; per-sample and
# per-frame addends; a mean of 0.5 beside the unit spread, so that E[x^2] -
# mean^2 in float32 partials would show.
GN_CASES = [
    ((1, 40, 56, 320), (1, 320), torch.bfloat16),
    ((2, 45, 77, 64), (2, 64), torch.bfloat16),
    ((28, 9, 16, 1280), (28, 1280), torch.bfloat16),
    ((28, 18, 32, 640), None, torch.bfloat16),
    ((3, 37, 41, 128), None, torch.float32),
    ((1, 200, 512, 128), None, torch.float32),
    ((2, 14, 36, 64, 320), (2, 14, 320), torch.bfloat16),
    ((2, 3, 13, 11, 64), (2, 3, 64), torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,add_shape,dtype", GN_CASES)
def test_cuda_group_norm_schedules(shape, add_shape, dtype):
    """Kernel A against its plain version at each schedule boundary, one
    wrapper launch a call; the teams' counters and sums left zero."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    c = shape[-1]
    x = (torch.randn(*shape, generator=g, device="cuda") + 0.5).to(dtype)
    w = torch.rand(c, generator=g, device="cuda") + 0.5
    b = torch.randn(c, generator=g, device="cuda") * 0.1
    add = torch.randn(*add_shape, generator=g, device="cuda").to(dtype) if add_shape else None
    _native.reset_launches()
    got = groupnorm.group_norm_kernel(x, w, b, 32, 1e-6, True, add)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["groupnorm"] == 1
    assert not any(t.any() for t in groupnorm._workspace(x.device, 32))
    _check(got, groupnorm.group_norm_plain(x, w, b, 32, 1e-6, True, add), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,add_shape,dtype", GN_CASES)
def test_cuda_group_norm_split_form(shape, add_shape, dtype):
    """Kernel A's split form (statistics launch, sums added across blocks,
    apply launch) over the two W halves of x, as two sp ranks run it,
    against the plain version of the unsplit GroupNorm; its float64 sums
    against the plain float32 statistics. The halves are drawn apart (the
    second x3 + 2), so that a half normalised by its own statistics fails
    A's tolerance, which is asserted too. One launch of each a call; the
    wrapper's split form with one block launches both."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + 1)
    c = shape[-1]
    w_axis = len(shape) - 2
    x = torch.randn(*shape, generator=g, device="cuda") + 0.5
    x = x.narrow(w_axis, 0, x.shape[w_axis] // 2 * 2).contiguous()  # two equal W blocks
    half = x.shape[w_axis] // 2
    x.narrow(w_axis, half, half).mul_(3.0).add_(2.0)
    x = x.to(dtype)
    w = torch.rand(c, generator=g, device="cuda") + 0.5
    b = torch.randn(c, generator=g, device="cuda") * 0.1
    add = torch.randn(*add_shape, generator=g, device="cuda").to(dtype) if add_shape else None
    halves = [h.contiguous() for h in x.chunk(2, dim=w_axis)]
    _native.reset_launches()
    sums = sum(groupnorm.group_norm_stats_kernel(h, 32, add) for h in halves)
    got = torch.cat([groupnorm.group_norm_apply_kernel(h, w, b, sums, 32, 1e-6, True, add, shards=2)
                     for h in halves], dim=w_axis)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["gn_stats"] == 2 and _native.LAUNCHES["gn_apply"] == 2
    assert _native.LAUNCHES["groupnorm"] == 0
    want_sums = groupnorm.group_norm_stats_plain(x, 32, add).double()
    assert torch.allclose(sums, want_sums, rtol=1e-4, atol=1e-4 * float(want_sums.abs().max()))
    want = groupnorm.group_norm_plain(x, w, b, 32, 1e-6, True, add)
    _check(got, want, 2e-2)
    local = torch.cat([groupnorm.group_norm_apply_kernel(h, w, b, groupnorm.group_norm_stats_kernel(h, 32, add),
                                                         32, 1e-6, True, add) for h in halves], dim=w_axis)
    assert float((local.float() - want.float()).abs().max()) > 2e-2 * float(want.float().abs().max())
    # The wrapper's split form with one block (reduce the identity): stats, reduce, apply.
    _native.reset_launches()
    one = groupnorm.group_norm(x, w, b, 32, 1e-6, True, add, lambda t: t, 1)
    assert _native.LAUNCHES["gn_stats"] == 1 and _native.LAUNCHES["gn_apply"] == 1
    _check(one, want, 2e-2)


@pytest.mark.cuda
def test_cuda_group_norm_alternating_team_sizes():
    """Calls whose teams differ in size, back to back on one stream, share
    the barrier counters: each must find them reset by the one before."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = [torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
          for s in ((28, 9, 16, 1280), (3, 37, 41, 128), (7, 24, 24, 320))]
    w, b = torch.ones(1280, device="cuda"), torch.zeros(1280, device="cuda")
    outs = [groupnorm.group_norm_kernel(x, w[: x.shape[-1]], b[: x.shape[-1]], 32, 1e-5, False)
            for _ in range(3) for x in xs]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        x = xs[i % 3]
        _check(got, groupnorm.group_norm_plain(x, w[: x.shape[-1]], b[: x.shape[-1]], 32, 1e-5, False), 2e-2)


# D's frame attention alone: F in {1, 8, 14, 16} (16: one full mma tile, no
# padded rows), S not a multiple of the 8-pixel stage, heads 5, 10 and 20.
FRAME_CASES = [(2, 1, 45, 5), (1, 8, 13, 10), (2, 14, 100, 5), (1, 16, 37, 20), (2, 14, 9, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,s,heads", FRAME_CASES)
def test_cuda_frame_attention_matches_plain(b, f, s, heads):
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(f * s + heads)
    c = heads * 64
    qkv = torch.randn(b, f, s, 3 * c, generator=g, device="cuda")
    qkv[..., : 2 * c] *= 2.0**0.5  # logits q.k/8 of standard deviation 2
    qkv = qkv.to(torch.bfloat16)
    _native.reset_launches()
    got = temporal.frame_attention_kernel(qkv, heads)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["frame_attn"] == 1 and got.shape == (b, f, s, c)
    _check(got, temporal.frame_attention(*qkv.chunk(3, dim=-1), heads), 3e-2, rms_tol=1e-2)


def _block(dim, heads, temporal_block, seed):
    from posetraj_torch.core.init import Init
    from posetraj_torch.models import transformer as tt

    ini = Init(torch.Generator(device="cuda").manual_seed(seed), torch.device("cuda"), torch.bfloat16)
    init = tt.init_temporal_basic_transformer_block if temporal_block else tt.init_basic_transformer_block
    p = init(ini, dim, heads, 16)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    f, s = 3, 45
    x = torch.randn(2 * f, s, dim, generator=g, device="cuda").to(torch.bfloat16)
    if temporal_block:
        ctx = torch.randn(2, 1, s, 16, generator=g, device="cuda").to(torch.bfloat16)
        return lambda: tt.temporal_basic_transformer_block(p, x, f, heads, context=ctx)
    ctx = torch.randn(2 * f, 1, 16, generator=g, device="cuda").to(torch.bfloat16)
    return lambda: tt.basic_transformer_block(p, x, heads, context=ctx)


@pytest.mark.cuda
@pytest.mark.parametrize("temporal_block", [False, True])
@pytest.mark.parametrize("dim,heads", [(32, 2), (256, 2), (1280, 10)])
def test_cuda_blocks_where_the_gate_declines(dim, heads, temporal_block):
    """head_dim 16 (ModelBundle.tiny()) and 128 (a (5, 10, 10, 20)-heads
    UNet): the blocks compute on the card, kernels C and D not launched,
    within the step tolerance (3e-2 rel RMS) of the all-plain block."""
    _need_cuda()
    from posetraj_torch.configs import KernelConfig, use_kernels

    run = _block(dim, heads, temporal_block, dim + heads)
    _native.reset_launches()
    with torch.inference_mode(), use_kernels(KernelConfig()):
        got = run().float()
    torch.cuda.synchronize()
    assert _native.LAUNCHES["qkvt"] == 0 and _native.LAUNCHES["temporal"] == 0
    with torch.inference_mode(), use_kernels(KernelConfig(qkvt_attn=False, temporal_attn=False, fused_ff=False)):
        want = run().float()
    assert torch.isfinite(got).all()
    assert float((got - want).norm() / want.norm()) <= 3e-2


@pytest.mark.cuda
def test_cuda_wrappers_still_refuse_head_dim_16():
    _need_cuda()
    dev, bf = "cuda", torch.bfloat16
    c = 32
    w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    wq, wo = torch.randn(3 * c, c, device=dev, dtype=bf), torch.randn(c, c, device=dev, dtype=bf)
    bo = torch.zeros(c, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="head_dim"):
        qkvt.attn_sublayer(torch.randn(2, 45, c, device=dev, dtype=bf), w, b, wq, wo, bo, 2)
    with pytest.raises(ValueError, match="head_dim"):
        temporal.temporal_attn_sublayer(torch.randn(2, 3, 45, c, device=dev, dtype=bf), w, b, wq, wo, bo, 2)
    with pytest.raises(ValueError, match="head_dim"):
        temporal.frame_attention_kernel(torch.randn(2, 3, 45, 3 * c, device=dev, dtype=bf), 2)


@pytest.mark.cuda
def test_cuda_tiny_generate():
    """ModelBundle.tiny() (head_dim 16) through the pipeline on the card:
    kernel A runs, the gates keep C and D off, the video is finite and in
    range."""
    _need_cuda()
    import numpy as np

    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params

    bundle = ModelBundle.tiny()
    pipe = SVDControlNetPipeline(init_params(bundle, seed=3), bundle)
    image = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    control = np.random.RandomState(1).rand(1, 2, 64, 64, 3).astype(np.float32)
    _native.reset_launches()
    out = pipe(image, control, height=64, width=64, num_frames=2, num_inference_steps=2, seed=7)
    assert out.shape == (1, 2, 64, 64, 3) and np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
    assert _native.LAUNCHES["groupnorm"] > 0 and _native.LAUNCHES["qkvt"] == 0 and _native.LAUNCHES["temporal"] == 0


@pytest.mark.cuda
def test_cuda_group_norm_temp_hint_shape():
    """Kernel A at the temp hint encoder's per-video GroupNorm, (B, F*h*w, C)
    with no addend and no SiLU, eps 1e-6, at a small h*w."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(14)
    x = (torch.randn(2, 14 * 8 * 8, 320, generator=g, device="cuda") + 0.5).to(torch.bfloat16)
    w = torch.rand(320, generator=g, device="cuda") + 0.5
    b = torch.randn(320, generator=g, device="cuda") * 0.1
    _native.reset_launches()
    got = groupnorm.group_norm_kernel(x, w, b, 32, 1e-6, False)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["groupnorm"] == 1
    _check(got, groupnorm.group_norm_plain(x, w, b, 32, 1e-6, False), 2e-2)


@pytest.mark.cuda
def test_cuda_temp_hint_encoder_matches_plain():
    """A small temp-variant hint encoder (64 embedding channels, so that
    kernel B takes the FF of its two blocks) on the card: kernel A once and
    B twice, the variant's part (out minus the conv stack's output) within
    B's tolerances of the same encoder with kernels A and B switched off."""
    _need_cuda()
    from posetraj_torch.configs import HintEncoderConfig, KernelConfig, use_kernels
    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as cn

    cfg = HintEncoderConfig(variant="temp", block_out_channels=(4, 8, 8, 16), embedding_channels=64,
                            temp_num_layers=2, temp_num_heads=2)
    params = cn.init_hint_encoder(make_init(3, torch.device("cuda"), torch.bfloat16), cfg)
    co = params["stack"]["conv_out"]
    co["weight"] = (torch.randn(co["weight"].shape, device="cuda") * 0.1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    g = torch.Generator(device="cuda").manual_seed(4)
    cond = (torch.rand(2, 3, 64, 64, 3, generator=g, device="cuda") * 2 - 1).to(torch.bfloat16)
    run = lambda: cn.hint_encoder(params, cfg, cond, 3, compute_dtype=torch.bfloat16)
    _native.reset_launches()
    with torch.inference_mode(), use_kernels(KernelConfig()):
        got = run()
    torch.cuda.synchronize()
    assert _native.LAUNCHES["groupnorm"] == 1 and _native.LAUNCHES["mlp"] == 2
    with torch.inference_mode(), use_kernels(KernelConfig(fused_groupnorm=False, fused_ff=False)):
        want = run()
        stack = cn._conv_stack(params["stack"], cond.reshape(6, 64, 64, 3), torch.bfloat16)
    assert got.shape == (6, 8, 8, 64) and torch.isfinite(got).all()
    _check(got, want, 3e-2, stack, 1e-2)


def _tiny_request(seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return rng.rand(1, 64, 64, 3).astype(np.float32), rng.rand(1, 2, 64, 64, 3).astype(np.float32)


def _eager_denoise(*args, graph=None, **kw):
    from posetraj_torch.pipeline import svd_controlnet

    return svd_controlnet.denoise_eager(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("switches", ["default", "un-fused"])
def test_cuda_generate_graph_matches_eager(switches):
    """ModelBundle.tiny() through generate() on the card, its denoise loop
    from the captured graph against the eager loop on the same inputs:
    equal bit for bit where two eager runs are (else no further apart than
    they are), with the same launches of every kernel."""
    _need_cuda()
    import contextlib
    import dataclasses
    from unittest import mock

    from posetraj_torch.configs import KernelConfig, PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate, init_params
    from posetraj_torch.pipeline import svd_controlnet

    kernels = KernelConfig() if switches == "default" else KernelConfig(
        qkvt_attn=False, temporal_attn=False, fused_ff_ln=False, fused_ln=True)
    bundle = dataclasses.replace(ModelBundle.tiny(), kernels=kernels)
    params = init_params(bundle, seed=5)
    image, control = _tiny_request(2)
    pcfg = PipelineConfig(height=64, width=64, num_frames=2, num_inference_steps=3, decode_chunk_size=2)
    sched = make_schedule(bundle.scheduler, 3)
    noises = {"latents": torch.randn(1, 2, 8, 8, 4, device="cuda"),
              "image_aug": torch.randn(1, 64, 64, 3, device="cuda")}
    run = lambda: generate(params, bundle, pcfg, image, control, noises, [[6.0, 128.0, 0.02]], sched.sigmas,
                           sched.timesteps, 2, output_latent=True)
    outs, launches = [], []
    for eager in (True, True, False):
        _native.reset_launches()
        with mock.patch.object(svd_controlnet, "denoise", _eager_denoise) if eager else contextlib.nullcontext():
            outs.append(run())
        torch.cuda.synchronize()
        launches.append(dict(_native.LAUNCHES))
    spread = float((outs[0] - outs[1]).abs().max())
    assert float((outs[2] - outs[0]).abs().max()) <= spread
    assert launches[2] == launches[0] and launches[0]["groupnorm"] > 0


@pytest.mark.cuda
def test_cuda_pipeline_reuses_its_graph():
    """A second request through one SVDControlNetPipeline replays the graph
    the first captured, with the same launches; another hint encoder in the
    parameters captures anew. Each request's latents equal the eager loop's
    on its inputs (or differ no more than two eager runs do)."""
    _need_cuda()
    from unittest import mock

    import numpy as np

    from posetraj_torch.core.init import make_init
    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.pipeline import ModelBundle, SVDControlNetPipeline, init_params
    from posetraj_torch.pipeline import svd_controlnet

    bundle = ModelBundle.tiny()
    params = init_params(bundle, seed=6)
    pipe = SVDControlNetPipeline(params, bundle)

    def request(seed):
        image, control = _tiny_request(seed)
        call = lambda: pipe(image, control, height=64, width=64, num_frames=2, num_inference_steps=3, seed=seed,
                            output_type="latent")
        _native.reset_launches()
        got = call()
        launched = dict(_native.LAUNCHES)
        with mock.patch.object(svd_controlnet, "denoise", _eager_denoise):
            want, again = call(), call()
        assert np.abs(got - want).max() <= np.abs(again - want).max()
        return launched

    first = request(1)
    graph = pipe.graph._graph
    assert graph is not None
    second = request(2)
    assert pipe.graph._graph is graph and second == first
    hint = cn.init_hint_encoder(make_init(9, torch.device("cuda"), torch.bfloat16), bundle.controlnet.hint)
    pipe.params = dict(params, controlnet=dict(params["controlnet"], controlnet_cond_embedding=hint))
    request(3)
    assert pipe.graph._graph is not None and pipe.graph._graph is not graph


@pytest.mark.cuda
def test_cuda_generate_keeps_its_graph_for_the_next_call():
    """generate() called directly, twice with one key, replays the graph the
    first call captured (the module's, kept as jit keeps a compiled
    program), with the same launches and latents; other parameters capture
    anew. The graph holds kernel A's workspace as it captured it."""
    _need_cuda()
    from posetraj_torch.configs import PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.pipeline import ModelBundle, generate, init_params
    from posetraj_torch.pipeline import svd_controlnet

    bundle = ModelBundle.tiny()
    image, control = _tiny_request(4)
    pcfg = PipelineConfig(height=64, width=64, num_frames=2, num_inference_steps=3, decode_chunk_size=2)
    sched = make_schedule(bundle.scheduler, 3)
    noises = {"latents": torch.randn(1, 2, 8, 8, 4, device="cuda"),
              "image_aug": torch.randn(1, 64, 64, 3, device="cuda")}

    def run(params):
        _native.reset_launches()
        out = generate(params, bundle, pcfg, image, control, noises, [[6.0, 128.0, 0.02]], sched.sigmas,
                       sched.timesteps, 2, output_latent=True)
        torch.cuda.synchronize()
        return out, dict(_native.LAUNCHES), svd_controlnet._SHARED_GRAPH._graph

    params = init_params(bundle, seed=7)
    first, launched, graph = run(params)
    second, again, same = run(params)
    assert graph is not None and same is graph and again == launched and torch.equal(first, second)
    assert all(any(t is w for w in svd_controlnet._SHARED_GRAPH._held) for t in groupnorm.workspaces())
    _, _, other = run(init_params(bundle, seed=8))
    assert other is not None and other is not graph


@pytest.mark.cuda
def test_cuda_generate_sharded_1x1_matches_generate():
    """generate_sharded on a (1, 1) mesh (no process group, every collective
    a no-op) against generate() with kernels C and D off, as the sharded
    path runs them: the same launches of every kernel (kernel 7 at 1024
    tokens, A's one launch, never its split form), latents within 2e-2
    relative RMS (only the CFG combine's float32 rounding differs, carried
    through bf16 steps)."""
    _need_cuda()
    import dataclasses

    from posetraj_torch.configs import KernelConfig, PipelineConfig
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.parallel import generate_sharded, make_serve_mesh
    from posetraj_torch.pipeline import generate, init_params

    bundle = dataclasses.replace(_train_bundle(), kernels=KernelConfig(qkvt_attn=False, temporal_attn=False))
    params = init_params(bundle, seed=13)
    g = torch.Generator(device="cuda").manual_seed(14)
    image = torch.rand(1, 256, 256, 3, generator=g, device="cuda")
    control = torch.rand(1, 2, 256, 256, 3, generator=g, device="cuda")
    noises = {"latents": torch.randn(1, 2, 32, 32, 4, generator=g, device="cuda"),
              "image_aug": torch.randn(1, 256, 256, 3, generator=g, device="cuda")}
    pcfg = PipelineConfig(height=256, width=256, num_frames=2, num_inference_steps=3, decode_chunk_size=2)
    sched = make_schedule(bundle.scheduler, 3)
    args = (params, bundle, pcfg, image, control, noises, [[6.0, 128.0, 0.02]], sched.sigmas, sched.timesteps, 2)
    outs, launches = [], []
    for run in (lambda: generate(*args, output_latent=True),
                lambda: generate_sharded(*args, make_serve_mesh(1, 1), output_latent=True)):
        _native.reset_launches()
        outs.append(run().float())
        torch.cuda.synchronize()
        launches.append(dict(_native.LAUNCHES))
    assert launches[1] == launches[0]
    assert launches[1]["flash_tq"] > 0 and launches[1]["groupnorm"] > 0 and launches[1]["gn_stats"] == 0
    assert launches[1]["qkvt"] == launches[1]["temporal"] == 0
    assert float((outs[1] - outs[0]).norm() / outs[0].norm()) <= 2e-2


# --------------------------------------------------------------------------
# Training on the card: the micro-step's graph, the variants, resume
# --------------------------------------------------------------------------


def _train_bundle(variant="base", kernels=None):
    """Two levels 64 and 128 wide (head_dim 64), one layer a block, the tiny
    VAE and CLIP: at 2x256x256 level 0 has 1024 tokens a frame, so A, B, C,
    D and kernel 5's backward (in C's) all run in a micro-step."""
    from posetraj_torch import configs
    from posetraj_torch.pipeline import ModelBundle

    u = configs.UNetConfig(block_out_channels=(64, 128), cross_attention_levels=(True, False),
                           num_attention_heads=(1, 2), layers_per_block=1, cross_attention_dim=16,
                           addition_time_embed_dim=8, projection_class_embeddings_input_dim=24, num_frames=2)
    hint = configs.HintEncoderConfig(variant=variant, block_out_channels=(4, 8, 8, 16), embedding_channels=64,
                                     temp_num_layers=1, temp_num_heads=2)
    return ModelBundle(unet=u, controlnet=configs.ControlNetConfig(unet=u, hint=hint), vae=configs.VAEConfig.tiny(),
                       clip=configs.CLIPVisionConfig.tiny(), kernels=kernels)


def _trainer(variant="base", **tcfg_kw):
    """A Trainer on the card over _train_bundle, its zero-initialised heads
    and the cam projection given small random values so that the hint and
    its condition reach the loss."""
    from posetraj_torch.configs import TrainConfig
    from posetraj_torch.pipeline import init_params
    from posetraj_torch.train import Trainer

    bundle = _train_bundle(variant)
    params = init_params(bundle, seed=11)
    g = torch.Generator(device="cuda").manual_seed(12)

    def live(node, path=""):
        if isinstance(node, dict):
            return {k: live(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [live(v, f"{path}.{i}") for i, v in enumerate(node)]
        noise = (torch.randn(node.shape, generator=g, device="cuda") * 0.05).to(node.dtype)
        if bool((node == 0).all()):
            return noise.contiguous(memory_format=torch.channels_last) if node.ndim == 4 else noise
        return node + noise if "cc_projection" in path else node

    frozen = {k: params[k] for k in ("unet", "vae", "clip")}
    return Trainer(bundle, TrainConfig(num_frames=2, height=256, width=256, **tcfg_kw), frozen,
                   live(params["controlnet"]))


def _train_batch(seed, size=256, **extra):
    g = torch.Generator(device="cuda").manual_seed(seed)
    batch = {"pixel_values": torch.rand(1, 2, size, size, 3, generator=g, device="cuda") * 2 - 1,
             "trajectories": torch.rand(1, 2, size, size, 3, generator=g, device="cuda") * 2 - 1,
             "motion_values": torch.full((1,), 127.0, device="cuda")}
    batch.update(extra)
    return batch


def _train_tensors(trainer):
    """Masters, EMA, accumulator and Adam's moments, in a fixed order."""
    from posetraj_torch.core.params import leaves

    st = trainer.state
    masters = list(leaves(st.controlnet_params))
    moments = [st.optimizer.state[p][k] for p in masters if p in st.optimizer.state for k in ("exp_avg", "exp_avg_sq")]
    return [*masters, *leaves(st.ema_params), *st.grad_acc, *moments]


def _copy_state(trainer):
    return [t.detach().clone() for t in _train_tensors(trainer)]


def _cloned(obj):
    """A copy of a state dict that later steps leave alone."""
    if isinstance(obj, dict):
        return {k: _cloned(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cloned(v) for v in obj)
    return obj.detach().clone() if isinstance(obj, torch.Tensor) else obj


def _max_diff(a, b):
    assert len(a) == len(b)
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


@pytest.mark.cuda
def test_cuda_train_graph_matches_eager():
    """Four micro-steps (two updates) from one state: Trainer.step, whose
    first call runs eagerly on the capture stream and captures and whose
    later calls replay, against Trainer.step_eager; equal bit for bit where
    two eager runs are (else no further apart than they are), with the same
    launches of every kernel."""
    _need_cuda()
    trainer = _trainer(gradient_accumulation_steps=2, lr_warmup_steps=1, learning_rate=1e-4)
    init = _cloned(trainer.state_dict())
    batch = _train_batch(0)

    def run(step):
        trainer.load_state_dict(init)
        _native.reset_launches()
        losses = [float(step(batch)["loss"]) for _ in range(4)]
        torch.cuda.synchronize()
        return losses, dict(_native.LAUNCHES), _copy_state(trainer)

    eager, again, graph = run(trainer.step_eager), run(trainer.step_eager), run(trainer.step)
    spread = _max_diff(eager[2], again[2])
    assert _max_diff(graph[2], eager[2]) <= spread
    assert graph[1] == eager[1] and eager[1]["groupnorm"] > 0 and eager[1]["qkvt"] > 0 and eager[1]["flash_bwd"] > 0
    if spread == 0:
        assert graph[0] == eager[0]
    assert trainer.graph.capture_s > 0 and all(any(t is w for w in trainer.graph._held)
                                               for t in groupnorm.workspaces())


@pytest.mark.cuda
def test_cuda_train_graph_captures_anew_for_a_new_key():
    """Another batch shape or KernelConfig is another key: the trainer's
    graph captures anew (and again on the way back: it keeps one graph)."""
    _need_cuda()
    import dataclasses

    from posetraj_torch.configs import KernelConfig

    trainer = _trainer()
    trainer.step(_train_batch(1))
    first = trainer.graph._graph
    trainer.step(_train_batch(2))
    assert trainer.graph._graph is first
    trainer.step(_train_batch(3, size=128))
    second = trainer.graph._graph
    assert second is not None and second is not first
    trainer.bundle = dataclasses.replace(trainer.bundle, kernels=KernelConfig(qkvt_attn=False))
    trainer.step(_train_batch(4, size=128))
    assert trainer.graph._graph is not second


@pytest.mark.cuda
def test_cuda_layer_norm_gate_under_grad():
    """Kernel 8 has no backward: under grad its gate declines a LayerNorm
    that a gradient flows through, which runs as F.layer_norm with its
    gradient; without a gradient the same call launches kernel 8."""
    _need_cuda()
    from posetraj_torch.configs import KernelConfig, use_kernels
    from posetraj_torch.ops import primitives

    x = torch.randn(8192, 320, device="cuda", dtype=torch.bfloat16)
    p = {"weight": torch.rand(320, device="cuda") + 0.5, "bias": torch.randn(320, device="cuda")}
    with use_kernels(KernelConfig(fused_ln=True)):
        leaf = x.clone().requires_grad_(True)
        assert not layernorm.fused_layer_norm_applicable(leaf, p["weight"], p["bias"])
        _native.reset_launches()
        y = primitives.layer_norm(p, leaf)
        y.float().square().sum().backward()
        assert _native.LAUNCHES["layernorm"] == 0 and leaf.grad is not None
        ref = leaf.detach().clone().requires_grad_(True)
        torch.nn.functional.layer_norm(ref.float(), (320,), p["weight"], p["bias"]).to(x.dtype).float().square().sum(
        ).backward()
        assert torch.equal(leaf.grad, ref.grad)
        with torch.no_grad():
            assert layernorm.fused_layer_norm_applicable(leaf, p["weight"], p["bias"])
            got = primitives.layer_norm(p, leaf)
        torch.cuda.synchronize()
        assert _native.LAUNCHES["layernorm"] == 1
        _check(got, layernorm.layer_norm_plain(x, p["weight"], p["bias"]), 1e-2, rms_tol=2e-3)


def _plain_wrappers():
    """Every kernel wrapper of the model routed to its plain version (as
    chip_smoke.plain_versions)."""
    import contextlib
    from unittest import mock

    from posetraj_torch.ops.attention import dot_product_attention

    stack = contextlib.ExitStack()
    for module, name, value in (
            (groupnorm, "group_norm", groupnorm.group_norm_plain), (mlp, "geglu_mlp", mlp.geglu_mlp_plain),
            (qkvt, "attn_sublayer", qkvt.attn_sublayer_plain),
            (temporal, "temporal_attn_sublayer", temporal.temporal_attn_sublayer_plain),
            (flash, "flash_attention", dot_product_attention),
            (flash, "flash_attention_tq", flash.flash_attention_tq_plain),
            (layernorm, "layer_norm", layernorm.layer_norm_plain)):
        stack.enter_context(mock.patch.object(module, name, value))
    return stack


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["bbox", "cam"])
def test_cuda_train_variant_matches_plain(variant):
    """One micro-step of the bbox and cam variants with the kernels (the
    graph's first call) against the same micro-step with every wrapper
    plain: the accumulated gradient within 2e-2 relative RMS (chip_smoke
    phase 5(a)'s tolerance: bf16 roundings through forward and backward)."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(21)
    extra = {"bbox": {"bbox_trajectories": torch.rand(1, 2, 256, 256, 3, generator=g, device="cuda") * 2 - 1},
             "cam": {"cam_parameter": torch.randn(1, 2, 12, generator=g, device="cuda")}}[variant]
    trainer = _trainer(variant, conditioning_dropout_prob=0.0)
    batch = _train_batch(5, **extra)
    gen = trainer.generator.get_state()
    _native.reset_launches()
    with _plain_wrappers():
        trainer.step_eager(batch)
    assert sum(_native.LAUNCHES.values()) == 0
    want = [a.float().clone() for a in trainer.state.grad_acc]
    with torch.no_grad():
        torch._foreach_zero_(trainer.state.grad_acc)
    trainer.state.step = 0
    trainer.generator.set_state(gen)
    trainer.step(batch)
    torch.cuda.synchronize()
    assert _native.LAUNCHES["groupnorm"] > 0 and _native.LAUNCHES["qkvt"] > 0
    got = trainer.state.grad_acc
    num = sum(float((a.float() - b).square().sum()) for a, b in zip(got, want))
    den = sum(float(b.square().sum()) for b in want)
    assert 0 < den and (num / den) ** 0.5 <= 2e-2


@pytest.mark.cuda
def test_cuda_checkpoint_resume(tmp_path):
    """A run of five graphed micro-steps saved after the third, against a
    new Trainer restored from that checkpoint for the last two: bit for bit
    the same losses, masters, EMA, accumulator and moments."""
    _need_cuda()
    from posetraj_torch.train import restore_checkpoint, save_checkpoint

    kw = dict(lr_warmup_steps=1, learning_rate=1e-4)
    run = _trainer(**kw)
    batches = [_train_batch(30 + i) for i in range(5)]
    for b in batches[:3]:
        run.step(b)
    path = save_checkpoint(str(tmp_path), run.state.step, run)
    want = [float(run.step(b)["loss"]) for b in batches[3:]]
    resumed = _trainer(**kw)
    restore_checkpoint(path, resumed)
    got = [float(resumed.step(b)["loss"]) for b in batches[3:]]
    assert got == want and resumed.state.step == 5
    assert _max_diff(_copy_state(run), _copy_state(resumed)) == 0
