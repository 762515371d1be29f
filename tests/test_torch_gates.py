"""Dispatch gates of kernels C and D (ops/qkvt.attn_sublayer_applicable,
ops/temporal.temporal_attn_sublayer_applicable) and the blocks that call
them (models/transformer.basic_transformer_block and
temporal_basic_transformer_block), on the CPU.

A gate says yes only where the kernel takes the input: its KernelConfig
switch, head_dim 64, C <= gemm.MAX_K, and F <= 16 for D. Where it says no,
the block computes the un-fused formulation (LayerNorm, the packed
projection, the attention, to_out) instead of raising on the card. On the
CPU both branches run plain PyTorch in float32, so the blocks agree with
the branch they replaced to float32 summation noise (1e-5). Tiny widths,
no JAX: seconds.
"""

import pytest
import torch

from posetraj_torch.configs import KernelConfig, use_kernels
from posetraj_torch.core.init import Init
from posetraj_torch.models import transformer as tt
from posetraj_torch.ops import gemm, qkvt, temporal


def _x(*shape):
    return torch.empty(shape, device="meta")


# head_dim 64 is the kernels'; 16 is ModelBundle.tiny()'s, 40 the temp hint
# encoder's (320 channels, 8 heads), 128 a (5, 10, 10, 20)-heads UNet's
# level 2 (1280 channels, 10 heads).
HEAD_DIMS = [(64, True), (16, False), (40, False), (128, False)]


@pytest.mark.parametrize("head_dim,want", HEAD_DIMS)
def test_attn_gate_head_dims(head_dim, want):
    heads = 320 // head_dim if 320 % head_dim == 0 else 2
    c = heads * head_dim
    with use_kernels(KernelConfig()):
        assert qkvt.attn_sublayer_applicable(_x(2, 45, c), heads) is want


@pytest.mark.parametrize("head_dim,want", HEAD_DIMS)
def test_temporal_gate_head_dims(head_dim, want):
    heads = 320 // head_dim if 320 % head_dim == 0 else 2
    c = heads * head_dim
    with use_kernels(KernelConfig()):
        assert temporal.temporal_attn_sublayer_applicable(_x(2, 14, 45, c), heads) is want


@pytest.mark.parametrize("frames,want", [(1, True), (14, True), (16, True), (17, False)])
def test_temporal_gate_frames(frames, want):
    with use_kernels(KernelConfig()):
        assert temporal.temporal_attn_sublayer_applicable(_x(1, frames, 9, 320), 5) is want


def test_gates_decline_c_above_the_gemm_depth():
    heads = gemm.MAX_K // 64 + 1
    with use_kernels(KernelConfig()):
        assert qkvt.attn_sublayer_applicable(_x(1, 4, gemm.MAX_K), gemm.MAX_K // 64)
        assert not qkvt.attn_sublayer_applicable(_x(1, 4, 64 * heads), heads)
        assert not temporal.temporal_attn_sublayer_applicable(_x(1, 2, 4, 64 * heads), heads)


def test_gates_check_weight_shapes_and_rank():
    c = 320
    with use_kernels(KernelConfig()):
        assert qkvt.attn_sublayer_applicable(_x(1, 4, c), 5, _x(3 * c, c), _x(c, c))
        assert not qkvt.attn_sublayer_applicable(_x(1, 4, c), 5, _x(2 * c, c), _x(c, c))
        assert not qkvt.attn_sublayer_applicable(_x(1, 4, c), 5, _x(3 * c, c), _x(c, 2 * c))
        assert not qkvt.attn_sublayer_applicable(_x(1, 2, 4, c), 5)
        assert temporal.temporal_attn_sublayer_applicable(_x(1, 2, 4, c), 5, _x(3 * c, c), _x(c, c))
        assert not temporal.temporal_attn_sublayer_applicable(_x(1, 2, 4, c), 5, _x(3 * c, 2 * c), _x(c, c))
        assert not temporal.temporal_attn_sublayer_applicable(_x(2, 4, c), 5)


@pytest.mark.parametrize("switch", ["qkvt_attn", "temporal_attn"])
def test_gates_follow_their_switch(switch):
    x3, x4 = _x(2, 45, 320), _x(2, 14, 45, 320)
    with use_kernels(KernelConfig(**{switch: False})):
        assert qkvt.attn_sublayer_applicable(x3, 5) is (switch != "qkvt_attn")
        assert temporal.temporal_attn_sublayer_applicable(x4, 5) is (switch != "temporal_attn")


def _block(dim, heads, temporal_block, seed=0):
    ini = Init(torch.Generator().manual_seed(seed), torch.device("cpu"), torch.float32)
    init = tt.init_temporal_basic_transformer_block if temporal_block else tt.init_basic_transformer_block
    p = init(ini, dim, heads, 16)
    g = torch.Generator().manual_seed(seed + 1)
    f, s = 3, 10
    x = torch.randn(2 * f, s, dim, generator=g)
    if temporal_block:
        ctx = torch.randn(2, 1, s, 16, generator=g)
        return p, lambda **kw: tt.temporal_basic_transformer_block(p, x, f, heads, context=ctx, **kw)
    ctx = torch.randn(2 * f, 1, 16, generator=g)
    return p, lambda **kw: tt.basic_transformer_block(p, x, heads, context=ctx, **kw)


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_backend_xla_is_the_unfused_branch(monkeypatch):
    _, run = _block(128, 2, False)
    calls = _spy(monkeypatch, qkvt, "attn_sublayer")
    with use_kernels(KernelConfig()):
        fused = run()
        assert len(calls) == 1
        xla = run(backend="xla")
        assert len(calls) == 1
    with use_kernels(KernelConfig(qkvt_attn=False)):
        unfused = run()
    assert torch.equal(xla, unfused)
    torch.testing.assert_close(xla, fused, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="backend"):
        run(backend="pallas")


@pytest.mark.parametrize("temporal_block", [False, True])
def test_tiny_head_dim_16_block_matches_the_kernel_branch(monkeypatch, temporal_block):
    """ModelBundle.tiny()'s level 0 (32 channels, 2 heads of 16): the gate
    declines, and the block's result equals the one it gave when it sent
    the sub-layer to the kernel wrapper (plain on the CPU)."""
    _, run = _block(32, 2, temporal_block)
    module, name = (temporal, "temporal_attn_sublayer") if temporal_block else (qkvt, "attn_sublayer")
    gate = "temporal_attn_sublayer_applicable" if temporal_block else "attn_sublayer_applicable"
    calls = _spy(monkeypatch, module, name)
    with use_kernels(KernelConfig()):
        got = run()
        assert not calls
        monkeypatch.setattr(module, gate, lambda *a, **k: True)
        want = run()
        assert len(calls) == 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
