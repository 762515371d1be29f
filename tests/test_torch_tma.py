"""The tensor-map description of the flash-attention forward's operands
(posetraj_torch.ops.flash.tma_operand) for the four layouts its callers hand
it: kernel 5's head-folded (BN, S, d) tensors, kernel 7's (B, S, N, d) views
of a packed projection, kernel 6's packed QKV at head_dim 128, and kernel
C's q/k/v scratch (3, B, heads, S, 64). The CUDA side builds the same rank-4
map (d, S, N, B) from the same strides (csrc/hopper.cuh make_tmap); TMA
needs the base address and every byte stride to be a multiple of 16, so a
misaligned view must raise before any launch. CPU only, no JAX."""

import pytest
import torch

from posetraj_torch.ops import flash

BF = torch.bfloat16


def test_head_folded_operand():
    """Kernel 5: (BN, S, d) contiguous, seen as (BN, S, 1, d)."""
    q = torch.zeros(6, 200, 64, dtype=BF)
    desc = flash.tma_operand(q[:, :, None], 128)
    assert desc.dims == (64, 200, 1, 6)
    assert desc.strides == (128, 128, 200 * 128)
    assert desc.box == (64, 128, 1, 1) and desc.offset == 0


@pytest.mark.parametrize("d", [64, 128])
def test_packed_projection_views(d):
    """Kernels 6 and 7: q, k, v as (B, S, N, d) views of one (B, S, 3C)
    projection, read in place: row stride 3C, head stride d, column offsets
    0, C, 2C."""
    b, s, n = 2, 180, 3
    c = n * d
    qkv = torch.zeros(b, s, 3 * c, dtype=BF)
    views = flash._unpack(qkv, n)
    for i, t in enumerate(views):
        desc = flash.tma_operand(t, 128)
        assert desc.dims == (d, s, n, b)
        assert desc.strides == (3 * c * 2, d * 2, s * 3 * c * 2)
        assert desc.offset == i * c * 2


def test_qkvt_scratch_operand():
    """Kernel C: q, k, v slices of the (3, B, heads, S, 64) scratch, seen as
    (B, S, heads, 64); o is written as (B, S, C), head h at column 64 h."""
    b, heads, s = 2, 5, 144
    scratch = torch.zeros(3, b, heads, s, 64, dtype=BF)
    for i in range(3):
        desc = flash.tma_operand(scratch[i].permute(0, 2, 1, 3), 128)
        assert desc.dims == (64, s, heads, b)
        assert desc.strides == (64 * 2, s * 64 * 2, heads * s * 64 * 2)
        assert desc.offset == i * b * heads * s * 64 * 2


@pytest.mark.parametrize("case", ["column_offset", "row_stride", "head_dim_stride"])
def test_misaligned_views_raise(case):
    """A base address or stride that is not a multiple of 16 bytes, or a
    head_dim axis that is not contiguous, is refused."""
    if case == "column_offset":  # base 8 bytes into a row
        t = torch.zeros(2, 64, 3 * 128 + 8, dtype=BF)[..., 4 : 4 + 128].unflatten(-1, (2, 64))
    elif case == "row_stride":  # rows 392 bytes apart
        t = torch.zeros(2, 64, 3 * 64 + 4, dtype=BF)[..., :64].unflatten(-1, (1, 64))
    else:
        t = torch.zeros(2, 64, 1, 128, dtype=BF)[..., ::2]
    with pytest.raises(ValueError, match="16|contiguous"):
        flash.tma_operand(t, 128)
