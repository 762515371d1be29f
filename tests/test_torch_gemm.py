"""The host side of the port's Hopper GEMM (posetraj_torch/csrc/gemm.cuh),
which kernels B, C and D launch: the tile width it picks, the TMA tensor
maps it builds for A, W, the output and the residual
(posetraj_torch.ops.gemm.tensor_maps), the refusals of what TMA cannot take
(16-byte bases and strides), kernel B's scratch, and the plain version of
the GEMM alone against numpy. CPU only, no JAX."""

import numpy as np
import pytest
import torch

from posetraj_torch.ops import _native, gemm, mlp

BF = torch.bfloat16


@pytest.mark.parametrize("n,width", [(320, 160), (640, 160), (1280, 160), (960, 192), (1920, 192), (3840, 192),
                                     (128, 128), (200, 128), (72, 128), (384, 192)])
def test_tile_width_pads_least(n, width):
    """The widest of 192, 160 and 128 columns that pads N least: no padding
    at the UNet's widths (C = 320, 640, 1280 and 3C)."""
    assert gemm.tile_n(n) == width
    pad = -(-n // width) * width - n
    assert all(pad <= -(-n // w) * w - n for w in gemm.TILE_WIDTHS)


def test_store_maps():
    """D's QKV product at a ragged M: A and W in 64-column boxes under the
    128-byte swizzle (A 128 rows, W one tile of rows), the output in 32 x 64
    boxes under the 64-byte swizzle; byte strides, innermost dim first."""
    m, n, k = 1000, 960, 320
    maps = gemm.tensor_maps(m, n, k, "store")
    assert set(maps) == {"a", "w", "out"}
    assert maps["a"] == gemm.TensorMap((k, m, 1, 1), (2 * k, 2 * k * m, 2 * k * m), (64, 128, 1, 1), 128)
    assert maps["w"] == gemm.TensorMap((k, n, 1, 1), (2 * k, 2 * k * n, 2 * k * n), (64, 192, 1, 1), 128)
    assert maps["out"] == gemm.TensorMap((n, m, 1, 1, 1), (2 * n, 2 * n * m, 2 * n * m, 2 * n * m), (32, 64, 1, 1, 1),
                                         64)


def test_bias_residual_maps():
    """An out-projection (N = C = 320): W in 160-row boxes, the residual
    loaded in the output's 32 x 64 boxes."""
    m, c = 2 * 14 * 100, 320
    maps = gemm.tensor_maps(m, c, c, "bias_residual")
    assert maps["w"].box == (64, 160, 1, 1)
    assert maps["residual"] == gemm.TensorMap((c, m, 1, 1), (2 * c, 2 * c * m, 2 * c * m), (32, 64, 1, 1), 64)
    assert maps["out"].dims == (c, m, 1, 1, 1)


def test_geglu_maps():
    """Kernel B's first product: W1 (2N, K) seen as (K, N, 2), so one stage
    loads 128 of A's rows and the 128 matching G rows N further on; u (M, N)
    is stored in 32 x 64 boxes."""
    m, k, n = 28 * 720, 640, 2560
    maps = gemm.tensor_maps(m, n, k, "geglu")
    assert maps["w"] == gemm.TensorMap((k, n, 2, 1), (2 * k, 2 * k * n, 4 * k * n), (64, 128, 1, 1), 128)
    assert maps["out"].dims == (n, m, 1, 1, 1)
    assert "residual" not in maps


def test_heads_layout():
    """C's QKV product writes the (3, B, heads, S, 64) scratch with 16-byte
    stores (a 64-row box may span two batches), so it has no output map;
    N must be 3C with C a multiple of 64 and M a multiple of S."""
    maps = gemm.tensor_maps(3 * 45, 3 * 128, 128, "heads", s=45)
    assert set(maps) == {"a", "w"}
    for m, n, s in ((3 * 45, 3 * 96, 45), (3 * 45, 3 * 128 + 8, 45), (100, 3 * 128, 45), (90, 3 * 128, None)):
        with pytest.raises(ValueError, match="heads"):
            gemm.tensor_maps(m, n, 128, "heads", s=s)


@pytest.mark.parametrize("m,n,k", [(64, 100, 64), (64, 128, 100), (64, 0, 64)])
def test_strides_that_tma_cannot_take_raise(m, n, k):
    """K and N must be positive multiples of 8: every row stride is then a
    multiple of 16 bytes, as TMA requires."""
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm.tensor_maps(m, n, k)
    with pytest.raises(ValueError):
        gemm.linear_kernel(torch.zeros(m, k, dtype=BF), torch.zeros(max(n, 1), k, dtype=BF))


def test_linear_kernel_refusals():
    """The GEMM alone refuses mismatched shapes, other dtypes and CPU
    tensors before any launch; nothing is counted."""
    a, w = torch.zeros(64, 128, dtype=BF), torch.zeros(96, 128, dtype=BF)
    _native.reset_launches()
    with pytest.raises(ValueError, match="do not match"):
        gemm.linear_kernel(a, w, torch.zeros(95, dtype=BF))
    with pytest.raises(ValueError, match="do not match"):
        gemm.linear_kernel(a, w, None, torch.zeros(64, 95, dtype=BF))
    with pytest.raises(ValueError, match="dtype"):
        gemm.linear_kernel(a.float(), w.float())
    with pytest.raises(ValueError, match="CUDA"):
        gemm.linear_kernel(a, w)
    with pytest.raises(ValueError, match="mode"):
        gemm.tensor_maps(64, 96, 128, "transpose")
    assert _native.LAUNCHES["gemm"] == 0


@pytest.mark.parametrize("ln,add,residual", [(False, False, False), (True, False, False), (True, False, True),
                                             (True, True, True), (False, True, True), (True, True, False)])
def test_mlp_scratch(ln, add, residual):
    """Kernel B's scratch: the first product's operand [LN](x [+ add])
    where there is a LayerNorm or an addend, xa = bf16(x + add) where the
    LayerNorm leaves no copy of the residual, and u (M, N) in bf16."""
    x = torch.zeros(1000, 320, dtype=BF)
    xn, xa, u = mlp.scratch(x, 1280, ln, add, residual)
    assert u.shape == (1000, 1280) and u.dtype == BF
    assert (xn is not None) == (ln or add) and (xa is not None) == (ln and add and residual)
    for t in (xn, xa):
        assert t is None or (t.shape == x.shape and t.dtype == BF)


@pytest.mark.parametrize("bias,residual", [(False, False), (True, False), (True, True), (False, True)])
def test_linear_plain_matches_numpy(bias, residual):
    """linear_plain = a W^T [+ bias] [+ residual], in float32 against numpy."""
    rng = np.random.RandomState(7)
    a, w = rng.randn(50, 72).astype(np.float32), rng.randn(40, 72).astype(np.float32)
    b = rng.randn(40).astype(np.float32) if bias else None
    r = rng.randn(50, 40).astype(np.float32) if residual else None
    want = a @ w.T + (b if bias else 0) + (r if residual else 0)
    got = gemm.linear_plain(*(None if t is None else torch.from_numpy(t) for t in (a, w, b, r)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
