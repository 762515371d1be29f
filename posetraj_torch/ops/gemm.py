"""The port's one Hopper GEMM (posetraj_torch/csrc/gemm.cuh), seen from
Python: out = epilogue(A W^T) over bf16 A (M, K) and W (N, K).

Kernels B (ops/mlp.py: both products of the GEGLU MLP), C (ops/qkvt.py) and
D (ops/temporal.py: their QKV and out-projections) launch it from their own
C entry points; C's and D's wrappers count its two launches a call under
`gemm`. `linear_kernel` launches it alone (pt_gemm, exported by the qkvt
library), also counted under `gemm`; `linear_plain` is the same function in
plain PyTorch. It replaces the projection kernels of
posetraj_tpu/ops/pallas_qkvt.py (ln_qkvt_proj, out_proj_res) and
pallas_temporal.py (ln_qkvt_proj4, out_proj_res4).

`tile_n` and `tensor_maps` describe what the CUDA side builds for one
product: its output tile width and the TMA tensor maps of A, W, the output
and the residual. TMA needs every base address and byte stride to be a
multiple of 16, so K and N must be multiples of 8; `tensor_maps` raises
ValueError otherwise, and the wrappers call it before any launch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from posetraj_torch.ops import _native

NAME = "qkvt"
COUNT = "gemm"
TILE_M = 128  # output rows of a tile (two consumer warpgroups of 64)
TILE_K = 64  # K columns of a ring stage: one 128-byte box
BOX_COLS = 32  # output box: 32 columns (64 bytes) x 64 rows
TILE_WIDTHS = (192, 160, 128)  # output columns of a tile, one width a launch (tile_n)
GEGLU_WIDTH = 128  # columns of u a GEGLU tile holds, from 2 x 128 W1 rows
MAX_K = 2048  # the row pre-pass (LayerNorm, addend) holds a row in one warp's registers
MODES = ("store", "heads", "bias_residual", "geglu")


class TensorMap(NamedTuple):
    """One bf16 TMA tensor map: dims innermost first, the byte strides of
    dims 1.., the box, and the swizzle span in bytes."""

    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    swizzle: int


def tile_n(n: int) -> int:
    """The output tile width for N columns: the widest of 192, 160 and 128
    that pads N least (gemm.cuh pick_bn)."""
    return min(TILE_WIDTHS, key=lambda bn: (-(-n // bn) * bn - n, -bn))


def tensor_maps(m: int, n: int, k: int, mode: str = "store", s: Optional[int] = None) -> Dict[str, TensorMap]:
    """The tensor maps gemm.cuh builds for a product of A (m, k) and W (n, k)
    (GEGLU: W1 (2n, k) for u (m, n)): "a" and "w" in 64-column boxes under
    the 128-byte swizzle, A 128 rows a box, W tile_n(n) rows (GEGLU: 128 rows
    of A's half and 128 of G's, W1 seen as (k, n, 2)); "out" (and for
    "bias_residual" the "residual") in 32 x 64 boxes under the 64-byte
    swizzle. For "heads" the output is C's q/k/v scratch (3, B, heads, S,
    64) with C = n / 3 and S = s, written by 16-byte stores, not by a map (a
    box's 64 rows may span two batches). Raises ValueError where TMA cannot
    take the operands or the heads layout does not fit."""
    if mode not in MODES:
        raise ValueError(f"gemm: mode {mode!r} is not one of {MODES}")
    if k % 8 or n % 8 or k < 1 or n < 1:
        raise ValueError(f"gemm: K={k} and N={n} must be positive multiples of 8 (TMA: 16-byte strides)")
    if m >= 2**31 // TILE_M:
        raise ValueError(f"gemm: M={m} rows is too many for 32-bit row indices")
    if mode == "heads" and (n % 3 or (n // 3) % 64 or s is None or s < 1 or m % s):
        raise ValueError(f"gemm: heads needs N = 3C with C % 64 == 0 and M = B*S (M={m}, N={n}, S={s})")
    maps = {"a": TensorMap((k, m, 1, 1), (2 * k, 2 * k * m, 2 * k * m), (TILE_K, TILE_M, 1, 1), 128)}
    if mode == "geglu":
        maps["w"] = TensorMap((k, n, 2, 1), (2 * k, 2 * k * n, 4 * k * n), (TILE_K, GEGLU_WIDTH, 1, 1), 128)
    else:
        maps["w"] = TensorMap((k, n, 1, 1), (2 * k, 2 * k * n, 2 * k * n), (TILE_K, tile_n(n), 1, 1), 128)
    if mode != "heads":
        maps["out"] = TensorMap((n, m, 1, 1, 1), (2 * n,) + (2 * n * m,) * 3, (BOX_COLS, 64, 1, 1, 1), 64)
    if mode == "bias_residual":
        maps["residual"] = TensorMap((n, m, 1, 1), (2 * n,) + (2 * n * m,) * 2, (BOX_COLS, 64, 1, 1), 64)
    return maps


def linear_plain(a, w, bias=None, residual=None) -> torch.Tensor:
    """a W^T [+ bias] [+ residual] in a's dtype."""
    out = F.linear(a, w, bias)
    return out if residual is None else residual + out


def linear_kernel(a, w, bias=None, residual=None) -> torch.Tensor:
    """The GEMM alone on the card: a (M, K), w (N, K), bias (N,) and
    residual (M, N) bf16 CUDA tensors; out (M, N) bf16."""
    m, k = a.shape
    n = w.shape[0]
    if w.shape != (n, k) or (bias is not None and bias.shape != (n,)) or (
            residual is not None and residual.shape != (m, n)):
        raise ValueError(f"gemm: a {tuple(a.shape)}, w {tuple(w.shape)} and the bias or residual do not match")
    tensor_maps(m, n, k, "store" if bias is None and residual is None else "bias_residual")
    _native.check_dtype("gemm", torch.bfloat16, a=a, w=w, bias=bias, residual=residual)
    _native.check_cuda("gemm", a=a, w=w, bias=bias, residual=residual)
    out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    P, I, L = _native.P, _native.I, _native.L
    _native.call(NAME, "pt_gemm", [P, P, P, P, P, L, I, I], _native.ptr(a), _native.ptr(w), _native.ptr(bias),
                 _native.ptr(residual), _native.ptr(out), m, n, k, count=COUNT)
    return out
