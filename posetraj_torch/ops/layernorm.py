"""Kernel 8: row LayerNorm in one pass, forward only.

Port of posetraj_tpu/ops/pallas_groupnorm.py:fused_layer_norm. The CUDA
kernel is posetraj_torch/csrc/layernorm.cu; `layer_norm_plain` is the same
function in plain PyTorch. Like the Pallas kernel, it has no backward: the
wrapper refuses an input that requires grad while grad mode is on.

`fused_layer_norm_applicable` is the dispatch gate of ops/primitives.layer_norm
(the JAX package's fused_layer_norm_applicable): KernelConfig.fused_ln, a
CUDA tensor, C % 8 == 0, C <= 2048 and at least 4096 rows, and no gradient
asked for.

`plan` is the kernel's launch plan, pure Python so that the CPU tests hold
it: how many lanes share a row, how many 16-byte vectors each lane holds
and the persistent grid, from the CTAs an SM holds of the chosen instance,
which the compiled library reports (`occupancy`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from posetraj_torch.configs import kernel_config
from posetraj_torch.ops import _native

NAME = "layernorm"
MAX_C = 2048
MIN_ROWS = 4096
THREADS = 128      # a CTA: 4 warps (csrc/layernorm.cu kThreads)
VEC_BYTES = 16     # x and y move in 16-byte vectors
_OCCUPANCY = {}    # (device, dtype, vecs) -> (SMs, CTAs an SM holds)


class Plan(NamedTuple):
    lanes: int  # lanes a row: a power of two, at most 32
    rows: int   # rows a warp takes at a time: 32 // lanes
    vecs: int   # 16-byte vectors of a row each lane holds
    grid: int   # CTAs launched: at most ctas_per_sm on each SM


def max_vecs(itemsize: int) -> int:
    """Vectors a lane holds of the widest row (C = MAX_C) on a whole warp:
    8 in bf16, 16 in float32 (the kernel's instances)."""
    return MAX_C * itemsize // VEC_BYTES // 32


@functools.lru_cache(maxsize=None)
def layout(c: int, itemsize: int) -> tuple:
    """(lanes, vecs) for a row of C values of `itemsize` bytes. A row of nv
    16-byte vectors goes to the largest power-of-two group of lanes (at most
    a warp) that divides nv; if that leaves a lane more than max_vecs
    vectors (nv with a large odd factor, e.g. 41 at C = 328), the whole warp
    takes the row and its last round is ragged."""
    if c % 8 or not 0 < c <= MAX_C:
        raise ValueError(f"layer_norm plan: C must be a positive multiple of 8 up to {MAX_C} (C={c})")
    nv = c * itemsize // VEC_BYTES
    lanes = min(nv & -nv, 32)
    if nv // lanes > max_vecs(itemsize):
        lanes = 32
    return lanes, -(-nv // lanes)


@functools.lru_cache(maxsize=None)
def plan(m: int, c: int, dtype: torch.dtype, sms: int, ctas_per_sm: int) -> Plan:
    """The launch plan of kernel 8 for (m, c) rows of `dtype` on a card of
    `sms` SMs, each holding `ctas_per_sm` CTAs of the instance for
    layout(c)'s vectors a lane. The grid is as many CTAs as the SMs hold at
    once, or fewer if the rows run out first."""
    lanes, vecs = layout(c, dtype.itemsize)
    if m < 1 or sms < 1 or ctas_per_sm < 1:
        raise ValueError(f"layer_norm plan: needs rows, SMs and CTAs an SM (m={m}, sms={sms}, "
                         f"ctas_per_sm={ctas_per_sm})")
    rows = 32 // lanes
    groups = -(-m // rows)  # a warp takes one group of rows at a time
    return Plan(lanes, rows, vecs, min(ctas_per_sm * sms, -(-groups // (THREADS // 32))))


def occupancy(device: torch.device, dtype: torch.dtype, vecs: int) -> tuple:
    """(SMs of the card, CTAs an SM holds of the kernel's instance for
    `vecs` vectors a lane of `dtype`), as the compiled library reports them;
    asked once for each key."""
    key = (device.index, dtype, vecs)
    got = _OCCUPANCY.get(key)
    if got is None:
        out = ctypes.c_int(0)
        err = _native.library(NAME).pt_layer_norm_ctas_per_sm(int(dtype == torch.bfloat16), vecs, ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"layer_norm: no occupancy for {vecs} vectors a lane of {dtype} (CUDA error {err})")
        got = _OCCUPANCY[key] = (torch.cuda.get_device_properties(device).multi_processor_count, out.value)
    return got


def layer_norm_plain(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """Reference formulation (_ln_kernel): float32 mean, then the mean of
    the squared deviation, rsqrt(var + eps), affine in float32, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def fused_layer_norm_applicable(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """The gate of ops/primitives.layer_norm. It declines while grad mode is
    on and x or one of `params` (weight, bias) requires grad: kernel 8 has
    no backward, in the JAX package as here, so a LayerNorm that a gradient
    flows through runs as F.layer_norm. Under a training step with
    KernelConfig.fused_ln that is every LayerNorm of the ControlNet and of
    the UNet's up path; the UNet's down path and mid block, which take no
    input that needs a gradient, still launch kernel 8."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return False
    c = x.shape[-1]
    return (kernel_config().fused_ln and x.is_cuda and c % 8 == 0 and c <= MAX_C
            and math.prod(x.shape[:-1]) >= MIN_ROWS)


def layer_norm(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """(..., C) LayerNorm. CPU tensor: the plain version. CUDA tensor:
    kernel 8, or an error. Not differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("layer_norm: kernel 8 has no backward; train with KernelConfig(fused_ln=False)")
    return (layer_norm_kernel if x.is_cuda else layer_norm_plain)(x, weight, bias, eps)


def layer_norm_kernel(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    c = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"layer_norm kernel: dtype {x.dtype} (bf16 or float32 only)")
    if c % 8 or c > MAX_C or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"layer_norm kernel: needs C % 8 == 0, C <= {MAX_C} and (C,) weight and bias (C={c})")
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    _native.check_cuda("layer_norm", x=x, weight=weight, bias=bias)
    y = torch.empty_like(x)
    m = x.numel() // c
    if m == 0:
        return y
    pl = plan(m, c, x.dtype, *occupancy(x.device, x.dtype, layout(c, x.dtype.itemsize)[1]))
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_layer_norm", [P, P, P, P, L, I, Fl, I, I, I, I],
        _native.ptr(x), _native.ptr(weight), _native.ptr(bias), _native.ptr(y), m, c, float(eps),
        int(x.dtype == torch.bfloat16), pl.lanes, pl.vecs, pl.grid,
    )
    return y
