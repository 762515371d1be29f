"""Kernel 8: row LayerNorm in one pass, forward only.

Port of posetraj_tpu/ops/pallas_groupnorm.py:fused_layer_norm. The CUDA
kernel is posetraj_torch/csrc/layernorm.cu; `layer_norm_plain` is the same
function in plain PyTorch. Like the Pallas kernel, it has no backward: the
wrapper refuses an input that requires grad while grad mode is on.

`fused_layer_norm_applicable` is the dispatch gate of ops/primitives.layer_norm
(the JAX package's fused_layer_norm_applicable): KernelConfig.fused_ln, a
CUDA tensor, C % 8 == 0, C <= 2048 and at least 4096 rows.
"""

from __future__ import annotations

import math

import torch

from posetraj_torch.configs import kernel_config
from posetraj_torch.ops import _native

NAME = "layernorm"
MAX_C = 2048
MIN_ROWS = 4096


def layer_norm_plain(x, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """Reference formulation (_ln_kernel): float32 mean, then the mean of
    the squared deviation, rsqrt(var + eps), affine in float32, cast back."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def fused_layer_norm_applicable(x: torch.Tensor) -> bool:
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
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_layer_norm", [P, P, P, P, L, I, Fl, I],
        _native.ptr(x), _native.ptr(weight), _native.ptr(bias), _native.ptr(y), m, c, float(eps),
        int(x.dtype == torch.bfloat16),
    )
    return y
