"""Kernel A: channels-last GroupNorm (+SiLU) (+ per-sample / per-frame addend).

Port of posetraj_tpu/ops/pallas_groupnorm.py:fused_group_norm. The CUDA
kernel is posetraj_torch/csrc/groupnorm.cu; `group_norm_plain` is the same
function in plain PyTorch. `group_norm` runs the plain version for a tensor
on the CPU and launches the kernel for one on the card.
"""

from __future__ import annotations

import math

import torch

from posetraj_torch.ops import _native

NAME = "groupnorm"


def _addend_shape(x: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """add (N, C) or (N, F, C) -> (N, F, C) with F = 1 for a per-sample vector."""
    if add.ndim == 2:
        add = add[:, None]
    if add.ndim != 3 or add.shape[0] != x.shape[0] or add.shape[-1] != x.shape[-1]:
        raise ValueError(f"group_norm: addend {tuple(add.shape)} does not fit x {tuple(x.shape)}")
    if add.shape[1] > 1 and (x.ndim < 3 or add.shape[1] != x.shape[1]):
        raise ValueError(f"group_norm: per-frame addend {tuple(add.shape)} needs x (N, F, ..., C)")
    return add


def group_norm_plain(x, weight, bias, num_groups: int, eps: float, act: bool, add=None) -> torch.Tensor:
    """Reference formulation: (x + add) in float32, two-pass mean/var per
    (sample, group), affine in float32, optional SiLU, cast back to x.dtype."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float()
    if add is not None:
        a = _addend_shape(x, add).float()
        mid = (a.shape[1],) + (1,) * (x.ndim - 3) if x.ndim >= 3 else ()
        xf = xf + a.reshape((n,) + mid + (c,))
    g = xf.reshape(n, -1, num_groups, c // num_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if act:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm(x, weight, bias, num_groups: int, eps: float, act: bool, add=None) -> torch.Tensor:
    """(N, ..., C) GroupNorm. CPU tensor: the plain version. CUDA tensor:
    kernel A, or an error if the kernel does not take the inputs."""
    if not x.is_cuda:
        return group_norm_plain(x, weight, bias, num_groups, eps, act, add)
    return group_norm_kernel(x, weight, bias, num_groups, eps, act, add)


def rows_per_block(n: int, s: int) -> int:
    """Stats-pass row range per block: enough blocks (about 1024) to fill
    the card's 132 SMs several times over, at least 32 rows each."""
    blocks_per_sample = max(1, -(-1024 // n))
    return max(32, -(-s // blocks_per_sample))


def group_norm_kernel(x, weight, bias, num_groups: int, eps: float, act: bool, add=None) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm kernel: dtype {x.dtype} (bf16 or float32 only)")
    n, c = x.shape[0], x.shape[-1]
    vec = 16 // x.element_size()
    if c % vec != 0 or c % num_groups != 0 or x.ndim < 2:
        raise ValueError(f"group_norm kernel: C={c} must divide by {vec} and by {num_groups} groups")
    s = math.prod(x.shape[1:-1])
    frames = 1
    if add is not None:
        add = _addend_shape(x, add).to(x.dtype).contiguous()
        frames = add.shape[1]
        if s % frames != 0:
            raise ValueError("group_norm kernel: rows per sample not divisible by frames")
    weight = weight.float().contiguous()
    bias = bias.float().contiguous()
    _native.check_cuda("group_norm", x=x, weight=weight, bias=bias, add=add)
    rpb = rows_per_block(n, s)
    nb = -(-s // rpb)
    partial = torch.empty((n, nb, 2 * num_groups), device=x.device, dtype=torch.float32)
    scale_shift = torch.empty((n, 2, c), device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_group_norm",
        [P, P, P, P, P, P, P, L, L, I, I, I, L, Fl, I, I],
        _native.ptr(x), _native.ptr(weight), _native.ptr(bias), _native.ptr(add),
        _native.ptr(partial), _native.ptr(scale_shift), _native.ptr(y),
        n, s, c, num_groups, frames, rpb, float(eps), int(act), int(x.dtype == torch.bfloat16),
    )
    return y
