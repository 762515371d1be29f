"""NN primitives over channels-last tensors, mixed-precision aware.

Layouts follow the JAX package: images (N, H, W, C), videos (B, F, H, W, C),
parameters in PyTorch layouts (see core/init.py). Matmuls and convolutions
run in the compute dtype; normalisation statistics in float32. Convolutions
go to cuDNN through a channels-last view (no layout copy), plain matmuls to
torch.matmul: the JAX package left both to XLA.

Precision of float32 work on the card: `set_float32_precision()` turns TF32
OFF for both matmuls (`torch.backends.cuda.matmul.allow_tf32 = False`) and
cuDNN convolutions (`torch.backends.cudnn.allow_tf32 = False`), so the
float32 VAE encode runs in full float32 as the reference's upcast intends.
The entry points call it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from posetraj_torch.configs import kernel_config
from posetraj_torch.ops import groupnorm as gn_kernel
from posetraj_torch.ops import layernorm as ln_kernel

# Activations this large take kernel A even with KernelConfig.fused_groupnorm
# off (the JAX package's rule: its XLA GroupNorm cannot fit the VAE decode).
GN_KERNEL_ALWAYS = 1 << 28


def set_float32_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """y = x @ W^T + b with W stored (out, in)."""
    dt = compute_dtype or x.dtype
    b = params.get("bias")
    return F.linear(x.to(dt), params["weight"].to(dt), None if b is None else b.to(dt))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(params: dict, x: torch.Tensor, stride: int = 1, padding="SAME", compute_dtype=None) -> torch.Tensor:
    """2D conv over (N, H, W, C) with an OIHW weight. `padding`: "SAME" (odd
    kernels, stride 1: symmetric k//2) or ((top, bottom), (left, right)),
    e.g. the VAE's asymmetric (0, 1, 0, 1)."""
    dt = compute_dtype or x.dtype
    w = params["weight"]
    kh, kw = w.shape[2:]
    xc = _nchw(x.to(dt))
    if padding == "SAME":
        pad = (kh // 2, kw // 2)
    else:
        (pt, pb), (pl, pr) = padding
        if pt == pb and pl == pr:
            pad = (pt, pl)
        else:
            xc = F.pad(xc, (pl, pr, pt, pb))
            pad = (0, 0)
    b = params.get("bias")
    y = F.conv2d(xc, w.to(dt), None if b is None else b.to(dt), stride=stride, padding=pad)
    return _nhwc(y)


def conv3d_temporal(params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Temporal conv with kernel (kf, 1, 1) over (N, F, H, W, C), weight
    (out, in, kf, 1, 1). One matmul computes every tap for every frame,
    (rows, C) @ (C, kf * out); output frame t then sums tap j of input frame
    t + j - kf // 2 (zero outside the clip), taps added in the JAX package's
    order j = 0, 1, 2. No frame-shifted copy of the input is made."""
    dt = compute_dtype or x.dtype
    w = params["weight"].to(dt)
    out_c, in_c, kf = w.shape[:3]
    xb = x.to(dt)
    f = xb.shape[1]
    pad = kf // 2
    taps = F.linear(xb, w[:, :, :, 0, 0].permute(2, 0, 1).reshape(kf * out_c, in_c))
    taps = taps.reshape(*xb.shape[:-1], kf, out_c)
    y = torch.zeros((*xb.shape[:-1], out_c), dtype=dt, device=xb.device)
    for j in range(kf):
        s = j - pad
        lo, hi = max(0, -s), min(f, f - s)
        y[:, lo:hi] += taps[:, lo + s : hi + s, ..., j, :]
    if "bias" in params:
        y += params["bias"].to(dt)
    return y


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, statistics in float32, result in x's
    dtype. Kernel 8 under KernelConfig.fused_ln where its gate admits x."""
    if ln_kernel.fused_layer_norm_applicable(x):
        return ln_kernel.layer_norm(x, params["weight"], params["bias"], eps)
    y = F.layer_norm(x.float(), x.shape[-1:], params["weight"].float(), params["bias"].float(), eps)
    return y.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (torch's nn.GELU default, diffusers' GEGLU)."""
    return F.gelu(x)


def geglu(params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    h = linear(params, x, compute_dtype)
    h, gate = h.chunk(2, dim=-1)
    return h * gelu(gate)


def _groups(c: int, num_groups: int) -> int:
    if c % num_groups != 0:
        if c >= num_groups:
            raise ValueError(f"group_norm: {c} channels not divisible by {num_groups} groups")
        # Tiny test configs have fewer channels than the standard 32 groups.
        return math.gcd(c, num_groups)
    return num_groups


def group_norm_silu(params: dict, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5,
                    act: bool = True, add: torch.Tensor | None = None) -> torch.Tensor:
    """GroupNorm over channels-last x (N, ..., C), statistics per sample over
    every non-batch dim, optionally followed by SiLU. add: optional (N, C)
    per-sample or (N, F, C) per-frame channel vector added to x before the
    norm (the resnet time-embedding broadcast), folded into kernel A.
    With KernelConfig.fused_groupnorm off, activations under 2^28 elements
    take the JAX package's XLA formulation instead: the add in x's dtype,
    float32 statistics, SiLU after the cast back."""
    groups = _groups(x.shape[-1], num_groups)
    if kernel_config().fused_groupnorm or x.numel() >= GN_KERNEL_ALWAYS:
        return gn_kernel.group_norm(x, params["weight"], params["bias"], groups, eps, act, add)
    if add is not None:
        lead = add.shape[:-1]
        x = x + add.reshape(*lead, *(1,) * (x.ndim - len(lead) - 1), add.shape[-1]).to(x.dtype)
    y = F.group_norm(x.float().movedim(-1, 1), groups, params["weight"].float(), params["bias"].float(), eps)
    y = y.movedim(1, -1).to(x.dtype)
    return silu(y) if act else y


def group_norm(params: dict, x: torch.Tensor, num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    return group_norm_silu(params, x, num_groups, eps, act=False)


def downsample_2x(params: dict, x: torch.Tensor, asymmetric_pad: bool = False, compute_dtype=None) -> torch.Tensor:
    """Stride-2 3x3 conv (diffusers Downsample2D): padding 1 in the UNet, the
    VAE encoder's manual (0, 1, 0, 1) pad with `asymmetric_pad=True`."""
    pad = ((0, 1), (0, 1)) if asymmetric_pad else ((1, 1), (1, 1))
    return conv2d(params, x, stride=2, padding=pad, compute_dtype=compute_dtype)


def upsample_nearest_2x(params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Nearest x2 upsample + 3x3 conv (diffusers Upsample2D)."""
    up = F.interpolate(_nchw(x), scale_factor=2.0, mode="nearest")
    return conv2d(params, _nhwc(up), stride=1, padding=((1, 1), (1, 1)), compute_dtype=compute_dtype)
