"""Kernel A: channels-last GroupNorm (+SiLU) (+ per-sample / per-frame addend).

Port of posetraj_tpu/ops/pallas_groupnorm.py:fused_group_norm. The CUDA
kernel is posetraj_torch/csrc/groupnorm.cu; `group_norm_plain` is the same
function in plain PyTorch. `group_norm` runs the plain version for a tensor
on the CPU and launches the kernel for one on the card, through `GroupNorm`,
its custom_vjp (_gn_fwd/_gn_bwd): the backward recomputes the plain version
for the gradients of x, weight, bias and the addend. `schedule` sets the
kernel's one cooperative launch: its grid and its teams, a team per sample
in flight, sized so that each sample in flight stays in its team's shared
memory between the kernel's two passes over it.
"""

from __future__ import annotations

import math

import torch

from posetraj_torch.ops import _native
from posetraj_torch.ops.recompute import recompute_vjp

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


class GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, add, num_groups: int, eps: float, act: bool):
        ctx.save_for_backward(x, weight, bias, add)
        ctx.static = (num_groups, eps, act)
        run = group_norm_kernel if x.is_cuda else group_norm_plain
        return run(x, weight, bias, num_groups, eps, act, add)

    @staticmethod
    def backward(ctx, grad):
        num_groups, eps, act = ctx.static
        fn = lambda x, w, b, add: group_norm_plain(x, w, b, num_groups, eps, act, add)
        return recompute_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:4], grad) + (None, None, None)


def group_norm(x, weight, bias, num_groups: int, eps: float, act: bool, add=None) -> torch.Tensor:
    """(N, ..., C) GroupNorm. CPU tensor: the plain version. CUDA tensor:
    kernel A, or an error if the kernel does not take the inputs.
    Differentiable in x, weight, bias and add."""
    return GroupNorm.apply(x, weight, bias, add, num_groups, eps, act)


# Kernel A's launch: 512 threads a CTA, at most two CTAs an SM, all
# co-resident; each CTA holds up to SLOTS x SLOT_BYTES of its rows in
# shared memory (csrc/groupnorm.cu), and one 16-byte vector of a row a
# thread: rows of at most 8 KB.
THREADS = 512
CTAS_PER_SM = 2
SLOTS = 4
SLOT_BYTES = 24 * 1024
SMEM_PER_SM = 228 * 1024
# Teams the counter buffer has room for: one per CTA of the largest grid.
MAX_TEAMS = 1024

_WORKSPACE = {}
_SMS = {}


def schedule(n: int, s: int, c: int, itemsize: int, groups: int, sms: int):
    """(grid, teams) of kernel A for x (n, s, c): a grid of as many CTAs as
    fit the SMs (two an SM while their shared memory allows), no more than
    give each CTA 8 KB; as many teams as samples that the grid can hold in
    shared memory at once (a sample needs ceil(s / rows a CTA holds) CTAs),
    at most one a sample, then evened out so that every team takes
    ceil(n / teams) samples or one fewer. A sample larger than the whole
    grid's shared memory runs one team of the whole grid, streaming."""
    row = c * itemsize
    if row > THREADS * 16:
        raise ValueError(f"group_norm kernel: a row of {row} bytes is wider than {THREADS} 16-byte vectors")
    smem = SLOTS * SLOT_BYTES + 4 * (THREADS * 16 // itemsize + 2 * groups) + 1024
    per_sm = max(1, min(CTAS_PER_SM, SMEM_PER_SM // smem))
    grid = max(1, min(per_sm * sms, MAX_TEAMS, -(-n * s * row // 8192)))
    need = -(-s // (SLOTS * (SLOT_BYTES // row)))
    most = max(1, min(n, grid // need))
    rounds = -(-n // most)
    return grid, -(-n // rounds)


def _workspace(device: torch.device, groups: int):
    """Kernel A's team state on one device: two barrier counters a team
    (int32) and three rounds of [sum, sum of squares] a group (float64).
    Zeroed when made, left zero by every launch (csrc/groupnorm.cu), so a
    call needs no memset; calls on one device share it and must not overlap
    on two streams."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1].numel() < MAX_TEAMS * 6 * groups:
        ws = _WORKSPACE[key] = (torch.zeros(2 * MAX_TEAMS, dtype=torch.int32, device=device),
                                torch.zeros(MAX_TEAMS * 6 * groups, dtype=torch.float64, device=device))
    return ws


def workspaces() -> tuple:
    """Every device's workspace as it stands. A CUDA graph that captured
    kernel A holds these, since its launches point into them and a later
    call with more groups replaces (and frees) a device's workspace."""
    return tuple(_WORKSPACE.values())


def group_norm_kernel(x, weight, bias, num_groups: int, eps: float, act: bool, add=None) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm kernel: dtype {x.dtype} (bf16 or float32 only)")
    n, c = x.shape[0], x.shape[-1]
    vec = 16 // x.element_size()
    if c % vec != 0 or c % num_groups != 0 or x.ndim < 2:
        raise ValueError(f"group_norm kernel: C={c} must divide by {vec} and by {num_groups} groups")
    s = math.prod(x.shape[1:-1])
    if s >= 2**31:
        raise ValueError(f"group_norm kernel: {s} rows a sample (at most 2^31 - 1)")
    frames = 1
    if add is not None:
        add = _addend_shape(x, add).to(x.dtype).contiguous()
        frames = add.shape[1]
        if s % frames != 0:
            raise ValueError("group_norm kernel: rows per sample not divisible by frames")
    weight = weight.float().contiguous()
    bias = bias.float().contiguous()
    _native.check_cuda("group_norm", x=x, weight=weight, bias=bias, add=add)
    sms = _SMS.get(x.device.index)
    if sms is None:
        sms = _SMS[x.device.index] = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid, teams = schedule(n, s, c, x.element_size(), num_groups, sms)
    counters, sums = _workspace(x.device, num_groups)
    y = torch.empty_like(x)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_group_norm",
        [P, P, P, P, P, P, P, L, L, I, I, I, Fl, I, I, I, I],
        _native.ptr(x), _native.ptr(weight), _native.ptr(bias), _native.ptr(add), _native.ptr(sums),
        _native.ptr(counters), _native.ptr(y),
        n, s, c, num_groups, frames, float(eps), int(act), int(x.dtype == torch.bfloat16), grid, teams,
    )
    return y
