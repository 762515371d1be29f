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

The split form, for W-sharded serving (the JAX package's psum_axis path):
`group_norm(..., reduce=, shards=)` runs a statistics launch (per-(sample,
group) [sum, sum of squares], the addend folded in), hands the (N, 2G)
sums to `reduce` (the caller's all-reduce over the ranks that hold the
other W blocks), then an apply launch that takes mean and rstd over
`shards` times the local count. Inference only: it raises under grad.
`group_norm_plain(..., reduce=, shards=)` is its plain version, with
float32 partials as the JAX package's _ref_group_norm
(group_norm_stats_plain, then group_norm_apply_plain).
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


def _plus_addend(x, add) -> torch.Tensor:
    """x + add in float32, the addend broadcast over x's rows."""
    xf = x.float()
    if add is None:
        return xf
    n, c = x.shape[0], x.shape[-1]
    a = _addend_shape(x, add).float()
    mid = (a.shape[1],) + (1,) * (x.ndim - 3) if x.ndim >= 3 else ()
    return xf + a.reshape((n,) + mid + (c,))


def _affine(g, x, weight, bias, mean, var, eps: float, act: bool) -> torch.Tensor:
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * weight.float() + bias.float()
    if act:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def group_norm_plain(x, weight, bias, num_groups: int, eps: float, act: bool, add=None, reduce=None,
                     shards: int = 1) -> torch.Tensor:
    """Reference formulation: (x + add) in float32, two-pass mean/var per
    (sample, group), affine in float32, optional SiLU, cast back to x.dtype.
    With `reduce`, the split form's plain version: group_norm_stats_plain,
    `reduce`, group_norm_apply_plain."""
    if reduce is not None:
        sums = reduce(group_norm_stats_plain(x, num_groups, add))
        return group_norm_apply_plain(x, weight, bias, sums, num_groups, eps, act, add, shards)
    g = _plus_addend(x, add).reshape(x.shape[0], -1, num_groups, x.shape[-1] // num_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    return _affine(g, x, weight, bias, mean, var, eps, act)


def group_norm_stats_plain(x, num_groups: int, add=None) -> torch.Tensor:
    """The split form's statistics: float32 [sum | sum of squares] (N, 2G)
    of x + add per (sample, group) (the JAX package's _stats_kernel
    partials, summed)."""
    g = _plus_addend(x, add).reshape(x.shape[0], -1, num_groups, x.shape[-1] // num_groups)
    return torch.cat([g.sum(dim=(1, 3)), (g * g).sum(dim=(1, 3))], dim=1)


def group_norm_apply_plain(x, weight, bias, sums, num_groups: int, eps: float, act: bool, add=None,
                           shards: int = 1) -> torch.Tensor:
    """The split form's apply: mean and var = E[x^2] - mean^2 (clamped at 0)
    from the (N, 2G) sums over `shards` blocks of each sample, then the
    affine and SiLU of group_norm_plain (the JAX package's _ref_group_norm
    with psum_axis)."""
    n = x.shape[0]
    g = _plus_addend(x, add).reshape(n, -1, num_groups, x.shape[-1] // num_groups)
    count = g.shape[1] * g.shape[3] * shards
    sums = sums.to(torch.float32)
    mean = (sums[:, :num_groups] / count).reshape(n, 1, num_groups, 1)
    var = ((sums[:, num_groups:] / count).reshape(n, 1, num_groups, 1) - mean * mean).clamp_min(0.0)
    return _affine(g, x, weight, bias, mean, var, eps, act)


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


def group_norm(x, weight, bias, num_groups: int, eps: float, act: bool, add=None, reduce=None,
               shards: int = 1) -> torch.Tensor:
    """(N, ..., C) GroupNorm. CPU tensor: the plain version. CUDA tensor:
    kernel A, or an error if the kernel does not take the inputs.
    Differentiable in x, weight, bias and add. With `reduce` (a function
    that sums an (N, 2G) tensor of statistics over the `shards` ranks holding
    the samples' other blocks, in place, and returns it) the split form,
    which raises under grad."""
    if reduce is None:
        return GroupNorm.apply(x, weight, bias, add, num_groups, eps, act)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias, add)):
        raise RuntimeError("group_norm: the split form (reduce=) has no backward; sharded serving is inference only")
    run = group_norm_split_kernel if x.is_cuda else group_norm_plain
    return run(x, weight, bias, num_groups, eps, act, add, reduce=reduce, shards=shards)


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


def _kernel_inputs(x, weight, bias, num_groups: int, add):
    """Checks common to every launch of kernel A: (n, s, frames, add as
    (n, frames, c) in x's dtype, float32 weight, float32 bias)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"group_norm kernel: dtype {x.dtype} (bf16 or float32 only)")
    n, c = x.shape[0], x.shape[-1]
    vec = 16 // x.element_size()
    if c % vec != 0 or c % num_groups != 0 or x.ndim < 2:
        raise ValueError(f"group_norm kernel: C={c} must divide by {vec} and by {num_groups} groups")
    if c * x.element_size() > THREADS * 16:
        raise ValueError(f"group_norm kernel: a row of {c * x.element_size()} bytes is wider than {THREADS} "
                         "16-byte vectors")
    s = math.prod(x.shape[1:-1])
    if s >= 2**31:
        raise ValueError(f"group_norm kernel: {s} rows a sample (at most 2^31 - 1)")
    frames = 1
    if add is not None:
        add = _addend_shape(x, add).to(x.dtype).contiguous()
        frames = add.shape[1]
        if s % frames != 0:
            raise ValueError("group_norm kernel: rows per sample not divisible by frames")
    weight = weight.float().contiguous() if weight is not None else None
    bias = bias.float().contiguous() if bias is not None else None
    _native.check_cuda("group_norm", x=x, weight=weight, bias=bias, add=add)
    return n, s, frames, add, weight, bias


def _sms(device) -> int:
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def group_norm_kernel(x, weight, bias, num_groups: int, eps: float, act: bool, add=None) -> torch.Tensor:
    n, s, frames, add, weight, bias = _kernel_inputs(x, weight, bias, num_groups, add)
    c = x.shape[-1]
    grid, teams = schedule(n, s, c, x.element_size(), num_groups, _sms(x.device))
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


# The split form's launches: a grid of (blocks, n) CTAs of THREADS threads,
# blocks a sample enough for SPLIT_CTAS_PER_SM CTAs an SM over the n
# samples, and no more than give each thread of a CTA one row.
SPLIT_CTAS_PER_SM = 4


def split_blocks(n: int, s: int, c: int, itemsize: int, sms: int) -> int:
    """CTAs a sample of the split form's two launches."""
    rows_a_pass = THREADS // (c * itemsize // 16)
    return max(1, min(-(-s // rows_a_pass), -(-SPLIT_CTAS_PER_SM * sms // n)))


def group_norm_stats_kernel(x, num_groups: int, add=None) -> torch.Tensor:
    """The split form's statistics launch: x (N, ..., C) [+ add] -> (N, 2G)
    float64 [sum | sum of squares] of each (sample, group) over x's rows."""
    n, s, frames, add, _, _ = _kernel_inputs(x, None, None, num_groups, add)
    if n > 65535:
        raise ValueError(f"group_norm split form: {n} samples (at most 65535)")
    sums = torch.zeros(n, 2 * num_groups, dtype=torch.float64, device=x.device)
    c = x.shape[-1]
    P, I, L = _native.P, _native.I, _native.L
    _native.call(NAME, "pt_group_norm_stats", [P, P, P, L, L, I, I, I, I, I],
                 _native.ptr(x), _native.ptr(add), _native.ptr(sums), n, s, c, num_groups, frames,
                 int(x.dtype == torch.bfloat16), split_blocks(n, s, c, x.element_size(), _sms(x.device)),
                 count="gn_stats")
    return sums


def group_norm_apply_kernel(x, weight, bias, sums, num_groups: int, eps: float, act: bool, add=None,
                            shards: int = 1) -> torch.Tensor:
    """The split form's apply launch: GroupNorm(x + add) [, SiLU] with the
    statistics `sums` (N, 2G) float64 summed over `shards` blocks of each
    sample, each of x's rows a sample."""
    n, s, frames, add, weight, bias = _kernel_inputs(x, weight, bias, num_groups, add)
    if sums.shape != (n, 2 * num_groups) or sums.dtype != torch.float64:
        raise ValueError(f"group_norm apply: sums {tuple(sums.shape)} {sums.dtype}, expected "
                         f"({n}, {2 * num_groups}) float64")
    _native.check_cuda("group_norm_apply", sums=sums)
    c = x.shape[-1]
    y = torch.empty_like(x)
    P, I, L, Fl, D = _native.P, _native.I, _native.L, _native.Fl, _native.D
    _native.call(NAME, "pt_group_norm_apply", [P, P, P, P, P, P, L, L, I, I, I, D, Fl, I, I, I],
                 _native.ptr(x), _native.ptr(weight), _native.ptr(bias), _native.ptr(add), _native.ptr(sums),
                 _native.ptr(y), n, s, c, num_groups, frames, float(s * (c // num_groups) * shards), float(eps),
                 int(act), int(x.dtype == torch.bfloat16), split_blocks(n, s, c, x.element_size(), _sms(x.device)),
                 count="gn_apply")
    return y


def group_norm_split_kernel(x, weight, bias, num_groups: int, eps: float, act: bool, add=None, reduce=None,
                            shards: int = 1) -> torch.Tensor:
    """Kernel A's split form on the card: statistics launch, `reduce` of the
    (N, 2G) sums, apply launch."""
    sums = reduce(group_norm_stats_kernel(x, num_groups, add))
    return group_norm_apply_kernel(x, weight, bias, sums, num_groups, eps, act, add, shards)
