"""The ("cfg", "sp") serving mesh and the context that spatially shards the
model graph (port of posetraj_tpu/parallel/spmd.py on torch.distributed).

Single-video serving cannot shard the batch: there is one video. The
denoise step shards over a ("cfg", "sp") mesh instead, one process per
device:

  * "cfg": the classifier-free-guidance pair. The uncond and cond branches
    run on disjoint ranks; the guidance combine is one small all-reduce a
    step (parallel/serve.py).
  * "sp": blocks of the latent W axis. W divides at every UNet level of the
    flagship (128 -> 64 -> 32 -> 16 over sp = 4; H's 72 -> 36 -> 18 -> 9
    does not).

Under W-sharding the model needs three kinds of communication, all here,
which ops/primitives.py, models/transformer.py and parallel/serve.py take
through the context `spatial_sharding(ctx)`:

  1. 3x3 convolutions: a halo of W columns from each neighbour
     (`halo_exchange_w`, point-to-point on the sp group), then the conv
     runs VALID along W. Edge ranks receive zeros, exactly the conv's zero
     padding.
  2. GroupNorm: per-(sample, group) partial [sum, sum of squares], summed
     over sp (`psum_spatial`) between kernel A's statistics and its apply
     (ops/groupnorm.py, the split form).
  3. Spatial self-attention: K/V all-gathered over sp
     (`all_gather_tokens`); the queries stay local, so kernel 7 runs each
     rank's S/sp query rows against all the keys.

Everything else is local under this layout: the temporal (3, 1, 1) convs
and the frame-axis attention act per pixel, LayerNorms per row, 1x1 convs
have no spatial extent. Every collective is a no-op on an axis of size 1,
so a (1, 1) mesh runs the same code on one device with no process group.

Backends: NCCL for CUDA tensors, gloo for CPU tensors (the tests). A CUDA
tensor on a gloo group raises; nothing is staged through host memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class ServeMesh:
    """A (n_cfg, n_sp) mesh of processes, rank r at (r // n_sp, r % n_sp) of
    the default process group (the JAX package's devices.reshape(n_cfg,
    n_sp)). `sp_group` holds this rank's row (same cfg index), `cfg_group`
    its column; each is None where its axis has size 1 (a (1, 1) mesh
    needs no process group). Collectives take tensors on `device` only.
    Made by parallel/serve.make_serve_mesh."""

    n_cfg: int
    n_sp: int
    rank: int
    device: torch.device
    sp_group: Optional[dist.ProcessGroup] = None
    cfg_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.n_cfg * self.n_sp

    @property
    def cfg_rank(self) -> int:
        return self.rank // self.n_sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.n_sp

    def sp_peer(self, j: int) -> int:
        """The default-group rank of sp index j in this rank's row."""
        return self.cfg_rank * self.n_sp + j


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    """The sharding layout of the model code run inside `spatial_sharding`.

    replicated_h / replicated_s: UNet levels that run REPLICATED (the full W
    on every sp rank) because their width ladder stops dividing, e.g. the
    deepest level of 320x576 (latent W 72 -> 36 -> 18 -> 9) under sp = 2.
    The downsampler into the first such level all-gathers W and the
    matching upsampler scatters it back (ops/primitives.py). Ops key their
    collectives on shapes: replicated_h holds the H extents of replicated
    levels (convolutions, GroupNorm, the Q7 context), replicated_s their
    token counts H * W (spatial self-attention, whose flattened (B*F, S, C)
    tensor no longer carries H). serve._check_divisible refuses a ladder
    where these keys collide with a sharded level's extents."""

    mesh: ServeMesh = dataclasses.field(compare=False)
    replicated_h: frozenset = frozenset()
    replicated_s: frozenset = frozenset()

    @property
    def sp_size(self) -> int:
        return self.mesh.n_sp

    @property
    def cfg_size(self) -> int:
        return self.mesh.n_cfg

    @property
    def sharded_w(self) -> bool:
        return self.sp_size > 1

    def w_sharded_at(self, h: int) -> bool:
        """Is the W axis of a spatial tensor with H extent `h` sharded?"""
        return self.sp_size > 1 and h not in self.replicated_h

    def tokens_sharded(self, s: int) -> bool:
        """Is the token axis of a flattened (B*F, S, C) tensor a W shard?"""
        return self.sp_size > 1 and s not in self.replicated_s


_STACK: list = []


@contextlib.contextmanager
def spatial_sharding(ctx: Optional[SpmdCtx]):
    """Make `ctx` the layout of the model code run inside this block."""
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


@contextlib.contextmanager
def local_tokens():
    """Suspend the spatial context: inside this block ops treat their token
    axes as local (where the "spatial" axis of a tensor is really a frame
    axis, as in the temp hint encoder's frame transformer)."""
    _STACK.append(None)
    try:
        yield
    finally:
        _STACK.pop()


def current() -> Optional[SpmdCtx]:
    return _STACK[-1] if _STACK else None


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, mesh: ServeMesh) -> torch.Tensor:
    if t.device != mesh.device:
        raise ValueError(f"a collective of the mesh on {mesh.device} got a tensor on {t.device}")
    return t


def halo_exchange_w(x: torch.Tensor, left: int, right: int, ctx: SpmdCtx) -> torch.Tensor:
    """x (..., H, W, C) with `left` columns of the left neighbour's block
    before it and `right` columns of the right neighbour's after it, along
    W. Edge ranks have no neighbour on that side and take zeros there (the
    conv's zero padding), as lax.ppermute delivers them."""
    if not left and not right:
        return x
    mesh = ctx.mesh
    j, n, w = mesh.sp_rank, mesh.n_sp, x.shape[-2]
    ops, parts = [], []
    if left:
        recv = x.new_zeros(*x.shape[:-2], left, x.shape[-1])
        if j + 1 < n:
            ops.append(dist.P2POp(dist.isend, _check(x[..., w - left:, :].contiguous(), mesh), mesh.sp_peer(j + 1),
                                  mesh.sp_group, tag=1))
        if j > 0:
            ops.append(dist.P2POp(dist.irecv, recv, mesh.sp_peer(j - 1), mesh.sp_group, tag=1))
        parts.append(recv)
    parts.append(x)
    if right:
        recv = x.new_zeros(*x.shape[:-2], right, x.shape[-1])
        if j > 0:
            ops.append(dist.P2POp(dist.isend, _check(x[..., :right, :].contiguous(), mesh), mesh.sp_peer(j - 1),
                                  mesh.sp_group, tag=2))
        if j + 1 < n:
            ops.append(dist.P2POp(dist.irecv, recv, mesh.sp_peer(j + 1), mesh.sp_group, tag=2))
        parts.append(recv)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat(parts, dim=-2)


def psum_spatial(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """Sum partial spatial statistics over the sp axis, in place."""
    if ctx.sp_size > 1:
        dist.all_reduce(_check(x, ctx.mesh), group=ctx.mesh.sp_group)
    return x


def _all_gather(x: torch.Tensor, n: int, group, mesh: ServeMesh, axis: int) -> torch.Tensor:
    x = _check(x.contiguous(), mesh)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def all_gather_tokens(x: torch.Tensor, ctx: SpmdCtx, axis: int = 1) -> torch.Tensor:
    """All-gather a token-sharded tensor along `axis` over sp, in the order
    of the sp ranks (attention K/V: (B, S_local, C) -> (B, S_global, C))."""
    if ctx.sp_size == 1:
        return x
    return _all_gather(x, ctx.sp_size, ctx.mesh.sp_group, ctx.mesh, axis)


def gather_w(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """All-gather the W axis (-2 of (..., H, W, C)) over sp: the entry into
    a replicated deep level."""
    return all_gather_tokens(x, ctx, axis=x.ndim - 2)


def scatter_w(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """This rank's W block of a replicated full-width tensor: the exit from
    a replicated deep level."""
    if ctx.sp_size == 1:
        return x
    w_loc = x.shape[-2] // ctx.sp_size
    return x.narrow(x.ndim - 2, ctx.mesh.sp_rank * w_loc, w_loc).contiguous()


def all_gather_cfg(x: torch.Tensor, ctx: SpmdCtx, axis: int = 0) -> torch.Tensor:
    """All-gather over the cfg axis, in the order of the cfg ranks."""
    if ctx.cfg_size == 1:
        return x
    return _all_gather(x, ctx.cfg_size, ctx.mesh.cfg_group, ctx.mesh, axis)


def psum_cfg(x: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
    """Sum over the cfg axis, in place."""
    if ctx.cfg_size > 1:
        dist.all_reduce(_check(x, ctx.mesh), group=ctx.mesh.cfg_group)
    return x


def all_gather_mesh(x: torch.Tensor, mesh: ServeMesh, axis: int = 0) -> torch.Tensor:
    """All-gather over every rank of the mesh, in rank order."""
    if mesh.size == 1:
        return x
    return _all_gather(x, mesh.size, None, mesh, axis)


def conv_halo_plan(kw: int, stride: int, pad_w: tuple) -> tuple:
    """(halo_left, halo_right) so that a W-VALID conv over the haloed local
    block gives this rank's block of the global conv's output.

    Global output column o reads inputs [o*stride - pl, o*stride - pl + kw
    - 1]. A rank owning local outputs [0, W_loc/stride) at global offset
    O = rank*W_loc (W_loc divisible by stride) needs inputs [O - pl, O +
    W_loc - stride + kw - 1 - pl]: pl columns more on the left and
    kw - 1 - pl - (stride - 1) on the right."""
    pl_, _ = pad_w
    halo_r = kw - 1 - pl_ - (stride - 1)
    if halo_r < 0:
        raise ValueError(f"unsupported conv geometry kw={kw} stride={stride} pad={pad_w}")
    return pl_, halo_r
