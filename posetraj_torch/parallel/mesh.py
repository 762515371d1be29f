"""The ("data", "model") device mesh and its sharding rules on
torch.distributed (port of posetraj_tpu/parallel/mesh.py).

The reference trains under Accelerate DDP over NCCL
(train_svd_traj_blender_14.py:821-827, 1066-1069; SURVEY.md 2.12-2.13).
Here, as there, one process drives one device: NCCL on the card, gloo for
CPU tensors. The mesh lays the processes out as the JAX package lays out
its devices:

  * "data": batch parallelism. Each data coordinate computes its rows of
    the global batch; the trainer all-reduces the gradient over "data"
    once per accumulation window (train/trainer.py); the batched pipeline
    all-gathers the frames over it.
  * "model": the at-rest layout of the big transformer weights, by the JAX
    package's rule (`param_shardings`): QKV / FF-in matrices shard their
    output (column) axis, the output projections their input (row) axis.

The compute runs on whole weights (gather-at-use): sharded leaves are kept
as this rank's block when not in use (the trainer's masters, AdamW moments
and EMA; the batched pipeline's ControlNet) and all-gathered over "model"
into whole-weight buffers before use (after each optimizer update; once a
pipeline call). That is numerically what the JAX package computes, and
kernels A-D take whole weights as they do on one device. Ranks of one model
group see the same rows and compute the same thing. Splitting the compute
itself (Megatron) needs the split on whole heads and whole GEGLU [value |
gate] pairs, which a block of columns does not give on this model's shapes.

Leaf names and layouts are the port's (core/bridge.py): the JAX column axis
(-1 of `kernel`) is dim 0 of `weight`, the row axis (-2) dim 1; a
self-attention's stacked `wqkv` (3C, C) is sharded as its three parts, so
that rank m holds [Wq_m; Wk_m; Wv_m].

One part of the model is not per sample: quirk Q7 (models/transformer.py,
diffusers 0.24.0) has pixel (b, s) of the temporal blocks read the context
row (b*S + s) % B of the whole batch. A rank computing its rows of the
global batch therefore needs the global batch's context rows and the global
index of each of its rows: `gather_batch_rows` all-gathers them over
"data" outside the model, and `global_batch_rows` hands them to the
transformer, which indexes that table in place of its local one.

Without a process group the mesh is (1, 1) and every collective is a
no-op; with one, every axis has its group, also at size 1.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from posetraj_torch.core.init import resolve_device
from posetraj_torch.core.params import chunks

# Weight-name suffixes that shard over "model" on their output (column)
# axis, and the output projections that shard their input (row) axis.
_COLUMN_SHARDED = ("to_q", "to_k", "to_v", "proj_in", "fc1", "linear_1")
_ROW_SHARDED = ("to_out", "proj_out", "fc2", "linear_2")
# Elements a bucket of the bucketed all-reduce flattens at a time.
_BUCKET = 1 << 26


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None) -> torch.device:
    """Join this process to the job's process group; returns its device.

    coordinator "host:port" with num_processes and process_id, or, without
    it, torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT). On the card the process takes cuda:LOCAL_RANK (else
    process_id modulo the visible cards) and NCCL; device="cpu" takes gloo.
    The counterpart of the JAX package's jax.distributed.initialize and of
    the reference's `accelerate launch` bootstrap."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init, rank, world = f"tcp://{coordinator}", int(process_id), int(num_processes)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        raise ValueError("a distributed run needs a coordinator address, or torchrun's environment (RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    if cpu:
        dev = torch.device("cpu")
    else:
        resolve_device(device)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init, rank=rank, world_size=world)
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (n_data, n_model) mesh of processes, rank r at (r // n_model,
    r % n_model) of the default group (the JAX package's
    devices.reshape(n_data, n_model)). `data_group` holds the ranks of this
    rank's model coordinate (its column), `model_group` those of its data
    coordinate (its row); both None without a process group. Made by
    make_mesh."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return {"data": self.data_group, "model": self.model_group}[axis]

    def all_reduce(self, tensors: List[torch.Tensor], axis: str, mean: bool = False) -> None:
        """Sum (or average) `tensors` in place over `axis`, flattened into
        buckets of at most _BUCKET elements per dtype."""
        group = self.group(axis)
        if group is None:
            return
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            for bucket in chunks([t for t in tensors if t.dtype == dtype], _BUCKET):
                flat = torch.cat([t.reshape(-1) for t in bucket])
                dist.all_reduce(flat, group=group)
                if mean:
                    flat /= self.shape[axis]
                torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in bucket]),
                                                                             bucket)])

    def barrier(self) -> None:
        """Every rank of the mesh waits here (a one-element all-reduce on
        the mesh's device, which NCCL and gloo both take; the host waits
        for it)."""
        if dist.is_initialized():
            dist.all_reduce(torch.zeros(1, device=self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The ("data", "model") mesh over every process of the default group,
    n_data defaulting to all of them over n_model (without a process group,
    a (1, 1) mesh). Every process calls this, in the same order as its
    other collectives: it makes the group of every row and column. device:
    where this process's tensors live, by default the current CUDA device;
    CPU tensors need gloo, CUDA tensors take NCCL (or gloo, which stages
    them)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} processes, the job has {world}")
    if not dist.is_initialized():
        return Mesh(1, 1, 0, device)
    if device.type == "cpu" and str(dist.get_backend()) != "gloo":
        raise ValueError(f"CPU tensors cannot use the {dist.get_backend()} backend: gloo for the CPU")
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == rank % n_model:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == rank // n_model:
            model_group = g
    return Mesh(n_data, n_model, rank, device, data_group, model_group)


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Where a tensor lives on a mesh: whole on every rank (axis None), or
    split along `dim` over `axis` ("data" or "model"). `parts` > 1 splits
    each of that many equal parts of the dim (a stacked [Wq; Wk; Wv]), so
    coordinate i holds block i of every part. The port's counterpart of a
    NamedSharding."""

    mesh: Mesh
    axis: Optional[str] = None
    dim: int = 0
    parts: int = 1

    @property
    def size(self) -> int:
        return 1 if self.axis is None else self.mesh.shape[self.axis]

    @property
    def sharded(self) -> bool:
        return self.size > 1

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of this rank's block of the whole tensor `t` (`t` itself
        when nothing is split); a split that does not divide raises."""
        if not self.sharded:
            return t
        n = self.size
        if t.shape[self.dim] % (self.parts * n):
            raise ValueError(f"dim {self.dim} of a {tuple(t.shape)} tensor does not divide into {self.parts} "
                             f"part(s) over {n} {self.axis} ranks")
        i = self.mesh.data_rank if self.axis == "data" else self.mesh.model_rank
        block = t.unflatten(self.dim, (self.parts, n, -1)).select(self.dim + 1, i)
        return block.flatten(self.dim, self.dim + 1).clone(memory_format=torch.contiguous_format)

    def gather(self, block: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole tensor from every rank's block (all-gather over the
        axis), written into `out` where given."""
        if not self.sharded:
            return block if out is None else out.copy_(block)
        block = block.contiguous()
        blocks = [torch.empty_like(block) for _ in range(self.size)]
        dist.all_gather(blocks, block, group=self.mesh.group(self.axis))
        whole = torch.stack([b.unflatten(self.dim, (self.parts, -1)) for b in blocks], dim=self.dim + 1)
        whole = whole.flatten(self.dim, self.dim + 2)
        return whole if out is None else out.copy_(whole)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh, ndim: int) -> Sharding:
    """Shard the leading (batch) axis of an `ndim`-dimensional array over
    "data"; its `local` raises unless n_data divides the batch."""
    if ndim < 1:
        raise ValueError("a batch sharding needs an array of at least one dimension")
    return Sharding(mesh, "data", 0)


def _spec_for(name: str, leaf: torch.Tensor, n_model: int):
    """(dim, parts) of a sharded port leaf, or None: the JAX package's
    _spec_for and bias rule on the port's names and layouts."""
    if n_model <= 1:
        return None
    path = name.split(".")
    kind, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if kind == "wqkv":  # to_q, to_k, to_v: each column-sharded
        return (0, 3) if leaf.shape[0] % (3 * n_model) == 0 else None
    if kind == "bias":  # follows a column-sharded weight
        return (0, 1) if parent in _COLUMN_SHARDED and leaf.shape[0] % n_model == 0 else None
    if leaf.ndim < 2:
        return None
    if parent in _COLUMN_SHARDED and leaf.shape[0] % n_model == 0:
        return (0, 1)
    if parent in _ROW_SHARDED and leaf.shape[1] % n_model == 0:
        return (1, 1)
    return None


def param_shardings(params, mesh: Mesh):
    """Tree of Shardings: transformer matmul weights split over "model",
    everything else replicated. Bias terms of column-sharded layers follow
    their weight's output axis; a leaf is split only where n_model divides
    its axis."""

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, f"{name}.{k}" if name else k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{name}.{i}" if name else str(i)) for i, v in enumerate(node)]
        spec = _spec_for(name, node, mesh.n_model)
        return Sharding(mesh) if spec is None else Sharding(mesh, "model", *spec)

    return walk(params, "")


def shard_params(params, shardings):
    """Each leaf's block on this rank (a copy where it is split, the leaf
    itself where it is replicated)."""
    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_params(v, s) for v, s in zip(params, shardings)]
    return shardings.local(params)


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """The global batch's context rows (B_glob, 1, D) and the global row of
    each of this rank's rows (b,), for quirk Q7's index."""

    table: torch.Tensor
    rows: torch.Tensor


_ROWS: list = []


@contextlib.contextmanager
def global_batch_rows(rows: Optional[BatchRows]):
    """Make `rows` the batch layout the model code inside this block reads
    (None: the local batch is the whole batch)."""
    _ROWS.append(rows)
    try:
        yield rows
    finally:
        _ROWS.pop()


def batch_rows() -> Optional[BatchRows]:
    return _ROWS[-1] if _ROWS else None


def gather_batch_rows(mesh: Mesh, local: torch.Tensor, groups: int = 1) -> BatchRows:
    """The BatchRows of `local`, this data coordinate's rows of `groups`
    stacked batches (CFG's [uncond; cond]: groups 2), each batch in data
    order: all-gathered over "data" (every rank calls this). The table is
    float32; the transformer casts it to its context's dtype."""
    b = local.shape[0] // groups
    local = local.float()  # exact for the bf16 context; every backend takes float32
    blocks = [local] if mesh.data_group is None else [torch.empty_like(local) for _ in range(mesh.n_data)]
    if mesh.data_group is not None:
        dist.all_gather(blocks, local.contiguous(), group=mesh.data_group)
    table = torch.cat([blk[g * b:(g + 1) * b] for g in range(groups) for blk in blocks])
    base = torch.arange(b, device=local.device) + mesh.data_rank * b
    return BatchRows(table, torch.cat([base + g * b * len(blocks) for g in range(groups)]))
