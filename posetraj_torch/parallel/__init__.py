"""The parallel layer on torch.distributed, one process a device: the
("data", "model") mesh of data parallelism and the at-rest sharding of the
transformer weights (mesh.py: initialize_distributed, make_mesh,
param_shardings, ...; used by Trainer(mesh=), SVDControlNetPipeline(mesh=)
and the training CLI's --distributed), and single-video sharded serving:
the ("cfg", "sp") mesh and the spatial-sharding context (spmd.py),
make_serve_mesh and generate_sharded (serve.py)."""

from posetraj_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharding,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    param_shardings,
    replicated,
    shard_params,
)
from posetraj_torch.parallel.spmd import ServeMesh, SpmdCtx, local_tokens, spatial_sharding  # noqa: F401

_SERVE = ("generate_sharded", "make_serve_mesh")


def __getattr__(name: str):
    # serve.py imports the pipeline and the models, which import spmd through
    # this package, so serve's names load on first use.
    if name in _SERVE:
        from posetraj_torch.parallel import serve

        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
