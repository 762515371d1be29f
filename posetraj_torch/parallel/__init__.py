"""Single-video sharded serving on torch.distributed: the ("cfg", "sp") mesh
and the spatial-sharding context (spmd.py), make_serve_mesh and
generate_sharded (serve.py). The data- and tensor-parallel mesh of the JAX
package's parallel/mesh.py is not in the port yet."""

from posetraj_torch.parallel.spmd import ServeMesh, SpmdCtx, local_tokens, spatial_sharding  # noqa: F401

_SERVE = ("generate_sharded", "make_serve_mesh")


def __getattr__(name: str):
    # serve.py imports the pipeline and the models, which import spmd through
    # this package, so serve's names load on first use.
    if name in _SERVE:
        from posetraj_torch.parallel import serve

        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
