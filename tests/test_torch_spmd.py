"""The port's sharded-serving pieces that need no process group, no JAX
compile: conv_halo_plan, serve._check_divisible at the JAX package's cases
(tests/test_sharded_single_video.py), the spatial context's keys and stack,
kernel A's split plain form over two W blocks summed in one process against
the unsplit GroupNorm, and the guards (a mesh without processes, a tensor
off the mesh's device, the split form under grad, a batched mesh on the
pipeline). Float32 on the CPU; the split form within 2e-5 (the JAX test's
GroupNorm tolerance: sums in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

from posetraj_torch.configs import PipelineConfig
from posetraj_torch.ops import groupnorm
from posetraj_torch.parallel import serve, spmd
from posetraj_torch.pipeline import ModelBundle


@pytest.mark.parametrize("kw,stride,pad,want", [
    (3, 1, (1, 1), (1, 1)),  # SAME 3x3
    (3, 2, (1, 1), (1, 0)),  # the UNet's and the hint encoder's downsampler
    (3, 2, (0, 1), (0, 1)),  # the VAE encoder's asymmetric (0, 1, 0, 1) pad
    (1, 1, (0, 0), (0, 0)),  # 1x1: no halo
])
def test_conv_halo_plan(kw, stride, pad, want):
    assert spmd.conv_halo_plan(kw, stride, pad) == want


def test_conv_halo_plan_refuses_a_geometry_it_cannot_serve():
    with pytest.raises(ValueError, match="unsupported"):
        spmd.conv_halo_plan(1, 2, (0, 0))


EVAL = PipelineConfig(height=320, width=576, num_frames=14, num_inference_steps=25, decode_chunk_size=2)
FLAGSHIP = PipelineConfig(height=576, width=1024, num_frames=14, num_inference_steps=25, decode_chunk_size=2)


@pytest.mark.parametrize("pcfg,bundle,mesh,want", [
    (FLAGSHIP, ModelBundle(), (2, 4), (frozenset(), frozenset())),  # every level sharded
    (EVAL, ModelBundle(), (2, 2), (frozenset({5}), frozenset({45}))),  # the 5x9 level replicated
    (PipelineConfig(height=64, width=192, num_frames=2, decode_chunk_size=1), ModelBundle.tiny(), (2, 2),
     (frozenset({1}), frozenset({3}))),  # the tiny replicated-deepest-level case
    (FLAGSHIP, ModelBundle(), (1, 1), (frozenset(), frozenset())),
], ids=["flagship-2x4", "eval-2x2", "tiny192-2x2", "flagship-1x1"])
def test_check_divisible_sets(pcfg, bundle, mesh, want):
    assert serve._check_divisible(pcfg, bundle, pcfg.num_frames, *mesh) == want


@pytest.mark.parametrize("pcfg,mesh,match", [
    (EVAL, (2, 4), "ambiguous"),  # sharded level-1 S == replicated level-2 S == 180
    (dataclasses.replace(FLAGSHIP, width=104), (2, 4), "divide|multiple"),  # latent 13
    (FLAGSHIP, (3, 1), "cfg axis"),
    (dataclasses.replace(FLAGSHIP, decode_chunk_size=4), (1, 2), "decode_chunk_size"),
], ids=["eval-sp4-ambiguous", "width104", "cfg3", "chunk"])
def test_check_divisible_refusals(pcfg, mesh, match):
    with pytest.raises(ValueError, match=match):
        serve._check_divisible(pcfg, ModelBundle(), pcfg.num_frames, *mesh)


def _mesh(n_cfg, n_sp, rank=0, device="cpu"):
    return spmd.ServeMesh(n_cfg, n_sp, rank, torch.device(device))


def test_ctx_keys_and_stack():
    ctx = spmd.SpmdCtx(_mesh(2, 2, rank=3), replicated_h=frozenset({5}), replicated_s=frozenset({45}))
    assert (ctx.cfg_size, ctx.sp_size, ctx.mesh.cfg_rank, ctx.mesh.sp_rank, ctx.mesh.sp_peer(0)) == (2, 2, 1, 1, 2)
    assert ctx.w_sharded_at(40) and not ctx.w_sharded_at(5)
    assert ctx.tokens_sharded(180) and not ctx.tokens_sharded(45)
    one = spmd.SpmdCtx(_mesh(2, 1))
    assert not one.sharded_w and not one.w_sharded_at(40) and not one.tokens_sharded(180)
    assert spmd.current() is None
    with spmd.spatial_sharding(ctx):
        assert spmd.current() is ctx
        with spmd.local_tokens():
            assert spmd.current() is None
        assert spmd.current() is ctx
    assert spmd.current() is None


def test_collectives_are_no_ops_at_size_one():
    ctx = spmd.SpmdCtx(_mesh(1, 1))
    x = torch.randn(2, 3, 4, 5)
    for fn in (spmd.psum_spatial, spmd.all_gather_tokens, spmd.gather_w, spmd.scatter_w, spmd.all_gather_cfg,
               spmd.psum_cfg):
        assert fn(x, ctx) is x
    # The halo of a lone rank is the conv's zero padding.
    h = spmd.halo_exchange_w(x, 1, 1, ctx)
    assert h.shape == (2, 3, 6, 5) and torch.equal(h[:, :, 1:5], x)
    assert not h[:, :, 0].any() and not h[:, :, 5].any()


def test_collective_refuses_a_tensor_off_the_mesh_device():
    """A mesh's collectives take tensors on its own device only: a CUDA
    tensor on a gloo (CPU) mesh raises before any communication, and is
    never staged through host memory."""
    ctx = spmd.SpmdCtx(_mesh(1, 2))
    with pytest.raises(ValueError, match="got a tensor on meta"):
        spmd.psum_spatial(torch.empty(2, 4, device="meta"), ctx)
    with pytest.raises(ValueError, match="got a tensor on meta"):
        spmd.all_gather_tokens(torch.empty(2, 4, 3, device="meta"), ctx)


def test_mesh_without_processes():
    mesh = serve.make_serve_mesh(1, 1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.sp_group, mesh.cfg_group) == (1, 0, None, None)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        serve.make_serve_mesh(2, 4, device="cpu")


def _split(x, add, w, b, groups, act):
    """Kernel A's split plain form on the two W halves of x, each reduce the
    sum of its own and the other half's partials (what the all-reduce of two
    ranks gives), concatenated back."""
    halves = x.chunk(2, dim=-2)
    partials = []
    for h in halves:
        groupnorm.group_norm_plain(h, w, b, groups, 1e-5, act, add, reduce=lambda t: partials.append(t) or t,
                                   shards=2)
    outs = [groupnorm.group_norm_plain(h, w, b, groups, 1e-5, act, add, reduce=lambda t, i=i: t + partials[1 - i],
                                       shards=2) for i, h in enumerate(halves)]
    return torch.cat(outs, dim=-2)


@pytest.mark.parametrize("shape,add_shape", [((3, 6, 8, 16), (3, 16)), ((2, 3, 4, 8, 16), (2, 3, 16))],
                         ids=["per-sample", "per-frame"])
def test_split_plain_form_matches_one_group_norm(shape, add_shape):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3 + 1)
    add = torch.from_numpy(rng.randn(*add_shape).astype(np.float32))
    w = torch.from_numpy(rng.randn(16).astype(np.float32))
    b = torch.from_numpy(rng.randn(16).astype(np.float32))
    want = groupnorm.group_norm_plain(x, w, b, 4, 1e-5, True, add)
    np.testing.assert_allclose(_split(x, add, w, b, 4, True).numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_split_form_raises_under_grad():
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        groupnorm.group_norm(x, torch.ones(8), torch.zeros(8), 4, 1e-5, True, reduce=lambda t: t, shards=1)
    with torch.no_grad():
        y = groupnorm.group_norm(x, torch.ones(8), torch.zeros(8), 4, 1e-5, True, reduce=lambda t: t, shards=1)
    assert y.shape == x.shape


def test_pipeline_mesh_arguments():
    """serve_mesh and the batched mesh cannot be combined; the batched mesh
    (parallel/mesh.py) is not in the port yet."""
    from posetraj_torch.pipeline import SVDControlNetPipeline

    mesh = serve.make_serve_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        SVDControlNetPipeline({}, ModelBundle.tiny(), mesh=object(), serve_mesh=mesh)
    with pytest.raises(NotImplementedError, match="mesh.py"):
        SVDControlNetPipeline({}, ModelBundle.tiny(), device="cpu", mesh=object())
    assert SVDControlNetPipeline({}, ModelBundle.tiny(), serve_mesh=mesh).device == torch.device("cpu")
