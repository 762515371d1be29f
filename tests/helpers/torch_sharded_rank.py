"""One rank of the port's single-video sharded serving on gloo CPU processes.

Driven by tests/test_torch_sharded.py: `world` of these processes join one
process group through a FileStore, run every case of their world size on the
inputs the test wrote (inputs.pt: numpy arrays and the port's parameters),
and each writes what it computed to out_<rank>.pt for the test to compare.

    python tests/helpers/torch_sharded_rank.py --dir <case dir> --world 2 --rank 0
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

# Invoked as a script: sys.path[0] is tests/helpers, not the repository root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# Each rank's process group gives up after this long on any collective.
PG_TIMEOUT_S = 60


def op_contracts(inp, mesh):
    """The spmd op contracts on this rank's W block of each input: halo
    convolutions, GroupNorm+SiLU with an addend (the split plain form), self-
    attention with gathered K/V, the gather/scatter boundary of a replicated
    level. Returns this rank's blocks of the outputs."""
    import torch

    from posetraj_torch.ops import primitives
    from posetraj_torch.ops.attention import attention
    from posetraj_torch.parallel import spmd

    n, j = mesh.n_sp, mesh.sp_rank
    block = lambda x, axis=-2: torch.from_numpy(x).chunk(n, dim=axis)[j].contiguous()
    ctx = spmd.SpmdCtx(mesh)
    out = {}
    with spmd.spatial_sharding(ctx):
        for name, (x, w, b, stride, pad) in inp["convs"].items():
            p = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}
            out[f"conv_{name}"] = primitives.conv2d(p, block(x), stride=stride, padding=pad)
        for name, (x, scale, bias, add, groups) in inp["group_norms"].items():
            p = {"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
            out[f"gn_{name}"] = primitives.group_norm_silu(p, block(x), groups, add=torch.from_numpy(add))
        q, k, v, heads = inp["attention"]
        out["attention"] = attention(block(q, 1), block(k, 1), block(v, 1), heads, gather_kv=ctx)
    x, down_w, down_b, up_w, up_b = inp["boundary"]
    rep = spmd.SpmdCtx(mesh, replicated_h=frozenset({x.shape[1] // 2}))
    with spmd.spatial_sharding(rep):
        down = primitives.downsample_2x({"weight": torch.from_numpy(down_w), "bias": torch.from_numpy(down_b)},
                                        block(x))
        out["boundary_down"] = down  # replicated: the full width on every rank
        out["boundary_up"] = primitives.upsample_nearest_2x(
            {"weight": torch.from_numpy(up_w), "bias": torch.from_numpy(up_b)}, down)
    return out


def generate_case(run, params, bundle, mesh, output_latent):
    """generate_sharded on one run's inputs (pcfg, image, control, noises)."""
    from posetraj_torch.diffusion.euler_karras import make_schedule
    from posetraj_torch.parallel import generate_sharded
    from posetraj_torch.pipeline.svd_controlnet import added_time_ids_inference

    pcfg, image, control, noises = run
    sched = make_schedule(bundle.scheduler, pcfg.num_inference_steps)
    return generate_sharded(params, bundle, pcfg, image, control, noises, added_time_ids_inference(pcfg),
                            sched.sigmas, sched.timesteps, pcfg.num_frames, mesh, output_latent=output_latent)


COUNTED = ("halo_exchange_w", "psum_spatial", "all_gather_tokens", "gather_w", "all_gather_cfg", "psum_cfg")


def collectives_per_step(run, params, bundle, mesh):
    """Calls of each spmd collective a denoise step: generate_sharded's
    latents at 2 steps less those at 1 step (the encode, the hint encoder
    and the final gather cancel)."""
    import dataclasses

    from posetraj_torch.parallel import spmd

    counts = []
    for steps in (1, 2):
        calls = dict.fromkeys(COUNTED, 0)
        real = {name: getattr(spmd, name) for name in COUNTED}

        def counting(name):
            def fn(*a, **k):
                calls[name] += 1
                return real[name](*a, **k)
            return fn

        try:
            for name in COUNTED:
                setattr(spmd, name, counting(name))
            generate_case((dataclasses.replace(run[0], num_inference_steps=steps), *run[1:]), params, bundle, mesh,
                          True)
        finally:
            for name, fn in real.items():
                setattr(spmd, name, fn)
        counts.append(calls)
    return {name: counts[1][name] - counts[0][name] for name in COUNTED}


def temp_hint(inp, mesh):
    """The temp variant's hint embedding on this rank's W block."""
    import torch

    from posetraj_torch.models import controlnet as cn
    from posetraj_torch.parallel import spmd

    hint_params, cfg, control, f = inp["temp_hint"]
    ctx = spmd.SpmdCtx(mesh)
    with spmd.spatial_sharding(ctx), torch.inference_mode():
        return cn.hint_encoder(hint_params, cfg, torch.from_numpy(control).chunk(mesh.n_sp, dim=-2)[
            mesh.sp_rank].contiguous(), f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="directory of inputs.pt; out_<rank>.pt is written there")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from posetraj_torch.parallel import make_serve_mesh

    store = dist.FileStore(os.path.join(args.dir, "store"), args.world)
    dist.init_process_group("gloo", store=store, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        inp = torch.load(os.path.join(args.dir, "inputs.pt"), weights_only=False)
        params, bundle, runs = inp["params"], inp["bundle"], inp["runs"]
        out = {}
        # Every mesh of this world size, made on every rank in one order.
        sp_only = make_serve_mesh(1, args.world, device="cpu")
        out["ops"] = op_contracts(inp, sp_only)
        mesh = sp_only if args.world == 2 else make_serve_mesh(2, args.world // 2, device="cpu")
        out["latents"] = generate_case(runs["main"], params, bundle, mesh, True)
        out["frames"] = generate_case(runs["main"], params, bundle, mesh, False)
        if args.world == 2:
            out["temp_hint"] = temp_hint(inp, sp_only)
        else:
            out["replicated_frames"] = generate_case(runs["replicated"], params, bundle, mesh, False)
            out["collectives"] = collectives_per_step(runs["main"], params, bundle, mesh)
        torch.save(out, os.path.join(args.dir, f"out_{args.rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
