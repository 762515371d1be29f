"""One rank of the port's ("data", "model") mesh on gloo CPU processes.

Driven by tests/test_torch_mesh.py: `world` of these processes join one
process group through a FileStore, run every case of their world size on
the inputs the test wrote (inputs.pt: the port's parameters, the bundle, the
TrainConfig, the global batches and the pipeline's inputs), and each writes
what it computed to out_<rank>.pt for the test to compare.

    python tests/helpers/torch_mesh_rank.py --dir <case dir> --world 4 --rank 0

World 4: training, a checkpoint and batched serving on (2, 2). World 2:
training on (2, 1) and (1, 2), the (2, 2) checkpoint (written by the world-4
run) restored into (1, 2), serving on (2, 1), then the training CLI with
--distributed --n_model_shards 2 over TCP on --port.
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


def snapshot(trainer):
    """What the test compares of a trainer: its state_dict (a collective:
    the unsharded layout), this rank's whole weights and its masters at
    rest, as copies."""
    import torch

    from posetraj_torch.core.params import leaves

    sd = trainer.state_dict()
    copy = lambda tree: [t.detach().clone() for t in leaves(tree or {})]
    return {"controlnet": copy(sd["controlnet"]), "ema": copy(sd["ema"]), "grad_acc": copy(sd["grad_acc"]),
            "moments": {i: {k: v.clone() for k, v in e.items() if isinstance(v, torch.Tensor) and v.ndim}
                        for i, e in sd["optimizer"]["state"].items()},
            "shards": copy(trainer.state.masters())}


def train(inp, mesh, steps, trainer=None):
    """`steps` micro-steps of a Trainer on `mesh` over the global batches:
    each step's metrics and the update norm, and a snapshot after every
    optimizer update."""
    from posetraj_torch.train import Trainer

    if trainer is None:
        trainer = Trainer(inp["bundle"], inp["tcfg"], inp["frozen"], inp["controlnet"], mesh=mesh, device="cpu")
    out = {"metrics": [], "update_norm": [], "snapshots": []}
    for i in steps:
        m = trainer.step(inp["batches"][i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if trainer.state.step % inp["tcfg"].gradient_accumulation_steps == 0:
            out["update_norm"].append(float(trainer.state.update_norm))
            out["snapshots"].append(snapshot(trainer))
    return trainer, out


def serve(inp, mesh):
    """The batched pipeline on `mesh`: the frames of the global batch."""
    from posetraj_torch.pipeline import SVDControlNetPipeline

    image, control, kw = inp["serve"]
    pipe = SVDControlNetPipeline(inp["params"], inp["bundle"], device="cpu", mesh=mesh)
    return pipe(image, control, **kw)


def cli_run(argv):
    """The training CLI with `argv`, the rows its loader yields recorded (a
    sum a sample)."""
    from posetraj_torch.data import datasets
    from posetraj_torch.train import cli

    rows = []
    epoch = datasets.PrefetchLoader.epoch

    def recording(self, *a, **k):
        for batch in epoch(self, *a, **k):
            rows.append([float(x.sum()) for x in batch["pixel_values"]])
            yield batch

    datasets.PrefetchLoader.epoch = recording
    try:
        cli.main(argv)
    finally:
        datasets.PrefetchLoader.epoch = epoch
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True, help="directory of inputs.pt; out_<rank>.pt is written there")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, default=0, help="the CLI's coordinator port (world 2)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from posetraj_torch.parallel.mesh import make_mesh
    from posetraj_torch.train import restore_checkpoint, save_checkpoint

    inp = torch.load(os.path.join(args.dir, "inputs.pt"), weights_only=False)
    store = dist.FileStore(os.path.join(args.dir, f"store{args.world}"), args.world)
    dist.init_process_group("gloo", store=store, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    out = {}
    steps = range(len(inp["batches"]))
    try:
        if args.world == 4:
            mesh = make_mesh(2, 2, device="cpu")
            trainer, out["train_2x2"] = train(inp, mesh, steps[:2])
            save_checkpoint(os.path.join(args.dir, "ckpt"), trainer.state.step, trainer)
            _, rest = train(inp, mesh, steps[2:], trainer)
            for k, v in rest.items():
                out["train_2x2"][k] += v
            out["serve_2x2"] = serve(inp, mesh)
        else:
            meshes = {"2x1": make_mesh(2, 1, device="cpu"), "1x2": make_mesh(1, 2, device="cpu")}
            for name, mesh in meshes.items():
                out[f"train_{name}"] = train(inp, mesh, steps)[1]
            resumed = train(inp, meshes["1x2"], range(0))[0]
            restore_checkpoint(os.path.join(args.dir, "ckpt", "checkpoint-2"), resumed)
            out["resumed_1x2"] = train(inp, meshes["1x2"], steps[2:], resumed)[1]
            out["serve_2x1"] = serve(inp, meshes["2x1"])
    finally:
        dist.destroy_process_group()
    if args.world == 2:
        out["cli_rows"] = cli_run(inp["cli_args"] + [
            "--output_dir", os.path.join(args.dir, "cli_mesh"), "--distributed", "--coordinator_address",
            f"localhost:{args.port}", "--num_processes", str(args.world), "--process_id", str(args.rank),
            "--n_model_shards", "2"])
    torch.save(out, os.path.join(args.dir, f"out{args.world}_{args.rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
