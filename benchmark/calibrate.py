#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from (not part of a run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --mode program|control|half|encode

For each seed, at the cell's own sizes and through the same code as a run,
the numbers the run compares:
  program  the program's output (a video cell: request 0 of the seed through
           one pipeline, its weights refilled in place for each seed; a
           training cell: a fresh trainer's first optimizer steps) against
           the float32 reference: the lower readings;
  control  the reference with fp8 operands put in the program's place: the
           upper readings;
  half     (training) the reference with half of each step's batch left out,
           the mean taken over the rest: a fault's readings;
  encode   encode_rel_rms alone, for the VAE encoder that the configuration
           states in float32 with TF32 off: the program's (as in program,
           the timed path's encode of the seed's request or micro-steps; a
           training cell keeps one trainer and refills its weights, batches
           and draws for each seed, which leaves the encode as a fresh
           trainer's) and its controls', the reference's encoder one step
           below float32 put in the program's place: "tf32" (TF32 products)
           and "bf16" (bfloat16 operands).
Prints one JSON line a seed and, last, the largest and smallest reading of
each number and, for the encode controls, whether the cell's limit failed
each seed's reading (harness.Check). Needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def video_readings(run, seeds, mode):
    from benchmark import inputs
    from benchmark.drivers import video

    prog = video.Program(run)
    tr = run.traffic
    for seed in seeds:
        run.seed = seed
        prog.weights.refill(seed)
        prog.requests = [inputs.video_request(seed, 0, tr)]
        prog.noises = [inputs.video_noises(seed, 0, tr, run.cfg["vae"]["latent_channels"], 8, run.device)]
        if mode == "program":
            prog.latents.clear()
            prog.encodes.clear()
            frames, latents = prog.request(0), prog.latents[-1]
        want = video.reference(run, prog, 0)
        if mode == "control":
            frames, latents, encoded = video.reference(run, prog, 0, fp8=True)
            frames = frames.cpu().numpy()
        else:
            encoded = prog.encodes[-1][1:]
        yield seed, video.readings(frames, latents, encoded, *want)


LOWER = ("tf32", "bf16")


def video_encode_readings(run, seeds):
    from benchmark import inputs
    from benchmark.drivers import video

    prog = video.Program(run)
    tr = run.traffic
    for seed in seeds:
        run.seed = seed
        prog.weights.refill(seed)
        prog.requests = [inputs.video_request(seed, 0, tr)]
        prog.noises = [inputs.video_noises(seed, 0, tr, run.cfg["vae"]["latent_channels"], 8, run.device)]
        prog.encodes.clear()
        prog.request(0)
        want = video.encode_reference(run, prog, 0)
        values = {"encode_rel_rms": video.rel_rms(prog.encodes[-1][1:], want)}
        for lower in LOWER:
            values[f"{lower}.encode_rel_rms"] = video.rel_rms(video.encode_reference(run, prog, 0, lower), want)
        yield seed, values


def train_encode_readings(run, seeds):
    from benchmark import inputs
    from benchmark.drivers import train

    windows, tr = run.traffic["check_windows"], run.traffic
    prog = train.Program(run)
    for seed in seeds:
        if seed != run.seed:
            run.seed = seed
            prog.weights.refill(seed)
            prog.trainer.generator.manual_seed(train.draw_seed(seed))
            prog.batches = [inputs.train_batch(seed, i, tr, run.device) for i in range(tr["pool"])]
            prog.steps = 0
        got = prog.first_steps(windows)["encode"]
        want = train.encode_reference(run, prog.weights, windows, prog.batches)
        values = {"encode_rel_rms": train.encode_gap(got, want)}
        for lower in LOWER:
            values[f"{lower}.encode_rel_rms"] = train.encode_gap(
                train.encode_reference(run, prog.weights, windows, prog.batches, lower), want)
        yield seed, values


def train_readings(run, seeds, mode):
    import gc

    from benchmark.drivers import train

    windows = run.traffic["check_windows"]
    for seed in seeds:
        run.seed = seed
        prog = train.Program(run)
        got = prog.first_steps(windows) if mode == "program" else None
        batches, weights = prog.batches, prog.weights
        prog.free()
        del prog
        gc.collect()
        want = train.reference(run, weights, windows, batches)
        if mode != "program":
            got = train.reference(run, weights, windows, batches, fp8=mode == "control", half=mode == "half")
        yield seed, {**train.readings(got, want), "worst": worst_leaves(weights, got, want)}


def worst_leaves(weights, got: dict, want: dict, n: int = 3) -> dict:
    """For each per-leaf number: its n worst leaves (name, elements, the
    reference's norm and RMS per element of the first gradient, both norms
    compared): what the worst-leaf readings come from."""
    import numpy as np

    from benchmark.drivers import train
    from benchmark.weights import walk

    leaves = list(walk(weights.tree["controlnet"]))
    med = {k: np.median(want[k]) for k in ("grad", "update", "ema")}
    out = {}
    for k in ("grad", "update", "ema"):
        gap = np.abs(got[k] - want[k]) / np.maximum(want[k], med[k])
        gap = np.where(train.moved(want) if k != "grad" else want["size"] > 1, gap, 0.0)
        out[k] = [[".".join(leaves[i][0]), leaves[i][1].numel(), float(want["grad"][i]),
                   float(want["grad"][i] / np.sqrt(leaves[i][1].numel())), float(want[k][i]), float(got[k][i]),
                   float(gap[i])] for i in np.argsort(-gap)[:n]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--mode", choices=("program", "control", "half", "encode"), default="program")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness import Run
    from benchmark.run import cache_dirs, load_cell

    cache_dirs()
    _, cell, cfg, traffic, limits = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    run = Run(cfg=cfg, traffic=traffic, cell=cell, seed=seeds[0], seconds=0.0, trace=False,
              device=torch.device("cuda", 0), t0=time.perf_counter(), limits=limits)
    if args.mode == "encode":
        gen = {"video": video_encode_readings, "train": train_encode_readings}[traffic["kind"]](run, seeds)
    else:
        gen = {"video": video_readings, "train": train_readings}[traffic["kind"]](run, seeds, args.mode)
    seen = {}
    for seed, values in gen:
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed, **values}), flush=True)
        for k, v in values.items():
            if k != "worst":
                seen.setdefault(k, []).append(v)
    summary = {"workload": args.workload, "mode": args.mode, "seeds": len(seeds),
               "max": {k: max(v) for k, v in seen.items()}, "min": {k: min(v) for k, v in seen.items()}}
    from benchmark.harness import Check

    summary["control_fails_every_seed"] = {
        k: all(not Check(k, v, limits[k.split(".", 1)[1]]).ok for v in vs)
        for k, vs in seen.items() if k.split(".", 1)[0] in LOWER and k.split(".", 1)[1] in limits}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
