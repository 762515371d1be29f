#!/usr/bin/env python3
"""The benchmark of posetraj_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's "workloads") names
a configuration (benchmark/configs/<name>.json) and a traffic mix
(benchmark/workloads/<traffic>.json), whose "kind" picks the driver
(benchmark/drivers/<kind>.py); benchmark/limits/<cell>.json holds the
limits of the numbers compared with the reference. The driver makes the
weights and inputs from --seed, sets up and warms the program, measures for
--seconds, then checks what the window produced against the float32
reference. With --trace 0 the last line of standard output carries the
cell's end-to-end metrics; with --trace 1 the window runs under
torch.profiler and the line carries the per-layer metrics
(benchmark/metrics/<name>.py) instead. The numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.

Exits 2 without a result when no CUDA device (or fewer than the cell asks
for) is present, and 3 when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "posetraj_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(name: str):
    """(manifest, cell, configuration dict, traffic dict, limits dict)."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "workloads" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{name}.json").read_text())
    return manifest, cell, cfg, traffic, limits


def cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths, so that only a
    checkout's first run builds. The port's nvcc builds land in
    build/kernels by its own rule; a Triton or torch extension kernel that a
    later PR adds finds its cache set here, in a file it may not edit."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))


def result(run, manifest: dict) -> dict:
    """The result line's object: the cell's end-to-end metrics (--trace 0)
    or its per-layer metrics (--trace 1), the device, the checks last."""
    from benchmark import harness

    name = run.cell["name"]
    metrics = {}
    if run.trace:
        for m in harness.cell_metrics(manifest, name, "per_layer"):
            value = harness.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(manifest, name, "end_to_end"):
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]][0], "unit": m["unit"]}
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": run.cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace_summary is not None:
        t = run.trace_summary
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    manifest, cell, cfg, traffic, limits = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    cache_dirs()
    from benchmark.harness import Run

    run = Run(cfg=cfg, traffic=traffic, cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda", 0), t0=T0, limits=limits)
    importlib.import_module(f"benchmark.drivers.{traffic['kind']}").run(run)
    out = result(run, manifest)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    print("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in run.phases.items()), file=sys.stderr)
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
