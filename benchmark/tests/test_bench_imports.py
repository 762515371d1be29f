"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import subprocess
import sys

from benchmark.config import ROOT

HARNESS = ["benchmark.run", "benchmark.harness", "benchmark.calibrate", "benchmark.drivers.video",
           "benchmark.drivers.train", "benchmark.work", "benchmark.inputs", "benchmark.weights"]


def _loaded(modules, extra=""):
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules) + extra +
            "print(sorted({n.split('.', 1)[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    extra = "import posetraj_torch.pipeline.svd_controlnet, posetraj_torch.train.trainer\n"
    assert not _loaded(HARNESS, extra) & {"jax", "jaxlib", "flax", "posetraj_tpu"}


def test_reference_loads_nothing_of_the_program():
    assert not _loaded(["benchmark.reference.model", "benchmark.reference.tree"]) & {
        "jax", "jaxlib", "flax", "posetraj_tpu", "posetraj_torch"}


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "base.video-320x576", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and not out.stdout.strip()
