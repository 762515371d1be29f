"""The port's tools/fill.py, tools/bench_train.py, tools/kernel_sweep.py,
utils/profiling.py and the converter's load onto a `meta` template, on the
CPU: fill_params bit for bit the JAX package's on the tiny UNet tree
(float32 and bf16), each leaf its own tensor, a `meta` template filled on
the card unless the CPU is asked for; StageTimer and trace;
bench_train_step on the tiny bundle at 64x64, 2 frames; the sweep's record
on the tiny bundle against a plain count of the wrappers' calls, its replay
on the CPU (where each wrapper is its plain version), its CACHED / SHED /
FAIL logic with a stubbed replay, and its skip-cache kept per card and
never by a CPU run. The kernels themselves are held on the
card in tests/test_torch_cuda.py. No JAX compile.
"""

import json
import os

import numpy as np
import pytest
import torch

H = W = 64
F = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fill_params_bitwise_jax(dtype):
    import jax
    import jax.numpy as jnp

    from posetraj_tpu.configs import UNetConfig
    from posetraj_tpu.models import unet as ju
    from posetraj_tpu.tools.fill import fill_params as jfill
    from posetraj_torch.core.params import leaves
    from posetraj_torch.tools.fill import fill_params

    shapes = ju.init_unet(None, UNetConfig.tiny())  # the JAX bench's template (no key: zeros)
    want = jfill(shapes, getattr(jnp, dtype))
    template = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    got = fill_params(template, getattr(torch, dtype), device="cpu")
    bits = np.uint32 if dtype == "float32" else np.uint16
    pairs = []

    def check(w, g):
        g_np = g.view(torch.int32 if dtype == "float32" else torch.int16).numpy().view(bits)
        assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
        np.testing.assert_array_equal(g_np, np.asarray(w).view(bits))
        pairs.append(g)

    jax.tree_util.tree_map(check, want, got)  # leaf by leaf, by path
    assert len(pairs) == len(list(leaves(got))) > 100
    # No leaf aliases another: the optimizer updates leaves in place.
    assert len({t.untyped_storage().data_ptr() for t in pairs}) == len(pairs)


def test_fill_params_meta_leaves_default_to_the_card(monkeypatch):
    """A `meta` template (init_params(device="meta"), the benches' and the
    sweep's) is filled on the card unless device="cpu" is passed: without a
    card, the default raises. A leaf that already has a device keeps it."""
    from posetraj_torch.tools.fill import fill_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"a": torch.empty(3, 5, device="meta"), "b": {"c": torch.empty(7, device="meta")}}
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        fill_params(tree, torch.float32)
    got = fill_params(tree, torch.float32, device="cpu")
    assert got["a"].device.type == "cpu" and got["b"]["c"].shape == (7,)
    assert fill_params({"x": torch.zeros(2, 2)}, torch.bfloat16)["x"].device.type == "cpu"


def test_params_from_diffusers_onto_a_meta_template():
    """The converter's load onto a `meta` template (no value read) gives
    what a load onto materialised parameters gives, bit for bit, in their
    dtypes and memory formats."""
    from posetraj_torch.core.params import leaves
    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.pipeline.svd_controlnet import init_params
    from posetraj_torch.tools.convert_weights import params_from_diffusers, params_to_diffusers

    bundle = ModelBundle.tiny("temp")
    real = init_params(bundle, seed=3, device="cpu", compute_dtype=torch.bfloat16)
    meta = init_params(bundle, device="meta", compute_dtype=torch.bfloat16)
    for name in real:
        back = params_from_diffusers(params_to_diffusers(real[name], name), meta[name], name, device="cpu")
        pairs = list(zip(leaves(back), leaves(real[name])))
        assert len(pairs) == len(list(leaves(real[name])))
        for a, b in pairs:
            assert a.dtype == b.dtype and a.stride() == b.stride() and torch.equal(a, b)


def test_stage_timer_and_trace_on_the_cpu(tmp_path):
    import time

    from posetraj_torch.utils import StageTimer, trace

    timer = StageTimer("cpu")
    for _ in range(2):
        with timer.stage("a"):
            time.sleep(0.01)
    with timer.stage("b", outputs=torch.ones(2)) as box:
        box["outputs"] = torch.zeros(1)
    d = timer.as_dict()
    assert set(d) == {"a", "b"} and d["a"] >= 0.02 and d["b"] >= 0.0 and timer.counts["a"] == 2
    assert timer.report().splitlines()[0].startswith("a: total ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StageTimer()
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        assert json.load(f)["traceEvents"]


def test_bench_train_step_on_the_cpu():
    from posetraj_torch.tools.bench_train import bench_train_step

    out = bench_train_step(height=64, width=64, frames=2, iters=1, tiny=True, verbose=False, device="cpu")
    assert set(out) == {"train_step_sec", "train_temp_gb", "train_arg_gb", "train_loss", "train_config",
                        "train_optimizer_step_sec", "train_step_eager_sec", "capture_sec", "device"}
    assert np.isfinite(out["train_loss"]) and out["train_step_sec"] > 0 and out["train_arg_gb"] > 0
    assert out["device"] == "cpu" and out["capture_sec"] == 0.0


def test_record_instances_on_the_tiny_bundle():
    """Every recorded key belongs to a TARGET, and there are as many keys as
    distinct (wrapper, arguments) a plain counting patch sees in the same
    run; the CPU replay (plain against plain) passes every one."""
    from unittest import mock

    from posetraj_torch.pipeline import ModelBundle
    from posetraj_torch.tools import kernel_sweep as ks

    bundle = ModelBundle.tiny()
    rec = ks.record_instances(resolutions=((H, W),), frames=F, bundle=bundle, device="cpu")
    names = {ks._short(m, a) for m, a in ks.TARGETS}
    assert rec and all(inst.name in names and k.startswith(inst.name + "(") for k, inst in rec.items())

    seen = set()
    patches = []
    for mod_name, attr in ks.TARGETS:
        mod = __import__(mod_name, fromlist=[attr])
        orig = getattr(mod, attr)

        def counting(*a, _orig=orig, _name=f"{mod_name}.{attr}", **k):
            desc = lambda v: (tuple(v.shape), v.stride(), v.dtype) if isinstance(v, torch.Tensor) else repr(v)
            seen.add((_name, tuple(desc(v) for v in a), tuple(sorted((n, desc(v)) for n, v in k.items()))))
            return _orig(*a, **k)

        patches.append(mock.patch.object(mod, attr, counting))
    for p in patches:
        p.start()
    try:
        ks._generate_once(bundle, rec_params(bundle), H, W, F, torch.device("cpu"), torch.float32)
    finally:
        for p in patches:
            p.stop()
    assert len(seen) == len(rec)
    result = ks.replay_records(rec, torch.device("cpu"), verbose=False)
    assert [o.status for _, o in result.instances] == ["OK"] * len(rec)
    assert sum(result.counts().values()) == len(rec)


def rec_params(bundle):
    from posetraj_torch.pipeline.svd_controlnet import init_params

    return init_params(bundle, seed=0, device="cpu")


def test_sweep_cached_shed_and_failed(tmp_path, monkeypatch):
    from posetraj_torch.tools import kernel_sweep as ks

    spec = ks.TensorSpec((4, 8), (8, 1), 0, torch.float32)
    insts = {i.key(): i for i in (ks.Instance("layernorm.layer_norm", (spec, spec, spec, 1e-5 * n), {})
                                  for n in (1, 2, 3))}
    calls = []
    status = {"value": "OK"}
    monkeypatch.setattr(ks, "SWEEP_CACHE_PATH", str(tmp_path / "build" / "ok.json"))
    monkeypatch.setattr(ks, "record_instances", lambda *a, **k: dict(insts))
    monkeypatch.setattr(ks, "replay", lambda inst, fn, gen, device: calls.append(inst.key()) or ks.Outcome(
        status["value"], 0.0, 1.0, 1e-2, 0.0))

    run = lambda **k: [o.status for _, o in ks.run_sweep(device="cpu", verbose=False, **k).instances]
    # On the CPU every wrapper is its plain version: the cache is neither
    # read nor written, so a CPU sweep cannot mark a card's instance passed.
    assert run() == ["OK"] * 3 and run() == ["OK"] * 3 and len(calls) == 6
    assert not os.path.exists(ks.SWEEP_CACHE_PATH)
    # A card's key (stood in for here): cached once passed, per card.
    card = {"key": "hash/NVIDIA H100 80GB HBM3/sm_90"}
    monkeypatch.setattr(ks, "cache_key", lambda device: card["key"])
    assert run() == ["OK"] * 3 and len(calls) == 9
    assert run() == ["CACHED"] * 3 and len(calls) == 9
    card["key"] = "hash/another card/sm_80"
    assert run() == ["OK"] * 3 and len(calls) == 12
    assert run(cache=False, deadline_s=-1.0) == ["SHED"] * 3 and len(calls) == 12
    card["key"] = "another"
    status["value"] = "FAIL"
    with pytest.raises(RuntimeError, match="3 kernel instance"):
        run()
    assert len(calls) == 15
    with open(ks.SWEEP_CACHE_PATH) as f:
        assert json.load(f)["key"] != "another"  # nothing that failed is cached


def test_sweep_cache_key_names_the_card(monkeypatch):
    """cache_key: None off the card; on one, the code hash with the card's
    name and compute capability, so another card or another build of the
    kernels finds no entry of its own."""
    from posetraj_torch.tools import kernel_sweep as ks

    assert ks.cache_key(torch.device("cpu")) is None
    card = {"name": "NVIDIA H100 80GB HBM3", "cap": (9, 0)}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: card["name"])
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: card["cap"])
    h100 = ks.cache_key(torch.device("cuda"))
    assert h100 == f"{ks.code_hash()}/NVIDIA H100 80GB HBM3/sm_90"
    card.update(name="NVIDIA A100-SXM4-80GB", cap=(8, 0))
    assert ks.cache_key(torch.device("cuda")) not in (h100, None)
    monkeypatch.setattr(ks, "code_hash", lambda: "edited")
    assert ks.cache_key(torch.device("cuda")).startswith("edited/")
