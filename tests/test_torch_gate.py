"""The port's tools/parity_gate.py against the JAX package's, on the CPU in
float32: the gate's inputs bit for bit; run_ours against the JAX run_ours on
one fake checkpoint, written from the JAX package's tiny parameters with its
own converter (convert_to_torch, torch.save to diffusion_pytorch_model.bin,
hand-written config.json files), 64x64, 2 frames, 2 steps, within 3e-3 of
the latents' max: the tolerance tests/test_torch_pipeline.py holds the
2-step generate() to (float32 cancellation at sigma_max = 700); the gate's
exit codes with and without --allow-config-divergence; its reference branch
where a reference checkout is given. The JAX run_ours is this file's one JAX
compile.
"""

import json
import os

import numpy as np
import pytest
import torch

H = W = 64
F = 2
STEPS = 2

# The tiny config.json dicts of tests/test_parity_gate.py (UNET_CFG, VAE_CFG,
# SCHED_CFG and its ControlNet config), copied.
UNET_CFG = {
    "in_channels": 8, "out_channels": 4, "block_out_channels": [32, 64, 64, 64], "num_attention_heads": [2, 4, 4, 4],
    "cross_attention_dim": 16, "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 24,
    "num_frames": F, "layers_per_block": 2, "transformer_layers_per_block": 1, "sample_size": 8,
    "down_block_types": ["CrossAttnDownBlockSpatioTemporal", "CrossAttnDownBlockSpatioTemporal",
                         "CrossAttnDownBlockSpatioTemporal", "DownBlockSpatioTemporal"],
    "up_block_types": ["UpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal", "CrossAttnUpBlockSpatioTemporal",
                       "CrossAttnUpBlockSpatioTemporal"],
}
VAE_CFG = {"in_channels": 3, "out_channels": 3, "latent_channels": 4, "block_out_channels": [32, 32, 32, 32],
           "layers_per_block": 1, "scaling_factor": 0.18215, "force_upcast": True}
SCHED_CFG = {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012, "beta_schedule": "scaled_linear",
             "prediction_type": "v_prediction", "timestep_type": "continuous", "timestep_spacing": "leading",
             "interpolation_type": "linear", "use_karras_sigmas": True, "sigma_min": 0.002, "sigma_max": 700.0,
             "steps_offset": 1, "trained_betas": None}
CN_CFG = {**{k: v for k, v in UNET_CFG.items() if k != "up_block_types"}, "conditioning_channels": 3,
          "conditioning_embedding_out_channels": [4, 8, 8, 16]}
# ModelBundle.tiny()'s VAE and CLIP, as config.json dicts (the fake
# checkpoint's).
TINY_VAE_CFG = {**VAE_CFG, "block_out_channels": [8, 16, 16, 16]}
TINY_CLIP_CFG = {"image_size": 28, "patch_size": 14, "hidden_size": 32, "num_hidden_layers": 2,
                 "num_attention_heads": 2, "intermediate_size": 64, "projection_dim": 16, "layer_norm_eps": 1e-5,
                 "hidden_act": "gelu", "model_type": "clip_vision_model"}
# The reference repository, for the gate's reference branch; that test skips
# without it, as tests/test_parity_gate.py does.
REFERENCE_REPO = os.environ.get("POSETRAJ_REFERENCE_REPO", "")
STUB_DIR = os.path.join(os.path.dirname(__file__), "ref_oracle")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_make_gate_inputs_bitwise_jax():
    from posetraj_tpu.tools.parity_gate import make_gate_inputs as jinputs
    from posetraj_torch.tools.parity_gate import make_gate_inputs

    got, want = make_gate_inputs(48, 80, 3, 7), jinputs(48, 80, 3, 7)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


@pytest.fixture(scope="module")
def fake_checkpoint(tmp_path_factory):
    """A diffusers-layout checkpoint of the JAX package's tiny parameters
    (zero convs randomised so the control video reaches the latents):
    weights through the JAX converter's convert_to_torch into
    diffusion_pytorch_model.bin, hand-written config.json files."""
    import jax

    from posetraj_tpu.models import clip as jc, controlnet as jcn, unet as ju, vae as jv
    from posetraj_tpu.pipeline.svd_controlnet import ModelBundle
    from posetraj_tpu.tools.convert_weights import convert_to_torch

    bundle = ModelBundle.tiny()
    key = jax.random.PRNGKey(0)
    params = {"unet": ju.init_unet(key, bundle.unet), "controlnet": jcn.init_controlnet(jax.random.PRNGKey(1),
                                                                                       bundle.controlnet),
              "vae": jv.init_vae(key, bundle.vae), "clip": jc.init_clip_vision(key, bundle.clip)}
    rng = np.random.RandomState(40)
    cp = params["controlnet"]
    for zc in cp["controlnet_down_blocks"] + [cp["controlnet_mid_block"],
                                              cp["controlnet_cond_embedding"]["stack"]["conv_out"]]:
        zc["kernel"] = rng.randn(*zc["kernel"].shape).astype(np.float32) * 0.05
    root = tmp_path_factory.mktemp("ckpt")
    subs = {"unet": ("unet", UNET_CFG), "controlnet": ("controlnet", CN_CFG), "vae": ("vae", TINY_VAE_CFG),
            "clip": ("image_encoder", TINY_CLIP_CFG)}
    for model, (sub, cfg) in subs.items():
        os.makedirs(root / sub)
        (root / sub / "config.json").write_text(json.dumps(cfg))
        sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in convert_to_torch(params[model], model).items()}
        torch.save(sd, root / sub / "diffusion_pytorch_model.bin")
    os.makedirs(root / "scheduler")
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(SCHED_CFG))
    return str(root)


@pytest.fixture(scope="module")
def port_latents(fake_checkpoint):
    from posetraj_torch.tools.parity_gate import run_ours

    return run_ours(fake_checkpoint, None, H, W, F, STEPS, seed=0, device="cpu")


def test_run_ours_matches_jax(fake_checkpoint, port_latents):
    from posetraj_tpu.tools.parity_gate import run_ours as jrun_ours

    want = np.asarray(jrun_ours(fake_checkpoint, None, H, W, F, STEPS, seed=0))
    assert port_latents.shape == want.shape == (1, F, H // 8, W // 8, 4)
    assert np.isfinite(port_latents).all()
    err = float(np.abs(port_latents - want).max())
    assert err <= 3e-3 * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def test_gate_exit_codes(fake_checkpoint, port_latents, tmp_path, capsys):
    """The tiny configs diverge from the recorded SVD constants: exit 1
    without --allow-config-divergence, before any model runs; with it, 0,
    and the saved latents are run_ours's. No reference repository is
    given, so that branch reports itself unavailable."""
    from posetraj_torch.tools import parity_gate

    common = [fake_checkpoint, "--height", str(H), "--width", str(W), "--frames", str(F), "--steps", str(STEPS),
              "--device", "cpu"]
    assert parity_gate.main(common + ["--skip-reference"]) == 1
    assert "FAIL: config.json diverges" in capsys.readouterr().out
    out = tmp_path / "lat.npz"
    rc = parity_gate.main(common + ["--allow-config-divergence", "--reference-repo", "", "--out", str(out)])
    assert rc == 0
    assert "reference branch unavailable" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(out)["ours"], port_latents)


def test_gate_reference_branch(fake_checkpoint):
    """The whole gate against the reference pipeline run on the diffusers
    stand-in (tests/ref_oracle) at float32: exit 0 within 2e-2, the JAX
    gate test's tolerance. Skips without a reference checkout, as
    tests/test_parity_gate.py does."""
    import sys

    if not os.path.isdir(os.path.join(REFERENCE_REPO, "models")):
        pytest.skip("reference checkout not available (POSETRAJ_REFERENCE_REPO)")

    from posetraj_torch.tools import parity_gate

    sys.path.insert(0, STUB_DIR)
    try:
        rc = parity_gate.main([fake_checkpoint, "--height", str(H), "--width", str(W), "--frames", str(F), "--steps",
                               str(STEPS), "--tolerance", "2e-2", "--allow-config-divergence", "--reference-repo",
                               REFERENCE_REPO, "--device", "cpu"])
    finally:
        sys.path.remove(STUB_DIR)
    assert rc == 0
