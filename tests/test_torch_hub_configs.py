"""The port's tools/hub_configs.py against the JAX package's, on the CPU:
EXPECTED, the configs built from config.json dicts (the recorded ones, the
tiny dicts of tests/test_parity_gate.py, an empty one; the ControlNet's
through parity_gate.controlnet_config_from_json) and the divergence strings
of verify_against_expected, all equal. No JAX compile.
"""

import dataclasses
import json
import os

import pytest

F = 2
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

def test_expected_matches_jax():
    from posetraj_tpu.tools import hub_configs as jhc
    from posetraj_torch.tools import hub_configs as hc

    assert hc.EXPECTED == jhc.EXPECTED


@pytest.mark.parametrize("kind,cfg", [
    ("unet", "expected"), ("vae", "expected"), ("clip", "expected"), ("scheduler", "expected"),
    ("unet", UNET_CFG), ("vae", VAE_CFG), ("vae", TINY_VAE_CFG), ("clip", TINY_CLIP_CFG), ("scheduler", SCHED_CFG),
    ("unet", {}), ("controlnet", "expected"), ("controlnet", CN_CFG),
])
def test_config_from_json_matches_jax(kind, cfg):
    from posetraj_tpu.tools import hub_configs as jhc, parity_gate as jpg
    from posetraj_torch.tools import hub_configs as hc, parity_gate as pg

    sub = {"clip": "image_encoder"}.get(kind, kind)
    if cfg == "expected":
        cfg = hc.EXPECTED["unet"] if kind == "controlnet" else hc.EXPECTED[sub]
    if kind == "controlnet":
        got = pg.controlnet_config_from_json(cfg, hc.unet_config_from_json(cfg))
        want = jpg.controlnet_config_from_json(cfg, jhc.unet_config_from_json(cfg))
    else:
        got = getattr(hc, f"{kind}_config_from_json")(cfg)
        want = getattr(jhc, f"{kind}_config_from_json")(cfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _write_expected(root, hc):
    names = {"feature_extractor": "preprocessor_config.json", "scheduler": "scheduler_config.json"}
    for sub, cfg in hc.EXPECTED.items():
        os.makedirs(root / sub, exist_ok=True)
        (root / sub / names.get(sub, "config.json")).write_text(json.dumps(cfg))


def test_verify_against_expected_strings_match_jax(tmp_path):
    from posetraj_tpu.tools import hub_configs as jhc
    from posetraj_torch.tools import hub_configs as hc

    _write_expected(tmp_path, hc)
    assert hc.verify_against_expected(str(tmp_path)) == [] == jhc.verify_against_expected(str(tmp_path))
    unet = dict(hc.EXPECTED["unet"], num_attention_heads=[5, 10, 10, 20])
    (tmp_path / "unet" / "config.json").write_text(json.dumps(unet))
    os.remove(tmp_path / "vae" / "config.json")
    got = hc.verify_against_expected(str(tmp_path))
    assert got == jhc.verify_against_expected(str(tmp_path))
    assert got == [f"unet.num_attention_heads: checkpoint={[5, 10, 10, 20]!r} recorded={[5, 10, 20, 20]!r}",
                   f"vae: config.json not found under {tmp_path}"]
