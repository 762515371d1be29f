"""The port's weight converter against the JAX package, on the CPU with the
tiny configs (no JAX compile: the JAX inits are numpy draws).

* params_to_jax(params_from_jax(t)) == t, bitwise, for UNet, VAE, CLIP
  and the ControlNet in every hint variant.
* params_to_diffusers against the JAX convert_to_torch of the same tree:
  the same keys, bitwise values; params_from_diffusers of that state dict
  back to the port's parameters, bitwise, in the dtypes of `like`.
* export_diffusers: the .safetensors file reads back as the JAX
  convert_to_torch state dict, bitwise; without safetensors, the .npz is
  the JAX export_diffusers' .npz. (The JAX package's .safetensors export
  is not the reference here: it hands save_file the transposed views of
  convert_to_torch, and save_file writes an array's memory as it lies, so
  every transposed weight is stored scrambled. The port's converter returns
  contiguous arrays.)
"""

import sys

import jax
import numpy as np
import pytest
import torch

VARIANTS = ("base", "bbox", "cam", "rot", "entity", "temp")


def _jax_tree(model, variant="base"):
    from posetraj_tpu import configs as jc
    from posetraj_tpu.models import clip as jcl, controlnet as jcn, unet as ju, vae as jv

    key = jax.random.PRNGKey(7)
    if model == "unet":
        return ju.init_unet(key, jc.UNetConfig.tiny())
    if model == "vae":
        return jv.init_vae(key, jc.VAEConfig.tiny())
    if model == "clip":
        return jcl.init_clip_vision(key, jc.CLIPVisionConfig.tiny())
    return jcn.init_controlnet(key, jc.ControlNetConfig.tiny(variant))


CASES = [("unet", "base"), ("vae", "base"), ("clip", "base")] + [("controlnet", v) for v in VARIANTS]


def _flat_equal(a, b):
    from posetraj_tpu.core.params import flatten_dict

    fa, fb = flatten_dict(a), flatten_dict(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.mark.parametrize("model,variant", CASES, ids=[f"{m}-{v}" for m, v in CASES])
def test_params_to_jax_inverts_params_from_jax(model, variant):
    from posetraj_torch.core.bridge import params_from_jax, params_to_jax

    from posetraj_tpu.core.params import flatten_dict

    tree = jax.tree_util.tree_map(np.asarray, _jax_tree(model, variant))
    _flat_equal(params_to_jax(params_from_jax(tree)), tree)
    # bf16 parameters come back as their float32 values (norms stay float32)
    bf = flatten_dict(params_to_jax(params_from_jax(tree, dtype=torch.bfloat16)))
    for k, a in flatten_dict(tree).items():
        rounded = torch.from_numpy(np.array(a)).bfloat16().float().numpy()
        assert bf[k].dtype == np.float32 and (np.array_equal(bf[k], rounded) or np.array_equal(bf[k], a)), k


@pytest.mark.parametrize("model,variant", CASES, ids=[f"{m}-{v}" for m, v in CASES])
def test_diffusers_state_dict_matches_jax_converter(model, variant):
    from posetraj_tpu.tools.convert_weights import convert_to_torch
    from posetraj_torch.core.bridge import params_from_jax, params_to_jax
    from posetraj_torch.core.params import leaves
    from posetraj_torch.tools.convert_weights import params_from_diffusers, params_to_diffusers

    tree = jax.tree_util.tree_map(np.asarray, _jax_tree(model, variant))
    params = params_from_jax(tree)
    sd = params_to_diffusers(params, model)
    want = convert_to_torch(tree, model)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == want[k].dtype and np.array_equal(sd[k], want[k]), k
    # back: a `like` in bf16 with float32 norms, as core/init.py makes them
    like = params_from_jax(tree, dtype=torch.bfloat16)
    back = params_from_diffusers(want, like, model)
    for got, ref, dst in zip(leaves(back), leaves(params), leaves(like)):
        assert got.dtype == dst.dtype and got.shape == ref.shape
        assert torch.equal(got, ref.to(dst.dtype))
    back32 = params_from_diffusers(want, like, model, dtype=torch.float32)
    _flat_equal(params_to_jax(back32), tree)
    with pytest.raises(KeyError):
        params_from_diffusers({k: v for k, v in list(want.items())[1:]}, like, model)


@pytest.mark.parametrize("safetensors", [True, False], ids=["safetensors", "npz"])
def test_export_diffusers_matches_jax(tmp_path, monkeypatch, safetensors):
    from posetraj_tpu.tools.convert_weights import convert_to_torch
    from posetraj_tpu.train.checkpoints import export_diffusers as jexport
    from posetraj_torch.core.bridge import params_from_jax
    from posetraj_torch.train.checkpoints import export_diffusers

    if not safetensors:
        monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    tree = jax.tree_util.tree_map(np.asarray, _jax_tree("controlnet", "cam"))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = export_diffusers(params_from_jax(tree), "controlnet", str(tmp_path / "port" / "controlnet"))
    want = jexport(tree, "controlnet", str(tmp_path / "jax" / "controlnet"))
    suffix = ".safetensors" if safetensors else ".npz"
    assert got.endswith(suffix) and want.endswith(suffix)
    if safetensors:
        from safetensors.numpy import load_file

        a, b = load_file(got), convert_to_torch(tree, "controlnet")
    else:
        a, b = dict(np.load(got)), dict(np.load(want))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
