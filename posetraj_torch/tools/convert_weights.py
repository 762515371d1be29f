"""PyTorch/diffusers checkpoint <-> parameter-tree weight converter (port of
posetraj_tpu/tools/convert_weights.py).

The reference loads frozen SVD weights with diffusers `from_pretrained`
(train_svd_traj_blender_14.py:866-898) and serializes trained ControlNets in
diffusers format (custom save hooks, :940-973; inference loads with
`from_pretrained(..., subfolder="controlnet")`,
run_inference_vipseg_json_repro.py:335). This module maps those state_dicts
onto the JAX package's channels-last trees (and back, for interop):

  torch Conv2d  (O, I, kh, kw)    <-> kernel (kh, kw, I, O)
  torch Conv3d  (O, I, kf, 1, 1)  <-> kernel (kf, 1, 1, I, O)
  torch Linear  (out, in)         <-> kernel (in, out)
  norm weight/bias                <-> scale/bias

Name translation is rule-based from our flattened names; `convert_to_jax`
verifies every target leaf is covered and every shape matches, so a wrong
architecture fails loudly rather than silently mis-loading.

The port's own parameters (core/init.py's layouts, the fused `wqkv`) are
already in torch layout. `jax_named_leaves` walks them in the order and
under the flat names of their JAX-package tree (core/bridge.params_to_jax),
without moving a value: `params_to_diffusers` maps each leaf straight to its
diffusers name (one device-side cast and one copy to the host a leaf), and
`params_from_diffusers` converts onto a template of that tree's shapes
(`jax_template`), so `like` may live on the `meta` device.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np

import torch

from posetraj_torch.core.bridge import params_from_jax
from posetraj_torch.core.params import cast_like, flatten_dict, leaves, unflatten_dict

Array = np.ndarray


# ---------------------------------------------------------------------------
# Name translation: our flat name -> torch state_dict name
# ---------------------------------------------------------------------------

_COMMON_RULES = [
    # attention out proj is wrapped in ModuleList([Linear, Dropout]) in diffusers
    (re.compile(r"\.to_out\."), ".to_out.0."),
    # GEGLU FeedForward: net.0 = GEGLU(proj), net.1 = Dropout, net.2 = Linear
    (re.compile(r"\.ff\.proj_in\."), ".ff.net.0.proj."),
    (re.compile(r"\.ff\.proj_out\."), ".ff.net.2."),
    (re.compile(r"\.ff_in\.proj_in\."), ".ff_in.net.0.proj."),
    (re.compile(r"\.ff_in\.proj_out\."), ".ff_in.net.2."),
    # our single downsampler/upsampler conv vs diffusers ModuleList wrapper
    (re.compile(r"\.downsampler\."), ".downsamplers.0.conv."),
    (re.compile(r"\.upsampler\."), ".upsamplers.0.conv."),
    # transformer block lists
    (re.compile(r"\.temporal_blocks\.(\d+)\."), r".temporal_transformer_blocks.\1."),
    (re.compile(r"(attentions\.\d+)\.blocks\.(\d+)\."), r"\1.transformer_blocks.\2."),
]

_UNET_RULES = _COMMON_RULES

_CONTROLNET_RULES = _COMMON_RULES + [
    # hint-encoder branches: our nested "stack"/"stack_2" vs flat reference names
    (re.compile(r"controlnet_cond_embedding\.stack_2\.conv_in\."), "controlnet_cond_embedding.conv_in_2."),
    (re.compile(r"controlnet_cond_embedding\.stack_2\.blocks\."), "controlnet_cond_embedding.blocks_2."),
    (re.compile(r"controlnet_cond_embedding\.stack_2\.conv_out\."), "controlnet_cond_embedding.conv_out_2."),
    (re.compile(r"controlnet_cond_embedding\.stack\."), "controlnet_cond_embedding."),
    (re.compile(r"controlnet_cond_embedding\.rot_embed\.embedding"), "controlnet_cond_embedding.rot_embed.weight"),
    # entity variant: zero convs named conv_in_2/conv_out_2 in the reference
    (re.compile(r"controlnet_cond_embedding\.entity_in\."), "controlnet_cond_embedding.conv_in_2."),
    (re.compile(r"controlnet_cond_embedding\.entity_out\."), "controlnet_cond_embedding.conv_out_2."),
    # temp variant: our nested "temp" group vs flat reference names
    (re.compile(r"controlnet_cond_embedding\.temp\.blocks\.(\d+)\."), r"controlnet_cond_embedding.transformer_blocks.\1."),
    (re.compile(r"controlnet_cond_embedding\.temp\."), "controlnet_cond_embedding."),
]

_VAE_RULES = _COMMON_RULES + [
    # our params nest quant_conv under encoder; diffusers keeps it top-level
    (re.compile(r"^encoder\.quant_conv\."), "quant_conv."),
    (re.compile(r"\.mid_block\.attention\."), ".mid_block.attentions.0."),
]

_CLIP_RULES = [
    (re.compile(r"^class_embedding$"), "vision_model.embeddings.class_embedding"),
    (re.compile(r"^patch_embedding\."), "vision_model.embeddings.patch_embedding."),
    (re.compile(r"^position_embedding$"), "vision_model.embeddings.position_embedding.weight"),
    # HF ships the historical typo "pre_layrnorm"
    (re.compile(r"^pre_layernorm\."), "vision_model.pre_layrnorm."),
    (re.compile(r"^post_layernorm\."), "vision_model.post_layernorm."),
    (re.compile(r"^layers\.(\d+)\.(q_proj|k_proj|v_proj|out_proj)\."), r"vision_model.encoder.layers.\1.self_attn.\2."),
    (re.compile(r"^layers\.(\d+)\.(fc1|fc2)\."), r"vision_model.encoder.layers.\1.mlp.\2."),
    (re.compile(r"^layers\.(\d+)\."), r"vision_model.encoder.layers.\1."),
]

RULES: Dict[str, list] = {
    "unet": _UNET_RULES,
    "controlnet": _CONTROLNET_RULES,
    "vae": _VAE_RULES,
    "clip": _CLIP_RULES,
}


def _leaf_suffix(name: str, torch_name: str) -> str:
    """Map our leaf key (kernel/scale/bias/...) to torch's (weight/bias)."""
    if name.endswith(".kernel"):
        return torch_name[: -len(".kernel")] + ".weight"
    if name.endswith(".scale"):
        return torch_name[: -len(".scale")] + ".weight"
    if name.endswith(".embedding"):
        return torch_name[: -len(".embedding")] + ".weight"
    return torch_name


def our_name_to_torch(name: str, model: str) -> str:
    torch_name = name
    for pat, rep in RULES[model]:
        torch_name = pat.sub(rep, torch_name)
    if model == "clip":
        # CLIP leaf mapping happens after the structural rules and the
        # class/position embeddings already end in their torch names.
        if torch_name.endswith((".kernel", ".scale")):
            torch_name = _leaf_suffix(name, torch_name)
        return torch_name
    return _leaf_suffix(name, torch_name)


def _to_jax_layout(name: str, t: Array) -> Array:
    if name.endswith(".kernel"):
        if t.ndim == 4:  # conv2d OIHW -> HWIO
            return np.transpose(t, (2, 3, 1, 0))
        if t.ndim == 5:  # conv3d OIDHW -> DHWIO
            return np.transpose(t, (2, 3, 4, 1, 0))
        if t.ndim == 2:  # linear (out,in) -> (in,out)
            return np.transpose(t)
    return t


def _to_torch_layout(name: str, t: Array) -> Array:
    if name.endswith(".kernel"):
        if t.ndim == 4:
            return np.transpose(t, (3, 2, 0, 1))
        if t.ndim == 5:
            return np.transpose(t, (4, 3, 0, 1, 2))
        if t.ndim == 2:
            return np.transpose(t)
    return t


def convert_to_jax(
    state_dict: Dict[str, Array],
    params_template,
    model: str,
    strict: bool = True,
    dtype=None,
) -> Dict:
    """torch state_dict (numpy arrays) -> pytree shaped like params_template.

    Every template leaf must be found with a matching shape (strict), so
    architecture drift fails loudly. Extra torch keys are reported via the
    returned tree's side channel only in non-strict mode.
    """
    flat = flatten_dict(params_template)
    out = {}
    missing = []
    for name, leaf in flat.items():
        tname = our_name_to_torch(name, model)
        if tname not in state_dict:
            missing.append((name, tname))
            continue
        t = _to_jax_layout(name, np.asarray(state_dict[tname]))
        t = t.reshape(np.shape(leaf)) if t.shape != tuple(leaf.shape) and t.size == leaf.size else t
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name} <- {tname}: {t.shape} vs {tuple(leaf.shape)}")
        out[name] = t.astype(dtype or leaf.dtype)
    if missing and strict:
        preview = "\n".join(f"  {a} <- {b}" for a, b in missing[:20])
        raise KeyError(f"{len(missing)} params not found in state_dict, e.g.:\n{preview}")
    for name, _ in missing:
        out[name] = np.asarray(flat[name])
    return unflatten_dict(out)


def convert_to_torch(params, model: str) -> Dict[str, Array]:
    """Our pytree -> diffusers-layout state_dict (for checkpoint interop).
    Every array is C-contiguous: safetensors' save_file writes an array's
    memory as it lies, so a transposed view would be stored scrambled."""
    out = {}
    for name, leaf in flatten_dict(params).items():
        out[our_name_to_torch(name, model)] = np.ascontiguousarray(_to_torch_layout(name, np.asarray(leaf)))
    return out


def load_torch_file(path: str) -> Dict[str, Array]:
    """Load a .safetensors or torch .bin/.pt file into numpy arrays."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy() for k, v in sd.items()}


def load_diffusers_model_dir(path: str) -> Dict[str, Array]:
    """Load all weight shards in a diffusers model directory."""
    import glob
    import os

    files = sorted(
        glob.glob(os.path.join(path, "*.safetensors")) + glob.glob(os.path.join(path, "*.bin"))
    )
    if not files:
        raise FileNotFoundError(f"no weight files under {path}")
    sd: Dict[str, Array] = {}
    for f in files:
        sd.update(load_torch_file(f))
    return sd


def _jax_shape(name: str, t: torch.Tensor) -> tuple:
    """The JAX-package shape of a port leaf named `name` (a JAX flat name)."""
    shape = tuple(t.shape)
    if name.endswith(".kernel"):
        if len(shape) == 2:
            return shape[::-1]
        if len(shape) == 4:  # OIHW -> HWIO
            return (shape[2], shape[3], shape[1], shape[0])
        if len(shape) == 5:  # OIDHW -> DHWIO
            return (*shape[2:], shape[1], shape[0])
    return shape


def jax_named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(JAX flat name, port tensor in torch layout) of every leaf of the
    port's parameters, in the order of flatten_dict(params_to_jax(tree)):
    `wqkv` as its to_q / to_k / to_v rows, a layer's `weight` as `kernel`, a
    norm's (1-D) `weight` as `scale`."""
    join = lambda k: f"{prefix}.{k}" if prefix else str(k)
    if isinstance(tree, dict):
        if "wqkv" in tree:
            for name, w in zip(("to_q", "to_k", "to_v"), tree["wqkv"].chunk(3, dim=0)):
                yield join(f"{name}.kernel"), w
            yield from jax_named_leaves(tree["to_out"], join("to_out"))
        elif "weight" in tree:
            yield join("scale" if tree["weight"].ndim == 1 else "kernel"), tree["weight"]
            if "bias" in tree:
                yield join("bias"), tree["bias"]
        else:
            for k, v in tree.items():
                yield from jax_named_leaves(v, join(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from jax_named_leaves(v, join(i))
    else:
        yield prefix, tree


def jax_template(like) -> Dict:
    """The JAX-package tree of `like` (params_to_jax's structure and
    shapes) with zero-stride float32 zeros for leaves: a template for
    convert_to_jax that reads no value of `like`."""
    return unflatten_dict({name: np.broadcast_to(np.float32(0), _jax_shape(name, t))
                           for name, t in jax_named_leaves(like)})


def _host_float32(t: torch.Tensor) -> Array:
    """A float32, C-contiguous host copy of `t` (cast and laid out on t's
    device, then copied once)."""
    h = t.detach().to(dtype=torch.float32, memory_format=torch.contiguous_format, copy=True)
    return (h.cpu() if h.device.type != "cpu" else h).numpy()


def params_from_diffusers(state_dict: Dict[str, Array], like, model: str, device=None, dtype=None):
    """A diffusers-layout state_dict -> the port's parameters shaped like
    `like` (a tree of the same model, e.g. from core/init.py, on any device,
    `meta` included), every name and shape checked (convert_to_jax,
    strict). On `device` (default: like's; required for a `meta` like) in
    `dtype`; dtype None keeps each leaf's dtype in `like` (the VAE keeps its
    float32 encoder)."""
    first = next(leaves(like))
    device = first.device if device is None else device
    tree = convert_to_jax(state_dict, jax_template(like), model)
    out = params_from_jax(tree, device=device, dtype=dtype or torch.float32)
    return out if dtype is not None else cast_like(out, like)


def params_to_diffusers(params, model: str) -> Dict[str, Array]:
    """The port's parameters -> a diffusers-layout state_dict of float32,
    C-contiguous numpy arrays (what export_diffusers writes), leaf by leaf
    from the torch layout the port keeps: bitwise
    convert_to_torch(params_to_jax(params), model), without its two host
    transposes a leaf."""
    return {our_name_to_torch(name, model): _host_float32(t) for name, t in jax_named_leaves(params)}
