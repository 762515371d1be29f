"""Trajectory ControlNet: UNet-encoder copy + hint encoder + zero-conv
residual heads (controlnet_sdv.py of the reference), with the hint
encoder's variants as one config switch (HintEncoderConfig.variant): base,
bbox, cam, rot, entity, temp."""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch

from posetraj_torch.configs import ControlNetConfig, HintEncoderConfig
from posetraj_torch.core.init import Init
from posetraj_torch.models.blocks import down_block, init_down_block, init_mid_block, maybe_checkpoint, mid_block
from posetraj_torch.models.embeddings import init_timestep_embedding
from posetraj_torch.models.transformer import basic_transformer_block, init_basic_transformer_block
from posetraj_torch.models.unet import compute_embeddings
from posetraj_torch.ops.primitives import conv2d, group_norm, linear, silu
from posetraj_torch.parallel import spmd


def _init_conv_stack(ini: Init, cfg: HintEncoderConfig) -> dict:
    """conv_in + interleaved [3x3 conv, 3x3 stride-2 conv] + zero conv_out:
    downsamples H x W by 8 to the latent resolution."""
    boc = cfg.block_out_channels
    stack = {"conv_in": ini.conv(cfg.conditioning_channels, boc[0], 3, 3), "blocks": []}
    for i in range(len(boc) - 1):
        stack["blocks"].append(ini.conv(boc[i], boc[i], 3, 3))
        stack["blocks"].append(ini.conv(boc[i], boc[i + 1], 3, 3))
    stack["conv_out"] = ini.zero_conv(boc[-1], cfg.embedding_channels, 3, 3)
    return stack


def _conv_stack(p: dict, cond: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """(N, H, W, 3) -> (N, H/8, W/8, C_embed); SiLU after every conv except
    the zero conv_out."""
    h = silu(conv2d(p["conv_in"], cond, compute_dtype=compute_dtype))
    for i, block in enumerate(p["blocks"]):
        stride = 2 if i % 2 == 1 else 1
        h = silu(conv2d(block, h, stride=stride, padding=((1, 1), (1, 1)), compute_dtype=compute_dtype))
    return conv2d(p["conv_out"], h, compute_dtype=compute_dtype)


def init_hint_encoder(ini: Init, cfg: HintEncoderConfig) -> dict:
    p = {"stack": _init_conv_stack(ini, cfg)}
    c = cfg.embedding_channels
    if cfg.variant == "bbox":
        p["stack_2"] = _init_conv_stack(ini, cfg)
    elif cfg.variant == "cam":
        p["cc_projection"] = ini.identity_pad_linear(c + cfg.camera_dim, c)
    elif cfg.variant == "rot":
        p["rot_embed"] = ini.embedding(cfg.num_rot_classes, c)
    elif cfg.variant == "entity":
        p["entity_in"] = ini.zero_conv(c, c, 3, 3)
        p["entity_out"] = ini.zero_conv(c, c, 3, 3)
    elif cfg.variant == "temp":
        p["temp"] = {
            "norm": ini.norm(c),
            "proj_in": ini.linear(c, c),
            "blocks": [init_basic_transformer_block(ini, c, cfg.temp_num_heads, None)
                       for _ in range(cfg.temp_num_layers)],
            "proj_out": ini.linear(c, c),
        }
    elif cfg.variant != "base":
        raise ValueError(f"unknown hint variant {cfg.variant}")
    return p


def hint_encoder(params: dict, cfg: HintEncoderConfig, cond: torch.Tensor, num_frames: int,
                 bbox_cond: Optional[torch.Tensor] = None, camera_cond: Optional[torch.Tensor] = None,
                 rot_id: Optional[torch.Tensor] = None, entity_cond: Optional[torch.Tensor] = None,
                 fidelity_shared_conv_out: bool = False, compute_dtype=None) -> torch.Tensor:
    """cond (B, F, H, W, 3) control video -> (B*F, H/8, W/8, C_embed).

    Extra conditions per variant:
      bbox_cond   (B, F, H, W, 3) rendered 3D-bbox video
      camera_cond (B, F, camera_dim) per-frame extrinsics R|T; None = zeros
      rot_id      (B,) integer class in [0, num_rot_classes)
      entity_cond (1, H/8, W/8, C_embed) entity map, the same for every
                  sample and frame
    fidelity_shared_conv_out (bbox): the reference's wiring, which sends the
    second stack through the first stack's conv_out."""
    b, f, hh, ww, c = cond.shape
    emb = _conv_stack(params["stack"], cond.reshape(b * f, hh, ww, c), compute_dtype)
    if cfg.variant == "bbox":
        if bbox_cond is None:
            raise ValueError("bbox variant requires bbox_cond")
        stack2 = dict(params["stack_2"])
        if fidelity_shared_conv_out:
            stack2["conv_out"] = params["stack"]["conv_out"]
        emb = emb + _conv_stack(stack2, bbox_cond.reshape(b * f, hh, ww, c), compute_dtype)
    elif cfg.variant == "cam":
        if camera_cond is None:
            camera_cond = torch.zeros((b, f, cfg.camera_dim), dtype=emb.dtype, device=emb.device)
        cam = camera_cond.reshape(b * f, 1, 1, cfg.camera_dim).to(emb.dtype)
        cam = cam.expand(b * f, emb.shape[1], emb.shape[2], cfg.camera_dim)
        emb = linear(params["cc_projection"], torch.cat([emb, cam], dim=-1), compute_dtype)
    elif cfg.variant == "rot":
        if rot_id is None:
            raise ValueError("rot variant requires rot_id")
        rot = params["rot_embed"]["embedding"][rot_id].repeat_interleave(f, dim=0).to(emb.dtype)  # (B*F, C)
        emb = emb + rot[:, None, None, :]
    elif cfg.variant == "entity":
        if entity_cond is None:
            raise ValueError("entity variant requires entity_cond (B or 1, h_lat, w_lat, C_embed)")
        e = conv2d(params["entity_in"], entity_cond.to(emb.dtype), compute_dtype=compute_dtype)
        e = conv2d(params["entity_out"], e, compute_dtype=compute_dtype)
        emb = emb + e[:1]  # the first map, for every sample and frame
    elif cfg.variant == "temp":
        # A transformer over the frames of each pixel, with a residual around
        # it. The GroupNorm's statistics span a whole video, (F, H, W) and
        # the group's channels, as torch's GroupNorm on (B, C, F, H, W) (and
        # over every sp rank's W block under sharded serving).
        n, eh, ew, ec = emb.shape
        t = params["temp"]
        h = group_norm(t["norm"], emb.reshape(b, f, eh, ew, ec), eps=1e-6)
        h = h.reshape(b, f, eh * ew, ec).transpose(1, 2).reshape(b * eh * ew, f, ec)
        h = linear(t["proj_in"], h, compute_dtype)
        # The token axis here is frames (the pixels sit in the batch): under
        # sharded serving no op may treat it as a W block.
        with spmd.local_tokens():
            for blk in t["blocks"]:
                h = basic_transformer_block(blk, h, cfg.temp_num_heads, backend="xla", compute_dtype=compute_dtype)
        h = linear(t["proj_out"], h, compute_dtype)
        emb = emb + h.reshape(b, eh * ew, f, ec).transpose(1, 2).reshape(n, eh, ew, ec)
    elif cfg.variant != "base":
        raise ValueError(f"unknown hint variant {cfg.variant}")
    return emb


def init_controlnet(ini: Init, cfg: ControlNetConfig) -> dict:
    u = cfg.unet
    n = u.num_levels
    boc = u.block_out_channels
    p: dict = {
        "conv_in": ini.conv(u.in_channels, boc[0], 3, 3),
        "time_embedding": init_timestep_embedding(ini, boc[0], u.time_embed_dim),
        "add_embedding": init_timestep_embedding(ini, u.projection_class_embeddings_input_dim, u.time_embed_dim),
        "controlnet_cond_embedding": init_hint_encoder(ini, cfg.hint),
        "down_blocks": [],
        "controlnet_down_blocks": [ini.zero_conv(boc[0], boc[0], 1, 1)],
    }
    out_ch = boc[0]
    for i in range(n):
        in_ch, out_ch = out_ch, boc[i]
        is_final = i == n - 1
        p["down_blocks"].append(init_down_block(
            ini, in_ch, out_ch, u.time_embed_dim, u.layers_per_block, u.cross_attention_levels[i],
            u.num_attention_heads[i], u.transformer_layers_per_block, u.cross_attention_dim,
            add_downsample=not is_final,
        ))
        for _ in range(u.layers_per_block):
            p["controlnet_down_blocks"].append(ini.zero_conv(out_ch, out_ch, 1, 1))
        if not is_final:
            p["controlnet_down_blocks"].append(ini.zero_conv(out_ch, out_ch, 1, 1))
    p["controlnet_mid_block"] = ini.zero_conv(boc[-1], boc[-1], 1, 1)
    p["mid_block"] = init_mid_block(ini, boc[-1], u.time_embed_dim, u.num_attention_heads[-1],
                                    u.transformer_layers_per_block, u.cross_attention_dim)
    return p


def controlnet_from_unet(controlnet_params: dict, unet_params: dict) -> dict:
    """Copy the encoder weights of a UNet (ControlNetSDVModel.from_unet):
    conv_in, time/add embeddings, down blocks, mid block."""
    p = dict(controlnet_params)
    for name in ("conv_in", "time_embedding", "add_embedding", "down_blocks", "mid_block"):
        p[name] = copy.deepcopy(unet_params[name])
    return p


def controlnet_forward(params: dict, cfg: ControlNetConfig, sample: torch.Tensor, timestep,
                       encoder_hidden_states: torch.Tensor, added_time_ids: torch.Tensor,
                       controlnet_cond: Optional[torch.Tensor] = None, conditioning_scale: float = 1.0,
                       bbox_cond: Optional[torch.Tensor] = None, camera_cond: Optional[torch.Tensor] = None,
                       rot_id: Optional[torch.Tensor] = None, entity_cond: Optional[torch.Tensor] = None,
                       compute_dtype=torch.bfloat16,
                       hint_embedding: Optional[torch.Tensor] = None,
                       remat=False) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Returns (down_block_residuals (12 for the 4-level config),
    mid_block_residual), each scaled by conditioning_scale. `hint_embedding`
    skips the hint encoder: the sampling loop computes it once. bbox_cond,
    camera_cond, rot_id, entity_cond: the hint variant's conditions (see
    hint_encoder). remat: False, True or "unit", as for unet_forward."""
    u = cfg.unet
    units = remat == "unit"
    blocks = bool(remat) and not units
    b, f, h, w, _ = sample.shape
    emb = compute_embeddings(params, u, timestep, added_time_ids, b, f, compute_dtype)
    context = encoder_hidden_states.to(compute_dtype).repeat_interleave(f, dim=0)
    x = conv2d(params["conv_in"], sample.reshape(b * f, h, w, sample.shape[-1]).to(compute_dtype),
               compute_dtype=compute_dtype)
    if hint_embedding is not None:
        x = x + hint_embedding.to(x.dtype)
    elif controlnet_cond is not None:
        x = x + hint_encoder(params["controlnet_cond_embedding"], cfg.hint, controlnet_cond.to(compute_dtype), f,
                             bbox_cond=bbox_cond, camera_cond=camera_cond, rot_id=rot_id, entity_cond=entity_cond,
                             compute_dtype=compute_dtype)
    indicator = torch.zeros((b, f), dtype=torch.float32, device=sample.device)
    skips: Tuple[torch.Tensor, ...] = (x,)
    for i, db_params in enumerate(params["down_blocks"]):
        x, new_skips = maybe_checkpoint(
            lambda xx, ee, cc, p=db_params, i=i: down_block(p, xx, ee, cc, f, u.num_attention_heads[i], indicator,
                                                            compute_dtype=compute_dtype, remat_units=units),
            blocks,
        )(x, emb, context if u.cross_attention_levels[i] else None)
        skips = skips + new_skips
    x = maybe_checkpoint(
        lambda xx, ee, cc: mid_block(params["mid_block"], xx, ee, cc, f, u.num_attention_heads[-1], indicator,
                                     compute_dtype=compute_dtype, remat_units=units),
        blocks,
    )(x, emb, context)
    down = tuple(conv2d(zc, s, compute_dtype=compute_dtype) * conditioning_scale
                 for zc, s in zip(params["controlnet_down_blocks"], skips))
    mid = conv2d(params["controlnet_mid_block"], x, compute_dtype=compute_dtype) * conditioning_scale
    return down, mid
