"""Plain float32 reference of SVD img2vid-14 with the PoseTraj trajectory
ControlNet: CLIP ViT-H/14, the VAE (2D encoder, temporal decoder), the
spatio-temporal UNet, the ControlNet with its hint encoder (base and bbox),
the Euler-Karras sampler and the EDM training loss.

Written from the diffusers 0.24.0 module semantics and the PoseTraj
training script, independently of the program under test: it imports no
module of the program, runs no kernel of it and reads only the weight tree
(nested dicts of tensors in PyTorch layouts: linear (out, in), conv
(out, in, kh, kw), temporal conv (out, in, 3, 1, 1)) and a configuration
dict. Activations are channels-last, (N, H, W, C) images and
(B, F, H, W, C) videos. Every product runs in float32 with TF32 off.

`Ops(fp8=True)` is the control of the bfloat16 compute: every operand of a
matmul, convolution or attention product is rounded to float8 e4m3
(per-tensor scale) before the float32 product, the precision one step below
the bfloat16 the configuration states; in a backward pass the gradient that
reaches each operand is rounded to float8 e5m2 (per-tensor scale), as fp8
training recipes take it. The VAE encoder, which the configuration states
in float32 with TF32 off, has its own controls one step below: its products
in TF32 (`tf32()`), or its operands rounded to bfloat16 (`Ops(bf16=True)`).

Quirks of the reference implementation that trained checkpoints bake in,
kept here: the ControlNet residuals re-added inside the down-block loop;
per-frame guidance; time ids (6, 128, 0.02) at inference; the temporal
cross-attention context interleaved across pixels; CLIP fed unnormalised
pixels at inference and normalised [-1, 1] pixels in training.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Attention logits are materialised in float32; the batch of heads is
# walked in chunks that keep them near this many bytes.
LOGIT_BYTES = 1 << 31


def full_float32() -> None:
    """TF32 off for matmuls and cuDNN: the reference's products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def tf32():
    """TF32 products for matmuls and cuDNN inside the block (on the card):
    the control of a part stated in float32 with TF32 off."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fake_fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude onto the format's largest finite value, back in float32."""
    scale = torch.finfo(dtype).max / t.abs().amax().clamp_min(1e-30)
    return (t * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fake_fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _fake_fp8(grad, torch.float8_e5m2)


class Ops:
    """The reference's arithmetic: float32, or with fp8 or bfloat16 operands (controls)."""

    def __init__(self, fp8: bool = False, remat: bool = False, bf16: bool = False):
        self.fp8 = fp8
        self.bf16 = bf16
        self.remat = remat  # checkpoint each (resnet, transformer) unit under grad

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return _Fp8.apply(t)
        return t.to(torch.bfloat16).float() if self.bf16 else t

    def linear(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        b = p.get("bias")
        return F.linear(self.q(x), self.q(p["weight"].float()), None if b is None else b.float())

    def conv(self, p: dict, x: torch.Tensor, stride: int = 1, pad=None) -> torch.Tensor:
        """(N, H, W, C) conv; pad an int (symmetric) or (left, right, top, bottom)."""
        w = p["weight"].float()
        xc = x.permute(0, 3, 1, 2)
        if pad is None:
            pad = w.shape[-1] // 2
        if not isinstance(pad, int):
            xc, pad = F.pad(xc, pad), 0
        b = p.get("bias")
        y = F.conv2d(self.q(xc), self.q(w), None if b is None else b.float(), stride=stride, padding=pad)
        return y.permute(0, 2, 3, 1)

    def conv_frames(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, C) conv with a (k, 1, 1) kernel over the frames, zero padded."""
        w = p["weight"].float()
        y = F.conv3d(self.q(x.permute(0, 4, 1, 2, 3)), self.q(w), p["bias"].float() if "bias" in p else None,
                     padding=(w.shape[2] // 2, 0, 0))
        return y.permute(0, 2, 3, 4, 1)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
        """Softmax attention of (B, Sq, C) over (B, Sk, C), `heads` heads."""
        b, sq, c = q.shape
        sk, hd = k.shape[1], c // heads
        qh, kh, vh = (self.q(t).reshape(b, t.shape[1], heads, hd).transpose(1, 2) for t in (q, k, v))
        step = max(1, LOGIT_BYTES // (heads * sq * sk * 4))
        outs = []
        for i in range(0, b, step):
            logits = torch.matmul(qh[i:i + step], kh[i:i + step].transpose(-1, -2)) * hd**-0.5
            outs.append(torch.matmul(torch.softmax(logits, dim=-1), vh[i:i + step]))
        return torch.cat(outs).transpose(1, 2).reshape(b, sq, c)

    def unit(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)


def _groups(c: int, groups: int = 32) -> int:
    return groups if c % groups == 0 else math.gcd(c, groups)


def group_norm(p: dict, x: torch.Tensor, eps: float, silu: bool = False, frames: int = 0) -> torch.Tensor:
    """GroupNorm of channels-last x over each sample; with `frames`, x is
    (B*F, H, W, C) and the statistics span each video's frames."""
    c = x.shape[-1]
    xc = x.reshape(-1, frames, *x.shape[1:]).movedim(-1, 1) if frames else x.movedim(-1, 1)
    y = F.group_norm(xc, _groups(c), p["weight"].float(), p["bias"].float(), eps).movedim(1, -1)
    y = y.reshape(x.shape)
    return F.silu(y) if silu else y


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["weight"].float(), p["bias"].float(), eps)


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' timestep embedding, flip_sin_to_cos, shift 0: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def mlp2(ops: Ops, p: dict, x: torch.Tensor) -> torch.Tensor:
    """TimestepEmbedding: linear, SiLU, linear."""
    return ops.linear(p["linear_2"], F.silu(ops.linear(p["linear_1"], x)))


# ---------------------------------------------------------------------------
# Residual blocks
# ---------------------------------------------------------------------------


def resnet2d(ops: Ops, p: dict, x: torch.Tensor, temb, eps: float) -> torch.Tensor:
    h = ops.conv(p["conv1"], group_norm(p["norm1"], x, eps, silu=True))
    if temb is not None and "time_emb_proj" in p:
        h = h + ops.linear(p["time_emb_proj"], F.silu(temb))[:, None, None, :]
    h = ops.conv(p["conv2"], group_norm(p["norm2"], h, eps, silu=True))
    if "conv_shortcut" in p:
        x = ops.conv(p["conv_shortcut"], x)
    return x + h


def resnet_temporal(ops: Ops, p: dict, x: torch.Tensor, frames: int, temb, eps: float) -> torch.Tensor:
    """(B*F, H, W, C): (3, 1, 1) convs over each video's frames."""
    video = lambda t: t.reshape(-1, frames, *t.shape[1:])
    flat = lambda t: t.reshape(-1, *t.shape[2:])
    h = flat(ops.conv_frames(p["conv1"], video(group_norm(p["norm1"], x, eps, silu=True, frames=frames))))
    if temb is not None and "time_emb_proj" in p:
        h = h + ops.linear(p["time_emb_proj"], F.silu(temb))[:, None, None, :]
    h = flat(ops.conv_frames(p["conv2"], video(group_norm(p["norm2"], h, eps, silu=True, frames=frames))))
    if "conv_shortcut" in p:
        x = flat(ops.conv_frames(p["conv_shortcut"], video(x)))
    return x + h


def spatio_temporal_res(ops: Ops, p: dict, x, temb, frames: int, eps: float, temporal_eps=None,
                        decoder: bool = False) -> torch.Tensor:
    """SpatioTemporalResBlock; AlphaBlender weights the spatial branch by
    sigmoid(mix) (video frames), the temporal one in the VAE decoder."""
    hs = resnet2d(ops, p["spatial_res_block"], x, temb, eps)
    ht = resnet_temporal(ops, p["temporal_res_block"], hs, frames, temb,
                         eps if temporal_eps is None else temporal_eps)
    alpha = torch.sigmoid(p["time_mixer"]["mix_factor"].float())
    if decoder:
        alpha = 1.0 - alpha
    return alpha * hs + (1.0 - alpha) * ht


# ---------------------------------------------------------------------------
# Transformers
# ---------------------------------------------------------------------------


def geglu_ff(ops: Ops, p: dict, x: torch.Tensor) -> torch.Tensor:
    h, gate = ops.linear(p["proj_in"], x).chunk(2, dim=-1)
    return ops.linear(p["proj_out"], h * F.gelu(gate))


def self_attention(ops: Ops, p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    q, k, v = ops.linear({"weight": p["wqkv"]}, x).chunk(3, dim=-1)
    return ops.linear(p["to_out"], ops.attention(q, k, v, heads))


def cross_attention(ops: Ops, p: dict, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """Over a one-token context the softmax is 1: to_out(to_v(ctx)), broadcast."""
    if ctx.shape[-2] == 1:
        return ops.linear(p["to_out"], ops.linear(p["to_v"], ctx))
    q, k, v = (ops.linear(p[n], t) for n, t in (("to_q", x), ("to_k", ctx), ("to_v", ctx)))
    return ops.linear(p["to_out"], ops.attention(q, k, v, heads))


def _cross_input(p: dict, x: torch.Tensor, ctx: torch.Tensor):
    """The cross-attention's normed queries; none are read over one key."""
    return x if ctx.shape[-2] == 1 else layer_norm(p["norm2"], x)


def basic_block(ops: Ops, p: dict, x: torch.Tensor, heads: int, ctx) -> torch.Tensor:
    """(N, S, C): self-attention, cross-attention, GEGLU feed-forward, pre-norm."""
    x = x + self_attention(ops, p["attn1"], layer_norm(p["norm1"], x), heads)
    if "attn2" in p:
        x = x + cross_attention(ops, p["attn2"], _cross_input(p, x, ctx), ctx, heads)
    return x + geglu_ff(ops, p["ff"], layer_norm(p["norm3"], x))


def temporal_block(ops: Ops, p: dict, x: torch.Tensor, frames: int, heads: int, ctx: torch.Tensor) -> torch.Tensor:
    """(B*F, S, C) attended over the frames of each pixel; ctx (B, S, 1, D)."""
    bf, s, c = x.shape
    b = bf // frames
    x = x.reshape(b, frames, s, c).transpose(1, 2).reshape(b * s, frames, c)  # (B*S, F, C)
    x = x + geglu_ff(ops, p["ff_in"], layer_norm(p["norm_in"], x))
    x = x + self_attention(ops, p["attn1"], layer_norm(p["norm1"], x), heads)
    ctx = ctx.reshape(b * s, 1, -1)
    x = x + cross_attention(ops, p["attn2"], _cross_input(p, x, ctx), ctx, heads)
    x = x + geglu_ff(ops, p["ff"], layer_norm(p["norm3"], x))
    return x.reshape(b, s, frames, c).transpose(1, 2).reshape(bf, s, c)


def spatio_temporal_transformer(ops: Ops, p: dict, x: torch.Tensor, ctx: torch.Tensor, frames: int,
                                heads: int) -> torch.Tensor:
    """TransformerSpatioTemporalModel over (B*F, H, W, C); ctx (B*F, 1, D)."""
    bf, hh, ww, c = x.shape
    b, s = bf // frames, hh * ww
    first = ctx.reshape(b, frames, 1, -1)[:, 0, 0]  # (B, D): each video's first-frame context
    # diffusers 0.24.0 builds the per-pixel temporal context sequence-major
    # while the rows are batch-major: pixel s of video b reads row (b*S+s) % B.
    rows = (torch.arange(b, device=x.device)[:, None] * s + torch.arange(s, device=x.device)[None]) % b
    tctx = first[rows][:, :, None, :]  # (B, S, 1, D)
    h = ops.linear(p["proj_in"], group_norm(p["norm"], x, 1e-6).reshape(bf, s, c))
    pos = mlp2(ops, p["time_pos_embed"], sinusoid(torch.arange(frames, device=x.device).repeat(b), c))
    alpha = torch.sigmoid(p["time_mixer"]["mix_factor"].float())
    for blk, tblk in zip(p["blocks"], p["temporal_blocks"]):
        h = basic_block(ops, blk, h, heads, ctx)
        mix = temporal_block(ops, tblk, h + pos[:, None, :], frames, heads, tctx)
        h = alpha * h + (1.0 - alpha) * mix
    return ops.linear(p["proj_out"], h).reshape(bf, hh, ww, c) + x


# ---------------------------------------------------------------------------
# UNet and ControlNet
# ---------------------------------------------------------------------------


def time_embedding(ops: Ops, p: dict, ucfg: dict, t: torch.Tensor, time_ids: torch.Tensor, frames: int):
    """(B*F, 4 C0) from the timestep (B,) and the added time ids (B, 3)."""
    b = time_ids.shape[0]
    emb = mlp2(ops, p["time_embedding"], sinusoid(t.reshape(-1).expand(b), ucfg["block_out_channels"][0]))
    added = sinusoid(time_ids.reshape(-1), ucfg["addition_time_embed_dim"]).reshape(b, -1)
    return (emb + mlp2(ops, p["add_embedding"], added)).repeat_interleave(frames, dim=0)


def _down_block(ops: Ops, p: dict, x, temb, ctx, frames: int, heads: int):
    eps = 1e-6 if "attentions" in p else 1e-5
    skips = []
    for i, rp in enumerate(p["resnets"]):
        ap = p["attentions"][i] if "attentions" in p else None

        def unit(xx, tt, rp=rp, ap=ap):
            xx = spatio_temporal_res(ops, rp, xx, tt, frames, eps)
            return xx if ap is None else spatio_temporal_transformer(ops, ap, xx, ctx, frames, heads)

        x = ops.unit(unit, x, temb)
        skips.append(x)
    if "downsampler" in p:
        x = ops.conv(p["downsampler"], x, stride=2, pad=1)
        skips.append(x)
    return x, skips


def _mid_block(ops: Ops, p: dict, x, temb, ctx, frames: int, heads: int):
    def unit(xx, tt):
        xx = spatio_temporal_res(ops, p["resnets"][0], xx, tt, frames, 1e-5)
        return spatio_temporal_transformer(ops, p["attentions"][0], xx, ctx, frames, heads)

    x = ops.unit(unit, x, temb)
    return ops.unit(lambda xx, tt: spatio_temporal_res(ops, p["resnets"][1], xx, tt, frames, 1e-5), x, temb)


def unet(ops: Ops, p: dict, ucfg: dict, sample, t, ctx, time_ids, down_res=None, mid_res=None):
    """sample (B, F, h, w, 8), t (B,) or (), ctx (B, 1, D), time_ids (B, 3) -> (B, F, h, w, 4)."""
    b, frames, h, w, cin = sample.shape
    temb = time_embedding(ops, p, ucfg, t, time_ids, frames)
    ctx = ctx.repeat_interleave(frames, dim=0)
    x = ops.conv(p["conv_in"], sample.reshape(b * frames, h, w, cin))
    skips = [x]
    for i, dp in enumerate(p["down_blocks"]):
        x, new = _down_block(ops, dp, x, temb, ctx if ucfg["cross_attention_levels"][i] else None, frames,
                             ucfg["num_attention_heads"][i])
        skips = skips + new
        if down_res is not None:
            # The residual merge sits inside the block loop and zip truncates:
            # residual k is added again after every later down block.
            skips = [s + r for s, r in zip(skips, down_res)]
    x = _mid_block(ops, p["mid_block"], x, temb, ctx, frames, ucfg["num_attention_heads"][-1])
    if mid_res is not None:
        x = x + mid_res
    heads = list(reversed(ucfg["num_attention_heads"]))
    cross = list(reversed(ucfg["cross_attention_levels"]))
    for i, up in enumerate(p["up_blocks"]):
        for j, rp in enumerate(up["resnets"]):
            ap = up["attentions"][j] if "attentions" in up else None

            def unit(xx, sk, tt, rp=rp, ap=ap, i=i):
                xx = spatio_temporal_res(ops, rp, torch.cat([xx, sk], dim=-1), tt, frames, 1e-6)
                return xx if ap is None else spatio_temporal_transformer(
                    ops, ap, xx, ctx if cross[i] else None, frames, heads[i])

            x = ops.unit(unit, x, skips.pop(), temb)
        if "upsampler" in up:
            x = ops.conv(up["upsampler"], x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
    x = ops.conv(p["conv_out"], group_norm(p["conv_norm_out"], x, 1e-5, silu=True))
    return x.reshape(b, frames, h, w, -1)


def _conv_stack(ops: Ops, p: dict, cond: torch.Tensor) -> torch.Tensor:
    h = F.silu(ops.conv(p["conv_in"], cond))
    for i, bp in enumerate(p["blocks"]):
        h = F.silu(ops.conv(bp, h, stride=2 if i % 2 else 1, pad=1))
    return ops.conv(p["conv_out"], h)


def hint_encoder(ops: Ops, p: dict, variant: str, cond: torch.Tensor, bbox=None) -> torch.Tensor:
    """cond (B, F, H, W, 3) in [-1, 1] -> (B*F, H/8, W/8, C0); the bbox
    variant adds a second stack over the rendered boxes."""
    flat = lambda t: t.reshape(-1, *t.shape[2:])
    emb = _conv_stack(ops, p["stack"], flat(cond))
    if variant == "bbox":
        emb = emb + _conv_stack(ops, p["stack_2"], flat(bbox))
    elif variant != "base":
        raise ValueError(f"the reference has no hint variant {variant!r}")
    return emb


def controlnet(ops: Ops, p: dict, ucfg: dict, sample, t, ctx, time_ids, hint_emb, scale: float = 1.0):
    """(12 down residuals, mid residual) of the trajectory ControlNet."""
    b, frames, h, w, cin = sample.shape
    temb = time_embedding(ops, p, ucfg, t, time_ids, frames)
    ctx = ctx.repeat_interleave(frames, dim=0)
    x = ops.conv(p["conv_in"], sample.reshape(b * frames, h, w, cin)) + hint_emb
    skips = [x]
    for i, dp in enumerate(p["down_blocks"]):
        x, new = _down_block(ops, dp, x, temb, ctx if ucfg["cross_attention_levels"][i] else None, frames,
                             ucfg["num_attention_heads"][i])
        skips = skips + new
    x = _mid_block(ops, p["mid_block"], x, temb, ctx, frames, ucfg["num_attention_heads"][-1])
    down = [ops.conv(zp, s) * scale for zp, s in zip(p["controlnet_down_blocks"], skips)]
    return down, ops.conv(p["controlnet_mid_block"], x) * scale


# ---------------------------------------------------------------------------
# VAE and CLIP
# ---------------------------------------------------------------------------


def _vae_attention(ops: Ops, p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    n, h, w, c = x.shape
    hf = group_norm(p["group_norm"], x, eps).reshape(n, h * w, c)
    q, k, v = (ops.linear(p[k_], hf) for k_ in ("to_q", "to_k", "to_v"))
    return ops.linear(p["to_out"], ops.attention(q, k, v, 1)).reshape(n, h, w, c) + x


def vae_encode(ops: Ops, p: dict, vcfg: dict, x: torch.Tensor):
    """(N, H, W, 3) in [-1, 1] -> (mean, logvar), each (N, H/8, W/8, 4)."""
    eps = vcfg["eps"]
    h = ops.conv(p["conv_in"], x)
    for blk in p["down_blocks"]:
        for rp in blk["resnets"]:
            h = resnet2d(ops, rp, h, None, eps)
        if "downsampler" in blk:
            h = ops.conv(blk["downsampler"], h, stride=2, pad=(0, 1, 0, 1))
    mb = p["mid_block"]
    h = resnet2d(ops, mb["resnets"][0], h, None, eps)
    h = _vae_attention(ops, mb["attention"], h, eps)
    h = resnet2d(ops, mb["resnets"][1], h, None, eps)
    h = ops.conv(p["conv_out"], group_norm(p["conv_norm_out"], h, eps, silu=True))
    mean, logvar = ops.conv(p["quant_conv"], h).chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def encode_image(ops: Ops, params: dict, cfg: dict, image: torch.Tensor, noise_image: torch.Tensor) -> torch.Tensor:
    """The pipeline's conditioning latents: the VAE encoder's mean of the
    noise-augmented image (1, H, W, 3) in [0, 1] -> (1, h, w, 4)."""
    return vae_encode(ops, params["vae"]["encoder"], cfg["vae"], image * 2.0 - 1.0 + 0.02 * noise_image)[0]


def encode_frames(ops: Ops, frozen: dict, cfg: dict, px: torch.Tensor, vae_eps: torch.Tensor) -> torch.Tensor:
    """Training's latents: each frame of px (B, F, H, W, 3) in [-1, 1]
    encoded and sampled with the draw vae_eps, times the scaling factor
    -> (B, F, h, w, 4)."""
    v = cfg["vae"]
    mean, logvar = vae_encode(ops, frozen["vae"]["encoder"], v, px.reshape(-1, *px.shape[2:]))
    lat = (mean + torch.exp(0.5 * logvar) * vae_eps) * v["scaling_factor"]
    return lat.reshape(*px.shape[:2], *lat.shape[1:])


def vae_decode(ops: Ops, p: dict, vcfg: dict, z: torch.Tensor, frames: int) -> torch.Tensor:
    """(B*F, h, w, 4), already divided by the scaling factor -> (B*F, H, W, 3)."""
    eps = vcfg["eps"]
    res = lambda rp, t: spatio_temporal_res(ops, rp, t, None, frames, eps, temporal_eps=1e-5, decoder=True)
    h = ops.conv(p["conv_in"], z)
    mb = p["mid_block"]
    h = res(mb["resnets"][0], h)
    for rp in mb["resnets"][1:2]:  # MidBlockTemporalDecoder pairs one attention with the second resnet
        h = res(rp, _vae_attention(ops, mb["attention"], h, eps))
    for blk in p["up_blocks"]:
        for rp in blk["resnets"]:
            h = res(rp, h)
        if "upsampler" in blk:
            h = ops.conv(blk["upsampler"], h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2))
    h = ops.conv(p["conv_out"], group_norm(p["conv_norm_out"], h, eps, silu=True))
    h = ops.conv_frames(p["time_conv_out"], h.reshape(-1, frames, *h.shape[1:]))
    return h.reshape(-1, *h.shape[2:])


def _blur_taps(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return (g / g.sum()).float().to(device)


def resize_antialias(x: torch.Tensor, size) -> torch.Tensor:
    """(N, H, W, C) -> (N, size, C): the SVD pipeline's resize: a Gaussian
    blur (sigma from the scale, about four sigma of taps, reflect padded),
    then bicubic (a = -0.75) with aligned corners."""
    xc = x.permute(0, 3, 1, 2)
    c = xc.shape[1]
    for axis, (n_in, n_out) in enumerate(zip(xc.shape[2:], size)):
        sigma = max((n_in / n_out - 1.0) / 2.0, 0.001)
        k = int(max(4.0 * sigma, 3))
        k += 1 - k % 2
        taps = _blur_taps(k, sigma, x.device)
        shape = (c, 1, k, 1) if axis == 0 else (c, 1, 1, k)
        pad = (0, 0, (k - 1) // 2, k // 2) if axis == 0 else ((k - 1) // 2, k // 2, 0, 0)
        xc = F.conv2d(F.pad(xc, pad, mode="reflect"), taps.reshape(1, 1, *shape[2:]).expand(shape), groups=c)
    xc = F.interpolate(xc, size=tuple(size), mode="bicubic", align_corners=True)
    return xc.permute(0, 2, 3, 1)


def clip_embed(ops: Ops, p: dict, ccfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """(B, 224, 224, 3) -> (B, projection_dim) image embeddings."""
    b, d, heads = pixels.shape[0], ccfg["hidden_size"], ccfg["num_heads"]
    eps = ccfg["layer_norm_eps"]
    patches = ops.conv(p["patch_embedding"], pixels, stride=ccfg["patch_size"], pad=0).reshape(b, -1, d)
    x = torch.cat([p["class_embedding"].float().expand(b, 1, d), patches], dim=1) + p["position_embedding"].float()
    x = layer_norm(p["pre_layernorm"], x, eps)
    for lp in p["layers"]:
        h = layer_norm(lp["layer_norm1"], x, eps)
        q, k, v = (ops.linear(lp[n], h) for n in ("q_proj", "k_proj", "v_proj"))
        x = x + ops.linear(lp["out_proj"], ops.attention(q, k, v, heads))
        x = x + ops.linear(lp["fc2"], F.gelu(ops.linear(lp["fc1"], layer_norm(lp["layer_norm2"], x, eps))))
    return ops.linear(p["visual_projection"], layer_norm(p["post_layernorm"], x[:, 0], eps))


# ---------------------------------------------------------------------------
# Sampler and sampling
# ---------------------------------------------------------------------------


def karras_schedule(scfg: dict, steps: int):
    """(sigmas (steps + 1,) ending in 0, conditioning timesteps 0.25 log
    sigma) of the SVD Euler-Discrete scheduler: Karras rho-7 ladder between
    sigma_max and sigma_min, "leading" spacing, v-prediction."""
    ramp = np.linspace(0, 1, steps)
    lo, hi = scfg["sigma_min"] ** (1 / scfg["rho"]), scfg["sigma_max"] ** (1 / scfg["rho"])
    sigmas = (hi + ramp * (lo - hi)) ** scfg["rho"]
    return np.concatenate([sigmas, [0.0]]).astype(np.float32), (0.25 * np.log(sigmas)).astype(np.float32)


@torch.no_grad()
def sample_video(ops: Ops, params: dict, cfg: dict, traffic: dict, image, control, noise_latents, noise_image,
                 keep: dict = None):
    """One request of the img2vid pipeline: image (1, H, W, 3) and control
    (1, F, H, W, 3) in [0, 1], the two standard-normal draws; returns
    (frames (1, F, H, W, 3) in [0, 1], final latents (1, F, h, w, 4)).
    `keep`, if given, receives the conditioning latents under "encode"."""
    u, v = cfg["unet"], cfg["vae"]
    frames = control.shape[1]
    emb = clip_embed(ops, params["clip"], cfg["clip"], resize_antialias(image, (cfg["clip"]["image_size"],) * 2))
    ctx = torch.cat([torch.zeros_like(emb), emb])[:, None, :]
    mean = encode_image(ops, params, cfg, image, noise_image)
    if keep is not None:
        keep["encode"] = mean
    cond_lat = torch.cat([torch.zeros_like(mean), mean])[:, None].expand(-1, frames, -1, -1, -1)
    ctrl = torch.cat([control, control]) * 2.0 - 1.0
    hint = hint_encoder(ops, params["controlnet"]["controlnet_cond_embedding"], cfg["hint"]["variant"], ctrl)
    sigmas, ts = karras_schedule(cfg["scheduler"], traffic["steps"])
    time_ids = torch.tensor([[6.0, 128.0, 0.02]] * 2, device=image.device)
    guidance = torch.linspace(traffic["min_guidance"], traffic["max_guidance"], frames,
                              device=image.device).reshape(1, -1, 1, 1, 1)
    lat = noise_latents * float(np.sqrt(sigmas[0].astype(np.float64) ** 2 + 1.0))
    for i in range(len(ts)):
        s, s_next = float(sigmas[i]), float(sigmas[i + 1])
        t = torch.tensor(float(ts[i]), device=image.device)
        inp = torch.cat([torch.cat([lat, lat]) / math.sqrt(s * s + 1.0), cond_lat], dim=-1)
        down, mid = controlnet(ops, params["controlnet"], u, inp, t, ctx, time_ids, hint)
        out = unet(ops, params["unet"], u, inp, t, ctx, time_ids, down, mid)
        uncond, cond = out.chunk(2)
        pred = uncond + guidance * (cond - uncond)
        denoised = pred * (-s / math.sqrt(s * s + 1.0)) + lat / (s * s + 1.0)
        lat = lat + (lat - denoised) / s * (s_next - s)
    z = lat[0] / v["scaling_factor"]
    chunk = traffic["decode_chunk"]
    out = torch.cat([vae_decode(ops, params["vae"]["decoder"], v, z[i:i + chunk], z[i:i + chunk].shape[0])
                     for i in range(0, frames, chunk)])
    return (out[None] / 2.0 + 0.5).clamp(0.0, 1.0), lat


# ---------------------------------------------------------------------------
# EDM training loss
# ---------------------------------------------------------------------------


def edm_sigmas(u: torch.Tensor) -> torch.Tensor:
    """Stratified draws u (B,) -> training sigmas of the shifted,
    interpolated cosine logSNR schedule (sigma_data 0.5, sigma in
    [0.002, 700], image_d 64, noise_d 32 to 64)."""
    n = u.shape[0]
    t = (torch.arange(n, dtype=torch.float32, device=u.device) + u.float()) / n
    lmin, lmax = -2.0 * math.log(0.002 / 0.5), -2.0 * math.log(700.0 / 0.5)

    def shifted(noise_d):
        shift = 2.0 * math.log(noise_d / 64)
        t_min = math.atan(math.exp(-0.5 * (lmax - shift)))
        t_max = math.atan(math.exp(-0.5 * (lmin - shift)))
        return -2.0 * torch.log(torch.tan(t_min + t * (t_max - t_min))) + shift

    low, high = shifted(32), shifted(64)
    return torch.exp(-(low + t * (high - low)) / 2.0) * 0.5


def draw_step(gen: torch.Generator, b: int, frames: int, latent_shape, device) -> dict:
    """The five draws of a training micro-step, in the trainer's order."""
    kw = dict(generator=gen, device=device)
    return {"vae_eps": torch.randn((b * frames, *latent_shape), **kw), "u_sigma": torch.rand((b,), **kw),
            "noise": torch.randn((b, frames, *latent_shape), **kw), "drop_p": torch.rand((b,), **kw),
            "frame_idx": torch.randint(0, frames, (1,), **kw)}


def edm_loss(ops: Ops, cn_params: dict, frozen: dict, cfg: dict, tcfg: dict, batch: dict, draws: dict,
             keep: dict = None):
    """The stage-1 loss of one micro-step: the video EDM loss plus
    spatial_loss_weight times the loss of one drawn frame. `keep`, if
    given, receives the encoded latents under "encode"."""
    u, v = cfg["unet"], cfg["vae"]
    px = batch["pixel_values"]
    b, frames = px.shape[:2]
    with torch.no_grad():
        lat = encode_frames(ops, frozen, cfg, px, draws["vae_eps"])
        if keep is not None:
            keep["encode"] = lat
        c = cfg["clip"]
        pix = resize_antialias(px[:, 0], (c["image_size"],) * 2)
        pix = (pix - torch.tensor(c["image_mean"], device=px.device)) / torch.tensor(c["image_std"], device=px.device)
        ctx = clip_embed(ops, frozen["clip"], c, pix)[:, None, :]
    noise = draws["noise"]
    sig = edm_sigmas(draws["u_sigma"])
    s5 = sig.reshape(b, 1, 1, 1, 1)
    cond = (lat + noise * tcfg["noise_aug_strength"])[:, 0] / v["scaling_factor"]
    noisy = lat + noise * s5
    root = torch.sqrt(s5**2 + 1.0)
    c_in, c_out, c_skip, w = 1.0 / root, -s5 / root, 1.0 / (s5**2 + 1.0), (1.0 + s5**2) / s5**2
    g, p = tcfg["conditioning_dropout_prob"], draws["drop_p"]
    ctx = torch.where((p < 2 * g).reshape(b, 1, 1), 0.0, ctx)
    cond = cond * (1.0 - ((p >= g) & (p < 3 * g)).float()).reshape(b, 1, 1, 1)
    inp = torch.cat([noisy * c_in, cond[:, None].expand(b, frames, *cond.shape[1:])], dim=-1)
    t = 0.25 * torch.log(sig)
    time_ids = torch.stack([torch.full_like(sig, 6.0), torch.full_like(sig, tcfg["noise_aug_strength"]),
                            batch["motion_values"].float()], dim=1)
    hint = hint_encoder(ops, cn_params["controlnet_cond_embedding"], cfg["hint"]["variant"],
                        batch["trajectories"], batch.get("bbox_trajectories"))
    down, mid = controlnet(ops, cn_params, u, inp, t, ctx, time_ids, hint)
    pred = unet(ops, frozen["unet"], u, inp, t, ctx, time_ids, down, mid)
    loss = (w * (pred * c_out + c_skip * noisy - lat) ** 2).reshape(b, -1).mean(dim=1).mean()
    if tcfg["use_spatial_loss"]:
        i = draws["frame_idx"].reshape(1)
        pick = lambda z: z.reshape(b, frames, *z.shape[1:]).index_select(1, i).reshape(b, *z.shape[1:])
        pred = unet(ops, frozen["unet"], u, inp.index_select(1, i), t, ctx, time_ids, [pick(r) for r in down],
                    pick(mid))[:, 0]
        den = pred * c_out[:, 0] + c_skip[:, 0] * noisy.index_select(1, i)[:, 0]
        loss_sp = (w[:, 0] * (den - lat.index_select(1, i)[:, 0]) ** 2).reshape(b, -1).mean(dim=1).mean()
        loss = loss + tcfg["spatial_loss_weight"] * loss_sp
    return loss
