"""Parameter initialisation on the device, from an explicit torch.Generator.

Matches PyTorch's layer defaults (weights and biases drawn from
U(-1/sqrt(fan_in), 1/sqrt(fan_in))), plus the zero init of the ControlNet's
zero convs. Parameters are plain nested dicts of tensors in PyTorch layouts:
linear weights (out, in), conv weights (out, in, kh, kw), the temporal (3,1,1)
conv (out, in, 3, 1, 1). Norm scales and biases stay float32; every other
leaf is cast to the compute dtype once, here.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` by default. The CPU only when
    the caller asks for it; without a GPU and without that request, raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "posetraj_torch runs on a CUDA device; none is available. "
                "Pass device='cpu' to run on the CPU."
            )
        device = "cuda"
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small tensor of fixed values on `device`, made once and kept for
    the process (a handful of keys: CLIP's mean and std, the blur taps of a
    resize, the training time ids). A CUDA graph capture may not copy from
    the host, so code that a captured step runs takes its constants from
    here; the eager step before a capture makes them. Callers must not
    write into the tensor."""
    return torch.tensor(values, dtype=dtype, device=device)


def default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, float32 on the CPU (the JAX package's rule)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def prepare_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """4D conv weights are kept channels-last in memory, the format cuDNN
    runs NHWC activations with."""
    if w.ndim == 4:
        return w.contiguous(memory_format=torch.channels_last)
    return w.contiguous()


class Init:
    """Random parameter factory bound to one generator, device and dtype."""

    def __init__(self, generator: torch.Generator, device: torch.device, dtype: torch.dtype):
        self.gen = generator
        self.device = device
        self.dtype = dtype

    def uniform(self, shape: Sequence[int], fan_in: int) -> torch.Tensor:
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        t = torch.rand(tuple(shape), generator=self.gen, device=self.device, dtype=torch.float32)
        return (t * (2.0 * bound) - bound).to(self.dtype)

    def normal(self, shape: Sequence[int], std: float = 1.0) -> torch.Tensor:
        t = torch.randn(tuple(shape), generator=self.gen, device=self.device, dtype=torch.float32)
        return (t * std).to(self.dtype)

    def linear(self, in_dim: int, out_dim: int, bias: bool = True) -> dict:
        p = {"weight": self.uniform((out_dim, in_dim), in_dim)}
        if bias:
            p["bias"] = self.uniform((out_dim,), in_dim)
        return p

    def conv(self, in_ch: int, out_ch: int, *kernel: int, bias: bool = True) -> dict:
        fan_in = in_ch * math.prod(kernel)
        p = {"weight": prepare_conv_weight(self.uniform((out_ch, in_ch, *kernel), fan_in))}
        if bias:
            p["bias"] = self.uniform((out_ch,), fan_in)
        return p

    def zero_conv(self, in_ch: int, out_ch: int, *kernel: int) -> dict:
        w = torch.zeros((out_ch, in_ch, *kernel), device=self.device, dtype=self.dtype)
        return {
            "weight": prepare_conv_weight(w),
            "bias": torch.zeros((out_ch,), device=self.device, dtype=self.dtype),
        }

    def identity_pad_linear(self, in_dim: int, out_dim: int) -> dict:
        """Identity on the first out_dim inputs, zero on the rest, zero bias:
        the camera projection's init, which passes the hint embedding
        through and ignores the camera until training moves it."""
        w = torch.zeros((out_dim, in_dim), device=self.device, dtype=self.dtype)
        w[:, :out_dim] = torch.eye(out_dim, device=self.device, dtype=self.dtype)
        return {"weight": w, "bias": torch.zeros((out_dim,), device=self.device, dtype=self.dtype)}

    def embedding(self, num: int, dim: int) -> dict:
        """nn.Embedding's default: N(0, 1)."""
        return {"embedding": self.normal((num, dim))}

    def norm(self, channels: int) -> dict:
        return {
            "weight": torch.ones(channels, device=self.device, dtype=torch.float32),
            "bias": torch.zeros(channels, device=self.device, dtype=torch.float32),
        }

    def mix_factor(self, alpha: float) -> dict:
        return {"mix_factor": torch.full((1,), alpha, device=self.device, dtype=torch.float32)}


def make_init(seed: int, device: torch.device, dtype: torch.dtype) -> Init:
    """An Init drawing from `seed` on `device`. On the `meta` device the
    leaves hold shapes, dtypes and layouts only (no generator, no memory):
    the templates of tools/fill.py and of the weight converter."""
    if torch.device(device).type == "meta":
        return Init(None, torch.device(device), dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return Init(gen, device, dtype)

