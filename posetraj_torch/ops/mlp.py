"""Kernel B: fused [LayerNorm +] GEGLU MLP [+ residual] [+ broadcast addend].

Port of posetraj_tpu/ops/pallas_mlp.py:_fused_impl, the kernel behind its
fused_geglu_mlp, fused_ln_geglu_mlp, fused_ln_geglu_mlp_res and
fused_ln_geglu_mlp_res_add: all four are `geglu_mlp` here, selected by
`ln_w` (LayerNorm prologue), `residual` and `add`. The CUDA kernel is
posetraj_torch/csrc/mlp.cu; `geglu_mlp_plain` is the same function in plain
PyTorch. `GegluMlp` is the custom_vjp of all four entry points: kernel
forward, plain recompute backward, with a gradient for `add` too.
`geglu_applicable` is the dispatch gate of models/transformer.feed_forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from posetraj_torch.configs import kernel_config
from posetraj_torch.ops import _native
from posetraj_torch.ops.recompute import recompute_vjp

NAME = "mlp"
MAX_K_OUT = 1280


def geglu_applicable(w1: torch.Tensor, w2: torch.Tensor) -> bool:
    """The JAX gate (pallas_mlp.fused_geglu_applicable): KernelConfig.fused_ff,
    and fused_ff_wide for K > 640; within kernel B's own limits (K % 64,
    N % 64, K_out % 16, K_out <= 1280) instead of the TPU's row and lane
    rules. w1 (2N, K), w2 (K_out, N)."""
    cfg = kernel_config()
    k, n, k_out = w1.shape[1], w1.shape[0] // 2, w2.shape[0]
    return (cfg.fused_ff and (k <= 640 or cfg.fused_ff_wide) and k % 64 == 0 and n % 64 == 0 and k_out % 16 == 0
            and k_out <= MAX_K_OUT)


def broadcast_add_rows(x: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """x (M, K) + add (G, S_a, K): row r takes add[r // (M // G), r % S_a]
    (pallas_mlp._broadcast_add_rows), added in x's dtype."""
    m, k = x.shape
    g, s_a, _ = add.shape
    rep = m // (g * s_a)
    return (x.reshape(g, rep, s_a, k) + add[:, None].to(x.dtype)).reshape(m, k)


def geglu_mlp_plain(x, w1, b1, w2, b2, ln_w=None, ln_b=None, eps: float = 1e-5,
                    residual: bool = False, add=None) -> torch.Tensor:
    """Reference formulation (pallas_mlp._ref_ln_geglu_mlp[_res[_add]]):
    xa = x [+ add]; h = [LN](xa) in float32, cast to x.dtype; [a|g] = h W1^T
    + b1; out = (a * gelu(g)) W2^T + b2 [+ xa], matmuls in x.dtype."""
    xa = broadcast_add_rows(x, add) if add is not None else x
    h = xa
    if ln_w is not None:
        h = F.layer_norm(xa.float(), xa.shape[-1:], ln_w.float(), ln_b.float(), eps).to(x.dtype)
    a, g = F.linear(h, w1, b1).chunk(2, dim=-1)
    out = F.linear(a * F.gelu(g), w2, b2)
    return xa + out if residual else out


class GegluMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_w, ln_b, add, eps: float, residual: bool):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_w, ln_b, add)
        ctx.static = (eps, residual)
        run = geglu_mlp_kernel if x.is_cuda else geglu_mlp_plain
        return run(x, w1, b1, w2, b2, ln_w, ln_b, eps, residual, add)

    @staticmethod
    def backward(ctx, grad):
        eps, residual = ctx.static
        fn = lambda x, w1, b1, w2, b2, ln_w, ln_b, add: geglu_mlp_plain(x, w1, b1, w2, b2, ln_w, ln_b, eps,
                                                                         residual, add)
        return recompute_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:8], grad) + (None, None)


def geglu_mlp(x, w1, b1, w2, b2, ln_w=None, ln_b=None, eps: float = 1e-5,
              residual: bool = False, add=None) -> torch.Tensor:
    """x (M, K); w1 (2N, K) [A rows | G rows]; b1 (2N,); w2 (K_out, N);
    b2 (K_out,); ln_w/ln_b (K,) or None; add (G, S_a, K) or None.
    CPU tensor: the plain version. CUDA tensor: kernel B, or an error.
    Differentiable in every tensor argument."""
    return GegluMlp.apply(x, w1, b1, w2, b2, ln_w, ln_b, add, eps, residual)


def geglu_mlp_kernel(x, w1, b1, w2, b2, ln_w=None, ln_b=None, eps: float = 1e-5,
                     residual: bool = False, add=None) -> torch.Tensor:
    m, k = x.shape
    n = w1.shape[0] // 2
    k_out = w2.shape[0]
    if w1.shape != (2 * n, k) or w2.shape != (k_out, n) or b1.shape != (2 * n,) or b2.shape != (k_out,):
        raise ValueError("geglu_mlp kernel: weight shapes do not match")
    if k % 64 or n % 64 or k_out % 16 or k_out > MAX_K_OUT:
        raise ValueError(f"geglu_mlp kernel: needs K%64==0, N%64==0, K_out%16==0, K_out<=1280 (K={k}, N={n}, K_out={k_out})")
    if residual and k_out != k:
        raise ValueError("geglu_mlp kernel: residual needs K_out == K")
    rows_per_group, s_a = 1, 1
    if add is not None:
        g, s_a, ka = add.shape
        if ka != k or m % g or (m // g) % s_a:
            raise ValueError(f"geglu_mlp kernel: addend {tuple(add.shape)} does not tile {m} rows")
        rows_per_group = m // g
    _native.check_dtype("geglu_mlp", torch.bfloat16, x=x, w1=w1, b1=b1, w2=w2, b2=b2, add=add)
    if ln_w is not None:
        ln_w, ln_b = ln_w.float().contiguous(), ln_b.float().contiguous()
    _native.check_cuda("geglu_mlp", x=x, w1=w1, b1=b1, w2=w2, b2=b2, ln_w=ln_w, ln_b=ln_b, add=add)
    out = torch.empty((m, k_out), device=x.device, dtype=x.dtype)
    P, I, L, Fl = _native.P, _native.I, _native.L, _native.Fl
    _native.call(
        NAME, "pt_mlp",
        [P, P, P, P, P, P, P, P, P, L, I, I, I, L, I, Fl, I],
        _native.ptr(x), _native.ptr(w1), _native.ptr(b1), _native.ptr(w2), _native.ptr(b2),
        _native.ptr(ln_w), _native.ptr(ln_b), _native.ptr(add), _native.ptr(out),
        m, k, n, k_out, rows_per_group, s_a, float(eps), int(residual),
    )
    return out
