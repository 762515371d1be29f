"""Kernel B, the GEGLU feed-forward (LayerNorm prologue, the GEGLU GEMM, the
output GEMM with the residual: three device kernels a call, named for
mlp_gemm), against its roofline over the traced window, %."""

from benchmark import work


def read(run):
    return work.roofline_share(run, "mlp", "mlp_gemm", "mlp", 3)
