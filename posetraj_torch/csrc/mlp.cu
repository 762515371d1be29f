// Kernel B: fused [LayerNorm +] GEGLU MLP [+ residual] [+ broadcast addend],
//   out = [xa +] (A * gelu_erf(G)) @ W2^T + b2,  [A | G] = LN(xa) @ W1^T + b1,
//   xa  = x [+ add],
// bf16 in and out, float32 accumulation.
//
// Replaces posetraj_tpu/ops/pallas_mlp.py:_fused_impl (_mlp_kernel), the
// kernel behind fused_geglu_mlp, fused_ln_geglu_mlp, fused_ln_geglu_mlp_res
// and fused_ln_geglu_mlp_res_add.
//
// Bound on the H100: operations. At the UNet's shapes (rows = 28*S, K = 320..
// 1280, hidden N = 4K) it does 3*K*N multiply-adds per row against ~4K bytes
// of activation per row. The design: up to three launches of the port's
// Hopper GEMM (gemm.cuh: warp-specialised wgmma fed by TMA through an
// mbarrier ring, persistent over 128-row tiles):
//   1. with a LayerNorm or an addend, the row pre-pass writes A = [LN](xa)
//      once (float32 statistics, rounded to bf16, as the reference);
//   2. u = bf16((A + b1a) * gelu_erf(G + b1g)) from 128 x (128 + 128) tiles
//      of A @ W1^T, the A and G columns of u's 128 columns side by side in
//      each consumer's registers, the gate applied in the epilogue;
//   3. out = u @ W2^T + b2 [+ xa], the residual tile loaded by TMA under
//      the mainloop (with an addend, xa = bf16(x + add) is written by the
//      pre-pass of step 1).
// u (rows, N) goes through device memory in bf16: the reference rounds it to
// the compute dtype before the second product, so this is the same
// function. A Hopper block cannot hold a (64, K_out) float32 accumulator
// beside [A | G]'s once K_out >= 640, so the TPU kernel's on-chip u would
// cap the row tile; the round trip costs 4 N bytes a row against 6 K N
// multiply-adds, still above the card's ~295 operations a byte at K = 320.

#include "gemm.cuh"

// xn (M, K) scratch, used when ln_w or add is given; xa (M, K) scratch,
// used when add, ln_w and residual are given; u (M, N) scratch.
// Requires K % 8 == 0, K <= 2048, N % 8 == 0, K_out % 8 == 0 (checked by
// the Python wrapper); residual requires K_out == K.
PT_EXPORT int pt_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                     const float* ln_w, const float* ln_b, const void* add, void* xn, void* xa, void* u, void* out,
                     long long m, int k, int n, int k_out, long long rows_per_group, int s_a, float eps,
                     int residual, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a = x;  // the first product's operand
  const void* res = x;  // the residual, xa
  int err = 0;
  if (ln_w != nullptr || add != nullptr) {
    const bool keep_xa = add != nullptr && ln_w != nullptr && residual;
    err = gemm::rows_prologue<gemm::mlp_gemm>(x, add, rows_per_group, s_a, ln_w, ln_b, eps, xn,
                                              keep_xa ? xa : nullptr, m, k, st);
    a = xn;
    if (add != nullptr) res = ln_w != nullptr ? xa : xn;
  }
  if (!err) err = gemm::geglu<gemm::mlp_gemm>(a, w1, b1, u, m, n, k, st);
  if (err) return err;
  return gemm::linear<gemm::mlp_gemm>(u, w2, out, residual ? res : nullptr,
                                      gemm::epilogue(gemm::kBiasResidual, b2), m, k_out, n, st);
}
