// Kernel C: the spatial self-attention sub-layer,
//   out = x + to_out(MHA(LN(x))),  x (B, S, C) bf16, head_dim 64,
// in one C call of four launches:
//   1. the row LayerNorm of x, written once into the o scratch (gemm.cuh
//      rows_prologue);
//   2. the port's Hopper GEMM (gemm.cuh) LN(x) @ Wqkv^T, its epilogue
//      scattering per-head q, k, v, each (B, heads, S, 64) contiguous;
//   3. the port's one flash-attention forward (flash_fwd.cuh: wgmma from
//      TMA-fed shared memory, a producer warpgroup and two consumer
//      warpgroups of 64 queries, 128-key tiles in a three-stage mbarrier
//      ring), reading q, k, v from that scratch and writing o as (B, S, C)
//      with head h at columns [64 h, 64 h + 64);
//   4. the GEMM o @ Wo^T + bo + x, the residual tile loaded by TMA.
// Also exports pt_gemm, the GEMM alone (ops/gemm.py).
//
// Replaces posetraj_tpu/ops/pallas_qkvt.py:attn_sublayer (ln_qkvt_proj,
// qkvt_attention/_qkvt_attn_kernel and out_proj_res). The TPU version's
// transposed (B, 3C, S) layout exists for Mosaic's lane rule; here q/k/v are
// head-major rows that TMA reads as 64-column boxes.
//
// Bound on the H100: operations. At S = 9216 the attention core does
// 4*S^2*64 multiply-adds per (batch, head) against 4*S*64*2 bytes of q/k/v/o
// (3.08 ms at 989 TFLOP/s for the level-0 call, B = 28, 5 heads); the
// projections add 0.21 ms. Softmax: exact online softmax in base 2, float32
// statistics and accumulators, P rounded to bf16 for the P@V product as the
// reference rounds its probabilities. A ragged S is masked: keys past S get
// -inf logits and queries past S are not stored, so S = 2880 (the 320x576
// level 0) runs through the same kernel.

#include "common.cuh"
#include "flash_fwd.cuh"
#include "gemm.cuh"

namespace {

constexpr int kHd = 64;  // head_dim

}  // namespace

// x, out: (B, S, C); wqkv: (3C, C) = [Wq; Wk; Wv] (out, in); wo: (C, C);
// bo: (C,); ln_w, ln_b: (C,) float32; qkv scratch (3, B, heads, S, 64);
// o scratch (B, S, C), which holds LN(x) until the attention writes o. All
// bf16 except the LayerNorm parameters.
PT_EXPORT int pt_attn_sublayer(const void* x, const float* ln_w, const float* ln_b, const void* wqkv,
                               const void* wo, const void* bo, void* qkv, void* o, void* out, long long b,
                               long long s, int c, int heads, float eps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t m = b * s;
  int err = gemm::rows_prologue<gemm::projection_gemm>(x, nullptr, 1, 1, ln_w, ln_b, eps, o, nullptr, m, c, st);
  gemm::Epilogue ep = gemm::epilogue(gemm::kHeads);
  ep.s = static_cast<int>(s);
  ep.c = c;
  if (!err) err = gemm::linear<gemm::projection_gemm>(o, wqkv, qkv, nullptr, ep, m, 3 * c, c, st);
  if (err) return err;

  const int64_t head_elems = b * heads * s * kHd;
  const bf16* qp = static_cast<const bf16*>(qkv);
  const Layout lqkv{heads * s * kHd, s * kHd, kHd}, lo{s * c, kHd, c};
  err = flash_forward(kHd, qp, qp + head_elems, qp + 2 * head_elems, o, nullptr, lqkv, lqkv, lqkv, lo, b, heads, s,
                      s, scale, st);
  if (err) return err;
  return gemm::linear<gemm::projection_gemm>(o, wo, out, x, gemm::epilogue(gemm::kBiasResidual, bo), m, c, c, st);
}

// out (M, N) = a (M, K) @ w (N, K)^T [+ bias (N,)] [+ residual (M, N)], all
// bf16; K % 8 == 0 and N % 8 == 0.
PT_EXPORT int pt_gemm(const void* a, const void* w, const void* bias, const void* residual, void* out, long long m,
                      int n, int k, void* stream) {
  const int mode = bias == nullptr && residual == nullptr ? gemm::kStore : gemm::kBiasResidual;
  return gemm::linear<gemm::projection_gemm>(a, w, out, residual, gemm::epilogue(mode, bias), m, n, k,
                                             static_cast<cudaStream_t>(stream));
}
