// Kernel D: the temporal (frame-axis) self-attention sub-layer,
//   out = x + to_out(frame_attention(LN(x))),  x (B, F, S, C) bf16,
// attention over the F frames of each pixel, head_dim 64, in four launches:
//   1. row LayerNorm statistics, then the GEMM LN(x) @ Wqkv^T -> qkv
//      (B, F, S, 3C), normalised tile by tile in shared memory (gemm.cuh);
//   2. frame attention (below): one warp per (batch, pixel, head) loads the
//      F x 64 q, k and v rows, computes the F x F logits, an exact float32
//      softmax and P @ V, and writes o (B, F, S, C);
//   3. GEMM o @ Wo^T + bo + x, the residual fused into the epilogue.
//
// Replaces posetraj_tpu/ops/pallas_temporal.py:temporal_attn_sublayer
// (ln_qkvt_proj4, frame_attention_t/_frame_attn_kernel and out_proj_res4).
//
// Bound on the H100: the two projections are operation-bound GEMMs; the
// frame attention is bytes-bound (F = 14: ~2*14*64 multiply-adds per 2-byte
// element read), so it reads q/k/v once, coalesced (a warp reads each
// 128-byte head row in one transaction), keeps the F x F logits in shared
// memory, and writes o once. Its shared-memory tiles are sized from bytes:
// the warps per block are chosen so that per-warp q/k/v/logit tiles
// (4 * (3 * F * 65 + F * F) bytes, rows padded against bank conflicts) fit
// 48 KB; the TPU version once overflowed
// its scoped VMEM by guessing a block size instead.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kHd = 64;
constexpr int kLd = kHd + 1;  // padded smem row: lanes reading rows i != j hit distinct banks

__host__ __device__ inline int warp_floats(int f) { return 3 * f * kLd + f * f; }

// qkv: (B, F, S, 3C); o: (B, F, S, C). Work item w = (b * S + s) * heads + h.
__global__ void frame_attn(const bf16* __restrict__ qkv, bf16* __restrict__ o, int64_t b_n, int f, int64_t s,
                           int c, int heads, float scale_log2) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpb = blockDim.x / 32;
  float* qs = smem + warp * warp_floats(f);
  float* ks = qs + f * kLd;
  float* vs = ks + f * kLd;
  float* p = vs + f * kLd;
  const int64_t items = b_n * s * heads;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * wpb + warp; w < items;
       w += static_cast<int64_t>(gridDim.x) * wpb) {
    const int h = static_cast<int>(w % heads);
    const int64_t pix = w / heads;  // b * S + s
    const int64_t b = pix / s, sp = pix % s;
    for (int i = 0; i < f; ++i) {
      const bf16* row = qkv + ((b * f + i) * s + sp) * 3 * c + h * kHd + 2 * lane;
      const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row));
      const float2 kv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
      const float2 vv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + 2 * c));
      qs[i * kLd + 2 * lane] = qv.x * scale_log2;
      qs[i * kLd + 2 * lane + 1] = qv.y * scale_log2;
      ks[i * kLd + 2 * lane] = kv.x;
      ks[i * kLd + 2 * lane + 1] = kv.y;
      vs[i * kLd + 2 * lane] = vv.x;
      vs[i * kLd + 2 * lane + 1] = vv.y;
    }
    __syncwarp();
    for (int e = lane; e < f * f; e += 32) {
      const int i = e / f, j = e % f;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHd; ++d) acc += qs[i * kLd + d] * ks[j * kLd + d];
      p[e] = acc;
    }
    __syncwarp();
    if (lane < f) {
      float mx = -INFINITY;
      for (int j = 0; j < f; ++j) mx = fmaxf(mx, p[lane * f + j]);
      float sum = 0.f;
      for (int j = 0; j < f; ++j) {
        const float ex = exp2f(p[lane * f + j] - mx);
        p[lane * f + j] = ex;
        sum += ex;
      }
      const float inv = 1.f / sum;
      for (int j = 0; j < f; ++j) p[lane * f + j] *= inv;
    }
    __syncwarp();
    for (int i = 0; i < f; ++i) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < f; ++j) {
        const float pj = p[i * f + j];
        a0 += pj * vs[j * kLd + 2 * lane];
        a1 += pj * vs[j * kLd + 2 * lane + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(o + ((b * f + i) * s + sp) * c + h * kHd + 2 * lane) =
          __floats2bfloat162_rn(a0, a1);
    }
    __syncwarp();
  }
}

}  // namespace

// x, out: (B, F, S, C); wqkv: (3C, C); wo: (C, C); bo: (C,); ln_w, ln_b: (C,)
// float32; qkv scratch (B, F, S, 3C); o scratch (B, F, S, C); stats scratch
// (B*F*S, 2) float32. Requires head_dim 64 and F <= 32 (checked by the
// Python wrapper).
PT_EXPORT int pt_temporal_sublayer(const void* x, const float* ln_w, const float* ln_b, const void* wqkv,
                                   const void* wo, const void* bo, void* qkv, void* o, float* stats, void* out,
                                   long long b, int f, long long s, int c, int heads, float eps, float scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t m = b * f * s;
  int err = gemm::launch(gemm::make_args(x, wqkv, ln_w, ln_b, qkv, m, 3 * c, c, gemm::kStore),
                         reinterpret_cast<float2*>(stats), eps, st);
  if (err) return err;

  const size_t per_warp = sizeof(float) * warp_floats(f);
  int wpb = static_cast<int>((48 * 1024) / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
  const int64_t items = b * s * heads;
  const int64_t want = (items + wpb - 1) / wpb;
  const int64_t blocks = want < 132 * 64 ? want : 132 * 64;
  frame_attn<<<static_cast<unsigned>(blocks), wpb * 32, wpb * per_warp, st>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(o), b, f, s, c, heads, scale * 1.4426950408889634f);

  gemm::Args p3 = gemm::make_args(o, wo, nullptr, nullptr, out, m, c, c, gemm::kBiasResidual);
  p3.bias = static_cast<const bf16*>(bo);
  p3.residual = static_cast<const bf16*>(x);
  err = gemm::launch(p3, nullptr, 0.f, st);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
