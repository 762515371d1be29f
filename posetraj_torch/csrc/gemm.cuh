// Tensor-core GEMM with an optional LayerNorm prologue and a fused
// epilogue, shared by the spatial (qkvt.cu) and temporal (temporal.cu)
// attention sub-layers:
//   out[m, n] = epilogue( LN(A)[m, :] . W[n, :] ),   A (M, K), W (N, K), bf16
// epilogues: store natural (M, N); scatter to per-head (3, B, H, S, 64) q/k/v;
// or + bias[n] + residual[m, n]. Float32 accumulation (WMMA bf16).
//
// Tiles: 128 x 64 output per block, K in steps of 64, 8 warps of 32 x 32,
// a 3-stage cp.async pipeline for the A and W tiles. With LayerNorm, a
// small kernel first computes each row's mean and rstd (float32, two
// passes); the GEMM then normalises each staged A tile in shared memory
// before its products, so the normalised activation never reaches device
// memory.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace gemm {

using namespace nvcuda;

constexpr int BM = 128, BN = 64, BK = 64, PAD = 8, STAGES = 3;
constexpr int LDS = BK + PAD;  // smem row of a staged tile (bf16)
constexpr int kWarps = 8, kThreads = 256;
constexpr size_t kStageElems = static_cast<size_t>(BM + BN) * LDS;
constexpr size_t kSmem = sizeof(bf16) * STAGES * kStageElems + sizeof(float) * kWarps * 256;

enum Epilogue { kStore = 0, kHeads = 1, kBiasResidual = 2 };

struct Args {
  const bf16* a;        // (M, K)
  const bf16* w;        // (N, K)
  const float* ln_w;    // (K,) or null: no LayerNorm
  const float* ln_b;
  const float2* stats;  // (M,) row (mean, rstd) when ln_w is set
  const bf16* bias;     // (N,) or null
  const bf16* residual; // (M, N) or null
  bf16* out;
  int64_t m;
  int n, k;
  int mode;
  // kHeads: out is (3, B, heads, S, head_dim) with row m = b * S + s and
  // column n = which * C + head * head_dim + d.
  int64_t s;
  int heads, head_dim;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One warp per row: mean and rstd of A's row in float32, two passes.
__global__ void row_stats(const bf16* __restrict__ a, float2* __restrict__ stats, int64_t m, int k, float eps) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const bf16* r = a + row * k;
  float sum = 0.f;
  for (int c = lane; c < k; c += 32) sum += to_f32(r[c]);
  const float mean = warp_sum(sum) / k;
  float var = 0.f;
  for (int c = lane; c < k; c += 32) {
    const float d = to_f32(r[c]) - mean;
    var += d * d;
  }
  const float rstd = rsqrtf(warp_sum(var) / k + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

__device__ __forceinline__ void issue_stage(const Args& p, bf16* st, int64_t m0, int n0, int k0) {
  bf16* As = st;
  bf16* Bs = st + BM * LDS;
  // A: 128 x 64 = 1024 vectors of 8; W: 64 x 64 = 512 vectors.
  for (int v = threadIdx.x; v < (BM + BN) * (BK / 8); v += kThreads) {
    const int r = v / (BK / 8), cv = v % (BK / 8);
    if (r < BM) {
      const int64_t gr = m0 + r;
      const bool valid = gr < p.m;
      cp_async16(As + r * LDS + cv * 8, p.a + (valid ? gr * p.k + k0 + cv * 8 : 0), valid);
    } else {
      const int rb = r - BM;
      cp_async16(Bs + rb * LDS + cv * 8, p.w + static_cast<int64_t>(n0 + rb) * p.k + k0 + cv * 8, true);
    }
  }
}

__global__ void __launch_bounds__(kThreads) gemm_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(smem_raw + sizeof(bf16) * STAGES * kStageElems);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int nk = p.k / BK;

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) issue_stage(p, stages + s * kStageElems, m0, n0, s * BK);
    cp_async_commit();
  }

  const int wm = warp / 2, wn = warp % 2;  // warp tile at rows wm*32, cols wn*32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    bf16* st = stages + (kt % STAGES) * kStageElems;
    bf16* As = st;
    const bf16* Bs = st + BM * LDS;
    if (p.ln_w != nullptr) {
      const int k0 = kt * BK;
      for (int v = tid; v < BM * (BK / 8); v += kThreads) {
        const int r = v / (BK / 8), cv = v % (BK / 8);
        const int64_t gr = m0 + r;
        if (gr >= p.m) continue;
        const float2 ms = p.stats[gr];
        Vec16<bf16> x = load16(As + r * LDS + cv * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = k0 + cv * 8 + e;
          x.set(e, (x.get(e) - ms.x) * ms.y * p.ln_w[c] + p.ln_b[c]);
        }
        store16(As + r * LDS + cv * 8, x);
      }
      __syncthreads();
    }
    // Refill the slot consumed in the previous step (every thread is past
    // the barrier above, so no warp still reads it).
    const int next = kt + STAGES - 1;
    if (next < nk) issue_stage(p, stages + (next % STAGES) * kStageElems, m0, n0, next * BK);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue, one 16x16 fragment at a time through a per-warp scratch tile;
  // each lane writes 8 consecutive columns of one row (16 bytes).
  float* sc = scratch + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t gr = m0 + wm * 32 + i * 16 + r;
      const int col = n0 + wn * 32 + j * 16 + c0;
      if (gr < p.m) {
        Vec16<bf16> o;
        if (p.mode == kBiasResidual) {
          Vec16<bf16> res{};
          if (p.residual != nullptr) res = load16(p.residual + gr * p.n + col);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float v = sc[r * 16 + c0 + e];
            if (p.bias != nullptr) v += to_f32(p.bias[col + e]);
            if (p.residual != nullptr) v += res.get(e);
            o.set(e, v);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) o.set(e, sc[r * 16 + c0 + e]);
        }
        int64_t dst;
        if (p.mode == kHeads) {
          const int c = p.n / 3;
          const int which = col / c, h = (col % c) / p.head_dim, d = col % p.head_dim;
          const int64_t b = gr / p.s, s = gr % p.s;
          const int64_t batches = p.m / p.s;
          dst = (((static_cast<int64_t>(which) * batches + b) * p.heads + h) * p.s + s) * p.head_dim + d;
        } else {
          dst = gr * p.n + col;
        }
        store16(p.out + dst, o);
      }
      __syncwarp();
    }
  }
}

// Requires N % 64 == 0, K % 64 == 0 (and head_dim % 8 == 0 for kHeads);
// checked by the Python wrappers. `stats` is (M,) float2 scratch, used when
// ln_w is set.
inline int launch(Args p, float2* stats, float eps, cudaStream_t stream) {
  if (p.ln_w != nullptr) {
    const int rows_per_block = 8;
    row_stats<<<static_cast<unsigned>((p.m + rows_per_block - 1) / rows_per_block), rows_per_block * 32, 0,
                stream>>>(p.a, stats, p.m, p.k, eps);
    p.stats = stats;
  }
  int err = set_smem(reinterpret_cast<const void*>(gemm_kernel), kSmem);
  if (err) return err;
  dim3 grid(p.n / BN, static_cast<unsigned>((p.m + BM - 1) / BM));
  gemm_kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return 0;
}

inline Args make_args(const void* a, const void* w, const float* ln_w, const float* ln_b, void* out, int64_t m,
                      int n, int k, int mode) {
  Args p{};
  p.a = static_cast<const bf16*>(a);
  p.w = static_cast<const bf16*>(w);
  p.ln_w = ln_w;
  p.ln_b = ln_b;
  p.out = static_cast<bf16*>(out);
  p.m = m;
  p.n = n;
  p.k = k;
  p.mode = mode;
  return p;
}

}  // namespace gemm
