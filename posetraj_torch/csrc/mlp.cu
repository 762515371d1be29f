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
// 1280, hidden 4K) it does 12*K^2 multiply-adds per row against ~4K bytes of
// activation traffic per row, well above the card's ~295 operations per
// byte, so the (rows, 4K) gated intermediate must never reach device memory
// (that round trip is what the unfused version pays). The design: one block
// owns BM rows and ALL K_out output columns, so the hidden axis is a loop
// inside the block:
//   prologue  xa = x + add (in bf16, as the reference rounds it), row
//             LayerNorm in float32, the normalised tile kept in shared memory;
//   loop over 64-wide hidden blocks:
//     A, G tiles = xn @ W1[blk]^T          (tensor cores, WMMA bf16 -> f32)
//     u = (A + b1a) * gelu_erf(G + b1g)    (float32, erff; rounded to bf16)
//     acc += u @ W2[:, blk]^T              (accumulator in registers)
//   epilogue  out = acc + b2 [+ xa], written once.
// BM is 64 rows at K_out <= 320 and 32 above; the register accumulator is
// 10 fragments a warp, 20 at K_out = 1280. Weight tiles are
// staged in shared memory by cp.async (W1 double-buffered in 64-column
// tiles, W2's 64 hidden columns in double-buffered 320-output-row chunks,
// the first fetched while A and G are computed);
// TMA and wgmma are the work of a later change.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 64;       // hidden columns per loop step (for A and for G)
constexpr int kBK = 64;       // K columns of W1 per staged tile
constexpr int kLdw = kBK + 8;  // padded smem row of a staged weight tile (bf16)
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int kOutChunk = 320;  // W2 output rows staged at a time

struct MlpArgs {
  const bf16* x;
  const bf16* w1;  // (2N, K): rows [A | G]
  const bf16* b1;  // (2N,)
  const bf16* w2;  // (K_out, N)
  const bf16* b2;  // (K_out,)
  const float* ln_w;  // (K,) or null: no LayerNorm
  const float* ln_b;
  const bf16* add;  // (G, S_a, K) or null
  bf16* out;        // (M, K_out)
  int64_t m;
  int k, n, k_out;
  int64_t rows_per_group;  // M / G
  int s_a;
  float eps;
  int residual;
};

__host__ __device__ constexpr size_t align128(size_t v) { return (v + 127) / 128 * 128; }

// Shared memory, in bytes from the start:
//   xs   (BM, K + 8)       bf16  normalised rows
//   w1s  2 x (128, 72)     bf16  double-buffered W1 tile: 64 A rows + 64 G rows
//   ag   (BM, 2*64 + 4)    f32   [A | G] before the gate
//   us   (BM, 72)          bf16  gated u
//   scratch 8 x (16, 16)   f32   epilogue staging, one tile per warp
//   w2s  (320, 72)         bf16  W2 columns of this hidden block, 320 output
//                                rows at a time; double-buffered when K_out
//                                > 320 and both buffers fit
template <int BM>
struct Smem {
  int k, k_out;
  __host__ __device__ size_t w1s() const { return align128(sizeof(bf16) * BM * (k + 8)); }
  __host__ __device__ size_t ag() const { return w1s() + align128(sizeof(bf16) * 2 * 2 * kBN * kLdw); }
  __host__ __device__ size_t us() const { return ag() + align128(sizeof(float) * BM * (2 * kBN + 4)); }
  __host__ __device__ size_t scratch() const { return us() + align128(sizeof(bf16) * BM * kLdw); }
  __host__ __device__ size_t w2s() const { return scratch() + align128(sizeof(float) * kWarps * 256); }
  __host__ __device__ static constexpr size_t w2_chunk() { return sizeof(bf16) * kOutChunk * kLdw; }
  __host__ __device__ int w2_bufs() const {
    return (k_out > kOutChunk && w2s() + 2 * w2_chunk() <= kMaxSmem) ? 2 : 1;
  }
  __host__ __device__ size_t total() const { return w2s() + w2_bufs() * w2_chunk(); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The addend row that row `row` of x takes: add[row / (M / G), row % S_a].
__device__ __forceinline__ const bf16* addend_row(const MlpArgs& a, int64_t row) {
  if (a.add == nullptr) return nullptr;
  return a.add + ((row / a.rows_per_group) * a.s_a + row % a.s_a) * a.k;
}

// W1 tile for hidden block j0, K columns [k0, k0 + 64): 64 A rows, 64 G rows.
__device__ __forceinline__ void stage_w1(bf16* dst, const MlpArgs& a, int j0, int k0) {
  for (int v = threadIdx.x; v < 2 * kBN * (kBK / 8); v += kThreads) {
    const int r = v / (kBK / 8), cv = v % (kBK / 8);
    const int64_t row = (r < kBN) ? (j0 + r) : (a.n + j0 + r - kBN);
    cp_async16(dst + r * kLdw + cv * 8, a.w1 + row * a.k + k0 + cv * 8);
  }
}

// W2 columns [j0, j0 + 64) of output rows [o0, o0 + rows).
__device__ __forceinline__ void stage_w2(bf16* dst, const MlpArgs& a, int j0, int o0, int rows) {
  for (int v = threadIdx.x; v < rows * (kBN / 8); v += kThreads) {
    const int r = v / (kBN / 8), cv = v % (kBN / 8);
    cp_async16(dst + r * kLdw + cv * 8, a.w2 + static_cast<int64_t>(o0 + r) * a.n + j0 + cv * 8);
  }
}

// BM rows per block; MAXF output accumulator fragments (16 x 16) per warp.
template <int BM, int MAXF>
__global__ void __launch_bounds__(kThreads, 1) mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<BM> lay{a.k, a.k_out};
  const int ldx = a.k + 8;
  constexpr int ldag = 2 * kBN + 4;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* w1s = reinterpret_cast<bf16*>(smem + lay.w1s());
  bf16* w2s = reinterpret_cast<bf16*>(smem + lay.w2s());
  const int w2_bufs = lay.w2_bufs();
  float* ag = reinterpret_cast<float*>(smem + lay.ag());
  bf16* us = reinterpret_cast<bf16*>(smem + lay.us());
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch());

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;

  // Prologue: xa = x + add rounded to bf16, then the row LayerNorm.
  for (int r = warp; r < BM; r += kWarps) {
    const int64_t gr = row0 + r;
    bf16* xrow = xs + r * ldx;
    if (gr >= a.m) {
      for (int c = lane; c < a.k; c += 32) xrow[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* arow = addend_row(a, gr);
    float sum = 0.f;
    for (int c = lane; c < a.k; c += 32) {
      const bf16 v = __float2bfloat16(to_f32(a.x[gr * a.k + c]) + (arow ? to_f32(arow[c]) : 0.f));
      xrow[c] = v;
      sum += to_f32(v);
    }
    if (a.ln_w != nullptr) {
      const float mean = warp_sum(sum) / a.k;
      float var = 0.f;
      for (int c = lane; c < a.k; c += 32) {
        const float d = to_f32(xrow[c]) - mean;
        var += d * d;
      }
      const float rstd = rsqrtf(warp_sum(var) / a.k + a.eps);
      for (int c = lane; c < a.k; c += 32)
        xrow[c] = __float2bfloat16((to_f32(xrow[c]) - mean) * rstd * a.ln_w[c] + a.ln_b[c]);
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.f);
  const int out_tiles_n = a.k_out / 16;
  constexpr int kRT = BM / 16;            // row tiles
  constexpr int kWarpsPerRow = kWarps / kRT;  // warps sharing one row tile
  const int nk = a.k / kBK;

  const int n_chunks = (a.k_out + kOutChunk - 1) / kOutChunk;
  const int chunk_rows0 = a.k_out < kOutChunk ? a.k_out : kOutChunk;
  for (int j0 = 0; j0 < a.n; j0 += kBN) {
    stage_w2(w2s, a, j0, 0, chunk_rows0);
    cp_async_commit();
    stage_w1(w1s, a, j0, 0);
    cp_async_commit();

    // [A | G] tiles for hidden columns [j0, j0 + 64), K in staged tiles.
    // Warp w owns row tile tm = w % RT and RT of the 8 [A | G] column tiles,
    // so each A fragment it loads feeds RT products.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kRT];
#pragma unroll
    for (int f = 0; f < kRT; ++f) wmma::fill_fragment(c[f], 0.f);
    const int tm_w = warp % kRT;
    const int col0 = (warp / kRT) * kRT;
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        stage_w1(w1s + ((kt + 1) & 1) * 2 * kBN * kLdw, a, j0, (kt + 1) * kBK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wt = w1s + (kt & 1) * 2 * kBN * kLdw;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, xs + tm_w * 16 * ldx + kt * kBK + kk, ldx);
#pragma unroll
        for (int f = 0; f < kRT; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, wt + (col0 + f) * 16 * kLdw + kk, kLdw);
          wmma::mma_sync(c[f], fa, fb, c[f]);
        }
      }
      __syncthreads();  // the tile is consumed before it is refilled
    }
#pragma unroll
    for (int f = 0; f < kRT; ++f)
      wmma::store_matrix_sync(ag + tm_w * 16 * ldag + (col0 + f) * 16, c[f], ldag, wmma::mem_row_major);
    __syncthreads();
    // u = (A + b1a) * gelu_erf(G + b1g), float32, rounded to bf16.
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = i / kBN;
      const int cc = i % kBN;
      const float av = ag[r * ldag + cc] + to_f32(a.b1[j0 + cc]);
      const float gv = ag[r * ldag + kBN + cc] + to_f32(a.b1[a.n + j0 + cc]);
      const float gelu = 0.5f * gv * (1.f + erff(gv * 0.70710678118654752f));
      us[r * kLdw + cc] = __float2bfloat16(av * gelu);
    }
    __syncthreads();
    // acc += u @ W2[:, j0:j0+64]^T, W2 staged 320 output rows at a time.
    for (int oc = 0; oc < n_chunks; ++oc) {
      const int o1 = (oc + 1) * kOutChunk;
      const int rows1 = a.k_out - o1 < kOutChunk ? a.k_out - o1 : kOutChunk;
      if (w2_bufs == 2) {  // prefetch the next chunk into the other buffer
        if (oc + 1 < n_chunks) {
          stage_w2(w2s + ((oc + 1) & 1) * kOutChunk * kLdw, a, j0, o1, rows1);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {  // one buffer: chunk 0 came with phase A, later ones load here
        if (oc > 0) {
          const int o0 = oc * kOutChunk;
          stage_w2(w2s, a, j0, o0, a.k_out - o0 < kOutChunk ? a.k_out - o0 : kOutChunk);
          cp_async_commit();
        }
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* wt = w2s + (w2_bufs == 2 ? (oc & 1) : 0) * kOutChunk * kLdw;
      const int tn0 = oc * (kOutChunk / 16);
#pragma unroll
      for (int kk = 0; kk < kBN; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, us + tm_w * 16 * kLdw + kk, kLdw);
#pragma unroll
        for (int f = 0; f < MAXF; ++f) {
          const int tn = warp / kRT + f * kWarpsPerRow;
          if (tn < out_tiles_n && tn >= tn0 && tn < tn0 + kOutChunk / 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, wt + (tn - tn0) * 16 * kLdw + kk, kLdw);
            wmma::mma_sync(acc[f], fa, fb, acc[f]);
          }
        }
      }
      __syncthreads();  // the chunk (and, after the last, `us`) is consumed before reuse
    }
  }

  // Epilogue: out = acc + b2 [+ xa].
  float* sc = scratch + warp * 256;
  const int tm = warp % kRT;
#pragma unroll
  for (int f = 0; f < MAXF; ++f) {
    const int tn = warp / kRT + f * kWarpsPerRow;
    if (tn < out_tiles_n) {
      wmma::store_matrix_sync(sc, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2;
      const int c0 = (lane % 2) * 8;
      const int64_t gr = row0 + tm * 16 + r;
      if (gr < a.m) {
        const bf16* arow = addend_row(a, gr);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = tn * 16 + c0 + e;
          float v = sc[r * 16 + c0 + e] + to_f32(a.b2[col]);
          if (a.residual)
            v += to_f32(__float2bfloat16(to_f32(a.x[gr * a.k + col]) + (arow ? to_f32(arow[col]) : 0.f)));
          a.out[gr * a.k_out + col] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

template <int BM, int MAXF>
int launch(const MlpArgs& a, cudaStream_t stream) {
  const size_t smem = Smem<BM>{a.k, a.k_out}.total();
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(mlp_kernel<BM, MAXF>), smem);
  if (err) return err;
  const int64_t blocks = (a.m + BM - 1) / BM;
  mlp_kernel<BM, MAXF><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Requires K % 64 == 0, N % 64 == 0, K_out % 16 == 0, K_out <= 1280
// (checked by the Python wrapper); residual requires K_out == K.
PT_EXPORT int pt_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                     const float* ln_w, const float* ln_b, const void* add, void* out, long long m, int k,
                     int n, int k_out, long long rows_per_group, int s_a, float eps, int residual,
                     void* stream) {
  MlpArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const bf16*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const bf16*>(b2);
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.add = static_cast<const bf16*>(add);
  a.out = static_cast<bf16*>(out);
  a.m = m;
  a.k = k;
  a.n = n;
  a.k_out = k_out;
  a.rows_per_group = rows_per_group;
  a.s_a = s_a;
  a.eps = eps;
  a.residual = residual;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_n = k_out / 16;
  // Rows per block as large as the register accumulator allows: 64 rows at
  // K_out <= 320, 32 rows above (20 fragments a warp at K_out = 1280).
  if (tiles_n <= 20) return launch<64, 10>(a, st);
  if (tiles_n <= 40) return launch<32, 10>(a, st);
  if (tiles_n <= 80) return launch<32, 20>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
