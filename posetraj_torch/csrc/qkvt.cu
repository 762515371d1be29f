// Kernel C: the spatial self-attention sub-layer,
//   out = x + to_out(MHA(LN(x))),  x (B, S, C) bf16, head_dim 64,
// in four launches:
//   1. row LayerNorm statistics, then the GEMM LN(x) @ Wqkv^T with the
//      normalisation applied to each staged tile, scattered to per-head q,
//      k, v, each (B, heads, S, 64) contiguous (gemm.cuh);
//   2. flash-attention forward (below): one block of 8 warps per 128 queries
//      of one (batch, head), looping over 64-key tiles with an online
//      softmax; K/V tiles double-buffered in shared memory by cp.async;
//   3. GEMM o @ Wo^T + bo + x, the residual fused into the epilogue.
//
// Replaces posetraj_tpu/ops/pallas_qkvt.py:attn_sublayer (ln_qkvt_proj,
// qkvt_attention/_qkvt_attn_kernel and out_proj_res). The TPU version's
// transposed (B, 3C, S) layout exists for Mosaic's lane rule; here q/k/v are
// head-major rows that a block reads as contiguous 8 KB tiles.
//
// Bound on the H100: operations. At S = 9216 the attention core does
// 4*S^2*64 multiply-adds per (batch, head) against 4*S*64*2 bytes of q/k/v/o;
// the (S, S) logits live only in registers. Softmax: exact online softmax in
// base 2 (the row max is subtracted; log2(e) is folded into the logit scale),
// float32 statistics and accumulators, P rounded to bf16 for the P@V product
// as the reference rounds its probabilities. A ragged S is masked: keys past
// S get -inf logits and queries past S are not stored, so S = 2880 (the
// 320x576 level 0) runs through the same kernel.
//
// Tensor cores through mma.sync m16n8k16 (bf16 -> f32), operands loaded by
// ldmatrix (V transposed on the fly), so the softmax works on the logits in
// registers; wgmma and TMA are the work of a later change.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kHd = 64;       // head_dim
constexpr int kBq = 128;      // queries per block (16 per warp)
constexpr int kBk = 64;       // keys per tile
constexpr int kWarps = kBq / 16;
constexpr int kLd = kHd + 8;  // padded smem row (bf16): 144 bytes, ldmatrix conflict-free
constexpr size_t kSmem = sizeof(bf16) * (kBq + 4 * kBk) * kLd;  // Q + double-buffered K, V

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + rows) of a (S, 64) bf16 matrix into smem (row stride
// kLd) with cp.async; rows past S are zero-filled.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row0, int rows, int64_t s) {
  for (int v = threadIdx.x; v < rows * (kHd / 8); v += blockDim.x) {
    const int r = v / (kHd / 8), cv = v % (kHd / 8);
    const bool valid = row0 + r < s;
    cp_async16(dst + r * kLd + cv * 8, src + (valid ? (row0 + r) * kHd + cv * 8 : 0), valid);
  }
}

// q, k, v: (BH, S, 64); o: (B, S, C) with head h at columns [64h, 64h+64).
__global__ void __launch_bounds__(kWarps * 32) flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                         const bf16* __restrict__ v, bf16* __restrict__ o,
                                                         int64_t s, int heads, int c, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBq * kLd;          // [2][kBk][kLd]
  bf16* Vs = Ks + 2 * kBk * kLd;      // [2][kBk][kLd]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix index, row within it
  const int64_t bh = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBq;
  const bf16* qb = q + bh * s * kHd;
  const bf16* kb = k + bh * s * kHd;
  const bf16* vb = v + bh * s * kHd;
  const int n_tiles = static_cast<int>((s + kBk - 1) / kBk);

  load_rows(Qs, qb, q0, kBq, s);
  load_rows(Ks, kb, 0, kBk, s);
  load_rows(Vs, vb, 0, kBk, s);
  cp_async_commit();

  uint32_t qa[4][4];
  float oacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8 of this warp
  float l_lo = 0.f, l_hi = 0.f;               // this thread's partial row sums
  const int qr = warp * 16;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    // Prefetch tile j+1 into the other buffer, then wait for tile j.
    if (j + 1 < n_tiles) {
      load_rows(Ks + (buf ^ 1) * kBk * kLd, kb, static_cast<int64_t>(j + 1) * kBk, kBk, s);
      load_rows(Vs + (buf ^ 1) * kBk * kLd, vb, static_cast<int64_t>(j + 1) * kBk, kBk, s);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldmatrix_x4(qa[kc], Qs + (qr + (mi & 1) * 8 + mr) * kLd + kc * 16 + (mi >> 1) * 8);
    }
    const bf16* Kt = Ks + buf * kBk * kLd;
    const bf16* Vt = Vs + buf * kBk * kLd;

    float sacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (np * 16 + (mi >> 1) * 8 + mr) * kLd + kc * 16 + (mi & 1) * 8);
        mma16816(sacc[2 * np], qa[kc], b[0], b[1]);
        mma16816(sacc[2 * np + 1], qa[kc], b[2], b[3]);
      }
    }
    // Scale into the log2 domain; mask keys past S on the last tile.
    const int64_t k0 = static_cast<int64_t>(j) * kBk;
    const bool ragged = k0 + kBk > s;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = sacc[nt][e] * scale_log2;
        if (ragged && k0 + nt * 8 + 2 * t + (e & 1) >= s) val = -INFINITY;
        sacc[nt][e] = val;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = fast_exp2(m_lo - mn_lo), al_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sacc[nt][0] = fast_exp2(sacc[nt][0] - mn_lo);
      sacc[nt][1] = fast_exp2(sacc[nt][1] - mn_lo);
      sacc[nt][2] = fast_exp2(sacc[nt][2] - mn_hi);
      sacc[nt][3] = fast_exp2(sacc[nt][3] - mn_hi);
      ps_lo += sacc[nt][0] + sacc[nt][1];
      ps_hi += sacc[nt][2] + sacc[nt][3];
    }
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      oacc[dt][0] *= al_lo;
      oacc[dt][1] *= al_lo;
      oacc[dt][2] *= al_hi;
      oacc[dt][3] *= al_hi;
    }
    // O += P @ V: the logits' accumulator layout is the A-operand layout.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kc][0], sacc[2 * kc][1]);
      pa[1] = pack_bf16(sacc[2 * kc][2], sacc[2 * kc][3]);
      pa[2] = pack_bf16(sacc[2 * kc + 1][0], sacc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kc + 1][2], sacc[2 * kc + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + (kc * 16 + (mi & 1) * 8 + mr) * kLd + dp * 16 + (mi >> 1) * 8);
        mma16816(oacc[2 * dp], pa, b[0], b[1]);
        mma16816(oacc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int64_t b = bh / heads;
  const int h = static_cast<int>(bh % heads);
  const int64_t row_lo = q0 + qr + g, row_hi = row_lo + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = h * kHd + dt * 8 + 2 * t;
    if (row_lo < s)
      *reinterpret_cast<__nv_bfloat162*>(o + (b * s + row_lo) * c + col) =
          __floats2bfloat162_rn(oacc[dt][0] * inv_lo, oacc[dt][1] * inv_lo);
    if (row_hi < s)
      *reinterpret_cast<__nv_bfloat162*>(o + (b * s + row_hi) * c + col) =
          __floats2bfloat162_rn(oacc[dt][2] * inv_hi, oacc[dt][3] * inv_hi);
  }
}

}  // namespace

// x, out: (B, S, C); wqkv: (3C, C) = [Wq; Wk; Wv] (out, in); wo: (C, C);
// bo: (C,); ln_w, ln_b: (C,) float32; qkv scratch (3, B, heads, S, 64);
// o scratch (B, S, C); stats scratch (B*S, 2) float32. All bf16 except the
// LayerNorm parameters and stats.
PT_EXPORT int pt_attn_sublayer(const void* x, const float* ln_w, const float* ln_b, const void* wqkv,
                               const void* wo, const void* bo, void* qkv, void* o, float* stats, void* out,
                               long long b, long long s, int c, int heads, float eps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t m = b * s;
  gemm::Args p1 = gemm::make_args(x, wqkv, ln_w, ln_b, qkv, m, 3 * c, c, gemm::kHeads);
  p1.s = s;
  p1.heads = heads;
  p1.head_dim = kHd;
  int err = gemm::launch(p1, reinterpret_cast<float2*>(stats), eps, st);
  if (err) return err;

  const int64_t head_elems = b * heads * s * kHd;
  const bf16* qp = static_cast<const bf16*>(qkv);
  dim3 grid(static_cast<unsigned>((s + kBq - 1) / kBq), static_cast<unsigned>(b * heads));
  err = set_smem(reinterpret_cast<const void*>(flash_fwd), kSmem);
  if (err) return err;
  flash_fwd<<<grid, kWarps * 32, kSmem, st>>>(qp, qp + head_elems, qp + 2 * head_elems, static_cast<bf16*>(o), s,
                                              heads, c, scale * 1.4426950408889634f);

  gemm::Args p3 = gemm::make_args(o, wo, nullptr, nullptr, out, m, c, c, gemm::kBiasResidual);
  p3.bias = static_cast<const bf16*>(bo);
  p3.residual = static_cast<const bf16*>(x);
  err = gemm::launch(p3, nullptr, 0.f, st);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
