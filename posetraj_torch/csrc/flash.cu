// Kernel 5: differentiable flash attention over head-folded q (BN, Sq, d),
// k and v (BN, Skv, d), bf16, d in {64, 128}:
//   forward  o = softmax(q k^T * scale) v, and per query row the base-2
//            log-sum-exp lse = m + log2(l) of the logits scaled by
//            scale * log2(e) (float32, (BN, Sq));
//   backward delta = rowsum(o * do) (float32), then
//            p = exp2(q k^T * scale * log2(e) - lse), ds = p * (do v^T - delta),
//            dq = ds k * scale, dk = ds^T q * scale, dv = p^T do.
//
// Replaces posetraj_tpu/ops/pallas_attention.py:flash_attention_diff:
// _flash_fwd_lse (_flash_kernel_tq_lse), and the two kernels of _flash_bwd
// (_flash_bwd_dq_kernel, _flash_bwd_dkv_kernel). The TPU forward works on a
// transposed (d, bq) layout for its lane rule; here every operand stays
// row-major (rows of d contiguous bf16), which is what ldmatrix wants.
//
// Bound on the H100: operations. The forward does 4*Sq*Skv*d and the
// backward 10*Sq*Skv*d multiply-adds per fold against O((Sq + Skv) * d)
// bytes; the (Sq, Skv) logits and probabilities live only in registers.
// Design: one block of 8 warps per 128 rows (queries for the forward and
// dq, keys for dk/dv); each warp owns 16 rows and loops over tiles of the
// other side, double-buffered in shared memory by cp.async. Products are
// mma.sync m16n8k16 (bf16 operands, float32 accumulators); an accumulator
// (logits, probabilities, ds) becomes the A operand of the next product in
// registers (mma.cuh). P and dS are rounded to bf16 for their products, as
// the forward rounds P for P @ V. dk/dv are summed by the block that owns
// the keys, so no atomics. Ragged edges: keys >= Skv get p = 0 in the
// forward and dq; query rows >= Sq get p = 0 in dk/dv, so padded rows add
// nothing; rows past the end are zero-filled on load and never stored.
// wgmma and TMA are the work of a later change.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // rows a block owns: queries (fwd, dq) or keys (dk/dv)

template <int HD>
struct Tile {
  static constexpr int kLd = HD + 8;               // padded smem row: ldmatrix without bank conflicts
  static constexpr int kCols = HD == 64 ? 64 : 32;  // tile of the other side per loop step
  static constexpr size_t kFwdSmem = sizeof(bf16) * (kRows + 4 * kCols) * kLd;
  static constexpr size_t kDqSmem = sizeof(bf16) * (2 * kRows + 4 * kCols) * kLd;
  static constexpr size_t kDkvSmem = sizeof(bf16) * (2 * kRows + 4 * kCols) * kLd + sizeof(float) * 4 * kCols;
};

// Rows [row0, row0 + rows) of an (S, HD) bf16 matrix into smem with row
// stride HD + 8, by cp.async; rows past S are zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row0, int rows, int64_t s) {
  constexpr int kV = HD / 8;
  for (int v = threadIdx.x; v < rows * kV; v += blockDim.x) {
    const int r = v / kV, cv = v % kV;
    const bool valid = row0 + r < s;
    cp_async16(dst + r * (HD + 8) + cv * 8, src + (valid ? (row0 + r) * HD + cv * 8 : 0), valid);
  }
}

// S = A B^T for one warp: 16 rows of A (registers, HD/16 k-chunks) against
// the kCols rows of a [n][k] smem tile.
template <int HD, int N>
__device__ __forceinline__ void rows_times_tile(float (*acc)[4], uint32_t (*a)[4], const bf16* tile) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int np = 0; np < N / 16; ++np) {
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t b[4];
      load_b_nk(b, tile, HD + 8, np * 16, kc * 16);
      mma16816(acc[2 * np], a[kc], b[0], b[1]);
      mma16816(acc[2 * np + 1], a[kc], b[2], b[3]);
    }
  }
}

// out (16 x HD) += P (16 x N, accumulator layout, rounded to bf16) @ tile,
// where the smem tile is stored [N][HD].
template <int HD, int N>
__device__ __forceinline__ void acc_times_tile(float (*out)[4], float (*p)[4], const bf16* tile) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    uint32_t pa[4];
    pack_a(pa, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      load_b_kn(b, tile, HD + 8, kc * 16, dp * 16);
      mma16816(out[2 * dp], pa, b[0], b[1]);
      mma16816(out[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

// Stores the warp's 16 x HD accumulator times `mul` as bf16 rows
// [r0, r0 + 16) of an (S, HD) matrix; rows >= s are skipped.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, float (*acc)[4], int64_t r0, int64_t s, float mul_lo,
                                           float mul_hi) {
  const int lane = threadIdx.x & 31, g = lane / 4, t = lane % 4;
  const int64_t lo = r0 + g, hi = lo + 8;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (lo < s)
      *reinterpret_cast<__nv_bfloat162*>(dst + lo * HD + col) =
          __floats2bfloat162_rn(acc[dt][0] * mul_lo, acc[dt][1] * mul_lo);
    if (hi < s)
      *reinterpret_cast<__nv_bfloat162*>(dst + hi * HD + col) =
          __floats2bfloat162_rn(acc[dt][2] * mul_hi, acc[dt][3] * mul_hi);
  }
}

// ---------------------------------------------------------------------------
// Forward: o and the base-2 lse. Grid (ceil(Sq / 128), BN).
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                         const bf16* __restrict__ v, bf16* __restrict__ o,
                                                         float* __restrict__ lse, int64_t sq, int64_t skv, float c) {
  constexpr int kLd = HD + 8, kN = Tile<HD>::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kRows * kLd;   // [2][kN][kLd]
  bf16* Vs = Ks + 2 * kN * kLd;  // [2][kN][kLd]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t bn = blockIdx.y, q0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const bf16* qb = q + bn * sq * HD;
  const bf16* kb = k + bn * skv * HD;
  const bf16* vb = v + bn * skv * HD;
  const int n_tiles = static_cast<int>((skv + kN - 1) / kN);
  const int qr = warp * 16;

  load_rows<HD>(Qs, qb, q0, kRows, sq);
  load_rows<HD>(Ks, kb, 0, kN, skv);
  load_rows<HD>(Vs, vb, 0, kN, skv);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  float oacc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8 of this warp
  float l_lo = 0.f, l_hi = 0.f;               // this thread's partial row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<HD>(Ks + (buf ^ 1) * kN * kLd, kb, static_cast<int64_t>(j + 1) * kN, kN, skv);
      load_rows<HD>(Vs + (buf ^ 1) * kN * kLd, vb, static_cast<int64_t>(j + 1) * kN, kN, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) load_a(qa[kc], Qs, kLd, qr, kc * 16);
    }
    float s[kN / 8][4];
    rows_times_tile<HD, kN>(s, qa, Ks + buf * kN * kLd);

    // Into the log2 domain; keys past Skv get -inf.
    const int64_t k0 = static_cast<int64_t>(j) * kN;
    const bool ragged = k0 + kN > skv;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * c;
        if (ragged && k0 + nt * 8 + 2 * t + (e & 1) >= skv) val = -INFINITY;
        s[nt][e] = val;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // Tile 0 holds at least one valid key, so the running max is finite
    // from then on and exp2(-inf - m) is 0, never NaN.
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = fast_exp2(m_lo - mn_lo), al_hi = fast_exp2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      s[nt][0] = fast_exp2(s[nt][0] - mn_lo);
      s[nt][1] = fast_exp2(s[nt][1] - mn_lo);
      s[nt][2] = fast_exp2(s[nt][2] - mn_hi);
      s[nt][3] = fast_exp2(s[nt][3] - mn_hi);
      ps_lo += s[nt][0] + s[nt][1];
      ps_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      oacc[dt][0] *= al_lo;
      oacc[dt][1] *= al_lo;
      oacc[dt][2] *= al_hi;
      oacc[dt][3] *= al_hi;
    }
    acc_times_tile<HD, kN>(oacc, s, Vs + buf * kN * kLd);
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const int64_t row0 = q0 + qr;
  store_rows<HD>(o + bn * sq * HD, oacc, row0, sq, 1.f / l_lo, 1.f / l_hi);
  if (t == 0) {
    if (row0 + g < sq) lse[bn * sq + row0 + g] = m_lo + log2f(l_lo);
    if (row0 + g + 8 < sq) lse[bn * sq + row0 + g + 8] = m_hi + log2f(l_hi);
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(o * do) in float32: HD/8 lanes per row, 16 bytes each.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void flash_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ delta,
                            int64_t rows) {
  constexpr int kL = HD / 8;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / kL;
  const int part = static_cast<int>(tid % kL);
  float acc = 0.f;
  if (row < rows) {
    const Vec16<bf16> a = load16(o + row * HD + part * 8), b = load16(dout + row * HD + part * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += a.get(i) * b.get(i);
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// dq: one block per (fold, 128 queries), looping over key tiles.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int64_t sq, int64_t skv, float c, float scale) {
  constexpr int kLd = HD + 8, kN = Tile<HD>::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + kRows * kLd;   // dO rows
  bf16* Ks = Ds + kRows * kLd;   // [2][kN][kLd]
  bf16* Vs = Ks + 2 * kN * kLd;  // [2][kN][kLd]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int64_t bn = blockIdx.y, q0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const bf16* kb = k + bn * skv * HD;
  const bf16* vb = v + bn * skv * HD;
  const int n_tiles = static_cast<int>((skv + kN - 1) / kN);
  const int qr = warp * 16;
  const int64_t row_lo = q0 + qr + g, row_hi = row_lo + 8;
  // Rows past Sq: lse = delta = 0 with zero q and dO give ds = 0, not NaN.
  const float lse_lo = row_lo < sq ? lse[bn * sq + row_lo] : 0.f;
  const float lse_hi = row_hi < sq ? lse[bn * sq + row_hi] : 0.f;
  const float dl_lo = row_lo < sq ? delta[bn * sq + row_lo] : 0.f;
  const float dl_hi = row_hi < sq ? delta[bn * sq + row_hi] : 0.f;

  load_rows<HD>(Qs, q + bn * sq * HD, q0, kRows, sq);
  load_rows<HD>(Ds, dout + bn * sq * HD, q0, kRows, sq);
  load_rows<HD>(Ks, kb, 0, kN, skv);
  load_rows<HD>(Vs, vb, 0, kN, skv);
  cp_async_commit();

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<HD>(Ks + (buf ^ 1) * kN * kLd, kb, static_cast<int64_t>(j + 1) * kN, kN, skv);
      load_rows<HD>(Vs + (buf ^ 1) * kN * kLd, vb, static_cast<int64_t>(j + 1) * kN, kN, skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
        load_a(qa[kc], Qs, kLd, qr, kc * 16);
        load_a(da[kc], Ds, kLd, qr, kc * 16);
      }
    }
    const bf16* Kt = Ks + buf * kN * kLd;
    float s[kN / 8][4], dp[kN / 8][4];
    rows_times_tile<HD, kN>(s, qa, Kt);
    rows_times_tile<HD, kN>(dp, da, Vs + buf * kN * kLd);
    const int64_t k0 = static_cast<int64_t>(j) * kN;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float p = k0 + nt * 8 + 2 * t + (e & 1) < skv ? fast_exp2(s[nt][e] * c - (lo ? lse_lo : lse_hi)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (lo ? dl_lo : dl_hi));  // ds
      }
    }
    acc_times_tile<HD, kN>(acc, s, Kt);
    __syncthreads();
  }
  store_rows<HD>(dq + bn * sq * HD, acc, q0 + qr, sq, scale, scale);
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (fold, 128 keys), looping over query tiles.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
    flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int64_t sq, int64_t skv, float c, float scale) {
  constexpr int kLd = HD + 8, kN = Tile<HD>::kCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kRows * kLd;
  bf16* Qs = Vs + kRows * kLd;   // [2][kN][kLd]
  bf16* Ds = Qs + 2 * kN * kLd;  // [2][kN][kLd] dO rows
  float* Ls = reinterpret_cast<float*>(Ds + 2 * kN * kLd);  // [2][kN] lse
  float* Es = Ls + 2 * kN;                                   // [2][kN] delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int64_t bn = blockIdx.y, k0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const bf16* qb = q + bn * sq * HD;
  const bf16* db = dout + bn * sq * HD;
  const float* lb = lse + bn * sq;
  const float* eb = delta + bn * sq;
  const int n_tiles = static_cast<int>((sq + kN - 1) / kN);
  const int kr = warp * 16;

  // lse/delta of query tile i into buffer `buf` (plain stores: the buffer
  // was last read before the previous iteration's closing barrier).
  auto load_stats = [&](int buf, int64_t i0) {
    for (int r = threadIdx.x; r < kN; r += blockDim.x) {
      const bool valid = i0 + r < sq;
      Ls[buf * kN + r] = valid ? lb[i0 + r] : 0.f;
      Es[buf * kN + r] = valid ? eb[i0 + r] : 0.f;
    }
  };

  load_rows<HD>(Ks, k + bn * skv * HD, k0, kRows, skv);
  load_rows<HD>(Vs, v + bn * skv * HD, k0, kRows, skv);
  load_rows<HD>(Qs, qb, 0, kN, sq);
  load_rows<HD>(Ds, db, 0, kN, sq);
  cp_async_commit();
  load_stats(0, 0);

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) {
      const int64_t i1 = static_cast<int64_t>(i + 1) * kN;
      load_rows<HD>(Qs + (buf ^ 1) * kN * kLd, qb, i1, kN, sq);
      load_rows<HD>(Ds + (buf ^ 1) * kN * kLd, db, i1, kN, sq);
      cp_async_commit();
      load_stats(buf ^ 1, i1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * kN * kLd;
    const bf16* Dt = Ds + buf * kN * kLd;
    const float* Lt = Ls + buf * kN;
    const float* Et = Es + buf * kN;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys; the K and V
    // A fragments are read from smem per k-chunk to keep registers for the
    // two HD-wide accumulators.
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, kLd, kr, kc * 16);
      load_a(va, Vs, kLd, kr, kc * 16);
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t b[4];
        load_b_nk(b, Qt, kLd, np * 16, kc * 16);
        mma16816(s[2 * np], ka, b[0], b[1]);
        mma16816(s[2 * np + 1], ka, b[2], b[3]);
        load_b_nk(b, Dt, kLd, np * 16, kc * 16);
        mma16816(dp[2 * np], va, b[0], b[1]);
        mma16816(dp[2 * np + 1], va, b[2], b[3]);
      }
    }
    // Columns are queries: p^T = exp2(s * c - lse[query]); queries past Sq
    // contribute nothing.
    const int64_t i0 = static_cast<int64_t>(i) * kN;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float p = i0 + col < sq ? fast_exp2(s[nt][e] * c - Lt[col]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Et[col]);  // ds^T
      }
    }
    acc_times_tile<HD, kN>(dv_acc, s, Dt);
    acc_times_tile<HD, kN>(dk_acc, dp, Qt);
    __syncthreads();
  }
  store_rows<HD>(dk + bn * skv * HD, dk_acc, k0 + kr, skv, scale, scale);
  store_rows<HD>(dv + bn * skv * HD, dv_acc, k0 + kr, skv, 1.f, 1.f);
}

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int64_t bn, int64_t sq,
               int64_t skv, float scale, cudaStream_t st) {
  constexpr size_t smem = Tile<HD>::kFwdSmem;
  int err = set_smem(reinterpret_cast<const void*>(flash_fwd<HD>), smem);
  if (err) return err;
  dim3 grid(static_cast<unsigned>((sq + kRows - 1) / kRows), static_cast<unsigned>(bn));
  flash_fwd<HD><<<grid, kWarps * 32, smem, st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                 static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, skv,
                                                 scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int64_t bn, int64_t sq, int64_t skv, float scale,
               cudaStream_t st) {
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dp = static_cast<const bf16*>(dout);
  const int64_t rows = bn * sq;
  const int64_t threads = rows * (HD / 8);
  flash_delta<HD><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(static_cast<const bf16*>(o), dp,
                                                                                 delta, rows);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  constexpr size_t smem_dq = Tile<HD>::kDqSmem, smem_dkv = Tile<HD>::kDkvSmem;
  err = set_smem(reinterpret_cast<const void*>(flash_bwd_dq<HD>), smem_dq);
  if (err) return err;
  dim3 grid_q(static_cast<unsigned>((sq + kRows - 1) / kRows), static_cast<unsigned>(bn));
  flash_bwd_dq<HD><<<grid_q, kWarps * 32, smem_dq, st>>>(qp, kp, vp, dp, lse, delta, static_cast<bf16*>(dq), sq,
                                                         skv, scale * kLog2e, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  err = set_smem(reinterpret_cast<const void*>(flash_bwd_dkv<HD>), smem_dkv);
  if (err) return err;
  dim3 grid_k(static_cast<unsigned>((skv + kRows - 1) / kRows), static_cast<unsigned>(bn));
  flash_bwd_dkv<HD><<<grid_k, kWarps * 32, smem_dkv, st>>>(qp, kp, vp, dp, lse, delta, static_cast<bf16*>(dk),
                                                           static_cast<bf16*>(dv), sq, skv, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (BN, Sq, hd), k, v (BN, Skv, hd), o (BN, Sq, hd) bf16; lse (BN, Sq)
// float32 out. hd is 64 or 128.
PT_EXPORT int pt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, long long bn,
                           long long sq, long long skv, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_fwd<64>(q, k, v, o, lse, bn, sq, skv, scale, st);
  if (hd == 128) return launch_fwd<128>(q, k, v, o, lse, bn, sq, skv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward's inputs, o and lse, the output gradient dout (BN, Sq, hd);
// delta (BN, Sq) float32 scratch; dq, dk, dv out, shaped as q, k, v.
PT_EXPORT int pt_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                           const float* lse, float* delta, void* dq, void* dk, void* dv, long long bn, long long sq,
                           long long skv, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bn, sq, skv, scale, st);
  if (hd == 128) return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bn, sq, skv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
