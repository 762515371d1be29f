// Flash attention over bf16 operands with head_dim d in {64, 128}, three
// Pallas kernels in one file:
//   forward  o = softmax(q k^T * scale) v and, where asked for, per query row
//            the base-2 log-sum-exp lse = m + log2(l) of the logits scaled by
//            scale * log2(e) (float32, (B, N, Sq) = (BN, Sq) head-folded);
//   backward delta = rowsum(o * do) (float32), then
//            p = exp2(q k^T * scale * log2(e) - lse), ds = p * (do v^T - delta),
//            dq = ds k * scale, dk = ds^T q * scale, dv = p^T do.
//
// The forward is flash_fwd.cuh's, which kernel C launches too; it reads q,
// k, v and writes o by (batch, head, row) strides with the head_dim axis
// contiguous, and serves three Pallas entry points of
// posetraj_tpu/ops/pallas_attention.py:
//   kernel 5  flash_attention_diff: _flash_fwd_lse (_flash_kernel_tq_lse),
//             head-folded (BN, S, d) operands, lse written; its backward
//             (below) replaces _flash_bwd (_flash_bwd_dq_kernel,
//             _flash_bwd_dkv_kernel);
//   kernel 6  flash_attention_qkv: _flash_qkv_fwd_impl (_flash_kernel_qkv),
//             per-head tiles read straight out of the packed (B, S, 3C)
//             projection (row stride 3C, q/k/v at column offsets 0, C, 2C,
//             head h at h * d), o written as (B, S, C), lse written;
//   kernel 7  flash_attention_tq and flash_attention (_flash_kernel_tq,
//             _flash_kernel): (B, Sq, N, d) q and (B, Skv, N, d) k, v read
//             in place (split views of a packed projection too), o written as
//             (B, Sq, N, d), no lse.
//
// Backward. Bound on the H100: operations, 10 * Sq * Skv * d multiply-adds
// per (batch, head) (S, dP, dV, dK, dQ) at 989 TFLOP/s. Three launches:
// flash_bwd_prep writes delta and a copy of lse padded to a multiple of 128
// rows (lse +inf, delta 0 on the padding, so a padded query row gets p = 0
// without a mask); flash_bwd_dkv and flash_bwd_dq each recompute P, so the
// pair does 14 of the 10 units of work, in exchange for sums that need no
// atomics and are the same from run to run. Both take the forward's shape:
// a producer warpgroup whose one thread keeps TMA loads in a two-stage
// mbarrier ring, and two consumer warpgroups of 64 rows each (setmaxnreg
// 24 / 240), every product a wgmma. The consumers do not take turns as the
// forward's do: on an H100 that made the pair slower.
//   dk/dv: a block owns 128 keys; per 64-query tile S^T = K Q^T and dP^T =
//     V dO^T (shared-memory operands), then dV += P^T dO and dK += dS^T Q
//     with P^T and dS^T as register A operands and dO, Q as transposed B.
//   dq: a block owns 128 queries; per 64-key tile
//     S = Q K^T, dP = dO V^T, then dQ += dS K, dS from registers.
// P and dS are rounded to bf16 for their products, as the forward rounds P.
// Keys >= Skv get p = 0 in dq (a zero-filled key has logit 0); keys >= Skv
// in dk/dv and queries >= Sq in dq are not stored.

#include "flash_fwd.cuh"

namespace {

// ---------------------------------------------------------------------------
// delta = rowsum(o * do) and lse, both into (BN, sq_pad) float32 with
// padding rows (lse +inf, delta 0); HD/8 lanes per row, 16 bytes each.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                               const float* __restrict__ lse, float* __restrict__ lse_pad,
                               float* __restrict__ delta, int64_t sq, int64_t sq_pad, int64_t rows_pad) {
  constexpr int kL = HD / 8;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / kL, fold = row / sq_pad, r = row % sq_pad;
  const int part = static_cast<int>(tid % kL);
  const bool valid = row < rows_pad && r < sq;
  const int64_t src = fold * sq + r;
  float acc = 0.f;
  if (valid) {
    const Vec16<bf16> a = load16(o + src * HD + part * 8), b = load16(dout + src * HD + part * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += a.get(i) * b.get(i);
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows_pad && part == 0) {
    delta[row] = acc;
    lse_pad[row] = valid ? lse[src] : INFINITY;
  }
}

// Rows [r0, r0 + 64) of the warpgroup's HD-wide float32 accumulator halves,
// times `mul`, as bf16 rows of a contiguous (S, HD) matrix; rows >= s are
// skipped.
template <int HD>
__device__ __forceinline__ void store_acc(bf16* dst, float (&acc)[HD / 64][32], int r0, int s, float mul) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, g = lane / 4, t = lane % 4;
  const int lo = r0 + 16 * warp + g, hi = lo + 8;
#pragma unroll
  for (int h = 0; h < HD / 64; ++h)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = h * 64 + 8 * i + 2 * t;
      if (lo < s)
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(lo) * HD + col) =
            __floats2bfloat162_rn(acc[h][4 * i] * mul, acc[h][4 * i + 1] * mul);
      if (hi < s)
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<int64_t>(hi) * HD + col) =
            __floats2bfloat162_rn(acc[h][4 * i + 2] * mul, acc[h][4 * i + 3] * mul);
    }
}

template <int HD>
__device__ __forceinline__ void zero_acc(float (&acc)[HD / 64][32]) {
#pragma unroll
  for (int h = 0; h < HD / 64; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
}

// S (64 x N) = A B^T over HD: A rows [row0, row0 + 64) of a [half][a_rows][64]
// tile, B the N rows of a [half][N][64] tile; both K-major.
template <int HD, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], const bf16* a, int a_rows, int row0, const bf16* b) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    if constexpr (N == 128)
      wgmma_ss_n128(acc, desc_k(a, a_rows, row0, kc), desc_k(b, N, 0, kc), kc);
    else
      wgmma_ss_n64(acc, desc_k(a, a_rows, row0, kc), desc_k(b, N, 0, kc), kc);
  }
}

// acc (64 x HD) += A (64 x K, registers) B, B the K rows of a [half][K][64]
// tile read MN-major.
template <int HD, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 64][32], const uint32_t (&a)[K / 16][4], const bf16* b) {
#pragma unroll
  for (int h = 0; h < HD / 64; ++h)
#pragma unroll
    for (int kc = 0; kc < K / 16; ++kc) wgmma_rs_n64(acc[h], a[kc], desc_mn(b, K, kc, h));
}

template <int HD>
struct DkvTile {
  static constexpr int kM = 128, kN = 64, kStages = 2;  // keys a block owns, queries a tile holds
  static constexpr int kOwnBytes = kM * HD * 2, kTileBytes = kN * HD * 2;
  static constexpr size_t kSmem = 1024 + 2 * kOwnBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages);
};

template <int HD>
struct DqTile {
  static constexpr int kM = 128, kN = 64, kStages = 2;  // queries a block owns, keys a tile holds
  static constexpr int kOwnBytes = kM * HD * 2, kTileBytes = kN * HD * 2;
  static constexpr size_t kSmem = 1024 + 2 * kOwnBytes + 2 * kStages * kTileBytes + 8 * (1 + 3 * kStages);
};

// The producer of both backward kernels: the block's own two operands
// (rows `own0` of maps a, b, kM rows each) once, then tiles j of maps c, d
// (kN rows each) through the ring. All coordinates are (col, row, 0, fold).
template <int HD, typename T>
__device__ __forceinline__ void bwd_produce(const CUtensorMap* ma, const CUtensorMap* mb, const CUtensorMap* mc,
                                            const CUtensorMap* md, bf16* own_a, bf16* own_b, bf16* ring_c,
                                            bf16* ring_d, uint64_t* own_full, uint64_t* c_full, uint64_t* d_full,
                                            uint64_t* empty, int own0, int n_tiles, int fold) {
  mbar_expect_tx(own_full, 2 * T::kOwnBytes);
  for (int h = 0; h < HD / 64; ++h) {
    tma_load(own_a + h * T::kM * 64, ma, own_full, h * 64, own0, 0, fold);
    tma_load(own_b + h * T::kM * 64, mb, own_full, h * 64, own0, 0, fold);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % T::kStages;
    mbar_wait(&empty[s], ((j / T::kStages) & 1) ^ 1);
    mbar_expect_tx(&c_full[s], T::kTileBytes);
    for (int h = 0; h < HD / 64; ++h)
      tma_load(ring_c + (s * HD / 64 + h) * T::kN * 64, mc, &c_full[s], h * 64, j * T::kN, 0, fold);
    mbar_expect_tx(&d_full[s], T::kTileBytes);
    for (int h = 0; h < HD / 64; ++h)
      tma_load(ring_d + (s * HD / 64 + h) * T::kN * 64, md, &d_full[s], h * 64, j * T::kN, 0, fold);
  }
}

// Shared-memory layout of both: own a, own b, ring c, ring d, barriers.
template <typename T>
struct BwdSmem {
  bf16 *a, *b, *c, *d;
  uint64_t *own_full, *c_full, *d_full, *empty;
  __device__ explicit BwdSmem(unsigned char* smem, int hd) {
    a = reinterpret_cast<bf16*>(smem);
    b = a + T::kM * hd;
    c = b + T::kM * hd;
    d = c + T::kStages * T::kN * hd;
    own_full = reinterpret_cast<uint64_t*>(d + T::kStages * T::kN * hd);
    c_full = own_full + 1;
    d_full = c_full + T::kStages;
    empty = d_full + T::kStages;
    if (threadIdx.x == 0) {
      mbar_init(own_full, 1);
      for (int s = 0; s < T::kStages; ++s) {
        mbar_init(&c_full[s], 1);
        mbar_init(&d_full[s], 1);
        mbar_init(&empty[s], 256);
      }
      mbar_init_fence();
    }
  }
};

// ---------------------------------------------------------------------------
// dk, dv: one block per (fold, 128 keys), looping over 64-query tiles.
// Maps: k, v in boxes of 128 rows; q, do in boxes of 64.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse_pad, const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int sq, int sq_pad, int skv, float c, float scale) {
  using T = DkvTile<HD>;
  constexpr int kN = T::kN;
  extern __shared__ unsigned char smem_raw[];
  BwdSmem<T> sm(align1024(smem_raw), HD);
  const int fold = blockIdx.y, k0 = blockIdx.x * T::kM;
  const int n_tiles = (sq + kN - 1) / kN;
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0)
      bwd_produce<HD, T>(&tk, &tv, &tq, &tdo, sm.a, sm.b, sm.c, sm.d, sm.own_full, sm.c_full, sm.d_full, sm.empty,
                         k0, n_tiles, fold);
  } else {
    regs_inc<240>();
    const int ct = threadIdx.x - 128, w = ct / 128, t = ct % 4;
    const float* lb = lse_pad + static_cast<int64_t>(fold) * sq_pad;
    const float* eb = delta + static_cast<int64_t>(fold) * sq_pad;
    float dk_acc[HD / 64][32], dv_acc[HD / 64][32];
    zero_acc<HD>(dk_acc);
    zero_acc<HD>(dv_acc);
    mbar_wait(sm.own_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % T::kStages;
      const uint32_t parity = (i / T::kStages) & 1;
      const bf16* Qt = sm.c + s * kN * HD;
      const bf16* Dt = sm.d + s * kN * HD;
      // lse and delta of this thread's query columns (padded: no mask).
      const int i0 = i * kN;
      float2 ls[kN / 8], es[kN / 8];
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
        ls[n] = *reinterpret_cast<const float2*>(lb + i0 + 8 * n + 2 * t);
        es[n] = *reinterpret_cast<const float2*>(eb + i0 + 8 * n + 2 * t);
      }
      float st[kN / 2], dpt[kN / 2];
      mbar_wait(&sm.c_full[s], parity);
      wgmma_fence();
      issue_ss<HD, kN>(st, sm.a, T::kM, 64 * w, Qt);
      wgmma_commit();
      mbar_wait(&sm.d_full[s], parity);
      issue_ss<HD, kN>(dpt, sm.b, T::kM, 64 * w, Dt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(st);
      fence_acc(dpt);
      // Columns are queries: p^T = exp2(s * c - lse[query]), ds^T = p^T *
      // (dp^T - delta[query]).
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? ls[n].y : ls[n].x, dl = (e & 1) ? es[n].y : es[n].x;
          const float p = fast_exp2(st[4 * n + e] * c - l);
          st[4 * n + e] = p;
          dpt[4 * n + e] = p * (dpt[4 * n + e] - dl);
        }
      }
      uint32_t pa[kN / 16][4], da[kN / 16][4];
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) {
        acc_to_a(pa[kc], st, kc);
        acc_to_a(da[kc], dpt, kc);
      }
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) {
        fence_acc(dv_acc[h]);
        fence_acc(dk_acc[h]);
      }
      wgmma_fence();
      issue_rs<HD, kN>(dv_acc, pa, Dt);
      issue_rs<HD, kN>(dk_acc, da, Qt);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) {
        fence_acc(dv_acc[h]);
        fence_acc(dk_acc[h]);
      }
      mbar_arrive(&sm.empty[s]);
    }
    const int64_t base = static_cast<int64_t>(fold) * skv * HD;
    store_acc<HD>(dk + base, dk_acc, k0 + 64 * w, skv, scale);
    store_acc<HD>(dv + base, dv_acc, k0 + 64 * w, skv, 1.f);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (fold, 128 queries), looping over key tiles.
// Maps: q, do in boxes of 128 rows; k, v in boxes of DqTile::kN.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse_pad, const float* __restrict__ delta, bf16* __restrict__ dq, int sq,
                 int sq_pad, int skv, float c, float scale) {
  using T = DqTile<HD>;
  constexpr int kN = T::kN;
  extern __shared__ unsigned char smem_raw[];
  BwdSmem<T> sm(align1024(smem_raw), HD);
  const int fold = blockIdx.y, q0 = blockIdx.x * T::kM;
  const int n_tiles = (skv + kN - 1) / kN;
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0)
      bwd_produce<HD, T>(&tq, &tdo, &tk, &tv, sm.a, sm.b, sm.c, sm.d, sm.own_full, sm.c_full, sm.d_full, sm.empty,
                         q0, n_tiles, fold);
  } else {
    regs_inc<240>();
    const int ct = threadIdx.x - 128, w = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    // This thread's rows g and g + 8; padded rows read lse +inf, delta 0.
    const int64_t row_lo = static_cast<int64_t>(fold) * sq_pad + q0 + 64 * w + 16 * warp + g;
    const float lse_lo = lse_pad[row_lo], lse_hi = lse_pad[row_lo + 8];
    const float dl_lo = delta[row_lo], dl_hi = delta[row_lo + 8];
    float acc[HD / 64][32];
    zero_acc<HD>(acc);
    mbar_wait(sm.own_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % T::kStages;
      const uint32_t parity = (j / T::kStages) & 1;
      const bf16* Kt = sm.c + s * kN * HD;
      const bf16* Vt = sm.d + s * kN * HD;
      float sacc[kN / 2], dp[kN / 2];
      mbar_wait(&sm.c_full[s], parity);
      wgmma_fence();
      issue_ss<HD, kN>(sacc, sm.a, T::kM, 64 * w, Kt);
      wgmma_commit();
      mbar_wait(&sm.d_full[s], parity);
      issue_ss<HD, kN>(dp, sm.b, T::kM, 64 * w, Vt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sacc);
      fence_acc(dp);
      const int k0 = j * kN;
#pragma unroll
      for (int n = 0; n < kN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          const float p =
              k0 + 8 * n + 2 * t + (e & 1) < skv ? fast_exp2(sacc[4 * n + e] * c - (lo ? lse_lo : lse_hi)) : 0.f;
          sacc[4 * n + e] = p * (dp[4 * n + e] - (lo ? dl_lo : dl_hi));  // ds
        }
      }
      uint32_t da[kN / 16][4];
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) acc_to_a(da[kc], sacc, kc);
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) fence_acc(acc[h]);
      wgmma_fence();
      issue_rs<HD, kN>(acc, da, Kt);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) fence_acc(acc[h]);
      mbar_arrive(&sm.empty[s]);
    }
    store_acc<HD>(dq + static_cast<int64_t>(fold) * sq * HD, acc, q0 + 64 * w, sq, scale);
  }
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
               float* stats, void* dq, void* dk, void* dv, int64_t bn, int64_t sq, int64_t skv, float scale,
               cudaStream_t st) {
  using Tk = DkvTile<HD>;
  using Tq = DqTile<HD>;
  const int64_t sq_pad = (sq + 127) / 128 * 128;
  float* lse_pad = stats;
  float* delta = stats + bn * sq_pad;
  const int64_t threads = bn * sq_pad * (HD / 8);
  flash_bwd_prep<HD><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lse_pad, delta, sq, sq_pad, bn * sq_pad);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  // Head-folded contiguous (BN, S, HD): rank-4 maps with one head.
  const Layout lq{sq * HD, sq * HD, HD}, lk{skv * HD, skv * HD, HD};
  CUtensorMap mk128, mv128, mq64, mdo64, mq128, mdo128, mkt, mvt;
  err = make_tmap(&mk128, k, HD, skv, 1, bn, lk, Tk::kM);
  if (!err) err = make_tmap(&mv128, v, HD, skv, 1, bn, lk, Tk::kM);
  if (!err) err = make_tmap(&mq64, q, HD, sq, 1, bn, lq, Tk::kN);
  if (!err) err = make_tmap(&mdo64, dout, HD, sq, 1, bn, lq, Tk::kN);
  if (!err) err = make_tmap(&mq128, q, HD, sq, 1, bn, lq, Tq::kM);
  if (!err) err = make_tmap(&mdo128, dout, HD, sq, 1, bn, lq, Tq::kM);
  if (!err) err = make_tmap(&mkt, k, HD, skv, 1, bn, lk, Tq::kN);
  if (!err) err = make_tmap(&mvt, v, HD, skv, 1, bn, lk, Tq::kN);
  if (!err) err = set_smem(reinterpret_cast<const void*>(flash_bwd_dkv<HD>), Tk::kSmem);
  if (!err) err = set_smem(reinterpret_cast<const void*>(flash_bwd_dq<HD>), Tq::kSmem);
  if (err) return err;
  const float c = scale * kLog2e;
  dim3 grid_k(static_cast<unsigned>((skv + Tk::kM - 1) / Tk::kM), static_cast<unsigned>(bn));
  flash_bwd_dkv<HD><<<grid_k, 384, Tk::kSmem, st>>>(mk128, mv128, mq64, mdo64, lse_pad, delta,
                                                     static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                     static_cast<int>(sq), static_cast<int>(sq_pad),
                                                     static_cast<int>(skv), c, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_q(static_cast<unsigned>((sq + Tq::kM - 1) / Tq::kM), static_cast<unsigned>(bn));
  flash_bwd_dq<HD><<<grid_q, 384, Tq::kSmem, st>>>(mq128, mdo128, mkt, mvt, lse_pad, delta, static_cast<bf16*>(dq),
                                                   static_cast<int>(sq), static_cast<int>(sq_pad),
                                                   static_cast<int>(skv), c, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward of kernels 5, 6 and 7. q (B, Sq, heads, hd), k, v (B, Skv,
// heads, hd) and o (B, Sq, heads, hd) bf16, each given by its (batch, head,
// row) element strides (s*[0], s*[1], s*[2]) with hd contiguous, base
// addresses and strides multiples of 16 bytes; lse (B * heads, Sq) float32
// out, or null for none. hd is 64 or 128.
PT_EXPORT int pt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, long long b,
                           int heads, long long sq, long long skv, int hd, float scale, const long long* sq_strides,
                           const long long* sk_strides, const long long* sv_strides, const long long* so_strides,
                           void* stream) {
  const Layout lq{sq_strides[0], sq_strides[1], sq_strides[2]}, lk{sk_strides[0], sk_strides[1], sk_strides[2]},
      lv{sv_strides[0], sv_strides[1], sv_strides[2]}, lo{so_strides[0], so_strides[1], so_strides[2]};
  return flash_forward(hd, q, k, v, o, lse, lq, lk, lv, lo, b, heads, sq, skv, scale,
                       static_cast<cudaStream_t>(stream));
}

// The forward's inputs, o and lse, the output gradient dout, all
// contiguous (BN, Sq, hd) (k, v (BN, Skv, hd)); stats (2, BN, Sq rounded
// up to 128) float32 scratch; dq, dk, dv out, shaped as q, k, v.
PT_EXPORT int pt_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                           const float* lse, float* stats, void* dq, void* dk, void* dv, long long bn, long long sq,
                           long long skv, int hd, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch_bwd<64>(q, k, v, o, dout, lse, stats, dq, dk, dv, bn, sq, skv, scale, st);
  if (hd == 128) return launch_bwd<128>(q, k, v, o, dout, lse, stats, dq, dk, dv, bn, sq, skv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
