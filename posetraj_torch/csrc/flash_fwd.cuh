// The one flash-attention forward of the port, launched by kernels C
// (qkvt.cu, between its two GEMMs), 5, 6 and 7 (flash.cu):
//   o = softmax(q k^T * scale) v over bf16 q (B, Sq, heads, hd), k, v (B,
//   Skv, heads, hd), hd 64 or 128, each read by its (batch, head, row)
//   strides, and, where lse is not null, the base-2 log-sum-exp per query
//   row, lse = m + log2(l) of the logits scaled by scale * log2(e)
//   (float32, (B * heads, Sq)).
//
// Design (Hopper, FA3-like). A block owns 128 queries of one (batch, head)
// and has three warpgroups. Warpgroup 0 is the producer: it gives up its
// registers (setmaxnreg 24) and one thread keeps TMA loads of 128-key K and
// V tiles in flight in a ring of three stages, each tile completing on its
// own mbarrier, each slot freed by an "empty" mbarrier that all 256
// consumer threads arrive at. Warpgroups 1 and 2 are the consumers
// (setmaxnreg 240), 64 query rows each: S = Q K^T by wgmma with both
// operands in shared memory (K-major), an online softmax in base 2 on the
// accumulator in registers, P rounded to bf16 and turned into the register
// A operand of O += P V, whose B operand is V's row-major tile read with
// the transpose bit. The two consumers take turns to issue their wgmma
// (named barriers), so one's softmax runs beside the other's products; at
// hd 64 each also issues S_j with P_{j-1} V_{j-1} and runs the softmax of
// S_j while P V finishes. The key tile is 128 at both head dims (S 64
// registers a thread, O 32 or 64, P 32); shared memory is Q + 3 x (K + V),
// 112 KB at hd 64 and 224 KB at hd 128, so one block of 384 threads fills
// an SM. Tiles are 128-byte swizzled TMA boxes of 64 columns (hd 128: two
// boxes); rows past S are zero-filled by TMA inside each (batch, head). A
// zero-filled key gives logit 0, not -inf, so keys >= Skv are masked to
// -inf on the last tile; query rows >= Sq are not stored.
//
// Bound on the H100: operations, 4 * Sq * Skv * hd multiply-adds per
// (batch, head) at 989 TFLOP/s against (2 Sq + 2 Skv) * hd * 2 bytes; the
// (Sq, Skv) logits live only in registers.
#pragma once

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct FwdTile {
  static constexpr int kM = 128;  // queries a block owns (64 per consumer warpgroup)
  static constexpr int kN = 128;  // keys a tile holds
  static constexpr int kStages = 3;
  // At hd 64, P_{j-1} V_{j-1} is issued with S_j and overlaps the softmax
  // of S_j. At hd 128, S, O and P in flight together are more registers
  // than ptxas will hold without serialising every wgmma, so each tile's
  // P V is issued on its own after its softmax.
  static constexpr bool kOverlap = HD == 64;
  static constexpr int kQBytes = kM * HD * 2, kKvBytes = kN * HD * 2;
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKvBytes + 8 * (1 + 3 * kStages);
};

// The two consumer warpgroups take turns to issue wgmma: warpgroup w waits
// on named barrier 1 + w (256 threads: its own 128 and the 128 of the one
// that passes the turn). sched_begin lets warpgroup 0 go first; sched_end
// takes the turn warpgroup 1 passes last, so both barriers end balanced. No
// branch sits inside a turn (ptxas would serialise the wgmma around it).
__device__ __forceinline__ void turn_start(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_end(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
}
__device__ __forceinline__ void sched_begin(int w) {
  if (w == 1) turn_end(1);
}
__device__ __forceinline__ void sched_end(int w) {
  if (w == 0) turn_start(0);
}

// Online softmax of one tile of raw logits s = q.k (this thread's rows g
// and g + 8 in the wgmma accumulator layout, keys k0 + column): keys >= skv
// are masked, s becomes p = exp2(s c - m) in place with m the running row
// max in the log2 domain, l the running partial row sums; al_* return the
// factors that rescale O.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N / 2], float& m_lo, float& m_hi, float& l_lo,
                                               float& l_hi, float& al_lo, float& al_hi, int k0, int skv, float c,
                                               int t) {
  if (k0 + N > skv) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * i + 2 * t + (e & 1) >= skv) s[4 * i + e] = -INFINITY;
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  // Every tile holds at least one valid key, so the new max is finite and
  // exp2(-inf) is 0, never NaN (c > 0 keeps the max's position).
  const float mn_lo = fmaxf(m_lo, mx_lo * c), mn_hi = fmaxf(m_hi, mx_hi * c);
  al_lo = fast_exp2(m_lo - mn_lo);
  al_hi = fast_exp2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    s[4 * i + 0] = fast_exp2(fmaf(s[4 * i + 0], c, -mn_lo));
    s[4 * i + 1] = fast_exp2(fmaf(s[4 * i + 1], c, -mn_lo));
    s[4 * i + 2] = fast_exp2(fmaf(s[4 * i + 2], c, -mn_hi));
    s[4 * i + 3] = fast_exp2(fmaf(s[4 * i + 3], c, -mn_hi));
    ps_lo += s[4 * i] + s[4 * i + 1];
    ps_hi += s[4 * i + 2] + s[4 * i + 3];
  }
  l_lo = l_lo * al_lo + ps_lo;
  l_hi = l_hi * al_hi + ps_hi;
}

template <int HD>
__global__ void __launch_bounds__(384, 1)
    hopper_flash_fwd(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, float* __restrict__ lse,
                     Layout lo, int heads, int sq, int skv, float c) {
  using T = FwdTile<HD>;
  constexpr int kM = T::kM, kN = T::kN, kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + T::kQBytes);  // [stage][half][kN][64]
  bf16* Vs = Ks + kStages * kN * HD;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::kQBytes + 2 * kStages * T::kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* kv_empty = v_full + kStages;

  const int bn = blockIdx.y, batch = bn / heads, head = bn % heads;
  const int q0 = blockIdx.x * kM;
  const int n_tiles = (skv + kN - 1) / kN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int h = 0; h < HD / 64; ++h) tma_load(Qs + h * kM * 64, &tq, q_full, h * 64, q0, head, batch);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&kv_empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], T::kKvBytes);
        for (int h = 0; h < HD / 64; ++h)
          tma_load(Ks + (s * HD / 64 + h) * kN * 64, &tk, &k_full[s], h * 64, j * kN, head, batch);
        mbar_expect_tx(&v_full[s], T::kKvBytes);
        for (int h = 0; h < HD / 64; ++h)
          tma_load(Vs + (s * HD / 64 + h) * kN * 64, &tv, &v_full[s], h * 64, j * kN, head, batch);
      }
    }
  } else {
    // Consumers: warpgroup w owns query rows [64 w, 64 w + 64) of the block.
    regs_inc<240>();
    const int ct = threadIdx.x - 128, w = ct / 128;
    const int warp = (ct % 128) / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
    float oacc[HD / 64][32];
#pragma unroll
    for (int h = 0; h < HD / 64; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[h][i] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8 of this warp, log2 domain
    float l_lo = 0.f, l_hi = 0.f;               // this thread's partial row sums
    float al_lo, al_hi;
    float sacc[kN / 2];
    uint32_t pa[kN / 16][4];
    auto issue_s = [&](int j) {
      const bf16* Kt = Ks + (j % kStages) * kN * HD;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) wgmma_ss_n128(sacc, desc_k(Qs, kM, 64 * w, kc), desc_k(Kt, kN, 0, kc), kc);
    };
    auto issue_pv = [&](int j) {
      const bf16* Vt = Vs + (j % kStages) * kN * HD;
#pragma unroll
      for (int h = 0; h < HD / 64; ++h)
#pragma unroll
        for (int kc = 0; kc < kN / 16; ++kc) wgmma_rs_n64(oacc[h], pa[kc], desc_mn(Vt, kN, kc, h));
    };
    auto softmax = [&](int j) { online_softmax<kN>(sacc, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi, j * kN, skv, c, t); };
    // P into the A operand; only once no P V product still reads pa.
    auto pack_p = [&] {
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) acc_to_a(pa[kc], sacc, kc);
    };
    auto parity = [&](int j) { return static_cast<uint32_t>((j / kStages) & 1); };

    auto rescale_o = [&] {
#pragma unroll
      for (int h = 0; h < HD / 64; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          oacc[h][4 * i + 0] *= al_lo;
          oacc[h][4 * i + 1] *= al_lo;
          oacc[h][4 * i + 2] *= al_hi;
          oacc[h][4 * i + 3] *= al_hi;
        }
    };
    // P_j V_j, then tile j's ring slot is free.
    auto finish_pv = [&](int j) {
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < HD / 64; ++h) fence_acc(oacc[h]);
      mbar_arrive(&kv_empty[j % kStages]);
    };
    // The two warpgroups take turns to issue their products (named barriers
    // 1 and 2), so that one's softmax runs beside the other's wgmma.
    sched_begin(w);
    mbar_wait(q_full, 0);
    if constexpr (T::kOverlap) {
      // S_j = Q K_j^T and O += P_{j-1} V_{j-1} in one turn; the softmax of
      // S_j runs while the tensor cores finish P V.
      turn_start(w);
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      issue_s(0);
      wgmma_commit();
      turn_end(w);
      wgmma_wait<0>();
      fence_acc(sacc);
      softmax(0);
      pack_p();
      for (int j = 1; j < n_tiles; ++j) {
        turn_start(w);
        mbar_wait(&k_full[j % kStages], parity(j));
        wgmma_fence();
        issue_s(j);
        wgmma_commit();
        mbar_wait(&v_full[(j - 1) % kStages], parity(j - 1));
        issue_pv(j - 1);
        wgmma_commit();
        turn_end(w);
        wgmma_wait<1>();
        fence_acc(sacc);
        softmax(j);
        finish_pv(j - 1);
        rescale_o();
        pack_p();
      }
      const int last = n_tiles - 1;
      turn_start(w);
      mbar_wait(&v_full[last % kStages], parity(last));
      wgmma_fence();
      issue_pv(last);
      wgmma_commit();
      turn_end(w);
      finish_pv(last);
    } else {
      for (int j = 0; j < n_tiles; ++j) {
        turn_start(w);
        mbar_wait(&k_full[j % kStages], parity(j));
        wgmma_fence();
        issue_s(j);
        wgmma_commit();
        turn_end(w);
        wgmma_wait<0>();
        fence_acc(sacc);
        softmax(j);
        rescale_o();
        pack_p();
        turn_start(w);
        mbar_wait(&v_full[j % kStages], parity(j));
        wgmma_fence();
        issue_pv(j);
        wgmma_commit();
        turn_end(w);
        finish_pv(j);
      }
    }
    sched_end(w);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const int row_lo = q0 + 64 * w + 16 * warp + g, row_hi = row_lo + 8;
    bf16* ob = o + batch * lo.batch + head * lo.head;
#pragma unroll
    for (int h = 0; h < HD / 64; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = h * 64 + 8 * i + 2 * t;
        if (row_lo < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * lo.row + col) =
              __floats2bfloat162_rn(oacc[h][4 * i] * inv_lo, oacc[h][4 * i + 1] * inv_lo);
        if (row_hi < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * lo.row + col) =
              __floats2bfloat162_rn(oacc[h][4 * i + 2] * inv_hi, oacc[h][4 * i + 3] * inv_hi);
      }
    if (lse != nullptr && t == 0) {
      if (row_lo < sq) lse[static_cast<int64_t>(bn) * sq + row_lo] = m_lo + log2f(l_lo);
      if (row_hi < sq) lse[static_cast<int64_t>(bn) * sq + row_hi] = m_hi + log2f(l_hi);
    }
  }
}

template <int HD>
int launch_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, Layout lq, Layout lk,
                     Layout lv, Layout lout, int64_t b, int heads, int64_t sq, int64_t skv, float scale,
                     cudaStream_t st) {
  using T = FwdTile<HD>;
  CUtensorMap tq, tk, tv;
  int err = make_tmap(&tq, q, HD, sq, heads, b, lq, T::kM);
  if (!err) err = make_tmap(&tk, k, HD, skv, heads, b, lk, T::kN);
  if (!err) err = make_tmap(&tv, v, HD, skv, heads, b, lv, T::kN);
  if (!err) err = set_smem(reinterpret_cast<const void*>(hopper_flash_fwd<HD>), T::kSmem);
  if (err) return err;
  dim3 grid(static_cast<unsigned>((sq + T::kM - 1) / T::kM), static_cast<unsigned>(b * heads));
  hopper_flash_fwd<HD><<<grid, 384, T::kSmem, st>>>(tq, tk, tv, static_cast<bf16*>(o), lse, lout, heads,
                                                     static_cast<int>(sq), static_cast<int>(skv), scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The forward at head_dim 64 or 128 (see the top of this file); q, k, v
// and o given by base pointer and (batch, head, row) element strides.
int flash_forward(int hd, const void* q, const void* k, const void* v, void* o, float* lse, Layout lq, Layout lk,
                  Layout lv, Layout lout, int64_t b, int heads, int64_t sq, int64_t skv, float scale,
                  cudaStream_t st) {
  if (hd == 64) return launch_flash_fwd<64>(q, k, v, o, lse, lq, lk, lv, lout, b, heads, sq, skv, scale, st);
  if (hd == 128) return launch_flash_fwd<128>(q, k, v, o, lse, lq, lk, lv, lout, b, heads, sq, skv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
