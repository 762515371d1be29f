// Kernel D: the temporal (frame-axis) self-attention sub-layer,
//   out = x + to_out(frame_attention(LN(x))),  x (B, F, S, C) bf16,
// attention over the F <= 16 frames of each pixel, head_dim 64, in four
// launches:
//   1. the row LayerNorm of x, written once into the o scratch, then the
//      port's Hopper GEMM (gemm.cuh) LN(x) @ Wqkv^T -> qkv (B, F, S, 3C);
//   2. frame attention (frame_attn, below): per pixel and head, the softmax
//      attention of the F query frames over the F key frames, o (B, F, S, C);
//   3. the GEMM o @ Wo^T + bo + x, the residual tile loaded by TMA.
//
// Replaces posetraj_tpu/ops/pallas_temporal.py:temporal_attn_sublayer
// (ln_qkvt_proj4, frame_attention_t/_frame_attn_kernel and out_proj_res4).
//
// Bound on the H100: the two projections are GEMMs (bytes-bound at C = 320,
// operation-bound at C = 1280). The frame attention is bytes-bound: per
// (pixel, head) it reads 3 x F x 64 bf16 and writes F x 64, against
// 4 F^2 64 operations (F = 14: ~28 operations a byte, a tenth of the card's
// ~295 at the bf16 tensor-core rate). Its design moves those bytes once and
// keeps the arithmetic off the shared-memory pipe:
//   * a producer warp loads, by TMA, q, k and v boxes of 8 pixels x one head
//     x 16 frame rows (64 channels, 128-byte swizzle; frames F..15 and
//     pixels past S are zero-filled) into a 4-stage mbarrier ring of 48 KB
//     stages, from one tensor map over the qkv scratch seen as [3C, F, S, B]
//     (frames inside pixels, so a pixel's 16 rows are one 2 KB tile);
//   * 8 consumer warps take one pixel each: the 16 x 16 logits are 8
//     mma.sync.m16n8k16 (bf16 in, float32 accumulate) from ldmatrix
//     fragments, the exp2 softmax (keys >= F masked) runs on the
//     accumulator fragments with quad shuffles, P is rounded to bf16 after
//     normalising (as the plain version casts its probabilities), and P V is
//     8 more mma with P straight from the logits' registers. wgmma is not
//     used: its 64-row tiles would compute 4x the logits across pixels that
//     never meet;
//   * each warp stages its 14 x 64 output rows in its q tile and writes them
//     with 16-byte stores, a whole 128-byte head row at a time.

#include "common.cuh"
#include "gemm.cuh"

namespace {

constexpr int kHd = 64;
constexpr int kRows = 16;                // frames, padded to one mma tile
constexpr int kPix = 8;                  // pixels a stage, one a consumer warp
constexpr int kStages = 4;
constexpr int kConsumers = kPix;
constexpr int kTile = kRows * kHd * 2;   // one pixel's rows of q, k or v: 2 KB
constexpr int kBox = kPix * kTile;       // one operand of a stage: 16 KB
constexpr int kStage = 3 * kBox;         // 48 KB
constexpr size_t kFrameSmem = static_cast<size_t>(kStages) * kStage + 1024;

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of 128-byte
// rows written by a TMA load with CU_TENSOR_MAP_SWIZZLE_128B (the tile is
// 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warp, one (pixel, head): q, k, v are the shared addresses of its
// 16 x 64 tiles; out points at o[b, 0, s, h * 64], frames `fstride`
// elements apart. Thread 4 g + t holds logits and outputs of rows g and
// g + 8 (the m16n8 accumulator layout); keys 8 nt + 2 t, + 1 of n-tile nt.
__device__ __forceinline__ void attend_pixel(uint32_t q, uint32_t k, uint32_t v, bf16* out, int64_t fstride, int f,
                                             float scale_log2, int lane) {
  const int mat = lane >> 3, r8 = lane & 7, g = lane >> 2, t = lane & 3;
  float sc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, q + swz(r8 + (mat & 1) * 8, 2 * kk + (mat >> 1)));
    ldsm_x4(b, k + swz(r8 + (mat >> 1) * 8, 2 * kk + (mat & 1)));
    mma16816(sc[0], a, b[0], b[1]);
    mma16816(sc[1], a, b[2], b[3]);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + 2 * t + (e & 1);
      sc[nt][e] = key < f ? sc[nt][e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nt][e] = fast_exp2(sc[nt][e] - mx[e >> 1]);
      sum[e >> 1] += sc[nt][e];
    }
  const float inv0 = 1.f / quad_sum(sum[0]), inv1 = 1.f / quad_sum(sum[1]);
  const uint32_t p[4] = {pack_bf16(sc[0][0] * inv0, sc[0][1] * inv0), pack_bf16(sc[0][2] * inv1, sc[0][3] * inv1),
                         pack_bf16(sc[1][0] * inv0, sc[1][1] * inv0), pack_bf16(sc[1][2] * inv1, sc[1][3] * inv1)};
  float oc[8][4] = {};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint32_t b[4];
    ldsm_x4_t(b, v + swz(r8 + (mat & 1) * 8, 2 * jj + (mat >> 1)));
    mma16816(oc[2 * jj], p, b[0], b[1]);
    mma16816(oc[2 * jj + 1], p, b[2], b[3]);
  }
  // Stage the output rows in q's tile (read in full above), then write each
  // head row's 128 bytes with 8 lanes of 16-byte stores.
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gemm::st_shared(q + swz(g, j) + 4 * t, pack_bf16(oc[j][0], oc[j][1]));
    gemm::st_shared(q + swz(g + 8, j) + 4 * t, pack_bf16(oc[j][2], oc[j][3]));
  }
  __syncwarp();
  for (int idx = lane; idx < f * 8; idx += 32) {
    const int row = idx >> 3, chunk = idx & 7;
    uint4 val;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(q + swz(row, chunk)));
    *reinterpret_cast<uint4*>(out + row * fstride + chunk * 8) = val;
  }
}

// qkv: the tensor map of the (B, F, S, 3C) scratch as [3C, F, S, B]; o:
// (B, F, S, C). Work unit u = (b * ceil(S / kPix) + pixel block) * heads + h,
// dealt to the persistent CTAs in turn; warp kConsumers is the producer.
__global__ void __launch_bounds__((kConsumers + 1) * 32, 1)
    frame_attn(const __grid_constant__ CUtensorMap qkv, bf16* __restrict__ o, int b_n, int f, int s, int c, int heads,
               float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pblocks = (s + kPix - 1) / kPix;
  const int64_t units = static_cast<int64_t>(b_n) * pblocks * heads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  if (warp == kConsumers) {
    if (lane == 0) {
      for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
        const int h = static_cast<int>(u % heads);
        const int64_t rest = u / heads;
        const int pb = static_cast<int>(rest % pblocks), b = static_cast<int>(rest / pblocks);
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], kStage);
        unsigned char* dst = smem + stage * kStage;
        for (int part = 0; part < 3; ++part)
          tma_load(dst + part * kBox, &qkv, &full[stage], part * c + h * kHd, 0, pb * kPix, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  const int64_t fstride = static_cast<int64_t>(s) * c;
  for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
    const int h = static_cast<int>(u % heads);
    const int64_t rest = u / heads;
    const int pb = static_cast<int>(rest % pblocks), b = static_cast<int>(rest / pblocks);
    const int pix = pb * kPix + warp;
    mbar_wait(&full[stage], phase);
    if (pix < s) {
      const uint32_t base = smem_addr(smem + stage * kStage + warp * kTile);
      bf16* out = o + (static_cast<int64_t>(b) * f * s + pix) * c + h * kHd;
      attend_pixel(base, base + kBox, base + 2 * kBox, out, fstride, f, scale_log2, lane);
    }
    fence_async_smem();  // this warp's staging writes before the next TMA load into the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The frame attention over a (B, F, S, 3C) qkv scratch into o (B, F, S, C).
int frame_attention(const void* qkv, void* o, int64_t b, int f, int64_t s, int c, int heads, float scale,
                    cudaStream_t st) {
  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(3 * c), static_cast<cuuint64_t>(f), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s) * 3 * c * 2, static_cast<cuuint64_t>(3 * c) * 2,
                                 static_cast<cuuint64_t>(f) * s * 3 * c * 2};
  const cuuint32_t box[4] = {kHd, kRows, kPix, 1};
  int err = gemm::encode(&map, qkv, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  err = set_smem(reinterpret_cast<const void*>(frame_attn), kFrameSmem);
  if (err) return err;
  const int64_t units = b * ((s + kPix - 1) / kPix) * heads;
  const int64_t blocks = units < gemm::sm_count() ? units : gemm::sm_count();
  frame_attn<<<static_cast<unsigned>(blocks), (kConsumers + 1) * 32, kFrameSmem, st>>>(
      map, static_cast<bf16*>(o), static_cast<int>(b), f, static_cast<int>(s), c, heads, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, F, S, C); wqkv: (3C, C); wo: (C, C); bo: (C,); ln_w, ln_b: (C,)
// float32; qkv scratch (B, F, S, 3C); o scratch (B, F, S, C), which holds
// LN(x) until the frame attention writes o. Requires head_dim 64 and F <= 16
// (checked by the Python wrapper).
PT_EXPORT int pt_temporal_sublayer(const void* x, const float* ln_w, const float* ln_b, const void* wqkv,
                                   const void* wo, const void* bo, void* qkv, void* o, void* out, long long b,
                                   int f, long long s, int c, int heads, float eps, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t m = b * f * s;
  int err = gemm::rows_prologue<gemm::projection_gemm>(x, nullptr, 1, 1, ln_w, ln_b, eps, o, nullptr, m, c, st);
  if (!err) err = gemm::linear<gemm::projection_gemm>(o, wqkv, qkv, nullptr, gemm::epilogue(gemm::kStore), m, 3 * c, c,
                                                          st);
  if (err) return err;

  err = frame_attention(qkv, o, b, f, s, c, heads, scale, st);
  if (err) return err;
  return gemm::linear<gemm::projection_gemm>(o, wo, out, x, gemm::epilogue(gemm::kBiasResidual, bo), m, c, c, st);
}

// The frame attention alone: qkv (B, F, S, 3C) -> o (B, F, S, C); head_dim
// 64, F <= 16 (checked by the Python wrapper).
PT_EXPORT int pt_frame_attention(const void* qkv, void* o, long long b, int f, long long s, int c, int heads,
                                 float scale, void* stream) {
  return frame_attention(qkv, o, b, f, s, c, heads, scale, static_cast<cudaStream_t>(stream));
}
