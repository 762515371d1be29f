// The port's one Hopper GEMM, shared by kernel B (mlp.cu: both products of
// the GEGLU MLP) and the projections of kernels C (qkvt.cu) and D
// (temporal.cu):
//   out = epilogue(A W^T + bias),  A (M, K), W (N, K), bf16 operands,
//   float32 accumulation, bf16 out,
// with an optional row pre-pass that writes A = [LN](x [+ add]) once
// (rows_prologue) and four epilogues:
//   kStore         out (M, N)                             (D's QKV)
//   kHeads         out (3, B, heads, S, 64), row m = b S + s, column
//                  n = which C + head 64 + d              (C's QKV, the layout
//                                                          the flash forward reads)
//   kBiasResidual  out (M, N) [+ residual (M, N)]          (C's and D's
//                  out-projections, B's second product, whose residual with
//                  an addend is bf16(x + add), written by the pre-pass)
//   kGeglu         u = bf16((A + b1a) gelu_erf(G + b1g)) where [A | G] are
//                  the products with W rows [j] and [N + j] (B's first product)
//
// Design (Hopper, warp-specialised, persistent). A block of three
// warpgroups stays on its SM and walks output tiles blockIdx.x, +gridDim.x,
// ... (N fastest, so the blocks in flight share A rows in L2). Warpgroup 0 is
// the producer (setmaxnreg 40): one thread keeps TMA loads of 128 x 64 A
// boxes and WN x 64 W boxes (GEGLU: two 128-row boxes, A's and G's) in a
// ring of 128-byte-swizzled stages (four or five, as shared memory allows),
// each completing on its "full" mbarrier and freed by an "empty" mbarrier
// that each consumer warp arrives at once its wgmma on the stage has
// finished; it runs on into the next tile's stages while the consumers
// finish the last tile. Warpgroups 1 and 2 (setmaxnreg 232) own rows
// [0, 64) and [64, 128) of the tile: the accumulator starts at the bias,
// then wgmma m64nWNk16 with both operands K-major in shared memory, one
// group in flight; the epilogue writes bf16 into a 64-byte-swizzled staging
// tile (conflict-free for the accumulator layout, addressed by 32-bit
// shared addresses), which TMA stores in 32 x 64 boxes (bulk groups, not
// waited for until the staging tile is needed again); a residual tile is
// TMA-loaded into the staging tile at the start of the tile, so it arrives
// under the mainloop; kHeads copies the staging tile out with 16-byte
// stores instead, since its 64 rows may span two batches. Tiles are WN =
// 192, 160 or 128 columns wide (pick_bn: no padded columns at the UNet's
// widths, e.g. 160 for N = 320, 640, 1280 and 192 for 3C); one width a
// kernel keeps the wgmma free of branches (ptxas serialises wgmma behind a
// divergent path, C7520). GEGLU tiles hold 128 columns of u from one
// m64n256 product of A's and G's W rows. Rows and K columns past the
// operands are zero-filled by TMA; rows and columns past the output are
// clipped by the TMA store, so any M works. TMA needs 16-byte aligned bases
// and strides: K % 8 == 0 and N % 8 == 0 (the wrappers check, ops/gemm.py).
//
// Bound on the H100: operations for kernel B (24 K N multiply-adds a row
// against ~4 (K + N) bytes, far above the card's ~295 operations a byte,
// even with u's bf16 round trip through device memory) and for C's and D's
// projections at large C; bytes where C is small (the QKV product at C =
// 320 writes 3C bf16 a row for 2 * 3C * C operations). The row pre-pass
// reads x once and writes A (and for B with an addend xa) once: ~0.5 GB at
// B's level-0 shape of 576x1024, 0.15 ms at 3.35 TB/s.
#pragma once

#include "hopper.cuh"

namespace gemm {

constexpr int kBM = 128;  // output rows a tile holds, 64 per consumer warpgroup
constexpr int kBK = 64;   // K columns a ring stage holds: one 128-byte swizzled box
constexpr int kGegluBN = 128;  // columns of u a GEGLU tile holds
constexpr int kBoxCols = 32;                  // columns of an output box: 64 bytes, 64-byte swizzle
constexpr int kBoxBytes = 64 * kBoxCols * 2;  // one warpgroup's 64 rows of one output box
constexpr int kMaxRowVecs = 8;  // rows_prologue: K <= 32 lanes x 8 vectors x 8 = 2048
constexpr int kMaxK = 32 * kMaxRowVecs * 8;
constexpr size_t kMaxSmem = 232448;

enum Mode { kStore = 0, kHeads = 1, kBiasResidual = 2, kGeglu = 3 };

// The caller, as a template tag, so that a profile can tell kernel B's
// launches (mlp_gemm) from C's and D's projections (projection_gemm).
struct mlp_gemm {};
struct projection_gemm {};

// What the epilogue needs beyond the accumulator.
struct Epilogue {
  bf16* out;         // kHeads: the q/k/v scratch (the other modes store through a tensor map)
  const bf16* bias;  // (N,), GEGLU (2N,) = [b1a | b1g]; or null. It initialises the accumulator.
  int mode;
  int residual;      // kBiasResidual: add the residual tile (tres)
  int s;             // kHeads: S and C
  int c;
};

// WN: the output columns of a tile (the wgmma width; GEGLU: 128 columns of
// u from a 256-wide product).
template <int WN, bool GEGLU>
struct Tile {
  static constexpr int kBN = WN;
  static constexpr int kWRows = GEGLU ? 2 * WN : WN;  // W rows a stage holds = accumulator columns
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + kWRows * kBK * 2;
  static constexpr int kOutBytes = kBM * WN * 2;  // the staging tile of both warpgroups
  static constexpr int kRing = (kMaxSmem - 1024 - 256 - kOutBytes) / kStageBytes;
  static constexpr int kStages = kRing < 5 ? kRing : 5;
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + kOutBytes + 8 * (2 * kStages + 2);
  static_assert(WN % kBoxCols == 0 && kStageBytes % 1024 == 0 && kSmem <= kMaxSmem, "tile");
};

// ---------------------------------------------------------------------------
// Device
// ---------------------------------------------------------------------------

// D (64 x N, float32) = or += A (64 x 16) B (16 x N), both K-major in
// shared memory.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  wgmma_ss_n128(d, da, db, accumulate);
}

template <>
__device__ __forceinline__ void wgmma_ss<160>(float (&d)[80], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float2 load_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One box of a rank-5 tensor map from shared memory to device memory, in
// this thread's bulk group; elements outside the tensor are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %4, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(0)
      : "memory");
}
// Named barrier of one warpgroup.
__device__ __forceinline__ void wg_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// 32-bit shared-memory accesses by address (no generic 64-bit pointers,
// which ptxas would keep live for every element of the epilogue).
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// gelu(g) = 0.5 g (1 + erf(g / sqrt(2))) with the erf of the TPU kernel
// (pallas_mlp._erf: Abramowitz-Stegun 7.1.26, max abs error 1.5e-7, below
// bf16's resolution): one reciprocal and one exp2 on the SFU and a few
// FMAs.
__device__ __forceinline__ float gelu_erf(float g) {
  const float x = g * 0.70710678118654752f, ax = fabsf(x);
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  const float poly = fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f), t, -0.284496736f), t,
                          0.254829592f) * t;
  const float erf_ax = 1.f - poly * fast_exp2(-ax * ax * 1.4426950408889634f);
  return 0.5f * g * (1.f + copysignf(erf_ax, x));
}

// kHeads: a warpgroup's 64 x WN staging tile into C's q/k/v scratch (3, B,
// heads, S, 64) by 16-byte stores (8 columns of one row each); row m is
// (b, s) = (m / S, m % S), column n is (which, head, d) = (n / C, n % C / 64,
// n % 64). A TMA store would need the 64 rows of a box in one batch.
template <int WN>
__device__ __forceinline__ void heads_copy_out(uint32_t out_s, const Epilogue& ep, int row0, int n0, int m, int n,
                                               int wt) {
  const int batches = m / ep.s, heads = ep.c / 64;
  for (int v = wt; v < 64 * (WN / 8); v += 128) {
    const int r = v / (WN / 8), c8 = v % (WN / 8);
    const int row = row0 + r, col = n0 + 8 * c8;
    if (row >= m || col >= n) continue;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(out_s + (c8 / 4) * kBoxBytes + r * 64 + (((c8 % 4) ^ ((r >> 1) & 3)) << 4))
                 : "memory");
    const int which = col / ep.c, head = (col % ep.c) / 64, d = col % 64;
    const int b = row / ep.s, sp = row % ep.s;
    *reinterpret_cast<uint4*>(ep.out + ((static_cast<int64_t>(which * batches + b) * heads + head) * ep.s + sp) * 64 +
                              d) = val;
  }
}

template <int WN, bool GEGLU, class Owner>
__global__ void __launch_bounds__(384, 1)
    hopper_gemm(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tres, Epilogue ep, int m,
                int n, int k) {
  using T = Tile<WN, GEGLU>;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* staging = smem + kStages * T::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + T::kOutBytes);
  uint64_t* empty = full + kStages;
  uint64_t* res_full = empty + kStages;

  const int tiles_n = (n + T::kBN - 1) / T::kBN;
  const int tiles = (m + kBM - 1) / kBM * tiles_n;
  const int nk = (k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(&res_full[0], 1);
    mbar_init(&res_full[1], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer.
    regs_dec<40>();
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * T::kBN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % kStages;
          bf16* As = reinterpret_cast<bf16*>(smem + s * T::kStageBytes);
          bf16* Ws = reinterpret_cast<bf16*>(smem + s * T::kStageBytes + T::kABytes);
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], T::kStageBytes);
          tma_load(As, &ta, &full[s], kb * kBK, m0, 0, 0);
          tma_load(Ws, &tw, &full[s], kb * kBK, n0, 0, 0);
          if constexpr (GEGLU) tma_load(Ws + WN * kBK, &tw, &full[s], kb * kBK, n0, 1, 0);
        }
      }
    }
  } else {
    // Consumers: warpgroup w owns rows [64 w, 64 w + 64) of each tile. This
    // thread's accumulator elements are rows 16 warp + g (+8), columns
    // 8 i + 2 t4 (+1) of the tile (GEGLU: columns [0, 128) are A's, [128,
    // 256) G's).
    regs_inc<232>();
    const int ct = threadIdx.x - 128, w = ct / 128, wt = ct % 128;
    const int warp = wt / 32, lane = wt % 32, g = lane / 4, t4 = lane % 4;
    const bool has_res = !GEGLU && ep.mode == kBiasResidual && ep.residual;
    // The warpgroup's staging tile: 64 x WN bf16 in boxes of 64 rows x 32
    // columns, each row's four 16-byte chunks swizzled by (row / 2) % 4, as
    // TMA's 64-byte swizzle lays them out (no bank conflicts for the
    // accumulator layout). slot[j]: this thread's address for chunk j of
    // its first row; (row / 2) % 4 is (g / 2) % 4 for both its rows.
    const uint32_t out_s = smem_addr(staging) + w * (T::kOutBytes / 2);
    uint32_t slot[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) slot[j] = out_s + (16 * warp + g) * 64 + ((j ^ ((g >> 1) & 3)) << 4) + 4 * t4;
    float acc[T::kWRows / 2];
    uint32_t it = 0, res_phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * T::kBN;
      const int row0 = m0 + 64 * w;
      const bool live = row0 < m;  // a ragged last tile may leave one warpgroup no rows
      if (wt == 0 && has_res && live) {
        // The residual comes into the staging tile under the mainloop, once
        // the last tile's stores have read it.
        bulk_wait_read();
        mbar_expect_tx(&res_full[w], 64 * WN * 2);
#pragma unroll
        for (int bx = 0; bx < WN / kBoxCols; ++bx)
          tma_load(staging + w * (T::kOutBytes / 2) + bx * kBoxBytes, &tres, &res_full[w], n0 + bx * kBoxCols, row0,
                   0, 0);
      }
      // The accumulator starts at the bias.
#pragma unroll
      for (int i = 0; i < T::kWRows / 8; ++i) {
        const int col = n0 + 8 * (i % (WN / 8)) + 2 * t4;
        const float2 b = ep.bias != nullptr && col < n ? load_bf2(ep.bias + (i < WN / 8 ? col : n + col))
                                                       : make_float2(0.f, 0.f);
        acc[4 * i] = acc[4 * i + 2] = b.x;
        acc[4 * i + 1] = acc[4 * i + 3] = b.y;
      }

      // Each k-step waits for its stage, issues its products and commits;
      // the products of the step before are then waited for and their
      // stage freed.
      auto issue = [&] {
        const int s = it % kStages;
        const bf16* As = reinterpret_cast<const bf16*>(smem + s * T::kStageBytes);
        const bf16* Ws = reinterpret_cast<const bf16*>(smem + s * T::kStageBytes + T::kABytes);
        mbar_wait(&full[s], (it / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kBK / 16; ++kc)
          wgmma_ss<T::kWRows>(acc, desc_k(As, kBM, 64 * w, kc), desc_k(Ws, T::kWRows, 0, kc), 1);
        wgmma_commit();
        ++it;
      };
      issue();
      for (int kb = 1; kb < nk; ++kb) {
        issue();
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 2) % kStages]);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

      // Epilogue: bf16 into the staging tile, then out by TMA (kHeads, whose
      // 64 rows may span two batches, by 16-byte stores).
      if (wt == 0) bulk_wait_read();  // the last tile's stores have read the staging tile
      wg_sync(1 + w);
      if (has_res && live) {
        mbar_wait(&res_full[w], res_phase);
        res_phase ^= 1;
      }
#pragma unroll
      for (int i = 0; i < WN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t addr = slot[i % 4] + (i / 4) * kBoxBytes + h * 8 * 64;
          float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          if constexpr (GEGLU) {
            v0 *= gelu_erf(acc[4 * (i + WN / 8) + 2 * h]);
            v1 *= gelu_erf(acc[4 * (i + WN / 8) + 2 * h + 1]);
          } else if (has_res) {
            const float2 x = unpack_bf16(ld_shared(addr));
            v0 += x.x;
            v1 += x.y;
          }
          st_shared(addr, pack_bf16(v0, v1));
        }
      if (ep.mode == kHeads) {
        wg_sync(1 + w);
        heads_copy_out<WN>(out_s, ep, row0, n0, m, n, wt);
        continue;
      }
      fence_async_smem();
      wg_sync(1 + w);
      if (wt == 0 && live) {
#pragma unroll
        for (int bx = 0; bx < WN / kBoxCols; ++bx)
          if (n0 + bx * kBoxCols < n) tma_store(&tout, out_s + bx * kBoxBytes, n0 + bx * kBoxCols, row0);
        bulk_commit();
      }
    }
    if (wt == 0) bulk_wait();  // shared memory stays until the last stores are done
  }
}

// One warp per row: xa = bf16(x [+ add]) and, with ln_w, the row LayerNorm
// of xa (float32 mean and variance, two passes over the row in registers),
// rounded to bf16: the A operand of the GEMM, written once; xa itself too
// where xa_out is given (kernel B's residual with an addend).
template <class Owner, int V>
__global__ void __launch_bounds__(256) rows_prologue_kernel(const bf16* __restrict__ x, const bf16* __restrict__ add,
                                                            int64_t rows_per_group, int s_a,
                                                            const float* __restrict__ ln_w,
                                                            const float* __restrict__ ln_b, float eps,
                                                            bf16* __restrict__ out, bf16* __restrict__ xa_out,
                                                            int64_t m, int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const int nv = k / 8;
  const bf16* xr = x + row * k;
  const bf16* ar = add != nullptr ? add + ((row / rows_per_group) * s_a + row % s_a) * k : nullptr;
  Vec16<bf16> v[V];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = lane + 32 * j;
    if (c < nv) {
      v[j] = load16(xr + 8 * c);
      if (ar != nullptr) {
        const Vec16<bf16> a = load16(ar + 8 * c);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[j].set(e, v[j].get(e) + a.get(e));
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[j].get(e);
    }
  }
  if (xa_out != nullptr) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < nv) store16(xa_out + row * k + 8 * c, v[j]);
    }
  }
  if (ln_w != nullptr) {
    const float mean = warp_sum(sum) / k;
    float var = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (lane + 32 * j < nv)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[j].get(e) - mean;
          var += d * d;
        }
    const float rstd = rsqrtf(warp_sum(var) / k + eps);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      if (c < nv)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[j].set(e, (v[j].get(e) - mean) * rstd * ln_w[8 * c + e] + ln_b[8 * c + e]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = lane + 32 * j;
    if (c < nv) store16(out + row * k + 8 * c, v[j]);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// A bf16 tensor map: dims innermost first, byte strides of dims 1.., box,
// swizzle. ops/gemm.py:tensor_maps describes the maps below.
inline int encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A K-major operand (rows, k) loaded in boxes of 64 columns x `box_rows`
// rows, 128-byte swizzle; `halves` 2 for GEGLU's W1, whose G rows follow
// its A rows (dims (k, rows, 2)).
inline int operand_map(CUtensorMap* map, const void* base, int64_t rows, int k, int box_rows, int halves) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(halves), 1};
  const cuuint64_t row = static_cast<cuuint64_t>(k) * 2, half = row * rows;
  const cuuint64_t strides[3] = {row, half, half * halves};
  const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(box_rows), 1, 1};
  return encode(map, base, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The product in tiles WN columns wide.
template <int WN, bool GEGLU, class Owner>
int launch(const CUtensorMap& ta, const void* w, const CUtensorMap& tout, const CUtensorMap& tres, const Epilogue& ep,
           int64_t m, int n, int k, cudaStream_t st) {
  using T = Tile<WN, GEGLU>;
  CUtensorMap tw;
  int err = operand_map(&tw, w, n, k, WN, GEGLU ? 2 : 1);
  if (!err) err = set_smem(reinterpret_cast<const void*>(hopper_gemm<WN, GEGLU, Owner>), T::kSmem);
  if (err) return err;
  const int64_t tiles = (m + kBM - 1) / kBM * ((n + WN - 1) / WN);
  if (tiles == 0) return 0;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  hopper_gemm<WN, GEGLU, Owner><<<grid, 384, T::kSmem, st>>>(ta, tw, tout, tres, ep, static_cast<int>(m), n, k);
  return static_cast<int>(cudaGetLastError());
}

// An (m, n) output (rank 5, n innermost) or residual (rank 4) in 32 x 64
// boxes, 64-byte swizzle.
inline int rows_map(CUtensorMap* map, const void* base, int64_t m, int n, int rank) {
  const cuuint64_t all = static_cast<cuuint64_t>(m) * n * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(m), 1, 1, 1};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(n) * 2, all, all, all};
  const cuuint32_t box[5] = {kBoxCols, 64, 1, 1, 1};
  return encode(map, base, rank, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

inline int check(const void* a, CUtensorMap* ta, int64_t m, int n, int k) {
  if (m >= (int64_t{1} << 31) / kBM || k % 8 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  return operand_map(ta, a, m, k, kBM, 1);
}

// xa = bf16(x [+ add]) and, with ln_w, LN(xa) into `out` (m, k): the A
// operand of a product that needs a prologue; xa into `xa_out` if it is not
// null. Needs k % 8 == 0, k <= kMaxK.
template <class Owner>
int rows_prologue(const void* x, const void* add, int64_t rows_per_group, int s_a, const float* ln_w,
                  const float* ln_b, float eps, void* out, void* xa_out, int64_t m, int k, cudaStream_t st) {
  if (k % 8 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  // As few vectors a lane as the row needs: fewer registers, more rows in
  // flight on each SM.
  auto run = [&](auto kernel) {
    kernel<<<static_cast<unsigned>((m + 7) / 8), 256, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(add), rows_per_group, s_a, ln_w, ln_b, eps,
        static_cast<bf16*>(out), static_cast<bf16*>(xa_out), m, k);
  };
  const int vecs = (k / 8 + 31) / 32;
  if (vecs <= 2) run(rows_prologue_kernel<Owner, 2>);
  else if (vecs <= 3) run(rows_prologue_kernel<Owner, 3>);
  else if (vecs <= 5) run(rows_prologue_kernel<Owner, 5>);
  else run(rows_prologue_kernel<Owner, kMaxRowVecs>);
  return static_cast<int>(cudaGetLastError());
}

// The widest of 192, 160 and 128 columns that pads N least (no padding at
// N = 320, 640, 1280 (160) or 960, 1920, 3840 (192)). ops/gemm.py:tile_n
// mirrors it.
inline int pick_bn(int n) {
  const int widths[3] = {192, 160, 128};
  int best = 0, pad_best = 1 << 30;
  for (int bn : widths) {
    const int pad = (n + bn - 1) / bn * bn - n;
    if (pad < pad_best) best = bn, pad_best = pad;
  }
  return best;
}

// out = epilogue(a (m, k) . w (n, k)^T) for kStore, kHeads (out (3, m / S,
// C / 64, S, 64); ep.s = S, ep.c = C) and kBiasResidual (`residual` (m, n)
// or null), in tiles of pick_bn(n) columns.
template <class Owner>
int linear(const void* a, const void* w, void* out, const void* residual, Epilogue ep, int64_t m, int n, int k,
           cudaStream_t st) {
  CUtensorMap ta, tout, tres;
  int err = check(a, &ta, m, n, k);
  if (!err) err = rows_map(&tout, out, m, n, 5);  // kHeads: unused (16-byte stores)
  if (!err) err = rows_map(&tres, residual != nullptr ? residual : out, m, n, 4);
  if (err) return err;
  ep.out = static_cast<bf16*>(out);
  ep.residual = residual != nullptr;
  switch (pick_bn(n)) {
    case 192: return launch<192, false, Owner>(ta, w, tout, tres, ep, m, n, k, st);
    case 160: return launch<160, false, Owner>(ta, w, tout, tres, ep, m, n, k, st);
    default: return launch<128, false, Owner>(ta, w, tout, tres, ep, m, n, k, st);
  }
}

// u (m, n) = bf16((A + b1a) gelu_erf(G + b1g)), [A | G] = a (m, k) . w1
// (2n, k)^T, b1 (2n,).
template <class Owner>
int geglu(const void* a, const void* w1, const void* b1, void* u, int64_t m, int n, int k, cudaStream_t st) {
  CUtensorMap ta, tout;
  int err = check(a, &ta, m, n, k);
  if (!err) err = rows_map(&tout, u, m, n, 5);
  if (err) return err;
  Epilogue ep{};
  ep.out = static_cast<bf16*>(u);
  ep.bias = static_cast<const bf16*>(b1);
  ep.mode = kGeglu;
  return launch<kGegluBN, true, Owner>(ta, w1, tout, tout, ep, m, n, k, st);
}

inline Epilogue epilogue(int mode, const void* bias = nullptr) {
  Epilogue ep{};
  ep.bias = static_cast<const bf16*>(bias);
  ep.mode = mode;
  return ep;
}

}  // namespace gemm
