// Hopper building blocks shared by the flash-attention kernels, the GEMM
// of kernels B, C and D (gemm.cuh), kernel A and D's frame attention
// (sm_90a): host-built TMA tensor maps, TMA loads that complete on an
// mbarrier, one-dimensional bulk copies, the mbarrier ring's init / arrive /
// expect-tx / wait, wgmma shared-memory
// descriptors for 128-byte-swizzled tiles, fence / commit / wait, the wgmma
// products the kernels use, the conversion of a float32 wgmma accumulator
// into a bf16 register A operand, and setmaxnreg.
//
// Tiles. Every operand tile in shared memory is what a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 64 bf16 (128 bytes), eight
// rows to a 1024-byte swizzle atom; a head_dim of 128 is two such
// 64-column tiles one after the other ([half][rows][64]). Tiles start on
// 1024-byte boundaries, so the descriptors' base offset is 0.
//
// Accumulator layout of wgmma m64nNk16 (float32), thread 32 w + 4 g + t of
// the warpgroup: d[4 i + 0, 1] at row 16 w + g, columns 8 i + 2 t, +1, and
// d[4 i + 2, 3] at row 16 w + g + 8. The bf16 A operand of m64nNk16 from
// registers has the same rows and k = columns, so accumulator chunks 2 kc
// and 2 kc + 1 pack into the A operand of k-step kc without leaving
// registers (acc_to_a).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time (no -lcuda)

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// Element strides of an operand addressed by (batch, head, row); the
// head_dim axis is contiguous.
struct Layout {
  int64_t batch, head, row;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the libraries need no
// -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The rank-4 tensor map (hd, s, heads, b) of a bf16 operand with element
// strides `l`, loaded in boxes of 64 columns x `rows` rows of one (batch,
// head). S has its own axis, so rows past s are zero-filled and a box never
// reaches the next head's or batch's rows. The base address and the byte
// strides must be multiples of 16 (the wrapper checks).
static int make_tmap(CUtensorMap* map, const void* base, int hd, int64_t s, int64_t heads, int64_t b, Layout l,
                     int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(l.row) * 2, static_cast<cuuint64_t>(l.head) * 2,
                                 static_cast<cuuint64_t>(l.batch) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Device: scalars
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Dynamic shared memory rounded up to the 1024-byte swizzle atom (the
// launch asks for 1024 bytes more than the tiles need).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ---------------------------------------------------------------------------
// Device: mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// After the inits, before any other thread uses the barriers.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives once and expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0: waiting on parity 1 passes at once (a free ring slot). A
// wait that has not completed after 2^24 tries (far longer than any tile
// takes) traps, so a broken ring fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// One box of a rank-4 tensor map at coordinates (c0 .. c3), innermost
// first, into shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One-dimensional bulk copies (no tensor map): `bytes` (a multiple of 16,
// 16-byte aligned) from global memory into shared memory, completing on
// `bar`, which first expects them; and from shared memory to global memory
// in this thread's bulk group.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// The stores this thread issued have read their shared memory / have completed.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Generic-proxy accesses to shared memory, ordered before a bulk or TMA copy
// of the same bytes after it.
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// Device: warpgroup MMA
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders the compiler's own reads and writes of an accumulator after the
// wgmma_wait before it (and before the wgmma after it).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// K-major operand (rows x head_dim, head_dim contiguous): 64 rows from
// `row0`, k-step kc (16 columns) of a [half][rows][64] tile. A k-step moves
// 32 bytes along the swizzled row; eight rows are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int row0, int kc) {
  return sw128_desc(tile + (kc / 4) * rows * 64 + row0 * 64 + (kc % 4) * 16, 16, 1024);
}

// MN-major B operand (k = rows of the tile, n = 64 columns of half `h`):
// k-step kc is rows [16 kc, 16 kc + 16); eight rows are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows, int kc, int h) {
  return sw128_desc(tile + h * rows * 64 + kc * 16 * 64, rows * 128, 1024);
}

// The bf16 A operand of k-step kc from a float32 accumulator (chunks 2 kc
// and 2 kc + 1), rounded to nearest.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int kc) {
  a[0] = pack_bf16(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

// D (64 x N, float32) = or += A (64 x 16) B (16 x N), bf16 operands. _ss:
// A and B K-major in shared memory; _rs: A from registers, B MN-major in
// shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

}  // namespace
