// Tensor-core and copy helpers shared by the attention kernels: mma.sync
// m16n8k16 (bf16 in, float32 accumulate), ldmatrix fragment loads, cp.async.
//
// Fragment layouts of m16n8k16, lane = 4 * g + t:
//   A (16x16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..),
//                         a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)
//   B (16x8):             b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C (16x8, float32):    c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so an accumulator tile pair (n 0-7, n 8-15) packs into the A operand of
// the next product without leaving registers.
#pragma once

#include "common.cuh"

namespace {

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

// A operand: rows [r0, r0+16) x k [k0, k0+16) of a row-major smem tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base, int ld, int r0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4(a, base + (r0 + (mi & 1) * 8 + mr) * ld + k0 + (mi >> 1) * 8);
}

// B operands of two n8 tiles, n [n0, n0+16) x k [k0, k0+16), from a tile
// stored [n][k]: (b[0], b[1]) for n0.., (b[2], b[3]) for n0+8...
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* base, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4(b, base + (n0 + (mi >> 1) * 8 + mr) * ld + k0 + (mi & 1) * 8);
}

// The same from a tile stored [k][n], transposed by ldmatrix.trans.
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* base, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4_trans(b, base + (k0 + (mi & 1) * 8 + mr) * ld + n0 + (mi >> 1) * 8);
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

// The A operand (16 x k16) made of accumulator tiles n and n+1 (16x8 each).
__device__ __forceinline__ void pack_a(uint32_t* a, const float* lo, const float* hi) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace
