// Shared helpers for the port's Hopper kernels (built for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

PT_EXPORT const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// 16 bytes of T as one vector: 8 bf16 or 4 float.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ float get(int i) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[i]);
  }
  __device__ __forceinline__ void set(int i, float v) {
    reinterpret_cast<T*>(&raw)[i] = from_f32<T>(v);
  }
};

template <typename T>
__device__ __forceinline__ Vec16<T> load16(const T* p) {
  Vec16<T> v;
  v.raw = *reinterpret_cast<const uint4*>(p);
  return v;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Vec16<T>& v) {
  *reinterpret_cast<uint4*>(p) = v.raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
