// Kernel 8: row LayerNorm in one pass over x (M, C), bf16 or float32:
//   mean = sum(x) / C, var = sum((x - mean)^2) / C (the mean of the squared
//   deviation, not E[x^2] - mean^2), y = (x - mean) * rsqrt(var + eps) * w + b,
//   statistics and affine in float32, y cast back to x's type.
//
// Replaces posetraj_tpu/ops/pallas_groupnorm.py:fused_layer_norm
// (_ln_kernel), which holds (bm, C) blocks of whole rows in VMEM.
//
// Bound on the H100: bytes. x is read once and y written once (4 bytes a
// value in bf16, 8 in float32) against ~8 float operations a value. Design:
// one warp per row, eight rows a block. Each lane loads its share of the row
// in 16-byte vectors into registers (at most kVec vectors: C <= 2048), so the
// two statistics and the affine never re-read device memory; the sums are
// warp shuffles, no shared memory, no barrier. w and b (float32, C) stay in
// L1/L2 across the rows.

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <typename T, int kVec>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    ln_rows(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b, T* __restrict__ y,
            int64_t m, int c, float eps) {
  constexpr int kE = Vec16<T>::N;  // values per 16-byte vector
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;  // whole warps leave together: one row is one warp
  const int nv = c / kE;
  const T* xr = x + row * c;
  Vec16<T> v[kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      v[i] = load16(xr + vi * kE);
#pragma unroll
      for (int e = 0; e < kE; ++e) sum += v[i].get(e);
    }
  }
  const float mean = warp_sum(sum) / c;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float d = v[i].get(e) - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / c + eps);
  T* yr = y + row * c;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      Vec16<T> out;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int col = vi * kE + e;
        out.set(e, (v[i].get(e) - mean) * rstd * __ldg(w + col) + __ldg(b + col));
      }
      store16(yr + vi * kE, out);
    }
  }
}

template <typename T, int kVec>
int launch(const void* x, const float* w, const float* b, void* y, int64_t m, int c, float eps, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((m + kRowsPerBlock - 1) / kRowsPerBlock);
  ln_rows<T, kVec><<<blocks, kRowsPerBlock * 32, 0, st>>>(static_cast<const T*>(x), w, b, static_cast<T*>(y), m,
                                                          c, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* w, const float* b, void* y, int64_t m, int c, float eps, cudaStream_t st) {
  const int per_lane = (c / Vec16<T>::N + 31) / 32;  // 16-byte vectors each lane holds
  switch (per_lane) {
    case 1: return launch<T, 1>(x, w, b, y, m, c, eps, st);
    case 2: return launch<T, 2>(x, w, b, y, m, c, eps, st);
    case 3: return launch<T, 3>(x, w, b, y, m, c, eps, st);
    case 4: return launch<T, 4>(x, w, b, y, m, c, eps, st);
    case 5: return launch<T, 5>(x, w, b, y, m, c, eps, st);
    case 6: return launch<T, 6>(x, w, b, y, m, c, eps, st);
    case 7: return launch<T, 7>(x, w, b, y, m, c, eps, st);
    case 8: return launch<T, 8>(x, w, b, y, m, c, eps, st);
    default: return per_lane <= 16 ? launch<T, 16>(x, w, b, y, m, c, eps, st)
                                   : static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y (M, C) contiguous, bf16 (is_bf16 = 1) or float32; w, b (C,) float32.
// C must be a multiple of 8 and at most 2048.
PT_EXPORT int pt_layer_norm(const void* x, const float* w, const float* b, void* y, long long m, int c, float eps,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % 8 != 0 || c > 2048 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch<bf16>(x, w, b, y, m, c, eps, st) : dispatch<float>(x, w, b, y, m, c, eps, st);
}
