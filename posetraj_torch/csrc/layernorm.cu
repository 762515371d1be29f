// Kernel 8: row LayerNorm in one pass over x (M, C), bf16 or float32:
//   mean = sum(x) / C, var = sum((x - mean)^2) / C (the mean of the squared
//   deviation, not E[x^2] - mean^2), y = (x - mean) * rsqrt(var + eps) * w + b,
//   statistics and affine in float32, y cast back to x's type.
//
// Replaces posetraj_tpu/ops/pallas_groupnorm.py:fused_layer_norm
// (_ln_kernel), which holds (bm, C) blocks of whole rows in VMEM.
//
// Bound on the H100: bytes. x is read once and y written once (4 bytes a
// value in bf16, 8 in float32) against ~8 float operations a value. The
// launch plan is ops/layernorm.py:plan; the design, for this card:
// - A persistent grid: as many CTAs as the SMs hold at once (the
//   occupancy the compiled instance reaches), each warp walking many groups
//   of rows.
// - A row maps onto a group of `lanes` lanes (a power of two) that divides
//   its 16-byte vectors where it can: C = 320 in bf16 is 40 vectors, 8
//   lanes x 5, four rows a warp, no idle lane. Each lane holds its V
//   vectors of the row in registers, in float32 once loaded, so the two
//   statistics and the affine never re-read device memory; the sums are
//   shuffles within the group. Widths whose vector count has no such split
//   (C = 328: 41 vectors) take the whole warp and a ragged last round.
// - While a group of rows reduces, the warp's next group is already loading
//   into the registers its vectors left; the first group loads while w and
//   b go to shared memory.
// - w and b are read once a CTA, as float4, into shared memory, laid out as
//   planes of float4 so that the lanes of a group, reading consecutive
//   vectors, touch consecutive 16 bytes: no bank conflict, and a broadcast
//   across the groups of a warp.
// - Stores are 16 bytes with the streaming hint (st.global.cs).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // ops/layernorm.py THREADS
constexpr int kWarps = kThreads / 32;

// The registers a thread should take for V vectors a lane of 16 / bytes
// values each: the row being reduced in float32, the next row's vectors in
// flight and 48 more (ptxas spilled at 40 with 4 and 11 float32 vectors),
// in granules of 8; and the CTAs an SM holds within its 65536 at that
// count, at most 8. The launch bounds hold the compiler to it; the grid is
// sized from the occupancy it reached (pt_layer_norm_ctas_per_sm).
__host__ __device__ constexpr int target_registers(int v, int bytes) {
  return ((16 / bytes + 4) * v + 48 + 7) / 8 * 8;
}
__host__ __device__ constexpr int target_ctas(int v, int bytes) {
  return 65536 / (kThreads * target_registers(v, bytes)) < 8 ? 65536 / (kThreads * target_registers(v, bytes)) : 8;
}

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store_cs(void* p, const uint4& v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// One lane's V vectors of a row (zeros where the row or the vector is out of range).
template <int V>
__device__ __forceinline__ void load_row(uint4 (&v)[V], const void* __restrict__ x, int64_t row, int64_t m,
                                         int64_t row_vecs, int sub, int lanes) {
  const uint4* xr = static_cast<const uint4*>(x) + row * row_vecs;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = sub + lanes * i;
    v[i] = (row < m && vi < row_vecs) ? __ldg(xr + vi) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, target_ctas(V, sizeof(T)))
    ln_rows(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b, T* __restrict__ y,
            int64_t m, int c, int lanes, float eps) {
  constexpr int kE = Vec16<T>::N;  // values per 16-byte vector of x
  constexpr int kP = kE / 4;       // float4 of w (and of b) per vector of x
  extern __shared__ float4 wb[];   // [w, b][kP planes][nv vectors]
  const int nv = c / kE;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);  // this lane's place in its row's group
  const int rows = 32 / lanes;         // rows a warp takes at a time
  const int64_t slot = lane / lanes;   // which of them is this lane's
  const int64_t groups = (m + rows - 1) / rows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t g = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;

  // The first group of rows starts loading before w and b go to shared
  // memory, so that the two latencies overlap.
  uint4 nxt[V];
  const bool active = g < groups;
  if (active) load_row<V>(nxt, x, g * rows + slot, m, nv, sub, lanes);
  {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int k = threadIdx.x; k < c / 4; k += kThreads) {
      const int vi = k / kP, p = k % kP;
      wb[p * nv + vi] = __ldg(w4 + k);
      wb[(kP + p) * nv + vi] = __ldg(b4 + k);
    }
  }
  __syncthreads();
  if (!active) return;  // the whole warp leaves: no shuffle waits on it
  const float inv_c = 1.f / static_cast<float>(c);

  for (; g < groups; g += stride) {
    const int64_t row = g * rows + slot;
    // This group's row in float32; its vectors' registers take the next
    // group's loads.
    float f[V][kE];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      Vec16<T> v;
      v.raw = nxt[i];
#pragma unroll
      for (int e = 0; e < kE; ++e) f[i][e] = v.get(e);
    }
    if (g + stride < groups) load_row<V>(nxt, x, (g + stride) * rows + slot, m, nv, sub, lanes);

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int e = 0; e < kE; ++e) sum += f[i][e];
    }
    const float mean = group_sum(sum, lanes) * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (sub + lanes * i < nv) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float d = f[i][e] - mean;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(group_sum(sq, lanes) * inv_c + eps);

    if (row < m) {
      T* yr = y + row * c;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int vi = sub + lanes * i;
        if (vi < nv) {
          Vec16<T> out;
#pragma unroll
          for (int p = 0; p < kP; ++p) {
            const float4 wv = wb[p * nv + vi], bv = wb[(kP + p) * nv + vi];
            const float ws[4] = {wv.x, wv.y, wv.z, wv.w}, bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) out.set(4 * p + e, (f[i][4 * p + e] - mean) * rstd * ws[e] + bs[e]);
          }
          store_cs(yr + static_cast<int64_t>(vi) * kE, out.raw);
        }
      }
    }
  }
}

// The instance for `vecs` vectors a lane: C <= 2048 gives at most 8 in
// bf16 and 16 in float32 (ops/layernorm.py:max_vecs); null for any other.
#define PT_LN_CASE(T, V) \
  case V: return reinterpret_cast<const void*>(ln_rows<T, V>);

const void* instance(int is_bf16, int vecs) {
  if (is_bf16) {
    switch (vecs) {
      PT_LN_CASE(bf16, 1) PT_LN_CASE(bf16, 2) PT_LN_CASE(bf16, 3) PT_LN_CASE(bf16, 4) PT_LN_CASE(bf16, 5)
      PT_LN_CASE(bf16, 6) PT_LN_CASE(bf16, 7) PT_LN_CASE(bf16, 8)
    }
    return nullptr;
  }
  switch (vecs) {
    PT_LN_CASE(float, 1) PT_LN_CASE(float, 2) PT_LN_CASE(float, 3) PT_LN_CASE(float, 4) PT_LN_CASE(float, 5)
    PT_LN_CASE(float, 6) PT_LN_CASE(float, 7) PT_LN_CASE(float, 8) PT_LN_CASE(float, 9) PT_LN_CASE(float, 10)
    PT_LN_CASE(float, 11) PT_LN_CASE(float, 12) PT_LN_CASE(float, 13) PT_LN_CASE(float, 14)
    PT_LN_CASE(float, 15) PT_LN_CASE(float, 16)
  }
  return nullptr;
}
#undef PT_LN_CASE

constexpr size_t kMaxSmem = 2 * 2048 * sizeof(float);  // w and b at C = 2048

}  // namespace

// The CTAs of the instance for `vecs` vectors a lane an SM holds at once,
// with the shared memory of the widest row, into *ctas: the occupancy
// ptxas's register count allows, from which the plan sizes its grid.
PT_EXPORT int pt_layer_norm_ctas_per_sm(int is_bf16, int vecs, int* ctas) {
  const void* fn = instance(is_bf16, vecs);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, kMaxSmem));
}

// x, y (M, C) contiguous, bf16 (is_bf16 = 1) or float32; w, b (C,) float32,
// all 16-byte aligned. C must be a multiple of 8 and at most 2048. The plan
// (ops/layernorm.py:plan): `lanes` lanes a row (a power of two, at most 32),
// `vecs` 16-byte vectors a lane (lanes * vecs covers the row), `grid` CTAs.
PT_EXPORT int pt_layer_norm(const void* x, const float* w, const float* b, void* y, long long m, int c, float eps,
                            int is_bf16, int lanes, int vecs, int grid, void* stream) {
  const int nv = c / (is_bf16 ? 8 : 4);
  const void* fn = instance(is_bf16, vecs);
  if (fn == nullptr || c % 8 != 0 || c > 2048 || m < 1 || grid < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || lanes * vecs < nv)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t rows = m;
  void* args[] = {&x, &w, &b, &y, &rows, &c, &lanes, &eps};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, static_cast<size_t>(2) * c *
                                           sizeof(float), static_cast<cudaStream_t>(stream)));
}
