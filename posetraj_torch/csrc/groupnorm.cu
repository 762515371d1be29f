// Kernel A: channels-last GroupNorm (+ SiLU) (+ per-sample or per-frame
// channel addend), bf16 or float32.
//
// Replaces posetraj_tpu/ops/pallas_groupnorm.py:fused_group_norm (its
// _stats_kernel and _norm_kernel Pallas calls and the jnp combine between).
//
// Bound on the H100: bytes. Per element it does a handful of float
// operations against 2 reads and 1 write of the activation, far below the
// card's ~295 operations per byte. The design therefore moves each element
// the fewest times a two-pass norm allows:
//   1. stats:    one read; each block reduces a row range of one sample to
//                per-group [sum, sum of squares] partials (float32), with the
//                addend folded in before the statistics;
//   2. finalize: a tiny kernel sums the partials (in double) and folds mean,
//                rstd, gamma and beta into one per-(sample, channel)
//                scale/shift pair;
//   3. apply:    one read and one write: y = (x + add) * w + b, then SiLU.
// Loads and stores are 16 bytes a thread, neighbouring threads on
// neighbouring channels. Offsets are 64-bit: a VAE-decode activation at
// 576x1024 holds more than 2^28 elements.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// add: (n, add_frames, c) or null. Row r of sample i takes frame
// r / (s / add_frames).
template <typename T>
__global__ void gn_stats(const T* __restrict__ x, const T* __restrict__ add, float* __restrict__ partial,
                         int64_t s, int c, int groups, int add_frames, int64_t rows_per_block) {
  extern __shared__ float smem[];
  float* ssum = smem;
  float* ssq = smem + c;
  constexpr int V = Vec16<T>::N;
  const int tid = threadIdx.x;
  const int n_idx = blockIdx.y;
  const int nb = gridDim.x;
  for (int i = tid; i < c; i += blockDim.x) {
    ssum[i] = 0.f;
    ssq[i] = 0.f;
  }
  __syncthreads();

  const int chunks = c / V;
  const int tx_n = chunks < kThreads ? chunks : kThreads;
  const int ty_n = kThreads / tx_n;
  const int tx = tid % tx_n;
  const int ty = tid / tx_n;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t row1 = row0 + rows_per_block < s ? row0 + rows_per_block : s;
  const int64_t rows_per_frame = s / add_frames;
  const T* xs = x + static_cast<int64_t>(n_idx) * s * c;
  if (ty < ty_n) {
    for (int ch = tx; ch < chunks; ch += tx_n) {
      float acc[V], acc2[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
      for (int64_t r = row0 + ty; r < row1; r += ty_n) {
        Vec16<T> v = load16(xs + r * c + ch * V);
        Vec16<T> a{};
        if (add != nullptr) {
          const int64_t frame = add_frames > 1 ? r / rows_per_frame : 0;
          a = load16(add + (static_cast<int64_t>(n_idx) * add_frames + frame) * c + ch * V);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float val = v.get(j) + (add != nullptr ? a.get(j) : 0.f);
          acc[j] += val;
          acc2[j] += val * val;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        atomicAdd(&ssum[ch * V + j], acc[j]);
        atomicAdd(&ssq[ch * V + j], acc2[j]);
      }
    }
  }
  __syncthreads();
  const int cg = c / groups;
  float* out = partial + (static_cast<int64_t>(n_idx) * nb + blockIdx.x) * 2 * groups;
  for (int g = tid; g < groups; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      s1 += ssum[g * cg + k];
      s2 += ssq[g * cg + k];
    }
    out[g] = s1;
    out[groups + g] = s2;
  }
}

// scale_shift: (n, 2, c) float32 -> w = rstd * gamma, b = beta - mean * w.
__global__ void gn_finalize(const float* __restrict__ partial, const float* __restrict__ gamma,
                            const float* __restrict__ beta, float* __restrict__ scale_shift, int nb,
                            int64_t s, int c, int groups, float eps) {
  extern __shared__ float smem[];
  float* mean = smem;
  float* rstd = smem + groups;
  const int n_idx = blockIdx.x;
  const int cg = c / groups;
  const double count = static_cast<double>(s) * cg;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    double s1 = 0.0, s2 = 0.0;
    for (int b = 0; b < nb; ++b) {
      const float* p = partial + (static_cast<int64_t>(n_idx) * nb + b) * 2 * groups;
      s1 += p[g];
      s2 += p[groups + g];
    }
    const double m = s1 / count;
    const double var = fmax(s2 / count - m * m, 0.0);
    mean[g] = static_cast<float>(m);
    rstd[g] = rsqrtf(static_cast<float>(var) + eps);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    const float w = rstd[g] * gamma[ch];
    scale_shift[static_cast<int64_t>(n_idx) * 2 * c + ch] = w;
    scale_shift[static_cast<int64_t>(n_idx) * 2 * c + c + ch] = beta[ch] - mean[g] * w;
  }
}

template <typename T>
__global__ void gn_apply(const T* __restrict__ x, const T* __restrict__ add,
                         const float* __restrict__ scale_shift, T* __restrict__ y, int64_t n, int64_t s,
                         int c, int add_frames, int act) {
  constexpr int V = Vec16<T>::N;
  const int64_t total = n * s * c / V;
  const int64_t rows_per_frame = s / add_frames;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = i * V;
    const int ch = static_cast<int>(e % c);
    const int64_t row = e / c;  // n_idx * s + r
    const int64_t n_idx = row / s;
    const float* w = scale_shift + n_idx * 2 * c + ch;
    const float* b = w + c;
    Vec16<T> v = load16(x + e);
    Vec16<T> a{};
    if (add != nullptr) {
      const int64_t frame = add_frames > 1 ? (row - n_idx * s) / rows_per_frame : 0;
      a = load16(add + (n_idx * add_frames + frame) * c + ch);
    }
    Vec16<T> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float val = v.get(j) + (add != nullptr ? a.get(j) : 0.f);
      float r = val * w[j] + b[j];
      if (act) r = r / (1.f + expf(-r));
      o.set(j, r);
    }
    store16(y + e, o);
  }
}

template <typename T>
int run(const void* x, const float* gamma, const float* beta, const void* add, float* partial,
        float* scale_shift, void* y, int64_t n, int64_t s, int c, int groups, int add_frames,
        int64_t rows_per_block, float eps, int act, cudaStream_t stream) {
  const int nb = static_cast<int>((s + rows_per_block - 1) / rows_per_block);
  gn_stats<T><<<dim3(nb, static_cast<unsigned>(n)), kThreads, 2 * c * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(add), partial, s, c, groups, add_frames,
      rows_per_block);
  gn_finalize<<<static_cast<unsigned>(n), kThreads, 2 * groups * sizeof(float), stream>>>(partial, gamma, beta, scale_shift,
                                                                   nb, s, c, groups, eps);
  const int64_t vecs = n * s * c / Vec16<T>::N;
  const int64_t want = (vecs + kThreads - 1) / kThreads;
  const int64_t blocks = want < 132 * 32 ? want : 132 * 32;
  gn_apply<T><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(add), scale_shift, static_cast<T*>(y), n, s, c,
      add_frames, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n, s, c) channels-last; gamma, beta: (c,) float32; add: (n,
// add_frames, c) or null; partial: (n, ceil(s/rows_per_block), 2*groups)
// float32 scratch; scale_shift: (n, 2, c) float32 scratch.
PT_EXPORT int pt_group_norm(const void* x, const float* gamma, const float* beta, const void* add,
                            float* partial, float* scale_shift, void* y, long long n, long long s, int c,
                            int groups, int add_frames, long long rows_per_block, float eps, int act,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<bf16>(x, gamma, beta, add, partial, scale_shift, y, n, s, c, groups, add_frames,
                     rows_per_block, eps, act, st);
  return run<float>(x, gamma, beta, add, partial, scale_shift, y, n, s, c, groups, add_frames,
                    rows_per_block, eps, act, st);
}
