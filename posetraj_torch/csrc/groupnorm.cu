// Kernel A: channels-last GroupNorm (+ SiLU) (+ per-sample or per-frame
// channel addend), bf16 or float32, in one launch.
//
// Replaces posetraj_tpu/ops/pallas_groupnorm.py:fused_group_norm (its
// _stats_kernel and _norm_kernel Pallas calls and the jnp combine between).
// Its split form for W-sharded serving (the psum_axis path: statistics,
// the caller's all-reduce, apply) is the second half of this file.
//
// Bound on the H100: bytes. Per element it does a handful of float
// operations against one read and one write of the activation, far below the
// card's ~295 operations per byte. A two-pass norm reads each element twice;
// this design keeps a sample in shared memory between the two reads, so that
// HBM sees one read and one write wherever the samples in flight fit the
// card's shared memory (2 x 96 KB an SM, ~25 MB):
//   * one cooperative launch of a persistent grid (two CTAs of 512 threads
//     an SM, co-resident), split into teams; a team owns one sample at a
//     time and each of its CTAs one contiguous range of the sample's rows
//     (ops/groupnorm.schedule sizes the teams so that a sample fits its
//     team's shared memory);
//   * phase 1: thread 0 brings the CTA's rows into a ring of four 24 KB
//     slots by bulk copies (cp.async.bulk, completing on mbarriers), and the
//     CTA reduces them, addend folded in, to per-group float32 [sum, sum of
//     squares] partials, which it adds in double (as the TPU kernel's combine
//     sums its partials) to its team's sums in device memory;
//   * phase 2: the team's CTAs meet at a barrier in device memory; each reads
//     the sums and folds mean, rstd, gamma and beta into per-channel scale
//     and shift;
//   * phase 3: the CTA applies (x + add) * w + b and the SiLU to its rows in
//     shared memory, in place, and writes them out by bulk copies; as each
//     piece is written out, the next round's piece is asked in behind it.
// Rows that overflow the four slots (a sample larger than its team's shared
// memory: the VAE's 151-302 MB samples, the temporal resnets' 83 MB frame
// folds at 576x1024) stream through the ring in both phases, the second read
// coming from L2 or HBM: the same kernel, another schedule.
// The teams' counters and sums persist across calls and reset themselves (a
// team's arrival count rises through the call; the last of its CTAs to
// finish zeroes it), so a call is one launch with no memset. The double
// sums take the CTAs' partials in the order they arrive: a run may differ
// from the next in the last bits of a sum, not of a bf16 output in practice.
// Offsets are 64-bit: a VAE-decode activation at 576x1024 holds more than
// 2^28 elements.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 4;
constexpr int kSlotBytes = 24 * 1024;

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_tanh(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// SiLU t * sigmoid(t). The SFU (16 operations a clock an SM) is the limit
// of phase 3 with two of its operations an element (exp and reciprocal), so
// a bf16 output takes sigmoid(t) = (1 + tanh(t / 2)) / 2, one operation, whose
// error (~2^-11) is below the bf16 rounding after it; float32 keeps both.
template <typename T>
__device__ __forceinline__ float silu(float t) {
  if constexpr (sizeof(T) == 2) return t * fmaf(0.5f, fast_tanh(0.5f * t), 0.5f);
  return t * fast_rcp(1.f + __expf(-t));
}

// The rows one CTA owns of one sample, cut into pieces of at most
// `piece_rows` rows, piece q of the CTA's load sequence in slot q % kSlots.
struct Range {
  int row0, rows, piece_rows, pieces;
  __device__ int piece_len(int p) const {
    const int left = rows - p * piece_rows;
    return left < piece_rows ? left : piece_rows;
  }
};

// Per-channel sums of v (one V-vector a thread (tx, ty), channels [col,
// col + V) of rows ty, ty + ty_n, ...) reduced over ty in `red` (kThreads * V
// floats of shared memory), then per group by `lanes` threads a group, added
// in double to out[0 .. groups). Every thread of the CTA calls it.
template <int V>
__device__ __forceinline__ void block_group_sums(const float (&v)[V], double* out, float* red, bool active, int ty,
                                                 int ty_n, int col, int c, int groups, int lanes) {
  const int tid = threadIdx.x;
  const int cg = c / groups;
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[ty * c + col + j] = v[j];
  }
  __syncthreads();
  for (int i = tid; i < c; i += kThreads) {
    float t = red[i];
    for (int r = 1; r < ty_n; ++r) t += red[r * c + i];
    red[i] = t;
  }
  __syncthreads();
  for (int gb = 0; gb < groups; gb += kThreads / lanes) {
    const int g = gb + tid / lanes, j = tid % lanes;
    float t = 0.f;
    if (g < groups)
      for (int i = j; i < cg; i += lanes) t += red[g * cg + i];
    for (int o = lanes / 2; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (g < groups && j == 0) atomicAdd(out + g, static_cast<double>(t));
  }
  __syncthreads();
}

// Threads a group in block_group_sums: a power of two up to 32.
__device__ __forceinline__ int group_lanes(int groups) {
  int lanes = 32;
  while (lanes > 1 && lanes * groups > kThreads) lanes >>= 1;
  return lanes;
}

// x, y: (n, s, c); add: (n, add_frames, c) or null (row r of a sample takes
// frame r / (s / add_frames)); sums_buf: (teams, 3, 2, groups) float64 and
// counters: [arrivals, CTAs done] per team, both zero between calls. CTAs
// [t G / T, (t + 1) G / T) of the G-CTA grid form team t of T, which takes
// samples t, t + T, ...
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gn_fused(const T* __restrict__ x, const T* __restrict__ add, const float* __restrict__ gamma,
             const float* __restrict__ beta, double* __restrict__ sums_buf, unsigned* __restrict__ counters,
             T* __restrict__ y, int n, int s, int c, int groups, int add_frames, float eps, int act, int teams) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots];
  constexpr int V = Vec16<T>::N;
  unsigned char* slots = smem;
  float* red = reinterpret_cast<float*>(smem + kSlots * kSlotBytes);  // kThreads * V floats
  float* mean = red + kThreads * V;
  float* rstd = mean + groups;
  const int tid = threadIdx.x;
  const int grid = gridDim.x;
  const int blk = blockIdx.x;

  auto team_start = [&](int t) { return static_cast<int>(static_cast<int64_t>(t) * grid / teams); };
  int team = static_cast<int>(static_cast<int64_t>(blk) * teams / grid);
  while (team + 1 < teams && team_start(team + 1) <= blk) ++team;
  while (team_start(team) > blk) --team;
  const int first = team_start(team);
  const int k = team_start(team + 1) - first;
  const int rank = blk - first;
  const int row_bytes = c * static_cast<int>(sizeof(T));
  Range rg;
  rg.row0 = static_cast<int>(static_cast<int64_t>(rank) * s / k);
  rg.rows = static_cast<int>(static_cast<int64_t>(rank + 1) * s / k) - rg.row0;
  rg.piece_rows = kSlotBytes / row_bytes;
  rg.pieces = (rg.rows + rg.piece_rows - 1) / rg.piece_rows;
  const bool resident = rg.pieces <= kSlots;

  // Thread (tx, ty) owns channels [tx V, tx V + V) of rows ty, ty + ty_n, ...
  const int chunks = c / V;  // at most kThreads (the wrapper checks)
  const int ty_n = kThreads / chunks;
  const int tx = tid % chunks, ty = tid / chunks;
  const bool active = ty < ty_n;
  const int col = tx * V;
  const int rows_per_frame = s / add_frames;
  const int cg = c / groups;
  const double count = static_cast<double>(s) * cg;
  unsigned* bar_count = counters + 2 * team;
  unsigned* bar_done = bar_count + 1;
  double* team_sums = sums_buf + static_cast<int64_t>(team) * 6 * groups;
  const int lanes = group_lanes(groups);

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // seq counts the pieces this CTA has taken in; piece seq sits in slot
  // seq % kSlots. `issued` counts the pieces it has asked for.
  uint32_t seq = 0, issued = 0;
  auto issue = [&](const T* xs, int p) {  // thread 0
    bulk_load(slots + (issued % kSlots) * kSlotBytes, xs + static_cast<int64_t>(rg.row0 + p * rg.piece_rows) * c,
              rg.piece_len(p) * row_bytes, &full[issued % kSlots]);
    ++issued;
  };
  auto group_sums = [&](const float (&v)[V], double* out) {
    block_group_sums<V>(v, out, red, active, ty, ty_n, col, c, groups, lanes);
  };

  int iter = 0;
  for (int smp = team; smp < n; smp += teams, ++iter) {
    // The team's sums rotate through three buffers by round: round i's is
    // read after barrier i, and zeroed by the team's first CTA after barrier
    // i + 1, before it arrives at barrier i + 2, after which round i + 3 adds.
    double* sums = team_sums + (iter % 3) * 2 * groups;
    const T* xs = x + static_cast<int64_t>(smp) * s * c;
    T* ys = y + static_cast<int64_t>(smp) * s * c;
    const T* as = add != nullptr ? add + static_cast<int64_t>(smp) * add_frames * c : nullptr;
    const T* xs_next = smp + teams < n ? xs + static_cast<int64_t>(teams) * s * c : nullptr;
    // Ask for the first pieces (unless the last round asked for them while it
    // wrote out), once the slots' last bulk stores have read them.
    if (tid == 0 && issued == seq) {
      bulk_wait_read();
      for (int p = 0; p < rg.pieces && p < kSlots; ++p) issue(xs, p);
    }
    const uint32_t q_round = seq;
    Vec16<T> a0{};
    if (active && as != nullptr && add_frames == 1) a0 = load16(as + col);
    auto addend = [&](int row) {
      return add_frames > 1 ? load16(as + static_cast<int64_t>(row / rows_per_frame) * c + col) : a0;
    };

    // Phase 1: statistics of this CTA's rows, piece by piece.
    float acc[V], acc2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
    for (int p = 0; p < rg.pieces; ++p, ++seq) {
      mbar_wait(&full[seq % kSlots], (seq / kSlots) & 1);
      const unsigned char* slot = slots + (seq % kSlots) * kSlotBytes;
      const int len = rg.piece_len(p);
      const int rbase = rg.row0 + p * rg.piece_rows;
      if (active) {
        for (int r = ty; r < len; r += ty_n) {
          const Vec16<T> v = load16(reinterpret_cast<const T*>(slot + r * row_bytes) + col);
          const Vec16<T> a = as != nullptr ? addend(rbase + r) : a0;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float val = v.get(j) + a.get(j);
            acc[j] += val;
            acc2[j] += val * val;
          }
        }
      }
      if (!resident) {
        __syncthreads();
        if (tid == 0 && p + kSlots < rg.pieces) issue(xs, p + kSlots);
      }
    }
    group_sums(acc, sums);
    group_sums(acc2, sums + groups);

    // Phase 2: the team's barrier, then every CTA reads the team's sums.
    if (tid == 0) {
      __threadfence();
      atomicAdd(bar_count, 1u);
      const unsigned target = static_cast<unsigned>(iter + 1) * static_cast<unsigned>(k);
      volatile unsigned* vcount = bar_count;
      for (uint32_t tries = 0; *vcount < target; ++tries)
        if (tries == (1u << 24)) __trap();
      __threadfence();
    }
    __syncthreads();
    for (int g = tid; g < groups; g += kThreads) {
      const double m = __ldcg(sums + g) / count;
      const double var = fmax(__ldcg(sums + groups + g) / count - m * m, 0.0);
      mean[g] = static_cast<float>(m);
      rstd[g] = rsqrtf(static_cast<float>(var) + eps);
    }
    if (rank == 0 && iter >= 1) {
      double* stale = team_sums + ((iter + 2) % 3) * 2 * groups;
      for (int i = tid; i < 2 * groups; i += kThreads) stale[i] = 0.0;
    }
    __syncthreads();

    // Phase 3: y = (x + add) * w + b [, SiLU], in place in the slots, out by
    // bulk stores. Resident rows are still in their slots; others stream in
    // again.
    float w[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = (col + j) / cg;
      w[j] = active ? rstd[g] * gamma[col + j] : 0.f;
      b[j] = active ? beta[col + j] - mean[g] * w[j] : 0.f;
      if (add_frames == 1) b[j] = fmaf(a0.get(j), w[j], b[j]);  // the per-sample addend, folded into the shift
    }
    if (!resident && tid == 0) {
      bulk_wait_read();
      for (int p = 0; p < kSlots; ++p) issue(xs, p);
    }
    for (int p = 0; p < rg.pieces; ++p) {
      const uint32_t q = resident ? q_round + p : seq;
      if (!resident) mbar_wait(&full[q % kSlots], (q / kSlots) & 1);
      unsigned char* slot = slots + (q % kSlots) * kSlotBytes;
      const int len = rg.piece_len(p);
      const int rbase = rg.row0 + p * rg.piece_rows;
      if (active) {
        for (int r = ty; r < len; r += ty_n) {
          T* at = reinterpret_cast<T*>(slot + r * row_bytes) + col;
          const Vec16<T> v = load16(at);
          Vec16<T> o;
          if (add_frames > 1 && as != nullptr) {
            const Vec16<T> a = addend(rbase + r);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float t = (v.get(j) + a.get(j)) * w[j] + b[j];
              o.set(j, act ? silu<T>(t) : t);
            }
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float t = fmaf(v.get(j), w[j], b[j]);
              o.set(j, act ? silu<T>(t) : t);
            }
          }
          store16(at, o);
        }
      }
      fence_async_smem();
      __syncthreads();
      if (tid == 0) {
        bulk_store(ys + static_cast<int64_t>(rbase) * c, slot, len * row_bytes);
        bulk_commit();
        // The next load goes to the slot this store reads, or to one stored
        // before it: a streamed range's next piece, or the next round's
        // piece p of a resident range.
        if (!resident && p + kSlots < rg.pieces) {
          bulk_wait_read();
          issue(xs, p + kSlots);
        } else if (resident && xs_next != nullptr) {
          bulk_wait_read();
          issue(xs_next, p);
        }
      }
      if (!resident) ++seq;
    }
  }
  // The team's last CTA to finish zeroes its counters: every CTA of the
  // team has passed its last barrier by then.
  if (tid == 0) {
    bulk_wait();
    __threadfence();
    if (atomicAdd(bar_done, 1u) == static_cast<unsigned>(k - 1)) {
      for (int i = 0; i < 6 * groups; ++i) team_sums[i] = 0.0;
      atomicExch(bar_count, 0u);
      atomicExch(bar_done, 0u);
    }
  }
}

template <typename T>
int run(const void* x, const float* gamma, const float* beta, const void* add, double* sums, unsigned* counters,
        void* y, int n, int s, int c, int groups, int add_frames, float eps, int act, int grid, int teams,
        cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* ap = static_cast<const T*>(add);
  T* yp = static_cast<T*>(y);
  void* args[] = {&xp, &ap, &gamma, &beta, &sums, &counters, &yp, &n, &s, &c, &groups, &add_frames, &eps, &act,
                  &teams};
  const size_t smem = static_cast<size_t>(kSlots) * kSlotBytes + (kThreads * Vec16<T>::N + 2 * groups) * sizeof(float);
  static size_t smem_set[64] = {};  // per device: the dynamic shared memory already allowed
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    const int err = set_smem(reinterpret_cast<const void*>(gn_fused<T>), smem);
    if (err) return err;
    smem_set[dev] = smem;
  }
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gn_fused<T>), dim3(grid),
                                                      dim3(kThreads), args, smem, stream));
}

// ---------------------------------------------------------------------------
// The split form: statistics and apply as two launches, for W-sharded
// serving, where each rank holds a W block of every sample and the caller
// sums the statistics over the ranks (one all-reduce) between the two. It
// replaces the _stats_kernel and _norm_kernel Pallas calls of
// fused_group_norm(psum_axis=...) (pallas_groupnorm.py:133, :159) and the
// psum between them. Bound on the H100: bytes, as the one launch. Plain
// 16-byte loads and stores, no team barrier (the caller's collective sits
// between the two launches): the apply launch reads x again (from L2 where
// the rank's activation fits it), so HBM sees three passes where the one
// launch has two.
// ---------------------------------------------------------------------------

// Per-(sample, group) [sum, sum of squares] of x + add into sums (n, 2 *
// groups) float64, zero before the launch. Grid (blocks, n): CTA (b, smp)
// reduces rows [b s / blocks, (b + 1) s / blocks) of sample smp as phase 1
// of gn_fused does (the addend folded in), then adds its group partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats(const T* __restrict__ x, const T* __restrict__ add, double* __restrict__ sums, int s, int c, int groups,
             int add_frames) {
  constexpr int V = Vec16<T>::N;
  __shared__ float red[kThreads * V];
  const int smp = blockIdx.y;
  const int row0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * s / gridDim.x);
  const int row1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * s / gridDim.x);
  const int chunks = c / V;
  const int ty_n = kThreads / chunks;
  const int tx = threadIdx.x % chunks, ty = threadIdx.x / chunks;
  const bool active = ty < ty_n;
  const int col = tx * V;
  const int rows_per_frame = s / add_frames;
  const T* xs = x + static_cast<int64_t>(smp) * s * c;
  const T* as = add != nullptr ? add + static_cast<int64_t>(smp) * add_frames * c : nullptr;
  float acc[V], acc2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
  if (active) {
#pragma unroll 4
    for (int r = row0 + ty; r < row1; r += ty_n) {
      const Vec16<T> v = load16(xs + static_cast<int64_t>(r) * c + col);
      Vec16<T> a{};
      if (as != nullptr) a = load16(as + static_cast<int64_t>(r / rows_per_frame) * c + col);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float val = as != nullptr ? v.get(j) + a.get(j) : v.get(j);
        acc[j] += val;
        acc2[j] += val * val;
      }
    }
  }
  double* out = sums + static_cast<int64_t>(smp) * 2 * groups;
  const int lanes = group_lanes(groups);
  block_group_sums<V>(acc, out, red, active, ty, ty_n, col, c, groups, lanes);
  block_group_sums<V>(acc2, out + groups, red, active, ty, ty_n, col, c, groups, lanes);
}

// y = (x + add) * w_c + b_c [, SiLU] from the summed statistics: mean and
// rstd of each group over `count` elements (s * c / groups a rank times the
// ranks), folded with gamma and beta into per-channel scale and shift as
// phases 2 and 3 of gn_fused do. Grid (blocks, n) as gn_stats; dynamic
// shared memory 2 * groups floats.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_apply(const T* __restrict__ x, const T* __restrict__ add, const float* __restrict__ gamma,
             const float* __restrict__ beta, const double* __restrict__ sums, T* __restrict__ y, int s, int c,
             int groups, int add_frames, double count, float eps, int act) {
  constexpr int V = Vec16<T>::N;
  extern __shared__ float stat[];  // mean[groups], rstd[groups]
  const int smp = blockIdx.y;
  const double* ss = sums + static_cast<int64_t>(smp) * 2 * groups;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    const double m = ss[g] / count;
    const double var = fmax(ss[groups + g] / count - m * m, 0.0);
    stat[g] = static_cast<float>(m);
    stat[groups + g] = rsqrtf(static_cast<float>(var) + eps);
  }
  __syncthreads();
  const int row0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * s / gridDim.x);
  const int row1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * s / gridDim.x);
  const int chunks = c / V;
  const int ty_n = kThreads / chunks;
  const int tx = threadIdx.x % chunks, ty = threadIdx.x / chunks;
  if (ty >= ty_n) return;
  const int col = tx * V;
  const int cg = c / groups;
  const int rows_per_frame = s / add_frames;
  const T* xs = x + static_cast<int64_t>(smp) * s * c;
  T* ys = y + static_cast<int64_t>(smp) * s * c;
  const T* as = add != nullptr ? add + static_cast<int64_t>(smp) * add_frames * c : nullptr;
  float w[V], b[V];
  const Vec16<T> a0 = as != nullptr && add_frames == 1 ? load16(as + col) : Vec16<T>{};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int g = (col + j) / cg;
    w[j] = stat[groups + g] * gamma[col + j];
    b[j] = beta[col + j] - stat[g] * w[j];
    if (as != nullptr && add_frames == 1) b[j] = fmaf(a0.get(j), w[j], b[j]);  // the per-sample addend
  }
  const bool per_frame = as != nullptr && add_frames > 1;
#pragma unroll 4
  for (int r = row0 + ty; r < row1; r += ty_n) {
    const int64_t off = static_cast<int64_t>(r) * c + col;
    const Vec16<T> v = load16(xs + off);
    Vec16<T> o;
    if (per_frame) {
      const Vec16<T> a = load16(as + static_cast<int64_t>(r / rows_per_frame) * c + col);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = (v.get(j) + a.get(j)) * w[j] + b[j];
        o.set(j, act ? silu<T>(t) : t);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = fmaf(v.get(j), w[j], b[j]);
        o.set(j, act ? silu<T>(t) : t);
      }
    }
    store16(ys + off, o);
  }
}

template <typename T>
int run_stats(const void* x, const void* add, double* sums, int n, int s, int c, int groups, int add_frames,
              int blocks, cudaStream_t stream) {
  gn_stats<T><<<dim3(blocks, n), kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(add), sums,
                                                         s, c, groups, add_frames);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_apply(const void* x, const float* gamma, const float* beta, const void* add, const double* sums, void* y,
              int n, int s, int c, int groups, int add_frames, double count, float eps, int act, int blocks,
              cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(groups) * sizeof(float);
  gn_apply<T><<<dim3(blocks, n), kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(add),
                                                            gamma, beta, sums, static_cast<T*>(y), s, c, groups,
                                                            add_frames, count, eps, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (n, s, c) channels-last; gamma, beta: (c,) float32; add: (n,
// add_frames, c) or null; sums: (teams, 3, 2, groups) float64 and counters:
// (2 * teams) uint32, zero before the first call and left zero by every
// call. grid CTAs (co-resident: at most two an SM) in `teams` teams; at most
// 512 16-byte vectors a row.
PT_EXPORT int pt_group_norm(const void* x, const float* gamma, const float* beta, const void* add, double* sums,
                            unsigned* counters, void* y, long long n, long long s, int c, int groups, int add_frames,
                            float eps, int act, int is_bf16, int grid, int teams, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), si = static_cast<int>(s);
  if (is_bf16)
    return run<bf16>(x, gamma, beta, add, sums, counters, y, ni, si, c, groups, add_frames, eps, act, grid, teams, st);
  return run<float>(x, gamma, beta, add, sums, counters, y, ni, si, c, groups, add_frames, eps, act, grid, teams, st);
}

// The split form's statistics: x (n, s, c), add (n, add_frames, c) or null
// -> sums (n, 2 * groups) float64 [sum | sum of squares], zeroed by the
// caller. A grid of (blocks, n) CTAs of 512 threads.
PT_EXPORT int pt_group_norm_stats(const void* x, const void* add, double* sums, long long n, long long s, int c,
                                  int groups, int add_frames, int is_bf16, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), si = static_cast<int>(s);
  if (is_bf16) return run_stats<bf16>(x, add, sums, ni, si, c, groups, add_frames, blocks, st);
  return run_stats<float>(x, add, sums, ni, si, c, groups, add_frames, blocks, st);
}

// The split form's apply: y = GroupNorm(x + add) [, SiLU] with the summed
// statistics `sums` (n, 2 * groups) float64 over `count` elements a group.
PT_EXPORT int pt_group_norm_apply(const void* x, const float* gamma, const float* beta, const void* add,
                                  const double* sums, void* y, long long n, long long s, int c, int groups,
                                  int add_frames, double count, float eps, int act, int is_bf16, int blocks,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), si = static_cast<int>(s);
  if (is_bf16)
    return run_apply<bf16>(x, gamma, beta, add, sums, y, ni, si, c, groups, add_frames, count, eps, act, blocks, st);
  return run_apply<float>(x, gamma, beta, add, sums, y, ni, si, c, groups, add_frames, count, eps, act, blocks, st);
}
