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

// Phase stamps of the split form's kernels for a profile where ncu does not
// run (posetraj_torch/tools/gn_split_profile.py builds this file with
// -DPT_GN_STAMPS): thread 0 of each of the first kStampCtas CTAs writes
// %globaltimer at each phase boundary into g_stamps[kernel][cta][phase],
// which the host reads with pt_group_norm_stamps. Without the define a
// stamp compiles to nothing.
#ifdef PT_GN_STAMPS
constexpr int kStampCtas = 4096;
__device__ unsigned long long g_stamps[2][kStampCtas][8];
__device__ __forceinline__ void stamp(int kernel, int phase) {
  if (threadIdx.x == 0 && blockIdx.x < kStampCtas) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[kernel][blockIdx.x][phase] = t;
  }
}
PT_EXPORT int pt_group_norm_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)));
}
#else
__device__ __forceinline__ void stamp(int, int) {}
#endif

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
// The split form, for W-sharded serving: each rank holds a W block of every
// sample and the caller sums the statistics over the ranks (one all-reduce)
// between the two launches. gn_stats replaces the _stats_kernel Pallas call
// of fused_group_norm(psum_axis=...) (pallas_groupnorm.py:133) and the sum
// of its partials, gn_apply the jnp combine and the _norm_kernel call
// (:159); the psum between them is the caller's.
//
// Bound on the H100: bytes. Statistics read x once, apply reads it again
// and writes y (the second read from L2 where the rank's activation fits),
// a handful of float operations an element. At the sharded path's shapes
// (the (2, 4)-local level 0 is 20.6 MB) a launch is a few microseconds of
// HBM traffic, so latency decides. What the design does about its causes:
//   * waves: each launch is one wave, its grid what the occupancy
//     calculator says fits the card at once (ops/groupnorm.split_grid from
//     pt_group_norm_split_occupancy, asked once a device: two CTAs of 512
//     threads an SM), no more CTAs than give each thread one row. CTA b owns
//     the contiguous, balanced rows [b R / grid, (b + 1) R / grid) of the
//     flattened n * s rows, across sample boundaries, so that small samples
//     do not cut the grid into short ranges of their own;
//   * the per-CTA tail: gn_stats brings its range in by bulk copies on an
//     mbarrier ring (four 20 KB slots, all asked for at once), accumulates
//     in float32 registers and reduces across the CTA once a sample segment
//     (the part of its range in one sample), through shared memory laid out
//     free of bank conflicts, into float32 partials in a workspace: no
//     atomics on the output. Each sample's last CTA to arrive (a per-sample
//     arrival counter, reset by that CTA) sums the sample's partials in CTA
//     order, in double, and writes its row of the sums;
//   * the zero fill: the sums are written whole by the launch, so they
//     need none, come out bitwise alike from run to run, and the launch can
//     be captured in a CUDA graph;
//   * host time: ops/groupnorm.group_norm_split_kernel checks and converts
//     its inputs once for both launches.
// gn_apply folds mean, rstd, gamma, beta and a per-sample addend into
// per-channel scale and shift where its range enters a sample, and streams
// the range through a ring of four 24 KB slots: thread 0's bulk loads run
// three pieces ahead, every thread normalises a piece in place, and the
// piece goes out by a bulk store while the next ones come in.
// Measured on an H100 (PERF.md; tools/gn_split_profile.py stamps each
// CTA's phases): with everything in flight from the start, the loads end
// when the memory system has delivered the whole input, then the tail runs
// (partials, arrival, the last CTA's sums: ~2.3 us median at the (2,
// 4)-local level 0). Plain 16-byte loads, smaller slots or a shallower ring measured
// no faster. A 64-bit division is a long emulated sequence on the critical
// path, so the CTAs cut their rows with div64 and walk samples without
// dividing.
// ---------------------------------------------------------------------------

// a / b for non-negative a, b: in 32 bits where both fit (a 64-bit division
// is a long emulated sequence, on the critical path of every CTA).
__device__ __forceinline__ int64_t div64(int64_t a, int64_t b) {
  if (((static_cast<uint64_t>(a) | static_cast<uint64_t>(b)) >> 32) == 0)
    return static_cast<int64_t>(static_cast<uint32_t>(a) / static_cast<uint32_t>(b));
  return a / b;
}

// Rows of one CTA: [cut(b), cut(b + 1)) of the grid's balanced cut of `rows`.
__device__ __forceinline__ int64_t cut(int64_t b, int64_t rows, int grid) { return div64(b * rows, grid); }

// The CTA whose rows hold row r.
__device__ __forceinline__ int cta_of(int64_t r, int64_t rows, int grid) {
  return static_cast<int>(div64((r + 1) * grid - 1, rows));
}

// The bulk stores this thread issued, all but the newest group, have read
// their shared memory.
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// The split form's rings: gn_stats's slots leave room for its reduction
// buffer with two CTAs an SM; gn_apply's take what two CTAs an SM allow.
constexpr int kStatsSlots = 4;
constexpr int kStatsSlotBytes = 20 * 1024;
constexpr int kApplySlots = 4;
constexpr int kApplySlotBytes = 24 * 1024;

// The pieces of a CTA's rows [r, end), cut at sample boundaries and every
// `piece_rows` rows, with the sample of each: the producer (thread 0, ahead
// of the others) and every thread walk the same sequence. One division, at
// the start.
struct Pieces {
  int64_t r, end, stop;  // stop: the end of sample smp's rows
  int smp, s, piece_rows;
  __device__ Pieces(int64_t r0, int64_t r1, int s_, int piece_rows_) : r(r0), end(r1), s(s_), piece_rows(piece_rows_) {
    smp = static_cast<int>(div64(r0, s_));
    stop = static_cast<int64_t>(smp + 1) * s_;
  }
  __device__ bool next(int64_t& row, int& len, int& sample) {
    if (r >= end) return false;
    if (r == stop) {
      ++smp;
      stop += s;
    }
    int64_t e = r + piece_rows;
    if (e > end) e = end;
    if (e > stop) e = stop;
    row = r;
    len = static_cast<int>(e - r);
    sample = smp;
    r = e;
    return true;
  }
};

// Per-group float32 [sum | sum of squares] of the CTA's per-thread channel
// sums v, v2 (channels [col, col + V) of rows ty, ty + ty_n, ... of a
// segment) into out[0 .. 2 groups), in a fixed order. `red` (2 kThreads V
// floats, 16-byte aligned) holds each sum array in V / 4 planes of float4s,
// thread (tx, ty)'s j-th float4 at (j ty_n + ty) chunks + tx: the float4s of
// consecutive threads are consecutive, free of bank conflicts. The sums over
// ty land in the ty = 0 row, then each group's channels are summed by
// `lanes` threads. Every thread calls it.
template <int V>
__device__ __forceinline__ void block_group_partials(const float (&v)[V], const float (&v2)[V], float* out,
                                                     float* red, bool active, int ty, int ty_n, int tx, int c,
                                                     int groups, int lanes) {
  const int tid = threadIdx.x;
  const int cg = c / groups;
  const int chunks = c / V;
  constexpr int kHalf = kThreads * V;
  // Where channel ch's sum of row lane r lies in one sum array.
  auto at = [&](int ch, int r) { return (((ch % V) / 4 * ty_n + r) * chunks + ch / V) * 4 + ch % 4; };
  if (active) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const int i = ((j / 4 * ty_n + ty) * chunks + tx) * 4;
      *reinterpret_cast<float4*>(red + i) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      *reinterpret_cast<float4*>(red + kHalf + i) = make_float4(v2[j], v2[j + 1], v2[j + 2], v2[j + 3]);
    }
  }
  __syncthreads();
  const int lane_stride = chunks * 4;  // from row lane r to r + 1
  for (int i = tid; i < 2 * c; i += kThreads) {
    float* sum = red + (i < c ? 0 : kHalf) + at(i < c ? i : i - c, 0);
    float t = sum[0];
    int r = 1;
    for (; r + 3 < ty_n; r += 4) {  // four loads in flight, added in lane order
      const float a = sum[r * lane_stride], b = sum[(r + 1) * lane_stride];
      const float d = sum[(r + 2) * lane_stride], e = sum[(r + 3) * lane_stride];
      t += a;
      t += b;
      t += d;
      t += e;
    }
    for (; r < ty_n; ++r) t += sum[r * lane_stride];
    sum[0] = t;
  }
  __syncthreads();
  for (int ob = 0; ob < 2 * groups; ob += kThreads / lanes) {
    const int o = ob + tid / lanes, j = tid % lanes;
    float t = 0.f;
    if (o < 2 * groups) {
      const float* base = red + (o < groups ? 0 : kHalf);
      const int ch0 = (o < groups ? o : o - groups) * cg;
      for (int i = j; i < cg; i += lanes) t += base[at(ch0 + i, 0)];
    }
    for (int m = lanes / 2; m > 0; m >>= 1) t += __shfl_xor_sync(0xffffffffu, t, m);
    if (o < 2 * groups && j == 0) out[o] = t;
  }
}

// x: (n * s, c) rows, add (n, add_frames, c) or null -> sums (n, 2 * groups)
// float64. part: (n, mmax, 2 * groups) float32 partials, [smp][i] from the
// i-th CTA that holds rows of sample smp (mmax: at least the CTAs a sample's
// rows reach); arrivals: (n) uint32, zero before the launch and left zero. A
// grid of at most one wave of kThreads-thread CTAs; dynamic shared memory
// kStatsSlots * kStatsSlotBytes + 2 kThreads V floats.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gn_stats(const T* __restrict__ x, const T* __restrict__ add, float* __restrict__ part,
             unsigned* __restrict__ arrivals, double* __restrict__ sums, int n, int s, int c, int groups,
             int add_frames, int mmax) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStatsSlots];
  __shared__ int span[2];  // the first and last CTA that hold rows of the segment's sample
  __shared__ bool last;
  constexpr int V = Vec16<T>::N;
  float* red = reinterpret_cast<float*>(smem + kStatsSlots * kStatsSlotBytes);
  const int tid = threadIdx.x;
  const int grid = gridDim.x, blk = blockIdx.x;
  const int64_t rows = static_cast<int64_t>(n) * s;
  const int row_bytes = c * static_cast<int>(sizeof(T));
  const int chunks = c / V;  // at most kThreads (the wrapper checks)
  const int ty_n = kThreads / chunks;
  const int tx = tid % chunks, ty = tid / chunks;
  const bool active = ty < ty_n;
  const int col = tx * V;
  const int rows_per_frame = s / add_frames;
  const int two_g = 2 * groups;
  const int lanes = group_lanes(two_g);
  stamp(0, 0);  // start
  Pieces loads(cut(blk, rows, grid), cut(blk + 1, rows, grid), s, kStatsSlotBytes / row_bytes);
  Pieces pieces = loads;

  auto issue = [&](uint32_t q) {  // thread 0: the next piece into slot q % kStatsSlots
    int64_t row;
    int len, smp;
    if (loads.next(row, len, smp))
      bulk_load(smem + (q % kStatsSlots) * kStatsSlotBytes, x + row * c, len * row_bytes, &full[q % kStatsSlots]);
  };
  if (tid == 0) {
    for (int i = 0; i < kStatsSlots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (uint32_t q = 0; q < kStatsSlots; ++q) issue(q);
  }

  float acc[V], acc2[V];
  // The segment's partials out; the sample's last CTA to arrive sums them
  // in CTA order, in double (thread 0 alone fences, on both sides of the
  // arrival count, as a grid barrier does).
  auto finish = [&](int smp) {
    stamp(0, 2);  // the segment's rows summed
    block_group_partials<V>(acc, acc2, part + (static_cast<int64_t>(smp) * mmax + blk - span[0]) * two_g, red,
                            active, ty, ty_n, tx, c, groups, lanes);
    __syncthreads();
    stamp(0, 3);  // partials written
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(arrivals + smp, 1u) == static_cast<unsigned>(span[1] - span[0]);
      if (last) {
        atomicExch(arrivals + smp, 0u);
        __threadfence();
      }
    }
    __syncthreads();
    stamp(0, 4);  // arrived
    if (last) {
      // The sample's m partials of two_g values: lane l of output o sums
      // partials l, l + L, ... (coalesced over o, eight loads in flight),
      // then output o's L lane sums are added in lane order.
      const int m = span[1] - span[0] + 1;
      const float* ps = part + static_cast<int64_t>(smp) * mmax * two_g;
      double* lane_sums = reinterpret_cast<double*>(red);
      const int L = two_g < kThreads ? kThreads / two_g : 1;
      for (int ob = 0; ob < two_g; ob += kThreads / L) {
        const int o = ob + tid % (kThreads / L), l = tid / (kThreads / L);
        double t = 0.0;
        if (o < two_g && l < L) {
          int i = l;
          for (; i + 7 * L < m; i += 8 * L) {
            float p[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) p[u] = __ldcg(ps + (i + u * L) * two_g + o);
#pragma unroll
            for (int u = 0; u < 8; ++u) t += static_cast<double>(p[u]);
          }
          for (; i < m; i += L) t += static_cast<double>(__ldcg(ps + i * two_g + o));
        }
        lane_sums[tid] = t;
        __syncthreads();
        if (l == 0 && o < two_g) {
          for (int k = 1; k < L; ++k) t += lane_sums[k * (kThreads / L) + tid];
          sums[static_cast<int64_t>(smp) * two_g + o] = t;
        }
        __syncthreads();
      }
    }
    __syncthreads();  // red, span and `last` are reused by the next segment
    stamp(0, 5);  // the sample's sums written, if this CTA was its last
  };

  int cur = -1;
  const T* as = nullptr;
  Vec16<T> a0{};
  int64_t row;
  int len, smp;
  for (uint32_t q = 0; pieces.next(row, len, smp); ++q) {
    if (smp != cur) {
      if (cur >= 0) finish(cur);
      cur = smp;
      if (tid == 0) {
        const int64_t base = static_cast<int64_t>(smp) * s;
        span[0] = cta_of(base, rows, grid);
        span[1] = cta_of(base + s - 1, rows, grid);
      }
      as = add != nullptr ? add + static_cast<int64_t>(smp) * add_frames * c : nullptr;
      a0 = active && as != nullptr && add_frames == 1 ? load16(as + col) : Vec16<T>{};
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = acc2[j] = 0.f;
    }
    if (q == 0) __syncthreads();  // the ring's barriers initialised
    mbar_wait(&full[q % kStatsSlots], (q / kStatsSlots) & 1);
    if (q == 0) stamp(0, 1);  // the first piece in
    const unsigned char* slot = smem + (q % kStatsSlots) * kStatsSlotBytes;
    if (active) {
      const bool per_frame = as != nullptr && add_frames > 1;
      const int in_smp = static_cast<int>(row - static_cast<int64_t>(smp) * s);
      for (int r = ty; r < len; r += ty_n) {
        const Vec16<T> v = load16(reinterpret_cast<const T*>(slot + r * row_bytes) + col);
        const Vec16<T> a = per_frame ? load16(as + static_cast<int64_t>((in_smp + r) / rows_per_frame) * c + col)
                                     : a0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float val = v.get(j) + a.get(j);
          acc[j] += val;
          acc2[j] += val * val;
        }
      }
    }
    __syncthreads();  // every thread is done with the slot
    if (tid == 0) issue(q + kStatsSlots);
  }
  finish(cur);
}

// y = (x + add) * w_c + b_c [, SiLU] with mean and rstd of each group over
// `count` elements (s * c / groups a rank times the ranks) from the summed
// statistics, folded with gamma, beta and a per-sample addend into the
// per-channel scale w_c and shift b_c where the CTA's rows enter a sample.
// x, y: (n * s, c) rows; sums (n, 2 * groups) float64. A grid of at most one
// wave, the rows cut as gn_stats cuts them; dynamic shared memory
// kApplySlots * kApplySlotBytes.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gn_apply(const T* __restrict__ x, const T* __restrict__ add, const float* __restrict__ gamma,
             const float* __restrict__ beta, const double* __restrict__ sums, T* __restrict__ y, int n, int s,
             int c, int groups, int add_frames, double count, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kApplySlots];
  constexpr int V = Vec16<T>::N;
  const int tid = threadIdx.x;
  const int grid = gridDim.x, blk = blockIdx.x;
  const int64_t rows = static_cast<int64_t>(n) * s;
  const int row_bytes = c * static_cast<int>(sizeof(T));
  const int chunks = c / V;
  const int ty_n = kThreads / chunks;
  const int tx = tid % chunks, ty = tid / chunks;
  const bool active = ty < ty_n;
  const int col = tx * V;
  const int cg = c / groups;
  const int rows_per_frame = s / add_frames;
  stamp(1, 0);  // start
  Pieces loads(cut(blk, rows, grid), cut(blk + 1, rows, grid), s, kApplySlotBytes / row_bytes);
  Pieces pieces = loads;

  auto issue = [&](uint32_t q) {  // thread 0: the next piece into slot q % kApplySlots
    int64_t row;
    int len, smp;
    if (loads.next(row, len, smp))
      bulk_load(smem + (q % kApplySlots) * kApplySlotBytes, x + row * c, len * row_bytes, &full[q % kApplySlots]);
  };
  if (tid == 0) {
    for (int i = 0; i < kApplySlots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (uint32_t q = 0; q + 1 < kApplySlots; ++q) issue(q);
  }
  __syncthreads();

  int cur = -1;
  const T* as = nullptr;
  float w[V], b[V];
  int64_t row;
  int len, smp;
  for (uint32_t q = 0; pieces.next(row, len, smp); ++q) {
    if (smp != cur) {
      cur = smp;
      as = add != nullptr ? add + static_cast<int64_t>(smp) * add_frames * c : nullptr;
      const double* ss = sums + static_cast<int64_t>(smp) * 2 * groups;
      const Vec16<T> a0 = active && as != nullptr && add_frames == 1 ? load16(as + col) : Vec16<T>{};
      int gp = -1;
      float mean = 0.f, rstd = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int g = (col + j) / cg;
        if (active && g != gp) {
          gp = g;
          const double m = __ldg(ss + g) / count;
          const double var = fmax(__ldg(ss + groups + g) / count - m * m, 0.0);
          mean = static_cast<float>(m);
          rstd = rsqrtf(static_cast<float>(var) + eps);
        }
        w[j] = active ? rstd * __ldg(gamma + col + j) : 0.f;
        b[j] = active ? __ldg(beta + col + j) - mean * w[j] : 0.f;
        b[j] = fmaf(a0.get(j), w[j], b[j]);  // the per-sample addend, folded into the shift
      }
    }
    const bool per_frame = as != nullptr && add_frames > 1;
    mbar_wait(&full[q % kApplySlots], (q / kApplySlots) & 1);
    if (q == 0) stamp(1, 1);  // the first piece in
    unsigned char* slot = smem + (q % kApplySlots) * kApplySlotBytes;
    if (active) {
      const int in_smp = static_cast<int>(row - static_cast<int64_t>(smp) * s);
      for (int r = ty; r < len; r += ty_n) {
        T* at = reinterpret_cast<T*>(slot + r * row_bytes) + col;
        const Vec16<T> v = load16(at);
        Vec16<T> o;
        if (per_frame) {
          const Vec16<T> a = load16(as + static_cast<int64_t>((in_smp + r) / rows_per_frame) * c + col);
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
      bulk_store(y + row * c, slot, len * row_bytes);
      bulk_commit();
      // The next load goes to the slot piece q - 1 was stored from: once
      // that store has read it (all but the newest bulk group).
      bulk_wait_read_1();
      issue(q + kApplySlots - 1);
    }
  }
  stamp(1, 2);  // the last store issued
  if (tid == 0) bulk_wait_read();  // the slots outlive the last stores' reads
  stamp(1, 3);  // end
}

template <typename T>
constexpr size_t stats_smem() {
  return static_cast<size_t>(kStatsSlots) * kStatsSlotBytes + 2 * kThreads * Vec16<T>::N * sizeof(float);
}

constexpr size_t kApplySmem = static_cast<size_t>(kApplySlots) * kApplySlotBytes;

// Allows the split form's kernels their dynamic shared memory, once a device.
template <typename T>
int allow_split_smem() {
  static bool set[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!set[dev]) {
    int err = set_smem(reinterpret_cast<const void*>(gn_stats<T>), stats_smem<T>());
    if (!err) err = set_smem(reinterpret_cast<const void*>(gn_apply<T>), kApplySmem);
    if (err) return err;
    set[dev] = true;
  }
  return 0;
}

template <typename T>
int run_stats(const void* x, const void* add, float* part, unsigned* arrivals, double* sums, int n, int s, int c,
              int groups, int add_frames, int grid, int mmax, cudaStream_t stream) {
  const int err = allow_split_smem<T>();
  if (err) return err;
  gn_stats<T><<<grid, kThreads, stats_smem<T>(), stream>>>(static_cast<const T*>(x), static_cast<const T*>(add),
                                                            part, arrivals, sums, n, s, c, groups, add_frames, mmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_apply(const void* x, const float* gamma, const float* beta, const void* add, const double* sums, void* y,
              int n, int s, int c, int groups, int add_frames, double count, float eps, int act, int grid,
              cudaStream_t stream) {
  const int err = allow_split_smem<T>();
  if (err) return err;
  gn_apply<T><<<grid, kThreads, kApplySmem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(add), gamma,
                                                       beta, sums, static_cast<T*>(y), n, s, c, groups, add_frames,
                                                       count, eps, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int split_occupancy(int* stats, int* apply) {
  int err = allow_split_smem<T>();
  if (err) return err;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(stats, gn_stats<T>, kThreads, stats_smem<T>()));
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(apply, gn_apply<T>, kThreads, kApplySmem));
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
// -> sums (n, 2 * groups) float64 [sum | sum of squares], every row written.
// part: (n, mmax, 2 * groups) float32 workspace, mmax at least the CTAs
// whose rows reach one sample; arrivals: (n) uint32, zero before the call and
// left zero. grid CTAs of 512 threads, 1 <= grid <= n * s (one wave:
// pt_group_norm_split_occupancy).
PT_EXPORT int pt_group_norm_stats(const void* x, const void* add, float* part, unsigned* arrivals, double* sums,
                                  long long n, long long s, int c, int groups, int add_frames, int is_bf16, int grid,
                                  int mmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), si = static_cast<int>(s);
  if (grid < 1 || grid > n * s) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) return run_stats<bf16>(x, add, part, arrivals, sums, ni, si, c, groups, add_frames, grid, mmax, st);
  return run_stats<float>(x, add, part, arrivals, sums, ni, si, c, groups, add_frames, grid, mmax, st);
}

// The split form's apply: y = GroupNorm(x + add) [, SiLU] with the summed
// statistics `sums` (n, 2 * groups) float64 over `count` elements a group.
// grid CTAs as the statistics launch.
PT_EXPORT int pt_group_norm_apply(const void* x, const float* gamma, const float* beta, const void* add,
                                  const double* sums, void* y, long long n, long long s, int c, int groups,
                                  int add_frames, double count, float eps, int act, int is_bf16, int grid,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), si = static_cast<int>(s);
  if (grid < 1 || grid > n * s) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return run_apply<bf16>(x, gamma, beta, add, sums, y, ni, si, c, groups, add_frames, count, eps, act, grid, st);
  return run_apply<float>(x, gamma, beta, add, sums, y, ni, si, c, groups, add_frames, count, eps, act, grid, st);
}

// The CTAs an SM holds at once of the split form's statistics and apply
// kernels for bf16 (is_bf16 = 1) or float32, into ctas[0] and ctas[1]: what
// the registers ptxas gave them and their shared memory allow, from which
// ops/groupnorm.split_grid sizes the launches' one wave.
PT_EXPORT int pt_group_norm_split_occupancy(int is_bf16, int* ctas) {
  return is_bf16 ? split_occupancy<bf16>(ctas, ctas + 1) : split_occupancy<float>(ctas, ctas + 1);
}
