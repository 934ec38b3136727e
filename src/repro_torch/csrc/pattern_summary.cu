// K1: Algorithm-1 behavior-pattern summary (paper §4.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pattern_summary.py::_kernel
// (with its helpers _region_stats and _trim).  It computes what the
// reference oracles compute (repro/core/patterns.py::critical_duration and
// repro/summarize/backends.py::NumpyBackend), not a block-for-block copy of
// the TPU kernel: for every row of a zero-padded (E, n) float32 utilization
// matrix it finds the smallest zero-gap bound g for which some region (a
// maximal run of positive samples whose inner zero-runs are <= g long) holds
// >= mass_fraction of the row total, takes the max-mass region at that g
// (leftmost on ties), trims it to positive ends and writes (mean, std,
// count) of the samples inside as float64.  An all-zero row gives
// (0, 0, n).  Totals, prefix sums and moments accumulate in float64.
//
// Bound: bytes.  The work reads E*n*4 bytes once and writes E*3*8 bytes, at
// 3.35 TB/s on an H100 SXM; it has no products, so nothing here runs on the
// tensor cores.  The design keeps enough independent loads in flight to
// reach that rate and does as little per sample as a row allows:
//
// * Pass 0 is reductions only: the row's float64 total, the sum of its
//   positive samples, their count and the first and last of them.  A row
//   whose total is not positive is done there, and so is a row whose
//   positive samples form one run (count == last - first + 1): no gap splits
//   it, so its region is [first, last + 1) and its mass the positive sum.
//   The rows of a fleet's profiling window are such rows.
// * Warp variant (n <= kWarpMaxN = 2048): one warp per row, kRowsPerBlock
//   rows a block.  Each lane issues all its loads (samples lane + 32 k, so
//   every load of the warp is one coalesced 128-byte line) before it adds
//   anything, and keeps its K samples in registers (K, the template
//   argument, is ceil(n / 32) rounded up to an instantiated count), so the
//   variance of a one-run row is a second warp reduction over registers and
//   device memory is read once.  The cap is the register budget: 64 samples
//   a lane still leaves a block of 8 warps two blocks an SM without spills.
//   Rows with several runs are appended to a work list, which a second
//   kernel (k1_warp_general, one warp per row, a persistent grid) runs
//   through the general path below in the warp's slice of shared memory.
// * Block variant (any n; the rule for n > 2048): one block of 512 threads
//   per row, a persistent grid.  Warp w owns a contiguous segment of the
//   row; pass 0 is the same reductions, combined in segment order, with the
//   row staged in shared memory when it fits (else re-read from L2).  The
//   general path's arrays live in a global scratch slice of the block.
// * General path (rows with more than one run): compute once, per positive
//   sample j in order, its position and its float64 inclusive and exclusive
//   prefix sums; then bisect g over [0, max_gap - 1] as the plain version
//   does (g = max_gap, one region, is always feasible).  A probe marks the
//   positive samples that start a region (zero-run before them > g) and end
//   one (zero-run after them > g); a start's index is a ballot and a count
//   of leading zeros, and a region's mass P[end] - P0[start].  There is no
//   float scan in a probe.
//
// The host part sits under #ifdef __CUDACC__ so the device code can also be
// compiled by a host compiler under a shim that emulates warps with threads.

#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
extern __shared__ __align__(16) unsigned char k1_smem[];
#endif

namespace k1 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;             // warp variant: a warp per row
constexpr int kMaxLaneSamples = 64;
constexpr int kWarpMaxN = 32 * kMaxLaneSamples;
constexpr int kGeneralWarps = 4;             // warp variant's general path
constexpr int kBlockThreads = 512;           // block variant
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kEntryBytes = 2 * sizeof(double) + sizeof(int);

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The pass-0 reductions of a set of samples.
struct Stats {
  double total;   // sum of every sample
  double mass;    // sum of the positive samples
  int count;      // number of positive samples
  int first;      // first positive sample, INT_MAX if none
  int last;       // last positive sample, -1 if none
};

__device__ __forceinline__ Stats no_samples() {
  Stats s;
  s.total = 0.0; s.mass = 0.0; s.count = 0; s.first = INT_MAX; s.last = -1;
  return s;
}

__device__ __forceinline__ void add_sample(Stats& s, int i, float v) {
  s.total += (double)v;
  if (v > 0.f) {
    s.mass += (double)v;
    ++s.count;
    s.first = min(s.first, i);
    s.last = max(s.last, i);
  }
}

// a then b (b's samples all come after a's)
__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  a.total += b.total;
  a.mass += b.mass;
  a.count += b.count;
  a.first = min(a.first, b.first);
  a.last = max(a.last, b.last);
}

// Butterfly reductions: every lane ends with the same bits (each step adds
// the same two values in either order).
__device__ __forceinline__ Stats warp_stats(Stats s) {
  for (int d = 16; d > 0; d >>= 1) {
    s.total += __shfl_xor_sync(kFull, s.total, d);
    s.mass += __shfl_xor_sync(kFull, s.mass, d);
    s.count += __shfl_xor_sync(kFull, s.count, d);
    s.first = min(s.first, __shfl_xor_sync(kFull, s.first, d));
    s.last = max(s.last, __shfl_xor_sync(kFull, s.last, d));
  }
  return s;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// float to double in a form the compiler cannot merge with an earlier
// conversion of the same value: the variance loop of k1_warp_rows converts
// its samples again rather than keep pass 0's doubles live across the
// reduction (that doubled the registers a lane needs).
__device__ __forceinline__ double widen_again(float v) {
#ifdef __CUDA_ARCH__
  double d;
  asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(v));
  return d;
#else
  return (double)v;
#endif
}

__device__ __forceinline__ bool one_run(const Stats& s) {
  return s.count == s.last - s.first + 1;
}

__device__ __forceinline__ void write_row(double* o, double mean, double sq,
                                          double count) {
  o[0] = mean;
  o[1] = sqrt(sq / count);
  o[2] = count;
}

// The general path's arrays: for the j-th positive sample of a row, its
// position and the row's prefix sums through it (p) and before it (p0).
struct Entries {
  double* p;
  double* p0;
  int* pos;
};

// A candidate region: its mass and its first and last entries.
struct Best {
  double mass;
  int lo;
  int hi;
};

__device__ __forceinline__ Best no_region() {
  Best b;
  b.mass = -INFINITY; b.lo = INT_MAX; b.hi = -1;
  return b;
}

// Max mass first, then the leftmost region (regions never overlap).
__device__ __forceinline__ void consider(Best& b, double m, int lo, int hi) {
  if (m > b.mass || (m == b.mass && lo < b.lo)) {
    b.mass = m; b.lo = lo; b.hi = hi;
  }
}

__device__ __forceinline__ Best warp_best(Best b) {
  for (int d = 16; d > 0; d >>= 1) {
    const double m = __shfl_xor_sync(kFull, b.mass, d);
    const int lo = __shfl_xor_sync(kFull, b.lo, d);
    const int hi = __shfl_xor_sync(kFull, b.hi, d);
    consider(b, m, lo, hi);
  }
  return b;
}

// Appends the positive samples of x[i0, i1) to e from entry `base`.  `run`
// is the sum of the samples before i0 and `prev` the last positive sample
// before i0 (-1 if none); both and `base` come back advanced past i1, the
// same in every lane.  Returns the longest zero-run ending at a positive
// sample of the range that follows another positive sample.
__device__ __forceinline__ int warp_compact(const float* x, int i0, int i1, int& base,
                            double& run, int prev, Entries e) {
  const int lane = lane_id();
  const unsigned below = (1u << lane) - 1u;
  int gap = 0;
  for (int c = i0; c < i1; c += 32) {
    const int i = c + lane;
    const float v = i < i1 ? x[i] : 0.f;
    double s = (double)v;                    // inclusive sum in the chunk
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += t;
    }
    double ex = __shfl_up_sync(kFull, s, 1);
    if (lane == 0) ex = 0.0;
    const unsigned positive = __ballot_sync(kFull, v > 0.f);
    if (v > 0.f) {
      const unsigned b = positive & below;
      const int j = base + __popc(b);
      const int p = b ? c + 31 - __clz(b) : prev;
      if (p >= 0) gap = max(gap, i - p - 1);
      e.p[j] = run + s;
      e.p0[j] = run + ex;
      e.pos[j] = i;
    }
    if (positive) prev = c + 31 - __clz(positive);
    base += __popc(positive);
    run += __shfl_sync(kFull, s, 31);
  }
  return warp_max(gap);
}

// One probe of the bisection at gap bound g over entries [j0, j1) of a row
// of m entries.  An entry starts a region when the zero-run before it is
// longer than g (or it is the first entry), and ends one when the zero-run
// after it is (or it is the last).  Returns the max-mass region that starts
// in [j0, j1), leftmost on ties.  `open_end` gets the end in [j0, j1) of a
// region that starts before j0 (-1 if none: a region has one end) and
// `last_start` the last start in [j0, j1) (-1 if none); all three are the
// same in every lane.
__device__ __forceinline__ Best warp_probe(Entries e, int j0, int j1, int m, int g,
                           int& open_end, int& last_start) {
  const int lane = lane_id();
  const unsigned upto = kFull >> (31 - lane);
  Best best = no_region();
  int st = -1, oe = -1;
  for (int c = j0; c < j1; c += 32) {
    const int j = c + lane;
    const bool live = j < j1;
    const int p = live ? e.pos[j] : 0;
    int before = __shfl_up_sync(kFull, p, 1);
    int after = __shfl_down_sync(kFull, p, 1);
    if (live && lane == 0 && j > 0) before = e.pos[j - 1];
    if (live && (lane == 31 || j + 1 == j1) && j + 1 < m) after = e.pos[j + 1];
    const bool start = live && (j == 0 || p - before - 1 > g);
    const bool end = live && (j == m - 1 || after - p - 1 > g);
    const unsigned starts = __ballot_sync(kFull, start);
    const unsigned mine = starts & upto;
    const int s = mine ? c + 31 - __clz(mine) : st;
    if (end) {
      if (s >= 0) consider(best, e.p[j] - e.p0[s], s, j);
      else oe = j;
    }
    if (starts) st = c + 31 - __clz(starts);
  }
  open_end = warp_max(oe);
  last_start = st;
  return warp_best(best);
}

// The bisection over g in [0, max_gap - 1] that the plain version runs:
// feasibility is monotone in g and g = max_gap (no split: one region over
// all m entries) is always feasible.  probe(g) returns the max-mass region
// at g, the same in every thread that calls it.
template <class Probe>
__device__ __forceinline__ Best bisect(Entries e, int m, int max_gap,
                                       double target, Probe probe) {
  Best reg;
  reg.mass = e.p[m - 1] - e.p0[0]; reg.lo = 0; reg.hi = m - 1;
  int lo_g = 0, hi_g = max_gap - 1;
  while (lo_g <= hi_g) {
    const int g = (lo_g + hi_g) >> 1;
    const Best b = probe(g);
    if (b.mass >= target) {
      reg = b;
      hi_g = g - 1;
    } else {
      lo_g = g + 1;
    }
  }
  return reg;
}

// ---- warp variant ----------------------------------------------------------

// Pass 0 for one row per warp, the row in registers (K samples a lane).
// Finishes all-zero and one-run rows; appends the others to the work list
// (work[0] counts them, work[1..] holds their rows).
template <int K>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
k1_warp_rows(const float* __restrict__ u, double* __restrict__ out,
             long long rows, int n, int* __restrict__ work) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = lane_id();
  const float* x = u + row * n;
  float v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < n ? x[i] : 0.f;
  }
  Stats s = no_samples();
#pragma unroll
  for (int k = 0; k < K; ++k) add_sample(s, lane + 32 * k, v[k]);
  s = warp_stats(s);
  double* o = out + row * 3;
  if (!(s.total > 0.0)) {
    if (lane == 0) write_row(o, 0.0, 0.0, (double)n);
    return;
  }
  if (!one_run(s)) {
    if (lane == 0) work[1 + atomicAdd(work, 1)] = (int)row;
    return;
  }
  const double mean = s.mass / s.count;
  double sq = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    const double d = widen_again(v[k]) - mean;
    if (i >= s.first && i <= s.last) sq += d * d;
  }
  sq = warp_sum(sq);
  if (lane == 0) write_row(o, mean, sq, (double)s.count);
}

// Bytes of one warp's slice of the general path's shared memory.
__host__ __device__ __forceinline__ size_t slice_bytes(int n) {
  return ((size_t)n * kEntryBytes + 15) & ~(size_t)15;
}

// The general path for the rows on the work list, a warp per row.
__global__ void __launch_bounds__(32 * kGeneralWarps)
k1_warp_general(const float* __restrict__ u, double* __restrict__ out, int n,
                double mass_fraction, const int* __restrict__ work) {
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  unsigned char* slice = k1_smem + (size_t)warp * slice_bytes(n);
  Entries e;
  e.p = (double*)slice;
  e.p0 = e.p + n;
  e.pos = (int*)(e.p0 + n);
  const int count = work[0];
  for (int w = blockIdx.x * kGeneralWarps + warp; w < count;
       w += gridDim.x * kGeneralWarps) {
    const long long row = work[1 + w];
    const float* x = u + row * n;
    int m = 0;
    double total = 0.0;
    const int max_gap = warp_compact(x, 0, n, m, total, -1, e);
    __syncwarp();
    const Best reg = bisect(e, m, max_gap, mass_fraction * total - 1e-9,
                            [&](int g) {
                              int open_end, last_start;
                              return warp_probe(e, 0, m, m, g, open_end,
                                                last_start);
                            });
    const int lo = e.pos[reg.lo], hi = e.pos[reg.hi] + 1;
    const double mean = reg.mass / (hi - lo);
    double sq = 0.0;
    for (int i = lo + lane; i < hi; i += 32) {
      const double d = (double)x[i] - mean;
      sq += d * d;
    }
    sq = warp_sum(sq);
    if (lane == 0) write_row(out + row * 3, mean, sq, (double)(hi - lo));
    __syncwarp();                            // the slice is rewritten next
  }
}

// ---- block variant ---------------------------------------------------------

struct BlockShared {
  Stats part[kBlockWarps];
  Best best[kBlockWarps];
  int open_end[kBlockWarps];
  int last_start[kBlockWarps];
  int gap[kBlockWarps];
  double sum[kBlockWarps];
};

__device__ double block_sum(double v, BlockShared& sh) {
  v = warp_sum(v);
  if (lane_id() == 0) sh.sum[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kBlockWarps; ++w) t += sh.sum[w];
  __syncthreads();                           // sh.sum is rewritten next
  return t;
}

// A persistent grid of blocks, each taking rows blockIdx.x, + gridDim.x, ...
// `stage` stages each row in n*4 bytes of dynamic shared memory.  `scratch`
// holds the general path's arrays: gridDim.x*n entries of p, of p0, of pos.
__global__ void __launch_bounds__(kBlockThreads)
k1_block_rows(const float* __restrict__ u, double* __restrict__ out,
              long long rows, int n, double mass_fraction, int stage,
              unsigned char* __restrict__ scratch) {
  __shared__ BlockShared sh;
  float* srow = (float*)k1_smem;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int seg = ((n + kBlockWarps - 1) / kBlockWarps + 31) & ~31;
  const int i0 = min(n, warp * seg), i1 = min(n, i0 + seg);
  const size_t slots = (size_t)gridDim.x * n;
  Entries e;
  e.p = (double*)scratch + (size_t)blockIdx.x * n;
  e.p0 = (double*)scratch + slots + (size_t)blockIdx.x * n;
  e.pos = (int*)((double*)scratch + 2 * slots) + (size_t)blockIdx.x * n;

  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* g = u + row * n;
    double* o = out + row * 3;
    Stats s = no_samples();
    for (int i = i0 + lane; i < i1; i += 32) {
      const float v = g[i];
      if (stage) srow[i] = v;
      add_sample(s, i, v);
    }
    s = warp_stats(s);
    if (lane == 0) sh.part[warp] = s;
    __syncthreads();
    Stats t = no_samples();
    for (int w = 0; w < kBlockWarps; ++w) merge(t, sh.part[w]);
    const float* x = stage ? srow : g;

    if (!(t.total > 0.0)) {
      if (threadIdx.x == 0) write_row(o, 0.0, 0.0, (double)n);
    } else if (one_run(t)) {
      const double mean = t.mass / t.count;
      double sq = 0.0;
      for (int i = t.first + threadIdx.x; i <= t.last; i += kBlockThreads) {
        const double d = (double)x[i] - mean;
        sq += d * d;
      }
      sq = block_sum(sq, sh);
      if (threadIdx.x == 0) write_row(o, mean, sq, (double)t.count);
    } else {
      // warp w's entries follow those of the segments before it
      int base = 0, prev = -1;
      double run = 0.0;
      for (int w = 0; w < warp; ++w) {
        base += sh.part[w].count;
        run += sh.part[w].total;
        prev = max(prev, sh.part[w].last);
      }
      const int gap = warp_compact(x, i0, i1, base, run, prev, e);
      if (lane == 0) sh.gap[warp] = gap;
      __syncthreads();
      int max_gap = 0;
      for (int w = 0; w < kBlockWarps; ++w) max_gap = max(max_gap, sh.gap[w]);
      const int m = t.count;
      const int cseg = ((m + kBlockWarps - 1) / kBlockWarps + 31) & ~31;
      const int j0 = min(m, warp * cseg), j1 = min(m, j0 + cseg);
      auto probe = [&](int gb) {
        int open_end, last_start;
        const Best b = warp_probe(e, j0, j1, m, gb, open_end, last_start);
        if (lane == 0) {
          sh.best[warp] = b;
          sh.open_end[warp] = open_end;
          sh.last_start[warp] = last_start;
        }
        __syncthreads();
        // segments in order: a region left open by the segments before
        // warp w's closes at w's open end
        Best r = no_region();
        int st = -1;
        for (int w = 0; w < kBlockWarps; ++w) {
          const int oe = sh.open_end[w];
          if (oe >= 0) consider(r, e.p[oe] - e.p0[st], st, oe);
          consider(r, sh.best[w].mass, sh.best[w].lo, sh.best[w].hi);
          if (sh.last_start[w] >= 0) st = sh.last_start[w];
        }
        __syncthreads();                     // sh is rewritten next probe
        return r;
      };
      const Best reg = bisect(e, m, max_gap,
                              mass_fraction * t.total - 1e-9, probe);
      const int lo = e.pos[reg.lo], hi = e.pos[reg.hi] + 1;
      const double mean = reg.mass / (hi - lo);
      double sq = 0.0;
      for (int i = lo + threadIdx.x; i < hi; i += kBlockThreads) {
        const double d = (double)x[i] - mean;
        sq += d * d;
      }
      sq = block_sum(sq, sh);
      if (threadIdx.x == 0) write_row(o, mean, sq, (double)(hi - lo));
    }
    __syncthreads();                         // sh.part and srow reused
  }
}

}  // namespace k1

// ---- host interface (plain C, loaded with ctypes) ----

#ifdef __CUDACC__

namespace {

template <int K>
void launch_rows(unsigned grid, cudaStream_t st, const float* u, double* out,
                 long long rows, int n, int* work) {
  k1::k1_warp_rows<K><<<grid, 32 * k1::kRowsPerBlock, 0, st>>>(u, out, rows,
                                                                n, work);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Longest row, in samples, the block variant stages in shared memory on the
// current device.
int k1_stage_limit(int* max_samples) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, k1::k1_block_rows);
  if (e != cudaSuccess) return (int)e;
  *max_samples = (optin - (int)attr.sharedSizeBytes) / (int)sizeof(float);
  return 0;
}

// Warp variant.  u: (rows, n) float32 row-major on the device, n <= 32 *
// lane_samples; out: (rows, 3) float64; work: rows + 1 ints of scratch.
// lane_samples must be one of the instantiated counts.  Launches pass 0 and
// then the general path for the rows pass 0 listed.  Returns the CUDA error
// of the launches (0 on success).
int k1_warp(const float* u, double* out, long long rows, int n,
            double mass_fraction, int lane_samples, int* work, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n > 32 * lane_samples || n > k1::kWarpMaxN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(work, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid =
      (unsigned)((rows + k1::kRowsPerBlock - 1) / k1::kRowsPerBlock);
  switch (lane_samples) {
#define K1_CASE(K) \
    case K: launch_rows<K>(grid, st, u, out, rows, n, work); break;
    K1_CASE(1) K1_CASE(2) K1_CASE(4) K1_CASE(8) K1_CASE(16) K1_CASE(24)
    K1_CASE(32) K1_CASE(40) K1_CASE(48) K1_CASE(56) K1_CASE(64)
#undef K1_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = k1::kGeneralWarps * k1::slice_bytes(n);
  e = set_smem((const void*)k1::k1_warp_general, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k1::k1_warp_general, 32 * k1::kGeneralWarps, smem);
  if (e != cudaSuccess) return (int)e;
  const long long want = (rows + k1::kGeneralWarps - 1) / k1::kGeneralWarps;
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid2 = (unsigned)(want < slots ? want : slots);
  k1::k1_warp_general<<<grid2, 32 * k1::kGeneralWarps, smem, st>>>(
      u, out, n, mass_fraction, work);
  return (int)cudaGetLastError();
}

// Block variant.  `grid` blocks (at most rows) take the rows in turn;
// scratch: grid * n * 20 bytes; stage != 0 stages each row in n * 4 bytes of
// dynamic shared memory.  Returns the CUDA error of the launch.
int k1_block(const float* u, double* out, long long rows, int n,
             double mass_fraction, int stage, int grid, void* scratch,
             void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (grid <= 0 || grid > rows) return (int)cudaErrorInvalidValue;
  const size_t smem = stage ? (size_t)n * sizeof(float) : 0;
  const cudaError_t e = set_smem((const void*)k1::k1_block_rows, smem);
  if (e != cudaSuccess) return (int)e;
  k1::k1_block_rows<<<(unsigned)grid, k1::kBlockThreads, smem,
                      (cudaStream_t)stream>>>(
      u, out, rows, n, mass_fraction, stage, (unsigned char*)scratch);
  return (int)cudaGetLastError();
}

const char* k1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

#endif  // __CUDACC__
