// K1: Algorithm-1 behavior-pattern summary (paper §4.2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pattern_summary.py::_kernel
// (with its helpers _region_stats and _trim).  It computes what the
// reference oracles compute (repro/core/patterns.py::critical_duration and
// repro/summarize/backends.py::NumpyBackend), not a block-for-block copy of
// the TPU kernel: for every row of a zero-padded (E, n) float32 utilization
// matrix it finds the smallest zero-gap bound g for which some region (a
// maximal run of nonzero samples whose inner zero-runs are <= g long) holds
// >= mass_fraction of the row total, takes the max-mass region at that g
// (leftmost on ties), trims it to nonzero boundaries and writes
// (mean, std, count) of the samples inside as float64.  An all-zero row
// gives (0, 0, n).  Row totals, prefix sums and moments accumulate in
// float64, so borderline feasibility cannot drift as it does with the TPU
// kernel's float32 total.
//
// Bound: bytes.  The work reads E*n*4 bytes once and writes E*3*8 bytes,
// at 3.35 TB/s on an H100 SXM; the arithmetic per sample is a few adds and
// compares.  The design is the simple one: one block per row, the row staged
// in dynamic shared memory when it fits (about 56 000 samples in 227 KB) and
// otherwise read from device memory tile by tile, so each bisection pass
// re-reads shared memory or L2 rather than HBM.  Each pass is a block-wide
// scan over tiles of blockDim*kItems samples (warp-shuffle scan, then a scan
// of the warp totals), with a carry from tile to tile.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kItems = 4;            // consecutive samples per thread per tile
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Summary of a contiguous range of samples under a fixed gap bound g.  The
// scan combines these; sums are relative to the start of the range.
struct Range {
  int f;        // first nonzero sample in the range, -1 if none
  int l;        // last nonzero sample
  int r;        // 1 if a region starts at a nonzero after f
  int sb;       // start of the last region that starts after f (if r)
  double zpre;  // sum of the samples before f (the whole range if f < 0)
  double ztot;  // sum of all samples in the range
  double pl;    // sum of the samples up to and including l
  double psb;   // sum of the samples before sb
};

// State after a prefix of the row: the open region and the running sums.
struct Carry {
  int last;     // last nonzero sample so far, -1 if none
  int st;       // first sample of the open region
  double p;     // prefix sum of all samples so far
  double pl;    // prefix sum through `last`
  double pst;   // prefix sum before `st`
};

struct Best {
  double mass;
  int lo;
  int hi;
};

struct Scratch {
  Range warp_tot[kMaxWarps];
  Range warp_pre[kMaxWarps];
  Range block_tot;
  Best best[kMaxWarps];
  int gap[kMaxWarps];
  double sum[kMaxWarps];
  Best result;
  int max_gap;
  double total;
};

__device__ __forceinline__ Range identity() {
  Range s;
  s.f = -1; s.l = -1; s.r = 0; s.sb = -1;
  s.zpre = 0.0; s.ztot = 0.0; s.pl = 0.0; s.psb = 0.0;
  return s;
}

__device__ __forceinline__ Range element(int i, float v) {
  Range s = identity();
  const double x = v;
  s.ztot = x;
  if (v > 0.f) {
    s.f = i; s.l = i; s.pl = x;
  } else {
    s.zpre = x;
  }
  return s;
}

// a then b.  A region starts at b's first nonzero when the zero-run between
// a's last nonzero and it is longer than g.
__device__ __forceinline__ Range combine(const Range& a, const Range& b,
                                         int g) {
  if (a.f < 0) {
    Range c = b;
    c.zpre = a.ztot + b.zpre;
    c.ztot = a.ztot + b.ztot;
    c.pl = a.ztot + b.pl;
    c.psb = a.ztot + b.psb;
    return c;
  }
  if (b.f < 0) {
    Range c = a;
    c.ztot = a.ztot + b.ztot;
    return c;
  }
  Range c;
  c.f = a.f;
  c.l = b.l;
  c.zpre = a.zpre;
  c.ztot = a.ztot + b.ztot;
  c.pl = a.ztot + b.pl;
  const bool j = b.f - a.l - 1 > g;
  c.r = a.r | (int)j | b.r;
  if (b.r) {
    c.sb = b.sb; c.psb = a.ztot + b.psb;
  } else if (j) {
    c.sb = b.f; c.psb = a.ztot + b.zpre;
  } else {
    c.sb = a.sb; c.psb = a.psb;
  }
  return c;
}

// Advance a carry over a range.
__device__ __forceinline__ void apply(Carry& c, const Range& s, int g) {
  if (s.f < 0) {
    c.p += s.ztot;
    return;
  }
  if (s.r) {
    c.st = s.sb; c.pst = c.p + s.psb;
  } else if (c.last < 0 || s.f - c.last - 1 > g) {
    c.st = s.f; c.pst = c.p + s.zpre;
  }
  c.pl = c.p + s.pl;
  c.last = s.l;
  c.p += s.ztot;
}

__device__ __forceinline__ Range shfl_up(const Range& s, int d) {
  Range o;
  o.f = __shfl_up_sync(kFull, s.f, d);
  o.l = __shfl_up_sync(kFull, s.l, d);
  o.r = __shfl_up_sync(kFull, s.r, d);
  o.sb = __shfl_up_sync(kFull, s.sb, d);
  o.zpre = __shfl_up_sync(kFull, s.zpre, d);
  o.ztot = __shfl_up_sync(kFull, s.ztot, d);
  o.pl = __shfl_up_sync(kFull, s.pl, d);
  o.psb = __shfl_up_sync(kFull, s.psb, d);
  return o;
}

__device__ __forceinline__ Range warp_inclusive_scan(Range x, int lane,
                                                     int g) {
  for (int d = 1; d < 32; d <<= 1) {
    const Range y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x, g);
  }
  return x;
}

// Max mass first, then the leftmost region.
__device__ __forceinline__ bool better(double m, int lo, const Best& b) {
  return m > b.mass || (m == b.mass && lo < b.lo);
}

__device__ __forceinline__ void consider(Best& b, double m, int lo, int hi) {
  if (better(m, lo, b)) {
    b.mass = m; b.lo = lo; b.hi = hi;
  }
}

// One pass over the row at gap bound g.  Returns, identically in every
// thread, the max-mass region (leftmost on ties) in sh.result, the largest
// inner zero-run in sh.max_gap and the row total in sh.total.
__device__ void scan_pass(const float* x, int n, int g, Scratch& sh) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockDim.x * kItems;

  Carry tc;                      // carry into the tile, same in every thread
  tc.last = -1; tc.st = -1; tc.p = 0.0; tc.pl = 0.0; tc.pst = 0.0;
  Best best;
  best.mass = -INFINITY; best.lo = INT_MAX; best.hi = 0;
  int max_gap = 0;

  for (int base = 0; base < n; base += tile) {
    const int i0 = base + tid * kItems;
    float v[kItems];
    Range s = identity();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = i0 + k;
      v[k] = i < n ? x[i] : 0.f;
      s = combine(s, element(i, v[k]), g);
    }
    const Range incl = warp_inclusive_scan(s, lane, g);
    Range excl = shfl_up(incl, 1);
    if (lane == 0) excl = identity();
    if (lane == 31) sh.warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const Range w = warp_inclusive_scan(
          lane < nwarps ? sh.warp_tot[lane] : identity(), lane, g);
      Range we = shfl_up(w, 1);
      if (lane == 0) we = identity();
      if (lane < nwarps) sh.warp_pre[lane] = we;
      if (lane == nwarps - 1) sh.block_tot = w;
    }
    __syncthreads();

    Carry c = tc;
    apply(c, sh.warp_pre[warp], g);
    apply(c, excl, g);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = i0 + k;
      if (i >= n) break;
      if (v[k] > 0.f) {
        if (c.last >= 0) {
          const int gap = i - c.last - 1;
          max_gap = max(max_gap, gap);
          if (gap > g) {         // the open region ends at c.last
            consider(best, c.pl - c.pst, c.st, c.last + 1);
            c.st = i; c.pst = c.p;
          }
        } else {
          c.st = i; c.pst = c.p;
        }
        c.p += (double)v[k];
        c.pl = c.p;
        c.last = i;
      } else {
        c.p += (double)v[k];
      }
    }
    apply(tc, sh.block_tot, g);
    __syncthreads();             // sh is rewritten by the next tile
  }
  // the region still open at the end of the row
  if (tid == 0 && tc.last >= 0)
    consider(best, tc.pl - tc.pst, tc.st, tc.last + 1);

  for (int d = 16; d > 0; d >>= 1) {
    Best o;
    o.mass = __shfl_down_sync(kFull, best.mass, d);
    o.lo = __shfl_down_sync(kFull, best.lo, d);
    o.hi = __shfl_down_sync(kFull, best.hi, d);
    consider(best, o.mass, o.lo, o.hi);
    max_gap = max(max_gap, __shfl_down_sync(kFull, max_gap, d));
  }
  if (lane == 0) {
    sh.best[warp] = best;
    sh.gap[warp] = max_gap;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nwarps; ++w) {
      consider(best, sh.best[w].mass, sh.best[w].lo, sh.best[w].hi);
      max_gap = max(max_gap, sh.gap[w]);
    }
    sh.result = best;
    sh.max_gap = max_gap;
    sh.total = tc.p;
  }
  __syncthreads();
}

__device__ double block_sum(double v, Scratch& sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
  if (lane == 0) sh.sum[warp] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += sh.sum[w];
  return t;
}

__global__ void __launch_bounds__(kMaxThreads)
pattern_summary_kernel(const float* __restrict__ u, double* __restrict__ out,
                       int n, double mass_fraction, int stage) {
  extern __shared__ float srow[];
  __shared__ Scratch sh;
  const float* row = u + (int64_t)blockIdx.x * n;
  const float* x = row;
  if (stage) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) srow[i] = row[i];
    __syncthreads();
    x = srow;
  }
  double* o = out + (int64_t)blockIdx.x * 3;

  // g = INT_MAX splits nothing: the one region spans every nonzero sample
  scan_pass(x, n, INT_MAX, sh);
  const double total = sh.total;
  if (!(total > 0.0)) {
    if (threadIdx.x == 0) {
      o[0] = 0.0; o[1] = 0.0; o[2] = (double)n;
    }
    return;
  }
  const double target = mass_fraction * total - 1e-9;
  Best reg = sh.result;
  // feasibility is monotone in g and g = max_gap is always feasible
  int lo_g = 0;
  int hi_g = sh.max_gap - 1;
  while (lo_g <= hi_g) {
    const int g = (lo_g + hi_g) >> 1;
    scan_pass(x, n, g, sh);
    if (sh.result.mass >= target) {
      reg = sh.result;
      hi_g = g - 1;
    } else {
      lo_g = g + 1;
    }
  }

  const double cnt = (double)(reg.hi - reg.lo);
  const double mean = reg.mass / cnt;
  double acc = 0.0;
  for (int i = reg.lo + threadIdx.x; i < reg.hi; i += blockDim.x) {
    const double d = (double)x[i] - mean;
    acc += d * d;
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    o[0] = mean; o[1] = sqrt(acc / cnt); o[2] = cnt;
  }
}

}  // namespace

// ---- host interface (plain C, loaded with ctypes) ----

extern "C" {

// Largest row length, in samples, that the kernel can stage in shared memory
// on the current device.
int k1_stage_limit(int* max_samples) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, pattern_summary_kernel);
  if (e != cudaSuccess) return (int)e;
  *max_samples = (optin - (int)attr.sharedSizeBytes) / (int)sizeof(float);
  return 0;
}

// u: (E, n) float32 row-major on the device; out: (E, 3) float64.  One block
// of `threads` (a multiple of 32, at most 256) per row; `stage` != 0 stages
// each row in n*4 bytes of dynamic shared memory.  Returns the CUDA error of
// the launch (0 on success).
int k1_pattern_summary(const float* u, double* out, long long rows, int n,
                       double mass_fraction, int threads, int stage,
                       void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  const size_t smem = stage ? (size_t)n * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pattern_summary_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pattern_summary_kernel<<<(unsigned)rows, threads, smem,
                           (cudaStream_t)stream>>>(u, out, n, mass_fraction,
                                                   stage);
  return (int)cudaGetLastError();
}

const char* k1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
