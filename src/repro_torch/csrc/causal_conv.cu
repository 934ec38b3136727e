// K5: mamba2's depthwise causal conv and its SiLU, forward and backward, on
// Hopper.
//
// Replaces no TPU kernel: the JAX reference leaves the conv to XLA, which
// fuses it.  As composed PyTorch ops (models/ssm.py::_causal_conv, then
// F.silu) the conv is W shifted float32 multiply-adds on a padded float32
// copy of its input, which autograd keeps for the backward (2051 x 5376 x 4
// bytes, 44 MB a mamba2-2.7b layer), beside SiLU's input.  This kernel
// keeps the copy out of device memory: the autograd function saves only x
// (the projection's output), the taps and the bias, and the backward
// recomputes the pre-activation from x.
//
// Over x (B, S, C), the taps w (C, W) with W <= 4 and the bias b (C,), all
// of one type T (f32 or bf16), for each batch, row s and channel:
//
//   pre[s] = T((..(x[s-W+1] w[0] + x[s-W+2] w[1]) + .. + x[s] w[W-1]) + b)
//   out[s] = T(silu(pre[s])),   silu(p) = p / (1 + exp(-p))
//
// with x[s] = 0 for s < 0, each product and sum one float32 rounding in tap
// order (__fmul_rn / __fadd_rn, no FMA contraction): the composed ops'
// rounding points, so the forward gives their bits.  The backward:
//
//   sig = 1 / (1 + exp(-pre)),   dpre = T(g sig (1 + pre (1 - sig)))
//   dx[s] = sum_k dpre[s+W-1-k] w[k]         (dpre[s] = 0 for s >= S)
//   dw[k] = sum over batches and rows of dpre[s] x[s-W+1+k]
//   db    = sum over batches and rows of dpre[s]
//
// dpre is rounded to T where torch's SiLU backward rounds it; dx is summed
// in float32 and rounded once.  dw and db are deterministic: a block sums
// its threads' partials in shared memory in a fixed order and writes one
// row of partials to an f32 scratch (allocated by the wrapper), and a
// second pass sums the rows in a fixed order.  No atomics.
//
// Bound on an H100 SXM: bytes (the conv's 2 W multiply-adds an element are
// far below the card's ratio of operations to bytes).  At mamba2-2.7b's xs
// conv (1 x 2048 x 5120 bf16) the forward reads x and writes out, 42 MB,
// 12.5 us at 3.35 TB/s; the backward reads x and g and writes dx, 63 MB,
// 18.8 us.  Design: a thread owns a vector of channels (8 bytes of T in
// the forward, 4 in the backward) and walks a span of rows, keeping the
// last W - 1 inputs (and, in the backward, the dx sums still open) in
// registers, so that each input is read once, plus a halo of W - 1 rows a
// span (and W - 1 rows of x and g after it in the backward).  A block is
// bx channel vectors by `by` spans; the grid (C / V / bx, spans / by, B).
// The span follows the shape and the card: S is cut into as many spans as
// kWaves waves of resident blocks hold (the kernel's occupancy times the
// SMs, asked of the runtime), so a wide conv walks long spans and a narrow
// one (B and C, 128 channels) a row a thread, and no last, mostly idle
// wave doubles the time.  The geometry is a function of the shape and the
// card alone, so the partials, and dw and db, are the same bits run after
// run.  The bf16 forward reads SiLU from a table (silu_table) and the
// conv's width, 4 in every model, is a template argument: on an H100 at
// mamba2-2.7b's xs conv the table took ~15% and the width ~10% off the
// forward's time.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

namespace k5 {

constexpr int kMaxW = 4;
constexpr int kThreads = 128;
// channel vectors a block (a warp reads 4 rows of 8 vectors)
constexpr int kBx = 8;
// the column sums' block: 32 columns, each summed by 16 warps
constexpr int kSumCols = 32;
constexpr int kSumWarps = 16;
// the vector a thread loads, in bytes: the backward holds more values a
// channel in registers, so it takes fewer channels a thread
constexpr int kFwdBytes = 8;
constexpr int kBwdBytes = 4;
// waves of resident blocks a grid holds: the second evens out the first's
// uneven end
constexpr int kWaves = 2;

struct Conv {
  const void* x;     // (B, S, C), channel stride 1
  const void* w;     // (C, W), contiguous
  const void* b;     // (C,)
  const void* g;     // backward: (B, S, C), contiguous
  void* out;         // forward: out; backward: dx; (B, S, C) contiguous
  float* part;       // backward: (B * gridDim.y, C, W + 1)
  long long sb, ss;  // x's batch and row strides, in elements
  int S, C, W;
  int bx, by, span;  // a block: bx channel vectors x by spans of rows
  // SiLU's output for every bf16 value by its 16 bits (silu_table), for a
  // bf16 forward; null for f32
  const void* silu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename X> __device__ __forceinline__ X from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to X and back: the composed ops' cast
template <typename X> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<X>(v));
}

template <typename X, int V> struct alignas(sizeof(X) * V) Vec {
  X v[V];
};

// V elements at p (aligned to V sizeof(X) bytes) as f32, in one load
template <typename X, int V>
__device__ __forceinline__ void load(const X* p, float (&f)[V]) {
  const Vec<X, V> ch = *reinterpret_cast<const Vec<X, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f(ch.v[i]);
}

template <typename X, int V>
__device__ __forceinline__ void store(X* p, const float (&f)[V]) {
  Vec<X, V> ch;
#pragma unroll
  for (int i = 0; i < V; ++i) ch.v[i] = from_f<X>(f[i]);
  *reinterpret_cast<Vec<X, V>*>(p) = ch;
}

// The taps of channels c0 .. c0 + V - 1, slot j holding tap j - (kMaxW - W)
// (slots below kMaxW - W hold none), so that slot j meets the input of row
// s - (kMaxW - 1 - j); and the bias.
template <typename T, int V>
__device__ __forceinline__ void load_taps(const T* w, const T* b, int c0,
                                          int W, float (&t)[kMaxW][V],
                                          float (&bias)[V]) {
#pragma unroll
  for (int j = 0; j < kMaxW; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i)
      t[j][i] = j >= kMaxW - W
          ? to_f(w[(long long)(c0 + i) * W + j - (kMaxW - W)]) : 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) bias[i] = to_f(b[c0 + i]);
}

// SiLU as torch computes it on the card (f32): p / (1 + exp(-p)); and its
// derivative's two factors, sig = 1 / (1 + exp(-p)) and 1 + p (1 - sig),
// the backward's dpre being (g sig) times the second
__device__ __forceinline__ float silu(float p) {
  return __fdiv_rn(p, __fadd_rn(1.0f, expf(-p)));
}

__device__ __forceinline__ float2 silu_grad(float p) {
  const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-p)));
  return make_float2(sig, __fmaf_rn(p, __fsub_rn(1.0f, sig), 1.0f));
}

// SiLU's bf16 output for every bf16 value, by its 16 bits: the bf16
// forward reads SiLU from this table instead of computing it.  Its input
// is a bf16 value, so a lookup is the same function, bit for bit, at the
// cost of one cached load (the values a layer meets lie in a few thousand
// entries) in place of an exponential and an IEEE division.  (A table of
// the derivative's factors made the backward slower: its 8-byte loads
// compete in L1 with the backward's two streams.)  One thread an entry.
__global__ void __launch_bounds__(256) silu_table(__nv_bfloat16* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float p = __bfloat162float(__ushort_as_bfloat16((unsigned short)i));
  out[i] = __float2bfloat16_rn(silu(p));
}

// SiLU forward in T: bf16 by the table, f32 computed
template <typename T> struct Silu;

template <> struct Silu<__nv_bfloat16> {
  const __nv_bfloat16* table;
  __device__ __forceinline__ Silu(const void* t)
      : table(static_cast<const __nv_bfloat16*>(t)) {}
  __device__ __forceinline__ __nv_bfloat16 operator()(__nv_bfloat16 p) const {
    return table[__bfloat16_as_ushort(p)];
  }
};

template <> struct Silu<float> {
  __device__ __forceinline__ Silu(const void*) {}
  __device__ __forceinline__ float operator()(float p) const {
    return silu(p);
  }
};

// pre (in T) of the row whose input is h[kMaxW - 1] (h[j]: the row
// kMaxW - 1 - j before it), in tap order at the composed ops' rounding
// points
template <typename T, int V>
__device__ __forceinline__ void conv_row(const float (&h)[kMaxW][V],
                                         const float (&t)[kMaxW][V],
                                         const float (&bias)[V], int W,
                                         T (&pre)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) {
      if (j >= kMaxW - W) {
        const float p = __fmul_rn(h[j][i], t[j][i]);
        acc = j == kMaxW - W ? p : __fadd_rn(acc, p);
      }
    }
    pre[i] = from_f<T>(__fadd_rn(acc, bias[i]));
  }
}

template <int V>
__device__ __forceinline__ void shift(float (&h)[kMaxW][V]) {
#pragma unroll
  for (int j = 0; j < kMaxW - 1; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) h[j][i] = h[j + 1][i];
}

// the rows s0 - (kMaxW - 1) .. s0 - 1 into h[0 .. kMaxW - 2] (0 before row 0)
template <typename T, int V>
__device__ __forceinline__ void load_halo(const T* x, long long ss, int s0,
                                          float (&h)[kMaxW][V]) {
#pragma unroll
  for (int j = 0; j < kMaxW - 1; ++j) {
    const int s = s0 - (kMaxW - 1) + j;
    if (s >= 0) {
      load<T, V>(x + s * ss, h[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) h[j][i] = 0.0f;
    }
  }
}

// block (gx, gy, batch); thread: channel vector blockIdx.x bx + tid % bx,
// the rows of span blockIdx.y by + tid / bx.  kW: the conv's width where
// it is known when compiled (kMaxW, every model's), 0 for p.W: a known
// width folds the tap-order selects out of conv_row.
template <typename T, int V, int kW>
__global__ void __launch_bounds__(kThreads) conv_fwd(Conv p) {
  const int W = kW ? kW : p.W;
  const int cv = blockIdx.x * p.bx + threadIdx.x % p.bx;
  const int s0 = (blockIdx.y * p.by + threadIdx.x / p.bx) * p.span;
  const int c0 = cv * V;
  if (c0 >= p.C || s0 >= p.S) return;
  const int s1 = min(s0 + p.span, p.S);
  const Silu<T> act(p.silu);
  float t[kMaxW][V], bias[V], h[kMaxW][V];
  load_taps<T, V>(static_cast<const T*>(p.w), static_cast<const T*>(p.b),
                   c0, W, t, bias);
  const T* x = static_cast<const T*>(p.x) + blockIdx.z * p.sb + c0;
  T* out = static_cast<T*>(p.out) + (long long)blockIdx.z * p.S * p.C + c0;
  load_halo<T, V>(x, p.ss, s0, h);
#pragma unroll 4
  for (int s = s0; s < s1; ++s) {
    T pre[V];
    Vec<T, V> o;
    load<T, V>(x + s * p.ss, h[kMaxW - 1]);
    conv_row<T, V>(h, t, bias, W, pre);
#pragma unroll
    for (int i = 0; i < V; ++i) o.v[i] = act(pre[i]);
    *reinterpret_cast<Vec<T, V>*>(out + (long long)s * p.C) = o;
    shift<V>(h);
  }
}

// The backward over the same blocks.  A thread walks rows c from its
// span's first s0 to kMaxW - 1 past its last: dpre[c] from the recomputed
// pre, its share of dw and db for the span's own rows, and its products
// with the taps into the open dx sums of rows c - kMaxW + 1 .. c, of which
// row c - kMaxW + 1 is complete and stored.  Dynamic shared memory: bx by V
// (kMaxW + 1) floats, each thread's dw and db.
template <typename T, int V, int kW>
__global__ void __launch_bounds__(kThreads) conv_bwd(Conv p) {
  extern __shared__ float red[];
  const int W = kW ? kW : p.W;
  constexpr int kVals = V * (kMaxW + 1);   // a thread's: slot j x V, db x V
  const int lane = threadIdx.x % p.bx, ty = threadIdx.x / p.bx;
  const int cv = blockIdx.x * p.bx + lane;
  const int s0 = (blockIdx.y * p.by + ty) * p.span;
  const int c0 = cv * V;
  float dw[kMaxW][V], db[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    db[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) dw[j][i] = 0.0f;
  }
  if (c0 < p.C && s0 < p.S) {
    float t[kMaxW][V], bias[V], h[kMaxW][V], acc[kMaxW][V];
    load_taps<T, V>(static_cast<const T*>(p.w), static_cast<const T*>(p.b),
                    c0, W, t, bias);
    const long long base = (long long)blockIdx.z * p.S * p.C + c0;
    const T* x = static_cast<const T*>(p.x) + blockIdx.z * p.sb + c0;
    const T* g = static_cast<const T*>(p.g) + base;
    T* dx = static_cast<T*>(p.out) + base;
    load_halo<T, V>(x, p.ss, s0, h);
#pragma unroll
    for (int j = 0; j < kMaxW; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = 0.0f;
    const int s1 = min(s0 + p.span, p.S);
#pragma unroll 2
    for (int c = s0; c < s1 + kMaxW - 1; ++c) {
      float dp[V];
      if (c < p.S) {
        float gf[V];
        T pre[V];
        load<T, V>(x + c * p.ss, h[kMaxW - 1]);
        load<T, V>(g + (long long)c * p.C, gf);
        conv_row<T, V>(h, t, bias, W, pre);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float2 d = silu_grad(to_f(pre[i]));
          dp[i] = round_to<T>(__fmul_rn(__fmul_rn(gf[i], d.x), d.y));
        }
        if (c < s1) {
#pragma unroll
          for (int j = 0; j < kMaxW; ++j)
#pragma unroll
            for (int i = 0; i < V; ++i) dw[j][i] += dp[i] * h[j][i];
#pragma unroll
          for (int i = 0; i < V; ++i) db[i] += dp[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dp[i] = 0.0f;
      }
      // row c - kMaxW + 1 + j takes dpre[c] times tap slot j
#pragma unroll
      for (int j = 0; j < kMaxW; ++j)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[j][i] += dp[i] * t[j][i];
      if (c >= s0 + kMaxW - 1)
        store<T, V>(dx + (long long)(c - (kMaxW - 1)) * p.C, acc[0]);
      shift<V>(acc);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[kMaxW - 1][i] = 0.0f;
      shift<V>(h);
    }
  }
  float* mine = red + threadIdx.x * kVals;
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) mine[j * V + i] = dw[j][i];
    mine[kMaxW * V + i] = db[i];
  }
  __syncthreads();
  // the block's row of partials: each value summed over ty in order
  const long long row = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  const int stride = p.bx * kVals;   // floats between two ty
  for (int q = threadIdx.x; q < stride; q += blockDim.x) {
    float sum = 0.0f;
    for (int y = 0; y < p.by; ++y) sum += red[y * stride + q];
    const int l = q / kVals, e = q % kVals;
    const int slot = e / V, c = (blockIdx.x * p.bx + l) * V + e % V;
    if (c >= p.C || slot < kMaxW - W) continue;
    const int k = slot == kMaxW ? W : slot - (kMaxW - W);
    p.part[(row * p.C + c) * (W + 1) + k] = sum;
  }
}

// dw and db: column j = c (W + 1) + k of the partials summed over their
// rows, warp w summing rows w, w + kSumWarps, .., then the warps' sums in
// order; k < W is tap k of channel c, k = W its bias.  Dynamic shared
// memory: kSumWarps x kSumCols floats.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumWarps) conv_col_sum(
    const float* part, int rows, int C, int W, T* dw, T* db) {
  extern __shared__ float red[];
  const int n = C * (W + 1);
  const int lane = threadIdx.x % kSumCols, warp = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + lane;
  float t = 0.0f;
  if (j < n)
    for (int r = warp; r < rows; r += kSumWarps)
      t += part[(long long)r * n + j];
  red[warp * kSumCols + lane] = t;
  __syncthreads();
  if (warp == 0 && j < n) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += red[w * kSumCols + lane];
    const int c = j / (W + 1), k = j % (W + 1);
    if (k < W) {
      dw[c * W + k] = from_f<T>(total);
    } else {
      db[c] = from_f<T>(total);
    }
  }
}

struct Geometry {
  int bx, by, span, gx, gy;
};

// the blocks of a call over B x S rows of C channels in vectors of V, on a
// card that holds `resident` blocks of the kernel at once: bx channel
// vectors (kBx, or all of them when C holds fewer); S cut into spans of
// `span` rows, as many as kWaves waves of resident blocks hold (at least
// one block row a batch, and no span shorter than a row); by spans a block
// (as many as kThreads threads hold, or all of them)
inline Geometry geometry(int B, int S, int C, int V, long long resident) {
  const int nvec = C / V;
  Geometry g;
  g.bx = nvec < kBx ? nvec : kBx;
  g.gx = (nvec + g.bx - 1) / g.bx;
  const int per_block = kThreads / g.bx;
  // block rows a batch
  long long rows = kWaves * resident / ((long long)g.gx * B);
  if (rows < 1) rows = 1;
  long long spans = rows * per_block;
  if (spans > S) spans = S;
  g.span = (int)((S + spans - 1) / spans);
  const int nspan = (S + g.span - 1) / g.span;
  g.by = per_block < nspan ? per_block : nspan;
  g.gy = (nspan + g.by - 1) / g.by;
  return g;
}

// a direction's full vector in elements of T (t: 0 f32, 1 bf16)
inline int full_vec(int t, bool backward) {
  return (backward ? kBwdBytes : kFwdBytes) / (t == 1 ? 2 : 4);
}

// the backward's scratch: a row of dw and db partials a block row a batch
inline long long scratch_floats(int B, int S, int C, int W, int V,
                                long long resident) {
  return (long long)B * geometry(B, S, C, V, resident).gy * C * (W + 1);
}

inline int bwd_smem(int threads, int V) {
  return threads * V * (kMaxW + 1) * 4;
}

}  // namespace k5

#ifdef __CUDACC__
namespace k5 {

// blocks of the <T, V, kW> kernel of a direction that the current card
// holds at once (its occupancy at kThreads threads times the SMs), asked
// of the runtime once a device; 0 if the runtime cannot say
template <typename T, int V, int kW, bool kBackward>
static long long resident_blocks() {
  static long long cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = kBackward
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, conv_bwd<T, V, kW>, kThreads,
                bwd_smem(kThreads, V))
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, conv_fwd<T, V, kW>, kThreads, 0);
    if (err != cudaSuccess || sms * per_sm == 0) return 0;
    cached[dev] = (long long)sms * per_sm;
  }
  return cached[dev];
}

template <typename T, int V, int kW>
static cudaError_t run_fwd(Conv p, int B, cudaStream_t st) {
  const long long resident = resident_blocks<T, V, kW, false>();
  if (resident == 0) return cudaErrorInvalidConfiguration;
  const Geometry g = geometry(B, p.S, p.C, V, resident);
  p.bx = g.bx;
  p.by = g.by;
  p.span = g.span;
  conv_fwd<T, V, kW><<<dim3(g.gx, g.gy, B), g.bx * g.by, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int V, int kW>
static cudaError_t run_bwd(Conv p, int B, void* dw, void* db,
                           cudaStream_t st) {
  const long long resident = resident_blocks<T, V, kW, true>();
  if (resident == 0) return cudaErrorInvalidConfiguration;
  const Geometry g = geometry(B, p.S, p.C, V, resident);
  p.bx = g.bx;
  p.by = g.by;
  p.span = g.span;
  const int threads = g.bx * g.by;
  conv_bwd<T, V, kW><<<dim3(g.gx, g.gy, B), threads, bwd_smem(threads, V),
                       st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = p.C * (p.W + 1);
  conv_col_sum<T><<<(n + kSumCols - 1) / kSumCols, kSumCols * kSumWarps,
                    kSumCols * kSumWarps * 4, st>>>(
      p.part, B * g.gy, p.C, p.W, static_cast<T*>(dw), static_cast<T*>(db));
  return cudaGetLastError();
}

template <typename T, int V>
static cudaError_t launch_fwd(const Conv& p, int B, cudaStream_t st) {
  return p.W == kMaxW ? run_fwd<T, V, kMaxW>(p, B, st)
                      : run_fwd<T, V, 0>(p, B, st);
}

template <typename T, int V>
static cudaError_t launch_bwd(const Conv& p, int B, void* dw, void* db,
                              cudaStream_t st) {
  return p.W == kMaxW ? run_bwd<T, V, kMaxW>(p, B, dw, db, st)
                      : run_bwd<T, V, 0>(p, B, dw, db, st);
}

// the backward's scratch for the kernel launch_bwd picks
template <typename T, int V>
static long long scratch_for(int B, int S, int C, int W) {
  const long long resident = W == kMaxW
      ? resident_blocks<T, V, kMaxW, true>()
      : resident_blocks<T, V, 0, true>();
  return scratch_floats(B, S, C, W, V, resident);
}

// full: the direction's vector (kFwdBytes / kBwdBytes of T), else one
// element
template <typename T>
static cudaError_t dispatch(const Conv& p, int B, bool backward, void* dw,
                            void* db, bool full, cudaStream_t st) {
  if (backward)
    return full ? launch_bwd<T, kBwdBytes / sizeof(T)>(p, B, dw, db, st)
                : launch_bwd<T, 1>(p, B, dw, db, st);
  return full ? launch_fwd<T, kFwdBytes / sizeof(T)>(p, B, st)
              : launch_fwd<T, 1>(p, B, st);
}

template <typename T>
static long long scratch(int B, int S, int C, int W, bool full) {
  return full ? scratch_for<T, kBwdBytes / sizeof(T)>(B, S, C, W)
              : scratch_for<T, 1>(B, S, C, W);
}

static bool bad_shape(int B, int S, int C, int W, int t, int vec,
                      bool backward) {
  if (B < 1 || B > 65535 || S < 1 || C < 1 || W < 1 || W > kMaxW || t < 0
      || t > 1)
    return true;
  // the grid's y at its most: every row a span, kThreads / kBx spans a
  // block
  const int fewest = kThreads / kBx;
  return !(vec == 1 || vec == full_vec(t, backward)) || C % vec != 0
      || (S + fewest - 1) / fewest > 65535;
}

}  // namespace k5

// The forward.  x (B, S, C) with channel stride 1 and batch / row strides
// sb / ss in elements; w (C, W) and b (C,) contiguous, of x's type; out
// (B, S, C) contiguous in x's type; silu: SiLU's table (k5_silu_table) for
// bfloat16 x, ignored for float32.  dtype: 0 float32, 1 bfloat16.  vec: 1,
// or 8 bytes of x's type when x's and out's rows start 8-byte aligned and C
// is a multiple of it.  Returns cudaGetLastError() of the launch (0 on
// success).
extern "C" int k5_conv_fwd(const void* x, const void* w, const void* b,
                           void* out, const void* silu, int B, int S,
                           int C, int W, long long sb, long long ss,
                           int dtype, int vec, void* stream) {
  if (k5::bad_shape(B, S, C, W, dtype, vec, false)
      || (dtype == 1 && silu == nullptr))
    return (int)cudaErrorInvalidValue;
  k5::Conv p = {};
  p.x = x; p.w = w; p.b = b; p.out = out; p.silu = silu;
  p.sb = sb; p.ss = ss; p.S = S; p.C = C; p.W = W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
      ? k5::dispatch<__nv_bfloat16>(p, B, false, nullptr, nullptr, vec > 1, st)
      : k5::dispatch<float>(p, B, false, nullptr, nullptr, vec > 1, st));
}

// The backward.  g (B, S, C) contiguous in x's type; x, w, b as in the
// forward; dx (B, S, C), dw (C, W), db (C,) contiguous in x's type; part:
// f32 scratch of k5_scratch_floats(B, S, C, W, dtype, vec) floats.  vec: 1,
// or 4 bytes of x's type when x's, g's and dx's rows start 4-byte aligned
// and C is a multiple of it.
extern "C" int k5_conv_bwd(const void* g, const void* x, const void* w,
                           const void* b, void* dx, void* dw, void* db,
                           float* part, int B, int S, int C, int W,
                           long long sb, long long ss, int dtype, int vec,
                           void* stream) {
  if (k5::bad_shape(B, S, C, W, dtype, vec, true))
    return (int)cudaErrorInvalidValue;
  k5::Conv p = {};
  p.x = x; p.w = w; p.b = b; p.g = g; p.out = dx; p.part = part;
  p.sb = sb; p.ss = ss; p.S = S; p.C = C; p.W = W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1
      ? k5::dispatch<__nv_bfloat16>(p, B, true, dw, db, vec > 1, st)
      : k5::dispatch<float>(p, B, true, dw, db, vec > 1, st));
}

// SiLU's table for the bf16 forward: out (65536,) bf16, filled on
// `stream`; made once a device by the wrapper
extern "C" int k5_silu_table(void* out, void* stream) {
  k5::silu_table<<<65536 / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

// the backward's f32 scratch in floats, for k5_conv_bwd's arguments (0 for
// a shape it refuses, or if the runtime cannot say)
extern "C" long long k5_scratch_floats(int B, int S, int C, int W,
                                       int dtype, int vec) {
  if (k5::bad_shape(B, S, C, W, dtype, vec, true)) return 0;
  return dtype == 1 ? k5::scratch<__nv_bfloat16>(B, S, C, W, vec > 1)
                    : k5::scratch<float>(B, S, C, W, vec > 1);
}

extern "C" const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
