// K6: the training loss head's softcap, log-sum-exp and cross-entropy,
// forward and backward, on Hopper.
//
// Replaces no TPU kernel: the JAX reference leaves the loss to XLA, which
// fuses it.  As composed PyTorch ops (models/layers.py::lm_logits, then
// cross_entropy_sums) the head casts the product h = x E^T to float32,
// softcaps it, masks the padded columns and takes logsumexp and the label's
// logit; autograd keeps the masked float32 (rows x V) logits for
// logsumexp's backward, and that backward and the gather's, the mask's and
// the cast's make four more float32 blocks of that size.  At mamba2-2.7b's
// 2048 x 50,277 each is 412 MB: 2.07 GB at the step's peak of device
// memory.  This kernel takes the loss from h, in h's type, and writes no
// float32 (rows x V) tensor: the autograd function saves h, one float32 lse
// a row and the labels, and the backward recomputes each logit from h.
//
// For each row r of h (rows, V) in T (f32 or bf16), with n = min(vocab
// size, V) the columns kept, c the softcap (0: none) and y the row's label
// clamped to >= 0:
//
//   l[j] = c ? tanh(f(h[j]) (1 / c)) c : f(h[j])     (f: to float32)
//   lse  = log(sum_{j < n} exp(l[j] - m)) + m,    m = max_{j < n} l[j]
//   nll  = lse - (y < n ? l[y] : -FLT_MAX)   (NaN for y >= V)
//
// (the composed ops mask the padded columns with float32's lowest value,
// so a label there gives their nll, FLT_MAX); and with g the row's dnll:
//
//   d[j]  = j < n ? g exp(l[j] - lse) - (j == y ? g : 0) : 0
//   dh[j] = T(c ? ((d[j] c) (1 - t[j]^2)) (1 / c) : d[j]),  t[j] = tanh(..)
//
// each product and sum where autograd of the composed ops makes it
// (logsumexp's backward g exp(l - lse), the gather's -g added, tanh's
// backward, the cast back to T rounding once), so dh lies within a step of
// T of theirs.  Rows with a negative label (padding) give an nll that the
// caller masks, and a zero g, as in the composed ops.
//
// Bound on an H100 SXM: bytes.  At mamba2-2.7b's head (2048 x 50,277 bf16,
// 206 MB) the forward reads h once, 61.5 us at 3.35 TB/s; the backward
// reads h and writes dh, 123 us.  Design: a block a row (the grid is the
// rows, up to 8 blocks of 256 threads resident an SM), each thread
// loading 16-byte vectors of the row; the forward keeps an online max and
// sum of exponentials in registers (rescaled when a vector raises the max)
// and merges them over the block by warp shuffles and shared memory in a
// fixed order, so lse is the same bits run after run; the backward is
// elementwise.  A row of an odd vocabulary (mamba2's 50,277 x 2 bytes)
// starts off the 16-byte grid: each row's first elements up to the next
// 16-byte boundary are peeled and read one by one, so h is neither padded
// nor copied.
#include <float.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

namespace k6 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the vector a thread loads, in bytes
constexpr int kVecBytes = 16;

struct Head {
  const void* h;        // (rows, V), contiguous
  const int* labels;    // (rows,)
  const float* lse;     // backward: (rows,), the forward's
  const float* g;       // backward: dnll (rows,)
  float* lse_out;       // forward: (rows,)
  float* nll;           // forward: (rows,)
  void* dh;             // backward: (rows, V), contiguous
  int V, n;             // columns; columns kept, min(vocab size, V)
  float cap, inv_cap;   // the softcap and 1 / cap in f32 (0, 0: none)
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

template <typename X, int E> struct alignas(kVecBytes) Vec {
  X v[E];
};

// a logit from h's value: the softcap as the composed ops take it on the
// card (a multiply by the reciprocal, tanh, a multiply), or the value
template <bool kCap>
__device__ __forceinline__ float logit(float x, float cap, float inv_cap,
                                      float& t) {
  if (!kCap) return x;
  t = tanhf(__fmul_rn(x, inv_cap));
  return __fmul_rn(t, cap);
}

// (m, s): the running max and sum of exp(l - m); one more value
__device__ __forceinline__ void add1(float& m, float& s, float v) {
  if (v > m) {
    s = __fmul_rn(s, expf(m - v));
    m = v;
  }
  s = __fadd_rn(s, expf(v - m));
}

// ... E more values, rescaled once
template <int E>
__device__ __forceinline__ void add_vec(float& m, float& s,
                                        const float (&v)[E]) {
  float mv = v[0];
#pragma unroll
  for (int i = 1; i < E; ++i) mv = fmaxf(mv, v[i]);
  if (mv > m) {
    s = __fmul_rn(s, expf(m - mv));
    m = mv;
  }
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < E; ++i) t = __fadd_rn(t, expf(v[i] - m));
  s = __fadd_rn(s, t);
}

// two (m, s) as one; symmetric, so both lanes of a shuffle get the same bits
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;   // neither has seen a value
  s = __fadd_rn(__fmul_rn(s, expf(m - M)), __fmul_rn(s2, expf(m2 - M)));
  m = M;
}

// (m, s) over the block, in thread 0; a fixed order of merges
__device__ __forceinline__ void block_merge(float& m, float& s) {
  __shared__ float wm[kWarps], ws[kWarps];
#pragma unroll
  for (int o = 16; o; o >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? wm[lane] : -INFINITY;
    s = lane < kWarps ? ws[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, s, o));
  }
}

// elements of a row before its first 16-byte boundary (at most n)
template <typename T>
__device__ __forceinline__ int peel(const T* row, int n) {
  const int head = (int)((kVecBytes - reinterpret_cast<uintptr_t>(row)
                          % kVecBytes) % kVecBytes / sizeof(T));
  return head < n ? head : n;
}

// The forward: block r reduces row r over its n kept columns.
template <typename T, bool kCap>
__global__ void __launch_bounds__(kThreads) ce_fwd(Head p) {
  constexpr int E = kVecBytes / sizeof(T);
  const long long r = blockIdx.x;
  const T* row = static_cast<const T*>(p.h) + r * p.V;
  const int n = p.n;
  const int head = peel(row, n);
  const int nvec = (n - head) / E;
  float m = -INFINITY, s = 0.0f, t;
  for (int j = threadIdx.x; j < head; j += kThreads)
    add1(m, s, logit<kCap>(to_f(row[j]), p.cap, p.inv_cap, t));
  const Vec<T, E>* body = reinterpret_cast<const Vec<T, E>*>(row + head);
  int i = threadIdx.x;
  // two vectors in flight a thread
  for (; i + kThreads < nvec; i += 2 * kThreads) {
    const Vec<T, E> a = body[i], b = body[i + kThreads];
    float va[E], vb[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      va[k] = logit<kCap>(to_f(a.v[k]), p.cap, p.inv_cap, t);
      vb[k] = logit<kCap>(to_f(b.v[k]), p.cap, p.inv_cap, t);
    }
    add_vec<E>(m, s, va);
    add_vec<E>(m, s, vb);
  }
  if (i < nvec) {
    const Vec<T, E> a = body[i];
    float va[E];
#pragma unroll
    for (int k = 0; k < E; ++k)
      va[k] = logit<kCap>(to_f(a.v[k]), p.cap, p.inv_cap, t);
    add_vec<E>(m, s, va);
  }
  for (int j = head + nvec * E + threadIdx.x; j < n; j += kThreads)
    add1(m, s, logit<kCap>(to_f(row[j]), p.cap, p.inv_cap, t));
  block_merge(m, s);
  if (threadIdx.x == 0) {
    const float lse = __fadd_rn(logf(s), m);
    const int y = p.labels[r] < 0 ? 0 : p.labels[r];
    const float ll = y < n ? logit<kCap>(to_f(row[y]), p.cap, p.inv_cap, t)
                           : (y < p.V ? -FLT_MAX : __int_as_float(0x7fc00000));
    p.lse_out[r] = lse;
    p.nll[r] = __fsub_rn(lse, ll);
  }
}

// dh[j] of a row from h's value x at column j
template <bool kCap>
__device__ __forceinline__ float grad(const Head& p, int j, float x,
                                      float lse, float g, int y) {
  if (j >= p.n) return 0.0f;
  float t = 0.0f;
  const float l = logit<kCap>(x, p.cap, p.inv_cap, t);
  float d = __fmul_rn(g, expf(__fsub_rn(l, lse)));
  if (j == y) d = __fsub_rn(d, g);
  if (kCap)
    d = __fmul_rn(__fmul_rn(__fmul_rn(d, p.cap), fmaf(-t, t, 1.0f)),
                  p.inv_cap);
  return d;
}

// The backward: block r writes row r of dh.  kVec: h's and dh's rows start
// at the same offset from the 16-byte grid, so both take vectors after the
// same peel; else one element at a time.
template <typename T, bool kCap, bool kVec>
__global__ void __launch_bounds__(kThreads) ce_bwd(Head p) {
  constexpr int E = kVecBytes / sizeof(T);
  const long long r = blockIdx.x;
  const T* row = static_cast<const T*>(p.h) + r * p.V;
  T* out = static_cast<T*>(p.dh) + r * p.V;
  const float lse = p.lse[r], g = p.g[r];
  const int y = p.labels[r] < 0 ? 0 : p.labels[r];
  const int V = p.V;
  const int head = kVec ? peel(row, V) : V;
  for (int j = threadIdx.x; j < head; j += kThreads)
    out[j] = from_f<T>(grad<kCap>(p, j, to_f(row[j]), lse, g, y));
  if (!kVec) return;
  const int nvec = (V - head) / E;
  const Vec<T, E>* body = reinterpret_cast<const Vec<T, E>*>(row + head);
  Vec<T, E>* obody = reinterpret_cast<Vec<T, E>*>(out + head);
  int i = threadIdx.x;
  for (; i + kThreads < nvec; i += 2 * kThreads) {
    const Vec<T, E> a = body[i], b = body[i + kThreads];
    Vec<T, E> oa, ob;
    const int ja = head + i * E, jb = ja + kThreads * E;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      oa.v[k] = from_f<T>(grad<kCap>(p, ja + k, to_f(a.v[k]), lse, g, y));
      ob.v[k] = from_f<T>(grad<kCap>(p, jb + k, to_f(b.v[k]), lse, g, y));
    }
    obody[i] = oa;
    obody[i + kThreads] = ob;
  }
  if (i < nvec) {
    const Vec<T, E> a = body[i];
    Vec<T, E> oa;
    const int ja = head + i * E;
#pragma unroll
    for (int k = 0; k < E; ++k)
      oa.v[k] = from_f<T>(grad<kCap>(p, ja + k, to_f(a.v[k]), lse, g, y));
    obody[i] = oa;
  }
  for (int j = head + nvec * E + threadIdx.x; j < V; j += kThreads)
    out[j] = from_f<T>(grad<kCap>(p, j, to_f(row[j]), lse, g, y));
}

// rows a launch takes: a block a row, the grid's x at most 2^31 - 1
inline bool bad_shape(long long rows, int V, int n, int dtype) {
  return rows < 1 || rows > 2147483647LL || V < 1 || n < 1 || n > V
      || dtype < 0 || dtype > 1;
}

}  // namespace k6

#ifdef __CUDACC__
namespace k6 {

template <typename T>
static cudaError_t launch_fwd(const Head& p, long long rows,
                              cudaStream_t st) {
  if (p.cap != 0.0f)
    ce_fwd<T, true><<<(unsigned)rows, kThreads, 0, st>>>(p);
  else
    ce_fwd<T, false><<<(unsigned)rows, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kVec>
static cudaError_t launch_bwd(const Head& p, long long rows,
                              cudaStream_t st) {
  if (p.cap != 0.0f)
    ce_bwd<T, true, kVec><<<(unsigned)rows, kThreads, 0, st>>>(p);
  else
    ce_bwd<T, false, kVec><<<(unsigned)rows, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

static void set_cap(Head& p, float cap) {
  p.cap = cap;
  p.inv_cap = cap != 0.0f ? 1.0f / cap : 0.0f;
}

}  // namespace k6

// The forward.  h (rows, V) contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); labels (rows,) int32; lse and nll (rows,) float32, written.
// n: the columns kept, 1 <= n <= V; cap: the softcap, 0 for none.  Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int k6_ce_fwd(const void* h, const int* labels, float* lse,
                         float* nll, long long rows, int V, int n, int dtype,
                         float cap, void* stream) {
  if (k6::bad_shape(rows, V, n, dtype)) return (int)cudaErrorInvalidValue;
  k6::Head p = {};
  p.h = h; p.labels = labels; p.lse_out = lse; p.nll = nll;
  p.V = V; p.n = n;
  k6::set_cap(p, cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? k6::launch_fwd<__nv_bfloat16>(p, rows, st)
                          : k6::launch_fwd<float>(p, rows, st));
}

// The backward.  g: dnll (rows,) float32; h, labels, n, dtype and cap as in
// the forward; lse (rows,) the forward's; dh (rows, V) contiguous in h's
// type, written.  vec: 1 when h and dh start at the same offset from the
// 16-byte grid (then every row does), else 0.
extern "C" int k6_ce_bwd(const float* g, const void* h, const float* lse,
                         const int* labels, void* dh, long long rows, int V,
                         int n, int dtype, float cap, int vec, void* stream) {
  if (k6::bad_shape(rows, V, n, dtype)) return (int)cudaErrorInvalidValue;
  k6::Head p = {};
  p.h = h; p.labels = labels; p.lse = lse; p.g = g; p.dh = dh;
  p.V = V; p.n = n;
  k6::set_cap(p, cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)(vec ? k6::launch_bwd<__nv_bfloat16, true>(p, rows, st)
                     : k6::launch_bwd<__nv_bfloat16, false>(p, rows, st));
  return (int)(vec ? k6::launch_bwd<float, true>(p, rows, st)
                   : k6::launch_bwd<float, false>(p, rows, st));
}

extern "C" const char* k6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
