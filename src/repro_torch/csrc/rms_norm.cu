// K4: the RMS norm, plain and with mamba2's skip and gate, on Hopper.
//
// Replaces no TPU kernel: the JAX reference leaves its norms to XLA, which
// fuses them.  Run as composed PyTorch ops, each norm keeps float32 copies
// of its rows for autograd (the f32 input and x * rstd), which at
// mamba2-2.7b's widths is about 180 MB a layer of saved activations.  This
// kernel keeps them out of device memory: the forward saves nothing but
// one f32 rstd a row, and the backward recomputes the normalised row in
// registers from the bf16 inputs the autograd function saved.
//
// Over rows of n columns (a row stride each, last dim contiguous), with w
// the scale (n,) and T the activation type (f32 or bf16):
//
//   plain:  v = x
//   gated:  u = T(y + xs * D[j / P]),  s = T(silu(z)),  v = T(u * s)
//           (y is K3's output, xs the scan's input, D f32 per head of P
//           columns: the tail of models/ssm.py::apply_mamba2)
//   rstd = rsqrt(mean(v^2) + eps),     out = T((v * rstd) * w)
//
// The gated variant may take the norm per group of n / G columns (Zamba2's
// grouped gated norm, a group per SSM group): one rstd a row and group,
// stored at row * G + group, and the mean over the group's columns.  G = 1
// is the norm over the whole row: the same blocks, loops and arithmetic as
// the kernel had before groups, so the same bits.
//
// Each T() is a rounding the composed ops make; the forward makes the same
// ones, unfused (__fmul_rn / __fadd_rn), so it matches them up to the
// order of the row's sum.  The backward works in f32 and rounds each
// gradient once:
//
//   vh = v rstd,  gw = g w,  c = mean(gw vh),  dv = rstd (gw - vh c)
//   dw = sum over rows of g vh
//   plain: dx = dv
//   gated: du = dv s, dz = dv u sig(z) (1 + z (1 - sig(z))),
//          dy = du, dxs = du D, dD = sum over rows and the head's columns
//          of du xs
//
// The column sums are deterministic: each backward block owns a fixed set
// of rows and accumulates its columns in shared memory, writes them to an
// f32 scratch (one row of partials a block, allocated by the wrapper), and
// a second pass sums the partials over blocks in a fixed order.  No
// atomics.
//
// Bound on an H100 SXM: bytes (no operation the function needs is a
// product; it counts none).  At mamba2-2.7b's gated layer (2048 rows of
// 5120 bf16) the forward reads y, xs, z and writes the output: 84 MB,
// 25 us at 3.35 TB/s; the plain forward at d_model 2560 reads and writes
// 21 MB, 6.3 us.  Design: one block per row in the forward (the row is
// staged in shared memory as f32 between the sum and the store); in the
// backward a grid of at most `backward_blocks` blocks walking rows, each
// row read twice (the second pass hits L1/L2) so that nothing but the
// column partials is staged.  Loads and stores are 16 bytes a thread when
// every row start is 16-byte aligned and n a multiple of the vector.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

namespace k4 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxSmem = 232448;
constexpr long long kDefaultSmem = 49152;
// most f32 partials one column sum keeps (8 MB, so they stay in L2)
constexpr long long kPartialFloats = 1 << 21;
constexpr int kMaxBlocks = 1024;
// the column sums' block: 32 columns, each summed by 16 warps
constexpr int kSumCols = 32;
constexpr int kSumWarps = 16;

struct Fwd {
  const void* x;   // plain: x; gated: y
  const void* xs;  // gated only
  const float* D;  // gated only
  const void* z;   // gated only
  const void* w;
  void* out;       // (M, n), contiguous
  float* rstd;     // (M,)
  long long M;
  int n, P, G;     // G: norm groups of n / G columns
  long long sx, sxs, sz;  // row strides, in elements
  float eps;
};

struct Bwd {
  const void* g;   // (M, n), contiguous
  const void* x;
  const void* xs;
  const float* D;
  const void* z;
  const void* w;
  const float* rstd;
  void* dx;        // plain: dx; gated: dy; (M, n), contiguous
  void* dxs;       // gated only, (M, n), contiguous
  void* dz;        // gated only, (M, n), contiguous
  float* part_w;   // (blocks, n)
  float* part_d;   // gated only, (blocks, n)
  float* col_d;    // gated only, (n,): the column sums of part_d
  long long M;
  int n, P, G;
  long long sx, sxs, sz;
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

template <typename X, int N> struct alignas(sizeof(X) * N) Chunk {
  X v[N];
};

// V elements at p (aligned to min(16, V sizeof(X)) bytes) as f32, in
// loads of at most 16 bytes
template <typename X, int V>
__device__ __forceinline__ void load(const X* p, float (&f)[V]) {
  constexpr int kBytes = (int)sizeof(X) * V;
  constexpr int kPer = (kBytes >= 16 ? 16 : kBytes) / (int)sizeof(X);
#pragma unroll
  for (int c = 0; c < V / kPer; ++c) {
    const Chunk<X, kPer> ch =
        *reinterpret_cast<const Chunk<X, kPer>*>(p + c * kPer);
#pragma unroll
    for (int i = 0; i < kPer; ++i) f[c * kPer + i] = to_f(ch.v[i]);
  }
}

template <typename X, int V>
__device__ __forceinline__ void store(X* p, const float (&f)[V]) {
  constexpr int kBytes = (int)sizeof(X) * V;
  constexpr int kPer = (kBytes >= 16 ? 16 : kBytes) / (int)sizeof(X);
#pragma unroll
  for (int c = 0; c < V / kPer; ++c) {
    Chunk<X, kPer> ch;
#pragma unroll
    for (int i = 0; i < kPer; ++i) ch.v[i] = from_f<X>(f[c * kPer + i]);
    *reinterpret_cast<Chunk<X, kPer>*>(p + c * kPer) = ch;
  }
}

// torch's silu on the card, x / (1 + exp(-x)) in f32, given e = exp(-x)
__device__ __forceinline__ float silu(float z, float e) {
  return __fdiv_rn(z, __fadd_rn(1.0f, e));
}

// the block's sum of v, the same in every thread; the order is fixed
// (a warp's butterfly, then the warps' sums in order)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  __syncthreads();
  return t;
}

// the V values of v = (x) or (T(u * s)) at vector vi of a row, with u, s,
// z, exp(-z) and xs; the V columns of a vector lie in one head (the wrapper
// takes the vector only where it divides P)
template <typename T, int V, bool kGated>
__device__ __forceinline__ void row_values(
    const T* x, const T* xs, const float* D, const T* z, int vi, int P,
    float (&v)[V], float (&u)[V], float (&s)[V], float (&zf)[V],
    float (&ez)[V], float (&xsf)[V]) {
  load<T, V>(x + (long long)vi * V, v);
  if constexpr (kGated) {
    load<T, V>(xs + (long long)vi * V, xsf);
    load<T, V>(z + (long long)vi * V, zf);
    const float d = D[vi * V / P];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ez[i] = expf(-zf[i]);
      u[i] = round_to<T>(__fadd_rn(v[i], __fmul_rn(xsf[i], d)));
      s[i] = round_to<T>(silu(zf[i], ez[i]));
      v[i] = round_to<T>(__fmul_rn(u[i], s[i]));
    }
  }
}

// one block a row and group (block b: row b / G, group b % G); dynamic
// shared memory: n floats (the group's columns, element i of its vector vi
// at i * nv + vi - v0) and kWarps floats
template <typename T, typename W, int V, bool kGated>
__global__ void __launch_bounds__(kThreads) rms_fwd(Fwd p) {
  extern __shared__ float smem[];
  const int ng = p.n / p.G;             // the group's columns
  const int nv = ng / V;                // and vectors
  const int v0 = (blockIdx.x % p.G) * nv;   // its first vector in the row
  float* red = smem + p.n;
  const long long row = blockIdx.x / p.G;
  const T* x = static_cast<const T*>(p.x) + row * p.sx;
  const T* xs = kGated ? static_cast<const T*>(p.xs) + row * p.sxs : nullptr;
  const T* z = kGated ? static_cast<const T*>(p.z) + row * p.sz : nullptr;
  float ss = 0.0f;
  for (int vi = v0 + threadIdx.x; vi < v0 + nv; vi += kThreads) {
    float v[V], u[V], s[V], zf[V], ez[V], xsf[V];
    row_values<T, V, kGated>(x, xs, p.D, z, vi, p.P, v, u, s, zf, ez, xsf);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      smem[i * nv + vi - v0] = v[i];
      ss = fmaf(v[i], v[i], ss);
    }
  }
  const float tot = block_sum(ss, red);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(tot, 1.0f / (float)ng), p.eps));
  if (threadIdx.x == 0) p.rstd[blockIdx.x] = r;
  const W* w = static_cast<const W*>(p.w);
  T* out = static_cast<T*>(p.out) + row * p.n;
  for (int vi = v0 + threadIdx.x; vi < v0 + nv; vi += kThreads) {
    float wf[V], o[V];
    load<W, V>(w + (long long)vi * V, wf);
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = __fmul_rn(__fmul_rn(smem[i * nv + vi - v0], r), wf[i]);
    store<T, V>(out + (long long)vi * V, o);
  }
}

// gridDim.x blocks, block b walks rows b, b + gridDim.x, ...; dynamic
// shared memory: the block's column sums of g vh (n floats) and, gated,
// of du xs (n floats), laid out as the forward's row, then kWarps floats
template <typename T, typename W, int V, bool kGated>
__global__ void __launch_bounds__(kThreads) rms_bwd(Bwd p) {
  extern __shared__ float smem[];
  const int nv = p.n / V;
  float* acc_w = smem;
  float* acc_d = smem + p.n;
  float* red = smem + (kGated ? 2 : 1) * p.n;
  for (int vi = threadIdx.x; vi < nv; vi += kThreads)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc_w[i * nv + vi] = 0.0f;
      if constexpr (kGated) acc_d[i * nv + vi] = 0.0f;
    }
  const W* w = static_cast<const W*>(p.w);
  const int ngv = nv / p.G;             // vectors of a norm group
  const float inv_n = 1.0f / (float)(p.n / p.G);
  for (long long row = blockIdx.x; row < p.M; row += gridDim.x) {
    const T* x = static_cast<const T*>(p.x) + row * p.sx;
    const T* xs =
        kGated ? static_cast<const T*>(p.xs) + row * p.sxs : nullptr;
    const T* z = kGated ? static_cast<const T*>(p.z) + row * p.sz : nullptr;
    const T* g = static_cast<const T*>(p.g) + row * p.n;
    for (int grp = 0; grp < p.G; ++grp) {
      const int v0 = grp * ngv;
      const float r = p.rstd[row * p.G + grp];
      float dot = 0.0f;
      for (int vi = v0 + threadIdx.x; vi < v0 + ngv; vi += kThreads) {
        float v[V], u[V], s[V], zf[V], ez[V], xsf[V], gf[V], wf[V];
        row_values<T, V, kGated>(x, xs, p.D, z, vi, p.P, v, u, s, zf, ez,
                                 xsf);
        load<T, V>(g + (long long)vi * V, gf);
        load<W, V>(w + (long long)vi * V, wf);
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(gf[i] * wf[i], v[i] * r, dot);
      }
      const float c = block_sum(dot, red) * inv_n;
      for (int vi = v0 + threadIdx.x; vi < v0 + ngv; vi += kThreads) {
        float v[V], u[V], s[V], zf[V], ez[V], xsf[V], gf[V], wf[V], d0[V];
        row_values<T, V, kGated>(x, xs, p.D, z, vi, p.P, v, u, s, zf, ez,
                                 xsf);
        load<T, V>(g + (long long)vi * V, gf);
        load<W, V>(w + (long long)vi * V, wf);
        const float d = kGated ? p.D[vi * V / p.P] : 0.0f;
        float d1[V], d2[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float vh = v[i] * r;
          const float dv = r * (gf[i] * wf[i] - vh * c);
          acc_w[i * nv + vi] += gf[i] * vh;
          if constexpr (kGated) {
            const float du = dv * s[i];
            const float sig = __frcp_rn(1.0f + ez[i]);
            d0[i] = du;
            d1[i] = du * d;
            d2[i] = dv * u[i] * sig * (1.0f + zf[i] * (1.0f - sig));
            acc_d[i * nv + vi] += du * xsf[i];
          } else {
            d0[i] = dv;
          }
        }
        const long long off = row * p.n + (long long)vi * V;
        store<T, V>(static_cast<T*>(p.dx) + off, d0);
        if constexpr (kGated) {
          store<T, V>(static_cast<T*>(p.dxs) + off, d1);
          store<T, V>(static_cast<T*>(p.dz) + off, d2);
        }
      }
    }
  }
  // with groups another thread may own a column's sums than the one that
  // writes them out below
  __syncthreads();
  const long long base = (long long)blockIdx.x * p.n;
  for (int vi = threadIdx.x; vi < nv; vi += kThreads)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p.part_w[base + vi * V + i] = acc_w[i * nv + vi];
      if constexpr (kGated) p.part_d[base + vi * V + i] = acc_d[i * nv + vi];
    }
}

// out[j] = the sum over the blocks' partials of column j: a block of
// kSumCols columns x kSumWarps warps, warp w summing the partials of blocks
// w, w + kSumWarps, ..., then the warps' sums added in order; dynamic
// shared memory: kSumWarps x kSumCols floats
template <typename W>
__global__ void __launch_bounds__(kSumCols * kSumWarps) col_sum(
    const float* part, int blocks, int n, W* out) {
  extern __shared__ float red[];
  const int lane = threadIdx.x % kSumCols, warp = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + lane;
  float t = 0.0f;
  if (j < n)
    for (int b = warp; b < blocks; b += kSumWarps)
      t += part[(long long)b * n + j];
  red[warp * kSumCols + lane] = t;
  __syncthreads();
  if (warp == 0 && j < n) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) total += red[w * kSumCols + lane];
    out[j] = from_f<W>(total);
  }
}

// one block a head: out[h] = the sum of its P columns' sums; dynamic
// shared memory: kWarps floats
__global__ void __launch_bounds__(kThreads) head_sum(
    const float* col, int P, float* out) {
  extern __shared__ float red[];
  const int h = blockIdx.x;
  float t = 0.0f;
  for (int j = threadIdx.x; j < P; j += kThreads) t += col[h * P + j];
  t = block_sum(t, red);
  if (threadIdx.x == 0) out[h] = t;
}

// the number of blocks of the backward pass over M rows of n columns: a
// function of the shape alone, so that the column sums are the same bits
// from run to run
inline int backward_blocks(long long M, int n) {
  long long b = kPartialFloats / (n > 0 ? n : 1);
  if (b > kMaxBlocks) b = kMaxBlocks;
  if (b > M) b = M;
  return (int)(b < 1 ? 1 : b);
}

inline long long fwd_smem(int n) { return ((long long)n + kWarps) * 4; }
inline long long bwd_smem(int n, bool gated) {
  return ((gated ? 2LL : 1LL) * n + kWarps) * 4;
}

}  // namespace k4

#ifdef __CUDACC__
namespace k4 {

template <typename K>
static cudaError_t allow_smem(K kernel, long long smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename W, int V, bool kGated>
static cudaError_t launch_fwd(const Fwd& p, cudaStream_t st) {
  const long long smem = fwd_smem(p.n);
  cudaError_t err = allow_smem(rms_fwd<T, W, V, kGated>, smem);
  if (err != cudaSuccess) return err;
  rms_fwd<T, W, V, kGated><<<(unsigned)(p.M * p.G), kThreads, smem, st>>>(
      p);
  return cudaGetLastError();
}

template <typename T, typename W, int V, bool kGated>
static cudaError_t launch_bwd(const Bwd& p, void* dw, float* dD, int H,
                              cudaStream_t st) {
  const long long smem = bwd_smem(p.n, kGated);
  cudaError_t err = allow_smem(rms_bwd<T, W, V, kGated>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = backward_blocks(p.M, p.n);
  rms_bwd<T, W, V, kGated><<<blocks, kThreads, smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int grid = (p.n + kSumCols - 1) / kSumCols;
  const int sum_smem = kSumCols * kSumWarps * 4;
  col_sum<W><<<grid, kSumCols * kSumWarps, sum_smem, st>>>(
      p.part_w, blocks, p.n, static_cast<W*>(dw));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (kGated) {
    col_sum<float><<<grid, kSumCols * kSumWarps, sum_smem, st>>>(
        p.part_d, blocks, p.n, p.col_d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    head_sum<<<H, kThreads, kWarps * 4, st>>>(p.col_d, p.P, dD);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// T: 0 f32, 1 bf16; W likewise; vec: the full vector (16 bytes of T) or 1
template <bool kGated>
static cudaError_t dispatch_fwd(const Fwd& p, int t, int w, int vec,
                                cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool full = vec > 1;
  if (t == 1 && w == 1)
    return full ? launch_fwd<bf, bf, 8, kGated>(p, st)
                : launch_fwd<bf, bf, 1, kGated>(p, st);
  if (t == 1 && w == 0)
    return full ? launch_fwd<bf, float, 8, kGated>(p, st)
                : launch_fwd<bf, float, 1, kGated>(p, st);
  if (t == 0 && w == 1)
    return full ? launch_fwd<float, bf, 4, kGated>(p, st)
                : launch_fwd<float, bf, 1, kGated>(p, st);
  if (t == 0 && w == 0)
    return full ? launch_fwd<float, float, 4, kGated>(p, st)
                : launch_fwd<float, float, 1, kGated>(p, st);
  return cudaErrorInvalidValue;
}

template <bool kGated>
static cudaError_t dispatch_bwd(const Bwd& p, void* dw, float* dD, int H,
                                int t, int w, int vec, cudaStream_t st) {
  using bf = __nv_bfloat16;
  const bool full = vec > 1;
  if (t == 1 && w == 1)
    return full ? launch_bwd<bf, bf, 8, kGated>(p, dw, dD, H, st)
                : launch_bwd<bf, bf, 1, kGated>(p, dw, dD, H, st);
  if (t == 1 && w == 0)
    return full ? launch_bwd<bf, float, 8, kGated>(p, dw, dD, H, st)
                : launch_bwd<bf, float, 1, kGated>(p, dw, dD, H, st);
  if (t == 0 && w == 1)
    return full ? launch_bwd<float, bf, 4, kGated>(p, dw, dD, H, st)
                : launch_bwd<float, bf, 1, kGated>(p, dw, dD, H, st);
  if (t == 0 && w == 0)
    return full ? launch_bwd<float, float, 4, kGated>(p, dw, dD, H, st)
                : launch_bwd<float, float, 1, kGated>(p, dw, dD, H, st);
  return cudaErrorInvalidValue;
}

static bool bad_shape(long long M, int n, int H, int G, int gated, int vec,
                      int t) {
  const int full = t == 1 ? 8 : 4;
  return M <= 0 || n <= 0 || (gated && (H <= 0 || n % H != 0
                                        || (n / H) % vec != 0))
      || G < 1 || (G > 1 && !gated) || n % G != 0 || (n / G) % vec != 0
      || M * G >= (1LL << 31)
      || !(vec == 1 || vec == full) || n % vec != 0;
}

}  // namespace k4

// The forward.  x: the plain variant's input, or the gated variant's y;
// xs, D, z: the gated variant's (null for plain); w: the scale; out
// (M, n) contiguous; rstd (M,) f32.  Row strides in elements.  t_dtype /
// w_dtype: 0 float32, 1 bfloat16.  vec: 1, or 8 (bf16) / 4 (f32) when
// every row start is 16-byte aligned (and, gated, the vector divides
// P = n / H).  H: heads of D (gated).  G: norm groups of n / G columns
// (gated; 1 for the plain variant), rstd (M, G).  Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int k4_rms_fwd(
    const void* x, const void* xs, const float* D, const void* z,
    const void* w, void* out, float* rstd, long long M, int n, int H, int G,
    long long sx, long long sxs, long long sz, float eps, int t_dtype,
    int w_dtype, int vec, int gated, void* stream) {
  if (k4::bad_shape(M, n, H, G, gated, vec, t_dtype)
      || k4::fwd_smem(n) > k4::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  k4::Fwd p;
  p.x = x; p.xs = xs; p.D = D; p.z = z; p.w = w; p.out = out;
  p.rstd = rstd; p.M = M; p.n = n; p.P = gated ? n / H : n; p.G = G;
  p.sx = sx; p.sxs = sxs; p.sz = sz; p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(gated ? k4::dispatch_fwd<true>(p, t_dtype, w_dtype, vec, st)
                     : k4::dispatch_fwd<false>(p, t_dtype, w_dtype, vec,
                                               st));
}

// The backward.  g (M, n) contiguous; x, xs, D, z, w as in the forward;
// rstd the forward's (M, G).  dx (the gated variant's dy), dxs, dz: (M, n)
// contiguous in T; dw (n,) in W's type; dD (H,) f32; part: f32 scratch of
// k4_scratch_floats(M, n, gated) floats.
extern "C" int k4_rms_bwd(
    const void* g, const void* x, const void* xs, const float* D,
    const void* z, const void* w, const float* rstd, void* dx, void* dxs,
    void* dz, void* dw, float* dD, float* part, long long M, int n, int H,
    int G, long long sx, long long sxs, long long sz, int t_dtype,
    int w_dtype, int vec, int gated, void* stream) {
  if (k4::bad_shape(M, n, H, G, gated, vec, t_dtype)
      || k4::bwd_smem(n, gated) > k4::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  k4::Bwd p;
  p.g = g; p.x = x; p.xs = xs; p.D = D; p.z = z; p.w = w; p.rstd = rstd;
  p.dx = dx; p.dxs = dxs; p.dz = dz; p.part_w = part;
  p.part_d = part + (long long)k4::backward_blocks(M, n) * n;
  p.col_d = p.part_d + (long long)k4::backward_blocks(M, n) * n;
  p.M = M; p.n = n; p.P = gated ? n / H : n; p.G = G;
  p.sx = sx; p.sxs = sxs; p.sz = sz;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(gated
      ? k4::dispatch_bwd<true>(p, dw, dD, H, t_dtype, w_dtype, vec, st)
      : k4::dispatch_bwd<false>(p, dw, dD, H, t_dtype, w_dtype, vec, st));
}

// the backward's f32 scratch: a row of column partials a block (two,
// gated) and, gated, the column sums of D's partials
extern "C" long long k4_scratch_floats(long long M, int n, int gated) {
  return ((gated ? 2LL : 1LL) * k4::backward_blocks(M, n) + (gated ? 1 : 0))
      * n;
}

extern "C" const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
