// K3: the Mamba2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces the JAX reference's Pallas TPU kernel
// src/repro/kernels/ssd_scan.py:25 (`_kernel`, launched by the
// `pallas_call` at :79, wrapper `ssd_scan` :63).  Over x (B, S, H, P),
// dt (B, S, H) f32 (post-softplus), A (H,) f32 (negative) and B/C
// (B, S, G, N), with head h reading group h / (H/G), in chunks of Q rows
// with an (N, P) f32 state carried across chunks and zero at the start:
//
//   cum   = cumsum(dt * A)                             per chunk, f32
//   y     = (C B^T * L) x + (C state) * exp(cum)       L[t,s] = exp(cum_t -
//                                                      cum_s) dt_s, t >= s
//   state = exp(cum[Q-1]) state + (B * w)^T x          w = exp(cum[Q-1] -
//                                                      cum) dt
//
// f32 inside, y in x's type.  Tensors are read in the JAX layout through
// their strides (last dim contiguous): the transposes the Pallas wrapper
// makes (ssd_scan.py:73-76, :94) are not needed.
//
// Design.  The Pallas grid (B, H, NC) runs its chunk axis in order and
// keeps the state in VMEM scratch.  Hopper blocks run in no order, so one
// block owns a (batch, head, slice of P) and loops over the chunks itself,
// carrying its slice of the state in shared memory.  The P columns of the
// state are independent (y[:, p] needs only state[:, p] and x[:, p]), so a
// block may own PS of them, at the cost of recomputing C B^T for each
// slice.  The wrapper takes the widest slice dividing P: at mamba2-2.7b's
// batch-1 layer all 64 columns, 80 blocks for 132 SMs with 131 KB of
// shared memory each (two slices of 32, 160 blocks of 107 KB, measured
// slower: the recomputed C B^T costs more than the idle SMs).  A whole
// Q = 256 chunk of B and C does not fit 227 KB in f32, so each chunk is
// walked in 64-row tiles: for every t tile, C's tile (transposed, padded
// by one word against bank conflicts) stays while the
// s tiles at or below the diagonal stream B and x through; the 64 x 64
// score tile is a 4 x 4 register tile per thread, then masked and decayed
// into shared memory, then multiplied into x by a RI x 4 register tile of
// y per thread.  After the t tiles, the state update streams B (scaled by
// w) and x once more.  The cumsum of dt * A is a block scan in f32
// (Kogge-Stone over warp shuffles).  exp is taken only where t >= s, so
// an upper-triangle difference never overflows and inf * 0 never appears.
//
// Arithmetic: f32 FMAs on the CUDA cores (no tensor cores, TF32 or fast
// math: expf), so f32 inputs meet the reference's 2e-5.
//
// Bound on an H100 SXM: bytes.  At mamba2-2.7b's layer (x (1, 2048, 80,
// 64), B/C (1, 2048, 1, 128), bf16, Q = 256) x, dt, B and C are read once
// and y written once: 43.6 MB, 0.013 ms at 3.35 TB/s.  The operations the
// function needs are fewer: C B^T once per (batch, group, chunk) and its
// product with x per head, each over the Q (Q + 1) / 2 pairs t >= s, and
// 4 Q N P per (head, chunk) for C times the state and the state update:
// 8.1 GFLOP, 0.008 ms at 989 TFLOP/s in bf16.  This first kernel runs on
// the CUDA cores (67 TFLOP/s fp32 peak), recomputes C B^T for every head
// (about 43% of its FMAs at that layer, where G = 1) and its score loop
// reads shared memory once per two FMAs, so it stays far from that bound;
// a C B^T shared by the heads of a group and wgmma tiles are the next step.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

namespace k3 {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of a t tile and of an s tile
constexpr int kPad = kTile + 1;    // padded row of a transposed tile
constexpr int kMaxQ = 1024;        // 4 scan values a thread at most
constexpr long long kMaxSmem = 232448;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  int B, S, H, P, G, N, Q;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// floats of shared memory: C and B tiles (transposed), x tile, score tile,
// state slice, cum and dt of the chunk, 32 words of scan scratch
__host__ __device__ inline long long smem_floats(int N, int Q, int PS) {
  return 2LL * N * kPad + (long long)kTile * PS + (long long)kTile * kPad
         + (long long)N * PS + 2LL * Q + 32;
}

// Inclusive cumsum of dt * A over the chunk's Q rows into cum; dt into dts.
// Thread i holds rows [i K, i K + K), K = ceil(Q / 256) <= 4.
__device__ __forceinline__ void chunk_cumsum(const float* dtp, long long ds,
                                             int c0, int Q, float Ah,
                                             float* cum, float* dts,
                                             float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = (Q + kThreads - 1) / kThreads;
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * K + k;
    if (k < K && i < Q) {
      const float d = dtp[(long long)(c0 + i) * ds];
      dts[i] = d;
      run += d * Ah;
    }
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < kThreads / 32) red[lane] = v;
  }
  __syncthreads();
  const float off = (warp ? red[warp - 1] : 0.f) + incl - run;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid * K + k;
    if (k < K && i < Q) cum[i] = off + loc[k];
  }
  __syncthreads();
}

// rows [r0, r0 + 64) of a (rows, N) operand, transposed into dst[n][row];
// rows at or past `valid` are zero; row r is scaled by scale[r] if given
template <typename T>
__device__ __forceinline__ void load_t(const T* src, long long rs, int r0,
                                       int valid, int N, const float* scale,
                                       float* dst) {
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    float v = 0.f;
    if (r < valid) {
      v = to_f(src[(long long)(r0 + r) * rs + n]);
      if (scale) v *= scale[r];
    }
    dst[n * kPad + r] = v;
  }
}

// rows [r0, r0 + 64) of x's P slice into dst[row][p]
template <typename T, int PS>
__device__ __forceinline__ void load_x(const T* src, long long rs, int r0,
                                       int valid, float* dst) {
  for (int i = threadIdx.x; i < kTile * PS; i += kThreads) {
    const int r = i / PS, q = i - r * PS;
    dst[i] = r < valid ? to_f(src[(long long)(r0 + r) * rs + q]) : 0.f;
  }
}

template <typename T, int PS>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd(Params p) {
  extern __shared__ __align__(16) float smem[];
  // y / state mapping: CG column groups of 4 columns, RG row groups
  constexpr int CG = PS / 4, RG = kThreads / CG, RI = kTile / RG;
  const int N = p.N, Q = p.Q;
  float* cs = smem;                  // C tile, [n][t]
  float* bs = cs + N * kPad;         // B tile, [n][s]
  float* xs = bs + N * kPad;         // x tile, [s][p]
  float* ss = xs + kTile * PS;       // scores, [t][s]
  float* st = ss + kTile * kPad;     // state slice, [n][p]
  float* cum = st + N * PS;
  float* dts = cum + Q;
  float* red = dts + Q;

  const int tid = threadIdx.x;
  const int nsplit = p.P / PS;
  const int bh = blockIdx.x / nsplit;
  const int b = bh / p.H, h = bh - b * p.H;
  const int p0 = (blockIdx.x - bh * nsplit) * PS;
  const int g = h / (p.H / p.G);
  const float Ah = p.A[h];
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + p0;
  const T* Bp = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const T* Cp = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + p0;
  const float* dtp = p.dt + (long long)b * p.S * p.H + h;

  const int sy = tid / 16, sx = tid % 16;      // score tile: 4 x 4 each
  const int ry = tid / CG, rx = tid % CG;      // y tile: RI x 4 each

  for (int i = tid; i < N * PS; i += kThreads) st[i] = 0.f;

  const int nc = p.S / Q;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    __syncthreads();
    chunk_cumsum(dtp, p.H, c0, Q, Ah, cum, dts, red);

    for (int t0 = 0; t0 < Q; t0 += kTile) {
      const int tn = min(kTile, Q - t0);
      load_t(Cp, p.c_ss, c0 + t0, tn, N, nullptr, cs);
      __syncthreads();
      // the state the previous chunks left: exp(cum_t) * C[t] . state
      float acc[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RI], sv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) cv[i] = cs[n * kPad + ry + RG * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[n * PS + rx + CG * j];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j],
                                                       acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int tl = ry + RG * i;
        const float e = tl < tn ? expf(cum[t0 + tl]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      // s tiles at or below the diagonal
      for (int s0 = 0; s0 < t0 + tn; s0 += kTile) {
        const int sn = min(kTile, Q - s0);
        load_t(Bp, p.b_ss, c0 + s0, sn, N, nullptr, bs);
        load_x<T, PS>(x + (long long)c0 * p.x_ss, p.x_ss, s0, sn, xs);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = cs[n * kPad + sy + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bs[n * kPad + sx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j],
                                                        sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = sy + 16 * i, t = t0 + tl;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sl = sx + 16 * j, s = s0 + sl;
            float v = 0.f;
            if (tl < tn && sl < sn && t >= s)
              v = sc[i][j] * expf(cum[t] - cum[s]) * dts[s];
            ss[tl * kPad + sl] = v;
          }
        }
        __syncthreads();
        for (int s = 0; s < sn; ++s) {
          float sv[RI], xv[4];
#pragma unroll
          for (int i = 0; i < RI; ++i) sv[i] = ss[(ry + RG * i) * kPad + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[s * PS + rx + CG * j];
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j],
                                                         acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int tl = ry + RG * i;
        if (tl < tn) {
          T* row = y + (long long)(c0 + t0 + tl) * p.y_ss;
#pragma unroll
          for (int j = 0; j < 4; ++j) row[rx + CG * j] = from_f<T>(acc[i][j]);
        }
      }
    }

    // state update: st = exp(cum[Q-1]) st + sum_s (B[s] w[s]) x[s]
    const float last = cum[Q - 1];
    const float decay = expf(last);
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = expf(last - cum[i]) * dts[i];          // dts becomes w
    for (int n = ry; n < N; n += RG)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[n * PS + rx + CG * j] *= decay;
    __syncthreads();
    for (int s0 = 0; s0 < Q; s0 += kTile) {
      const int sn = min(kTile, Q - s0);
      load_t(Bp, p.b_ss, c0 + s0, sn, N, dts + s0, bs);
      load_x<T, PS>(x + (long long)c0 * p.x_ss, p.x_ss, s0, sn, xs);
      __syncthreads();
      for (int n = ry; n < N; n += RG) {
        float a4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < sn; ++s) {
          const float bv = bs[n * kPad + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) a4[j] = fmaf(bv, xs[s * PS + rx + CG * j],
                                                   a4[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) st[n * PS + rx + CG * j] += a4[j];
      }
      __syncthreads();
    }
  }
}

}  // namespace k3

#ifdef __CUDACC__
namespace k3 {

template <typename T, int PS>
static cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long smem = smem_floats(p.N, p.Q, PS) * 4;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H * (p.P / PS));
  ssd_fwd<T, PS><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(const Params& p, int PS, cudaStream_t stream) {
  switch (PS) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k3

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and A are float32
// and contiguous.  Strides are in elements; the last dimension of x, B, C
// and y has stride 1.  PS is the width of the P slice one block owns.
// Returns cudaGetLastError() of the launch (0 on success).
extern "C" int k3_ssd_scan(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, void* y, int B, int S, int H, int P, int G, int N,
    int Q, long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, long long y_sb, long long y_ss, long long y_sh, int PS,
    int dtype, void* stream) {
  k3::Params p;
  p.x = x; p.dt = dt; p.A = A; p.Bm = Bm; p.Cm = Cm; p.y = y;
  p.B = B; p.S = S; p.H = H; p.P = P; p.G = G; p.N = N; p.Q = Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_ss = c_ss; p.c_sg = c_sg;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0
      || Q <= 0 || Q > k3::kMaxQ || S % Q != 0 || PS <= 0 || P % PS != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? k3::dispatch<__nv_bfloat16>(p, PS, st)
                  : dtype == 0 ? k3::dispatch<float>(p, PS, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// dynamic shared memory of one block, in bytes
extern "C" long long k3_smem_bytes(int N, int Q, int PS) {
  return k3::smem_floats(N, Q, PS) * 4;
}

extern "C" const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
