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
// makes (ssd_scan.py:73-76, :94) are not needed.  exp is taken only where
// t >= s (and of cum differences that are <= 0), so an upper-triangle
// difference never overflows and inf * 0 never appears.
//
// Two variants compute that function; the wrapper
// (kernels/ssd_scan.py::variant_for) picks one by a fixed rule before any
// launch: bf16 x/B/C with P in {64, 128}, N a multiple of 64 up to 256 and
// Q a multiple of 64 up to 256 run `wgmma`; everything else (f32 at any
// shape, the reduced test shapes) runs `simt`.  A failed launch of either
// raises; nothing retries on the other.
//
// `wgmma` (bf16, tensor cores): the Pallas grid's sequential chunk axis is
// split the way the Mamba-2 paper's GPU kernels split it (arXiv:2405.21060
// §6-7): only an elementwise pass runs in chunk order; every product runs
// in parallel over (batch, head, chunk), on wgmma m64n64k16 tiles fed by
// TMA (the Hopper pieces in sm90.cuh).  Four kernels in one stream, each
// named ssd_fwd_*; the wrapper allocates their scratch:
// 1. ssd_fwd_state, one block per (batch, head, chunk, 64-column P slice),
//    one warpgroup per 64 rows of N: cum by a warp scan (written to a
//    (B, H, S) f32 scratch for pass 4), w = exp(cum_last - cum) dt, and the
//    chunk's state contribution Sc = B^T (w x) (N, 64) f32 into a
//    (B, H, nc, N, P) scratch.  B arrives by TMA and is read M-major as the
//    A operand (transpose-A bit); w x is f32, so the threads rewrite x's TMA
//    tile in place as its bf16 hi half and a second tile as its lo half
//    (hi + lo carries f32 to ~2^-17), both read N-major: two products.
// 2. ssd_fwd_pass, the only sequential pass: per (batch, head, 4 state
//    elements), over the chunks, prev_c = run; run = exp(cum_last_c) run +
//    Sc_c, prev_c written over Sc_c.  Elementwise, no tensor work.
// 3. ssd_fwd_cb: CB = C B^T once per (batch, group, chunk) and 64 x 64 tile
//    pair at or below the diagonal (not per head), both operands K-major
//    like K2's Q K^T, into an f32 scratch in the accumulator fragment's
//    order (pass 4 reads each thread's 32 values back as 8 float4).
// 4. ssd_fwd_scan, one block per (batch, head, chunk, P slice) with one
//    consumer warpgroup per 64-row t tile: acc = C_t prev_c (C by TMA,
//    K-major; prev_c split hi + lo into N-major shared tiles), rows scaled
//    by exp(cum_t); then for every s tile at or below the diagonal, acc +=
//    (CB_ts * L_ts) x_s with the scores built in registers and fed as the
//    register A operand in hi + lo halves (K2's P V path), x_s N-major from
//    a TMA tile.  Every C and x tile of the chunk is loaded once, each on
//    its own mbarrier, so a warpgroup starts as soon as its tiles are in.
//    y is stored as bf16 from the accumulator.
//
// `simt` (f32, and bf16 outside the wgmma shapes; kernel ssd_fwd): the
// Pallas grid (B, H, NC) runs its chunk axis in order and keeps the state
// in VMEM scratch.  Hopper blocks run in no order, so one block owns a
// (batch, head, slice of P) and loops over the chunks itself, carrying its
// slice of the state in shared memory.  The P columns of the state are
// independent (y[:, p] needs only state[:, p] and x[:, p]), so a block may
// own PS of them, at the cost of recomputing C B^T for each slice; the
// wrapper takes the widest slice dividing P.  A whole Q = 256 chunk of B
// and C does not fit 227 KB in f32, so each chunk is walked in 64-row
// tiles: for every t tile, C's tile (transposed, padded by one word
// against bank conflicts) stays while the s tiles at or below the diagonal
// stream B and x through; the 64 x 64 score tile is a 4 x 4 register tile
// per thread, then masked and decayed into shared memory, then multiplied
// into x by a RI x 4 register tile of y per thread.  After the t tiles,
// the state update streams B (scaled by w) and x once more.  The cumsum of
// dt * A is a block scan in f32 (Kogge-Stone over warp shuffles).  f32
// FMAs on the CUDA cores (no tensor cores, TF32 or fast math: expf), so
// f32 inputs meet the reference's 2e-5.
//
// Bound on an H100 SXM: bytes.  At mamba2-2.7b's layer (x (1, 2048, 80,
// 64), B/C (1, 2048, 1, 128), bf16, Q = 256) x, dt, B and C are read once
// and y written once: 43.6 MB, 0.013 ms at 3.35 TB/s.  The operations the
// function needs are fewer: C B^T once per (batch, group, chunk) and its
// product with x per head, each over the Q (Q + 1) / 2 pairs t >= s, and
// 4 Q N P per (head, chunk) for C times the state and the state update:
// 8.1 GFLOP, 0.008 ms at 989 TFLOP/s in bf16.  The wgmma variant moves
// more than the bound counts: the f32 state scratch is written by pass 1,
// read and written by pass 2 and read by pass 4 (4 x 21 MB at that layer),
// and the hi + lo halves double its tensor work; that traffic, not the
// tensor cores, is what keeps it off the bound.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// the wgmma variant: ssd_fwd_state, ssd_fwd_pass, ssd_fwd_cb, ssd_fwd_scan

namespace k3 {

using namespace sm90;

constexpr int kW = 64;                        // rows of a t/s/N tile, P slice
constexpr int kTileBytes = kW * kRowBytes;    // one 64 x 64 bf16 tile: 8 KB
constexpr int kFrag = kW * kW;                // floats of one CB tile
constexpr int kWMaxThreads = 512;             // 4 warpgroups (N or Q 256)
constexpr int kPassThreads = 256;

struct WParams {
  const float* dt;     // (B, S, H), contiguous
  const float* A;      // (H,)
  void* y;             // (B, S, H, P) bf16
  float* cum;          // scratch (B, H, S): cumsum(dt * A) per chunk
  float* states;       // scratch (B, H, nc, N, P): Sc, then prev
  float* cb;           // scratch (B, G, nc, T (T + 1) / 2, 64 * 64): C B^T
  int B, S, H, P, G, N, Q;
  long long y_sb, y_ss, y_sh;
};

// shared-memory bytes (after 1024-byte alignment) of passes 1, 3 and 4
__host__ __device__ inline int state_smem(int N, int Q) {
  return Q * N * 2 + 2 * Q * kRowBytes + 8 * Q + 16;
}
__host__ __device__ inline int cb_smem(int N) {
  return 2 * N * kRowBytes + 8;
}
// pass 4 with `tpb` t tiles a block
__host__ __device__ inline int scan_smem(int N, int Q, int tpb) {
  return tpb * kW * N * 2 + Q * kRowBytes + 2 * N * kRowBytes + 8 * Q
         + 8 * (tpb + Q / kW);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Inclusive cumsum of dt * A over the chunk's Q rows (Q a multiple of 32,
// at most 256) into cum, dt into dts; warp 0 only, lane i holding rows
// [i K, i K + K), K = Q / 32.
__device__ __forceinline__ void warp_cumsum(const float* dtp, long long ds,
                                            int Q, float Ah, float* cum,
                                            float* dts) {
  const int lane = threadIdx.x & 31;
  const int K = Q / 32;
  float loc[8];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < K) {
      const float d = dtp[(long long)(lane * K + k) * ds];
      dts[lane * K + k] = d;
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
  const float off = incl - run;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < K) cum[lane * K + k] = off + loc[k];
}

// the m64n64 fragment of thread t of a warpgroup (warp w, lane l): register
// i is row 16w + l/4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l % 4) +
// (i & 1)
__device__ __forceinline__ int frag_row(int t, int i) {
  return (t / 32) * 16 + (t % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t % 4) + (i & 1);
}

// Pass 1.  grid (B * nc * H, P / 64), 128 * N / 64 threads; blockIdx.x =
// h + H (c + nc b) so that the heads of one chunk, which read the same B
// rows, run side by side.
__global__ void __launch_bounds__(kWMaxThreads, 1)
ssd_fwd_state(const __grid_constant__ CUtensorMap tm_b,
              const __grid_constant__ CUtensorMap tm_x, const WParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int Q = p.Q, N = p.N, nt = Q / kW, nc = p.S / Q;
  const int h = blockIdx.x % p.H;
  const int c = (blockIdx.x / p.H) % nc;
  const int b = blockIdx.x / (p.H * nc);
  const int ps = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int c0 = c * Q;
  const int tid = threadIdx.x;
  unsigned char* sB = smem;                      // N/64 atoms of Q rows
  unsigned char* sX = sB + Q * N * 2;            // x, then hi(w x)
  unsigned char* sLo = sX + Q * kRowBytes;       // lo(w x)
  float* sCum = reinterpret_cast<float*>(sLo + Q * kRowBytes);
  float* sW = sCum + Q;                          // dt, then w
  uint64_t* bars = reinterpret_cast<uint64_t*>(sW + Q);   // B, x

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bars + 1, Q * kRowBytes);
    for (int j = 0; j < nt; ++j)
      tma_load(sX + j * kTileBytes, &tm_x, bars + 1, ps * kW, h,
               c0 + j * kW, b);
    mbar_expect_tx(bars, Q * N * 2);
    for (int a = 0; a < N / kW; ++a)
      for (int j = 0; j < nt; ++j)
        tma_load(sB + a * Q * kRowBytes + j * kTileBytes, &tm_b, bars,
                 a * kW, g, c0 + j * kW, b);
  }
  if (tid < 32)
    warp_cumsum(p.dt + ((long long)b * p.S + c0) * p.H + h, p.H, Q, p.A[h],
                sCum, sW);
  __syncthreads();
  const float last = sCum[Q - 1];
  for (int i = tid; i < Q; i += blockDim.x) {
    sW[i] = expf(last - sCum[i]) * sW[i];
    if (ps == 0) p.cum[((long long)b * p.H + h) * p.S + c0 + i] = sCum[i];
  }
  __syncthreads();

  // w x as bf16 hi (over x, in place) + lo: a 16-byte chunk at byte
  // offset `off` holds 8 columns of row off / 128 (the swizzle only
  // permutes chunks within a row)
  mbar_wait(bars + 1, 0);
  for (int i = tid; i < Q * 8; i += blockDim.x) {
    const uint32_t off = i * 16;
    const float wv = sW[off >> 7];
    uint4 v = *reinterpret_cast<const uint4*>(sX + off);
    uint32_t* w32 = reinterpret_cast<uint32_t*>(&v);
    uint4 lo;
    uint32_t* l32 = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
          &w32[e]);
      split_bf16(wv * __bfloat162float(xv.x), wv * __bfloat162float(xv.y),
                 w32[e], l32[e]);
    }
    *reinterpret_cast<uint4*>(sX + off) = v;
    *reinterpret_cast<uint4*>(sLo + off) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  // warpgroup m: Sc rows [64 m, 64 m + 64) = B^T (rows of atom m, M-major)
  // times hi + lo (N-major), K = Q in k16 steps
  mbar_wait(bars, 0);
  const int m = tid / 128, t = tid % 128;
  const uint32_t aB = smem_u32(sB + m * Q * kRowBytes);
  const uint32_t aHi = smem_u32(sX), aLo = smem_u32(sLo);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
  for (int kk = 0; kk < Q / 16; ++kk) {
    const uint64_t da = make_desc(aB + kk * 16 * kRowBytes, 1024, 1024);
    wgmma_ss<1, 1>(acc, da, make_desc(aHi + kk * 16 * kRowBytes, 1024, 1024),
                   1);
    wgmma_ss<1, 1>(acc, da, make_desc(aLo + kk * 16 * kRowBytes, 1024, 1024),
                   1);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  float* out = p.states
      + ((((long long)b * p.H + h) * nc + c) * N + m * kW) * p.P + ps * kW;
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<float2*>(out + frag_row(t, i) * p.P + frag_col(t, i)) =
        make_float2(acc[i], acc[i + 1]);
}

// Pass 2.  One thread per 4 consecutive state elements of one (batch,
// head); the chunks in order, 4 loads in flight at a time.
__global__ void __launch_bounds__(kPassThreads)
ssd_fwd_pass(const WParams p) {
  const int NP4 = p.N * p.P / 4, nc = p.S / p.Q;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.B * p.H * NP4) return;
  const long long bh = idx / NP4;
  float4* st = reinterpret_cast<float4*>(p.states)
             + bh * nc * NP4 + (idx - bh * NP4);
  const float* last = p.cum + bh * p.S + p.Q - 1;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; c += 4) {
    float4 v[4];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < nc) {
        v[k] = st[(long long)(c + k) * NP4];
        d[k] = expf(last[(long long)(c + k) * p.Q]);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < nc) {
        st[(long long)(c + k) * NP4] = run;
        run = make_float4(fmaf(d[k], run.x, v[k].x), fmaf(d[k], run.y, v[k].y),
                          fmaf(d[k], run.z, v[k].z), fmaf(d[k], run.w, v[k].w));
      }
  }
}

// thread t's 32 values of a CB tile stored in fragment order (pass 3)
__device__ __forceinline__ void load_frag(const float4* src, float (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 f = src[k * 128];
    v[4 * k] = f.x;
    v[4 * k + 1] = f.y;
    v[4 * k + 2] = f.z;
    v[4 * k + 3] = f.w;
  }
}

// the (t, s) tiles of a chunk at or below the diagonal, row by row
__host__ __device__ inline int tile_pairs(int nt) { return nt * (nt + 1) / 2; }
__device__ __forceinline__ void pair_tiles(int pair, int& ti, int& si) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  si = pair - ti * (ti + 1) / 2;
}

// Pass 3.  grid (T (T + 1) / 2, nc, B G), one warpgroup: CB_ts = C_t B_s^T
// (64 x 64, K = N), both K-major, stored in fragment order: float4 k of
// thread t at (k * 128 + t) * 4.
__global__ void __launch_bounds__(128, 1)
ssd_fwd_cb(const __grid_constant__ CUtensorMap tm_c,
           const __grid_constant__ CUtensorMap tm_b, const WParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int N = p.N, nt = p.Q / kW, nc = p.S / p.Q;
  const int pair = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / p.G, g = blockIdx.z % p.G;
  int ti, si;
  pair_tiles(pair, ti, si);
  const int c0 = c * p.Q;
  unsigned char* sC = smem;
  unsigned char* sB = smem + N * kRowBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + N * kRowBytes);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, 2 * N * kRowBytes);
    for (int a = 0; a < N / kW; ++a) {
      tma_load(sC + a * kTileBytes, &tm_c, bar, a * kW, g, c0 + ti * kW, b);
      tma_load(sB + a * kTileBytes, &tm_b, bar, a * kW, g, c0 + si * kW, b);
    }
  }
  mbar_wait(bar, 0);
  const uint32_t aC = smem_u32(sC), aB = smem_u32(sB);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t col = (kk / 4) * kTileBytes + (kk % 4) * 32;
    wgmma_ss<0, 0>(acc, make_desc(aC + col, 16, 1024),
                   make_desc(aB + col, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  float4* out = reinterpret_cast<float4*>(
      p.cb + (((long long)blockIdx.z * nc + c) * tile_pairs(nt) + pair) * kFrag);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[k * 128 + t] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                                   acc[4 * k + 3]);
}

// Pass 4.  grid (B * nc * H, P / 64, T / tpb), 128 tpb threads: block z
// owns t tiles [z tpb, z tpb + tpb), warpgroup i the i-th of them (tpb = T
// unless the chunk's C tiles do not fit shared memory at once).
__global__ void __launch_bounds__(kWMaxThreads, 1)
ssd_fwd_scan(const __grid_constant__ CUtensorMap tm_c,
             const __grid_constant__ CUtensorMap tm_x, const WParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int Q = p.Q, N = p.N, NA = N / kW, nt = Q / kW, nc = p.S / Q;
  const int tpb = blockDim.x / 128;
  const int t_lo = blockIdx.z * tpb, t_end = t_lo + tpb;
  const int h = blockIdx.x % p.H;
  const int c = (blockIdx.x / p.H) % nc;
  const int b = blockIdx.x / (p.H * nc);
  const int ps = blockIdx.y;
  const int g = h / (p.H / p.G);
  const int c0 = c * Q;
  const int tid = threadIdx.x;
  unsigned char* sC = smem;                      // tpb tiles x NA atoms
  unsigned char* sX = sC + tpb * kW * N * 2;     // x tiles [0, t_end)
  unsigned char* sHi = sX + Q * kRowBytes;       // prev, N rows x 64 cols
  unsigned char* sLo = sHi + N * kRowBytes;
  float* sCum = reinterpret_cast<float*>(sLo + N * kRowBytes);
  float* sDt = sCum + Q;
  uint64_t* cbar = reinterpret_cast<uint64_t*>(sDt + Q);   // C tile i
  uint64_t* xbar = cbar + tpb;                             // x tile j

  if (tid == 0) {
    for (int i = 0; i < tpb + t_end; ++i) mbar_init(cbar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < t_end; ++j) {
      const int i = j - t_lo;
      if (i >= 0) {
        mbar_expect_tx(cbar + i, N * kRowBytes);
        for (int a = 0; a < NA; ++a)
          tma_load(sC + (i * NA + a) * kTileBytes, &tm_c, cbar + i, a * kW,
                   g, c0 + j * kW, b);
      }
      mbar_expect_tx(xbar + j, kTileBytes);
      tma_load(sX + j * kTileBytes, &tm_x, xbar + j, ps * kW, h, c0 + j * kW,
               b);
    }
  }
  const long long bh = (long long)b * p.H + h;
  for (int i = tid; i < Q; i += blockDim.x) {
    sCum[i] = p.cum[bh * p.S + c0 + i];
    sDt[i] = p.dt[((long long)b * p.S + c0 + i) * p.H + h];
  }
  // prev_c (N x 64 of the P slice, f32) as bf16 hi + lo, N-major tiles
  if (c > 0) {
    const float* prev = p.states + ((bh * nc + c) * N) * p.P + ps * kW;
    for (int i = tid; i < N * 16; i += blockDim.x) {
      const int n = i / 16, q = i % 16;
      const float4 v = *reinterpret_cast<const float4*>(prev + n * p.P
                                                        + 4 * q);
      uint2 hi, lo;
      split_bf16(v.x, v.y, hi.x, lo.x);
      split_bf16(v.z, v.w, hi.y, lo.y);
      const uint32_t off = swizzled(n * kRowBytes + q * 8);
      *reinterpret_cast<uint2*>(sHi + off) = hi;
      *reinterpret_cast<uint2*>(sLo + off) = lo;
    }
    fence_proxy_async();
  }
  __syncthreads();

  const int ti = t_lo + tid / 128, t = tid % 128;
  const int r0 = frag_row(t, 0);
  // this thread's CB fragments of row ti, tile si at cbp[si * 1024]
  const float4* cbp = reinterpret_cast<const float4*>(
      p.cb + (((long long)(b * p.G + g) * nc + c) * tile_pairs(nt)
              + ti * (ti + 1) / 2) * kFrag) + t;
  float sc[32];
  load_frag(cbp, sc);            // s tile 0, in flight during C prev
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint32_t aC = smem_u32(sC + (tid / 128) * NA * kTileBytes);
  mbar_wait(cbar + tid / 128, 0);
  if (c > 0) {
    // acc = C_t prev: C K-major (K = N), prev N-major, hi then lo
    const uint32_t aHi = smem_u32(sHi), aLo = smem_u32(sLo);
    fence_regs(acc);
    wgmma_fence();
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t da = make_desc(aC + (kk / 4) * kTileBytes
                                    + (kk % 4) * 32, 16, 1024);
      wgmma_ss<0, 1>(acc, da, make_desc(aHi + kk * 16 * kRowBytes, 1024,
                                        1024), 1);
      wgmma_ss<0, 1>(acc, da, make_desc(aLo + kk * 16 * kRowBytes, 1024,
                                        1024), 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    const float e0 = expf(sCum[ti * kW + r0]);
    const float e1 = expf(sCum[ti * kW + r0 + 8]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= (i >> 1) & 1 ? e1 : e0;
  }

  // acc += (CB_ts * L_ts) x_s over the s tiles at or below the diagonal;
  // sc holds CB_ts, and the next tile's loads overlap this tile's wgmma
  const float ct0 = sCum[ti * kW + r0], ct1 = sCum[ti * kW + r0 + 8];
  for (int si = 0; si <= ti; ++si) {
    const bool diag = si == ti;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int s = si * kW + frag_col(t, i);
      const int tl = r0 + 8 * ((i >> 1) & 1);
      const float ct = (i >> 1) & 1 ? ct1 : ct0;
      sc[i] = diag && frag_col(t, i) > tl
                  ? 0.f
                  : sc[i] * expf(ct - sCum[s]) * sDt[s];
    }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], hi[kk][e],
                   lo[kk][e]);
    if (!diag) load_frag(cbp + (si + 1) * (kFrag / 4), sc);
    mbar_wait(xbar + si, 0);
    const uint32_t aX = smem_u32(sX + si * kTileBytes);
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dx = make_desc(aX + kk * 16 * kRowBytes, 1024, 1024);
      wgmma_rs(acc, hi[kk], dx);
      wgmma_rs(acc, lo[kk], dx);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  }

  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y) + b * p.y_sb
                   + h * p.y_sh + ps * kW;
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(
        y + (long long)(c0 + ti * kW + frag_row(t, i)) * p.y_ss
        + frag_col(t, i)) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
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
  return sm90::error_string(code);
}
#endif  // __CUDACC__

#ifdef __CUDACC__
namespace k3 {

// t tiles per block of pass 4: the whole chunk unless its C tiles do not
// fit shared memory at once (N 256 with Q 256), then the largest divisor
// of T that fits
static int scan_tpb(int N, int Q) {
  const int nt = Q / kW;
  for (int tpb = nt; tpb > 1; --tpb)
    if (nt % tpb == 0 && scan_smem(N, Q, tpb) + 1024 <= kMaxSmem) return tpb;
  return 1;
}

static cudaError_t launch_wgmma(const CUtensorMap& tb, const CUtensorMap& tc,
                                const CUtensorMap& tx, const WParams& p,
                                cudaStream_t st) {
  const int nt = p.Q / kW, nc = p.S / p.Q, tpb = scan_tpb(p.N, p.Q);
  const int s1 = state_smem(p.N, p.Q) + 1024, s3 = cb_smem(p.N) + 1024;
  const int s4 = scan_smem(p.N, p.Q, tpb) + 1024;
  if (s1 > kMaxSmem || s4 > kMaxSmem) return cudaErrorInvalidValue;
  // raise each kernel's shared-memory limit on this device to the largest
  // size asked so far (once per size, not on every call: the host's
  // enqueue is on the step's path)
  constexpr int kDevices = 64;
  static int limit[kDevices][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  const void* fns[3] = {(const void*)ssd_fwd_state, (const void*)ssd_fwd_cb,
                        (const void*)ssd_fwd_scan};
  const int want[3] = {s1, s3, s4};
  for (int i = 0; i < 3 && err == cudaSuccess; ++i)
    if (want[i] > limit[dev][i]) {
      err = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, want[i]);
      if (err == cudaSuccess) limit[dev][i] = want[i];
    }
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * nc * p.H, p.P / kW);
  ssd_fwd_state<<<grid, 128 * (p.N / kW), s1, st>>>(tb, tx, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = (long long)p.B * p.H * p.N * p.P / 4;
  ssd_fwd_pass<<<(unsigned)((n4 + kPassThreads - 1) / kPassThreads),
                 kPassThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_fwd_cb<<<dim3(tile_pairs(nt), nc, p.B * p.G), 128, s3, st>>>(tc, tb,
                                                                    p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_fwd_scan<<<dim3(grid.x, grid.y, nt / tpb), 128 * tpb, s4, st>>>(
      tc, tx, p);
  return cudaGetLastError();
}

}  // namespace k3

// The wgmma variant: bf16 x/B/C with P in {64, 128}, N and Q multiples of
// 64 up to 256, S a multiple of Q.  x/B/C strides (elements) are those the
// TMA descriptors read by: 16-byte multiples, with a 16-byte-aligned base
// (the wrapper checks both).  cum (B, H, S), states (B, H, nc, N, P) and
// cb (B, G, nc, T (T + 1) / 2, 4096), T = Q / 64, are f32 scratch the
// caller allocates.  Returns 0, a cudaError_t of a launch, or minus the
// CUresult of a failed tensor-map encoding.
extern "C" int k3_ssd_scan_wgmma(
    const void* x, const float* dt, const float* A, const void* Bm,
    const void* Cm, void* y, float* cum, float* states, float* cb, int B,
    int S, int H, int P, int G, int N, int Q, long long x_sb, long long x_ss,
    long long x_sh, long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, long long y_sb,
    long long y_ss, long long y_sh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0
      || (P != 64 && P != 128) || N <= 0 || N % k3::kW != 0 || N > 256
      || Q <= 0 || Q % k3::kW != 0 || Q > 256 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tb, tc;
  int r = sm90::make_map(&tx, x, P, H, S, B, x_sh, x_ss, x_sb, k3::kW);
  if (r == 0)
    r = sm90::make_map(&tb, Bm, N, G, S, B, b_sg, b_ss, b_sb, k3::kW);
  if (r == 0)
    r = sm90::make_map(&tc, Cm, N, G, S, B, c_sg, c_ss, c_sb, k3::kW);
  if (r != 0) return r;
  k3::WParams p;
  p.dt = dt; p.A = A; p.y = y; p.cum = cum; p.states = states; p.cb = cb;
  p.B = B; p.S = S; p.H = H; p.P = P; p.G = G; p.N = N; p.Q = Q;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  return (int)k3::launch_wgmma(tb, tc, tx, p,
                               static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of one block of each wgmma pass (state, cb, scan),
// in bytes, into out[0..2]
extern "C" void k3_wgmma_smem_bytes(int N, int Q, long long* out) {
  out[0] = k3::state_smem(N, Q) + 1024;
  out[1] = k3::cb_smem(N) + 1024;
  out[2] = k3::scan_smem(N, Q, k3::scan_tpb(N, Q)) + 1024;
}
#endif  // __CUDACC__
