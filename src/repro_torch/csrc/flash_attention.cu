// K2: flash attention forward on Hopper (sm_90a).
//
// Replaces the JAX reference's Pallas TPU kernel
// src/repro/kernels/flash_attention.py:25 (`_kernel`, launched by the
// `pallas_call` at :95): online-softmax attention over q (B, Sq, H, D) and
// k/v (B, Skv, KV, D), with GQA (kv head h / (H/KV)), causal masking
// (qpos >= kpos), a sliding window (qpos - kpos < window), a tanh logit
// softcap and a scale (1/sqrt(D) by default).  The output is in q's dtype;
// lse (B, Sq, H) fp32 (m + log l per row) is written too, for the backward.
// Tensors are read in the JAX layout (B, S, H, D) through their strides,
// with D contiguous: nothing is transposed.
//
// Design.  One block of 256 threads per (q tile of 64 rows, head, batch);
// a loop inside the block over kv tiles of 32 rows carries the running
// (m, l, acc) of every row, where the TPU grid carried them in VMEM
// scratch from one grid step to the next.  Thread (ty, tx) = (tid / 8,
// tid % 8) owns rows ty and ty + 32: it computes their scores for kv
// columns tx + 8c (c < 4), keeps their m and l in registers (row max and
// row sum by shuffles across the 8 threads of a row), and accumulates
// their outputs for head-dim columns tx + 8n (n < D/8) in registers, so
// the BQ x D fp32 accumulator (64 KB at D = 256) never touches shared
// memory.  Q (once), K and V (per tile) are staged in shared memory in
// the input type; Q and K rows are padded by one 4-byte word so the score
// loop is free of bank conflicts.  P goes through shared memory for the
// P.V product.  kv tiles that the causal mask or the window masks
// wholly are skipped (the Pallas grid visits them).  At D = 256 the block
// takes 74 KB of dynamic shared memory in bf16 and 137 KB in fp32, above
// the 48 KB default, hence cudaFuncSetAttribute.
//
// Arithmetic: fp32 FMAs throughout (no tensor cores, no TF32, no fast
// math: expf, logf, tanhf), so fp32 inputs meet the reference's 2e-5.
// Fully masked rows keep l = 0 and are clamped to 1e-30 as `_kernel`
// :70 does.
//
// Bound on an H100 SXM: operations.  4 * D FLOPs per unmasked (q, k)
// pair and head (the causal and window pairs counted, not Sq * Skv) at
// the dense bf16 tensor-core rate of 989 TFLOP/s, against bytes (q, k,
// v, out read or written once) at 3.35 TB/s; at the gemma2-2b shapes the
// FLOPs dominate by two orders of magnitude.  This first kernel runs on
// the CUDA cores (67 TFLOP/s fp32 peak), and its score loop reads shared
// memory once per 1.3 FMAs, so it stays far from that bound: wgmma/TMA
// tiles are the next step.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

namespace k2 {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // kv rows per tile
constexpr int kThreads = 256;    // 32 row groups x 8 column groups
constexpr float kNegInf = -1.0e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Skv, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset, kv_len;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 4-byte word: the row padding of Q and K
template <typename T> struct Pad {
  static constexpr int value = 4 / sizeof(T);
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)(kBQ + kBK) * (D + Pad<T>::value) * sizeof(T)
       + (size_t)kBK * D * sizeof(T)
       + (size_t)kBQ * (kBK + 1) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int QS = D + Pad<T>::value;   // row stride of sQ and sK
  constexpr int PS = kBK + 1;             // row stride of sP
  constexpr int NC = D / 8;               // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBQ * QS;
  T* sV = sK + kBK * QS;
  float* sP = reinterpret_cast<float*>(sV + kBK * D);

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const T zero = from_f<T>(0.0f);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    sQ[r * QS + d] = s < p.Sq ? qg[s * p.q_ss + d] : zero;
  }

  // kv tiles holding at least one unmasked pair for this q tile
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + kBQ, p.Sq) - 1;
  int kend = p.kv_len;
  if (p.causal) kend = min(kend, qmax + 1);
  const int kbeg = p.window > 0 ? max(0, qmin - p.window + 1) : 0;
  const int jbeg = kbeg / kBK;
  const int jend = (max(kend, 0) + kBK - 1) / kBK;

  const int rows[2] = {ty, ty + 32};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float acc[2][NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[0][n] = acc[1][n] = 0.0f;

  for (int j = jbeg; j < jend; ++j) {
    const int k0 = j * kBK;
    __syncthreads();   // the last tile's readers are done (and sQ is full)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int s = k0 + c;
      const bool in = s < p.Skv;
      sK[c * QS + d] = in ? kg[s * p.k_ss + d] : zero;
      sV[c * D + d] = in ? vg[s * p.v_ss + d] : zero;
    }
    __syncthreads();

    float sc[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[0][c] = sc[1][c] = 0.0f;
    const T* qa = sQ + rows[0] * QS;
    const T* qb = sQ + rows[1] * QS;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a0 = to_f(qa[d]);
      const float a1 = to_f(qb[d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kk = to_f(sK[(tx + 8 * c) * QS + d]);
        sc[0][c] = fmaf(a0, kk, sc[0][c]);
        sc[1][c] = fmaf(a1, kk, sc[1][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = p.q_offset + q0 + rows[r];
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 8 * c;
        bool valid = kpos < p.kv_len;
        if (p.causal) valid = valid && qpos >= kpos;
        if (p.window > 0) valid = valid && (qpos - kpos) < p.window;
        float x = sc[r][c] * p.scale;
        if (p.softcap != 0.0f) x = tanhf(x / p.softcap) * p.softcap;
        x = valid ? x : kNegInf;
        sc[r][c] = x;
        ok[c] = valid;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pc = ok[c] ? expf(sc[r][c] - m_new) : 0.0f;
        sP[rows[r] * PS + tx + 8 * c] = pc;
        sum += pc;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      const float p0 = sP[rows[0] * PS + c];
      const float p1 = sP[rows[1] * PS + c];
      const T* vr = sV + c * D + tx;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vv = to_f(vr[8 * n]);
        acc[0][n] = fmaf(p0, vv, acc[0][n]);
        acc[1][n] = fmaf(p1, vv, acc[1][n]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + rows[r];
    if (s >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* og = static_cast<T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < NC; ++n) og[tx + 8 * n] = from_f<T>(acc[r][n] / lc);
    if (tx == 0) p.lse[((long long)b * p.Sq + s) * p.H + h] = m[r] + logf(lc);
  }
}

}  // namespace k2

#ifdef __CUDACC__
namespace k2 {

template <typename T, int D>
static cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k2

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor has stride 1.  Returns cudaGetLastError() of
// the launch (0 on success).
extern "C" int k2_flash_attention(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int Sq, int Skv, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, int q_offset,
    int kv_len, int dtype, void* stream) {
  k2::Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.kv_len = kv_len; p.softcap = softcap; p.scale = scale;
  if (B <= 0 || Sq <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? k2::dispatch<__nv_bfloat16>(p, D, st)
                  : dtype == 0 ? k2::dispatch<float>(p, D, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// dynamic shared memory of one block, in bytes (0 for an unsupported case)
extern "C" long long k2_smem_bytes(int dtype, int D) {
  if (dtype == 0) {
    switch (D) {
      case 16: return k2::smem_bytes<float, 16>();
      case 32: return k2::smem_bytes<float, 32>();
      case 64: return k2::smem_bytes<float, 64>();
      case 128: return k2::smem_bytes<float, 128>();
      case 256: return k2::smem_bytes<float, 256>();
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return k2::smem_bytes<__nv_bfloat16, 16>();
      case 32: return k2::smem_bytes<__nv_bfloat16, 32>();
      case 64: return k2::smem_bytes<__nv_bfloat16, 64>();
      case 128: return k2::smem_bytes<__nv_bfloat16, 128>();
      case 256: return k2::smem_bytes<__nv_bfloat16, 256>();
    }
  }
  return 0;
}

extern "C" const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
#endif  // __CUDACC__
