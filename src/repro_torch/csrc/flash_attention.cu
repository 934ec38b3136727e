// K2: flash attention forward on Hopper (sm_90a).
//
// Replaces the JAX reference's Pallas TPU kernel
// src/repro/kernels/flash_attention.py:25 (`_kernel`, launched by the
// `pallas_call` at :95): online-softmax attention over q and k (B, S, heads,
// D) and v (B, Skv, KV, Dv), with GQA (kv head h / (H/KV)), causal masking
// (qpos >= kpos), a sliding window (qpos - kpos < window), a tanh logit
// softcap and a scale (1/sqrt(D) by default).  The output (B, Sq, H, Dv) is
// in q's dtype; lse (B, Sq, H) fp32 (m + log l per row) is written too, for
// the backward.  Dv differs from D only in MLA (deepseek-v2: q/k 192 = 128
// nope + 64 rope dims, v 128), which the wgmma kernel takes as (192, 128).
// Head dim 112 (the JAX reference's simplified zamba2-7b, 3584 / 32) runs on
// the tiles of D = 128, and 224 (the published Zamba2-7B, 7168 / 32) on
// those of D = 256.
// Tensors are read in the JAX layout (B, S, H, D) through their strides,
// with D contiguous: nothing is transposed.
//
// Two kernels compute that function; the wrapper
// (kernels/flash_attention.py::variant_for) picks one by a fixed rule before
// any launch: bf16 with (D, Dv) in {(64, 64), (112, 112), (128, 128), (224,
// 224), (256, 256), (192, 128)} runs `flash_fwd_wgmma`, float32 and bf16
// with D = Dv in
// {16, 32} run `flash_fwd`.  A failed launch of either raises; nothing retries on the
// other.
//
// `flash_fwd_wgmma` (bf16, tensor cores).  One block of 3 warpgroups (384
// threads) per 128 q rows: (64 rows, 2 heads of one kv head, batch) when
// H/KV is even, so both heads share every K and V tile; else (128 rows,
// head, batch).  q tiles are launched last tile first, so the causal
// mask's longest blocks do not form the tail.
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec 24)
//   and one of its threads issues TMA loads (cp.async.bulk.tensor, 4-D
//   tensor maps over (D, heads, S, B) read through the tensors' strides)
//   of the Q tile once and of the K and V tiles of 64 kv rows into a ring
//   of 2 stages, with a full mbarrier per stage and operand and an empty
//   mbarrier per stage.  Only the kv tiles that hold an unmasked pair for
//   the block are loaded.  Rows past Sq or Skv arrive as zeros; masking
//   comes from positions only.
// - Warpgroups 1 and 2 are consumers of 64 q rows each (setmaxnreg.inc
//   240).  S = Q K^T is wgmma m64n64k16, both operands from shared memory,
//   K-major, D/16 k-steps (12 at MLA's D = 192).  The softmax runs on the
//   accumulator in registers: scale and softcap (tanh from ex2, accurate
//   to ~1e-7 absolute; tanh.approx's 2^-11 relative error would move p by
//   ~2% at scores near a cap of 50), the mask only on tiles that cross the
//   diagonal, the window's edge or kv_len, row max and row sum over the
//   accumulator's quad (2 shuffles, the sum only once at the end), exp2
//   with log2(e) folded into the scale.  P is rounded to bf16 in registers
//   and fed to wgmma as the A operand (the m64n64 accumulator fragment is
//   the k16 A fragment); O += P V is Dv/64 m64n64k16 per 16 kv rows, V from
//   shared memory MN-major (D contiguous, the transpose bit set).  The
//   stage is released after the P V wgmma has been waited on.
// - Shared memory holds the operands as TMA writes them with the 128-byte
//   swizzle: 64-column atoms (a 128-byte row of 64 bf16), so a Q, K or V
//   row of D = 256 is 4 atoms, each wgmma descriptor steps across them.
//   Q and K tiles have D/64 atoms, V tiles and the O accumulator Dv/64
//   (`WLayout<D, Dv>`).  At D = 256: Q 64 KB, K + V 2 stages x 64 KB:
//   192 KB (+1 KB to align); at MLA's (192, 128): Q 48 KB, K 2 x 24 KB,
//   V 2 x 16 KB: 128 KB.  Registers per consumer thread at D = 256: O 128
//   fp32, S 32, P 16; at (192, 128) O is 64.  MLA's V is not padded to 192:
//   that would add a copy and half again the P V work.
// - Head dim 112 runs `flash_fwd_wgmma<128, 128, kHeads, 112>`: the tensor
//   maps keep the real inner dimension (112), so the second 64-column box
//   of each Q, K and V row reads columns 64-127 and TMA fills 112-127 with
//   zeros (a box past the tensor's edge still delivers, and counts, all its
//   bytes, so the expect-tx counts stay the full tiles).  Zero columns add
//   nothing to Q K^T and give zero columns of P V, which the epilogue does
//   not store (they would land on the next head's output).  1/8 of the
//   tensor-core work is on those padding columns.  Head dim 224 runs
//   `flash_fwd_wgmma<256, 256, kHeads, 224>` the same way: the fourth box
//   reads columns 192-255, TMA fills 224-255 with zeros, and the epilogue
//   stores 224 columns (1/8 of the work on padding again).
// - Epilogue: O / max(l, 1e-30) to bf16 stored from registers, rows past
//   Sq and columns past the head dim skipped; lse = m + log(max(l, 1e-30)), or -1e30 for a row the mask
//   empties wholly, as the reference's kernel gives.
//
// `flash_fwd` (float32, and bf16 at D 16 and 32; the SIMT design).  One
// block of 256 threads per (q tile of 64 rows, head, batch); a loop inside
// the block over kv tiles of 32 rows carries the running (m, l, acc) of
// every row, where the TPU grid carried them in VMEM scratch from one grid
// step to the next.  Thread (ty, tx) = (tid / 8, tid % 8) owns rows ty and
// ty + 32: it computes their scores for kv columns tx + 8c (c < 4), keeps
// their m and l in registers (row max and row sum by shuffles across the
// 8 threads of a row), and accumulates their outputs for head-dim columns
// tx + 8n (n < D/8) in registers.  Q (once), K and V (per tile) are staged
// in shared memory in the input type; Q and K rows are padded by one
// 4-byte word so the score loop is free of bank conflicts.  P goes through
// shared memory for the P.V product.  kv tiles that the causal mask or the
// window masks wholly are skipped (the Pallas grid visits them).  fp32
// FMAs throughout (no tensor cores, no TF32, no fast math: expf, logf,
// tanhf), so fp32 inputs meet the reference's 2e-5; tensor cores would
// take fp32 only as TF32 (about 3 digits).  At D = 256 the block takes
// 137 KB of dynamic shared memory in fp32, hence cudaFuncSetAttribute.
//
// Bound on an H100 SXM: operations.  2 (D + Dv) FLOPs per unmasked (q, k)
// pair and head (the causal and window pairs counted, not Sq * Skv) at the
// dense tensor-core rate of the input type (989 TFLOP/s bf16), against
// bytes (q, k, v, out read or written once) at 3.35 TB/s; at the gemma2-2b
// shapes the FLOPs dominate by two orders of magnitude.  What still holds
// the wgmma kernel back from it: a consumer warpgroup does not overlap its
// softmax with its own next Q K^T (only the two consumers overlap each
// other), blocks are not persistent (each loads its Q and pays its
// prologue and epilogue in turn, and the causal blocks are unequal), and
// every wgmma is n64, so both consumers read each K tile from shared
// memory separately.  At MLA's shape H = KV (K and V are materialized per
// head), so every block runs one head and no K/V tile serves two heads.
//
// The Hopper building blocks (mbarriers, TMA, wgmma and its descriptors,
// tensor-map encoding) live in sm90.cuh, shared with K3.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>
#endif

#include "sm90.cuh"

namespace k2 {

using namespace sm90;

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

// ---------------------------------------------------------------------------
// flash_fwd_wgmma: bf16 on the tensor cores, fed by TMA (header above)

namespace k2 {

constexpr int kWRows = 128;       // q rows per block: 2 consumers x 64
constexpr int kWCols = 64;        // kv rows per tile
constexpr int kWStages = 2;       // depth of the K/V ring
constexpr int kWThreads = 384;    // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct WParams {
  void* o;
  float* lse;
  int Sq, H, KV;
  long long o_sb, o_ss, o_sh;
  int causal, window, q_offset, kv_len;
  float softcap, scale;
};

// Byte offsets in the block's shared memory, from a 1024-byte-aligned base
// (the 128-byte swizzle repeats every 8 rows = 1024 bytes, and wgmma's
// descriptors assume atoms that start on that period).  An operand tile is
// one atom per 64 columns, each `rows` x 128 bytes: Q and K tiles
// kQKAtoms (D / 64), V tiles kVAtoms (Dv / 64).
template <int D, int Dv> struct WLayout {
  static constexpr int kQKAtoms = D / kAtomCols;
  static constexpr int kVAtoms = Dv / kAtomCols;
  static constexpr int kQAtom = kWRows * kRowBytes;
  static constexpr int kKVAtom = kWCols * kRowBytes;
  static constexpr int kQBytes = kQKAtoms * kQAtom;
  static constexpr int kKTileBytes = kQKAtoms * kKVAtom;   // one K tile
  static constexpr int kVTileBytes = kVAtoms * kKVAtom;    // one V tile
  static constexpr int kQ0 = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kWStages * kKTileBytes;
  static constexpr int kBar = kV + kWStages * kVTileBytes;
  // q_full, k_full[kWStages], v_full[kWStages], empty[kWStages]
  static constexpr int kNumBars = 1 + 3 * kWStages;
  static constexpr int kBytes = kBar + 8 * kNumBars + 1024;   // + alignment
};

// kv tiles [jbeg, jend) holding an unmasked pair for q rows [q0, q0 + rows)
__device__ __forceinline__ void tile_range(const WParams& p, int q0,
                                           int rows, int& jbeg, int& jend) {
  const int qmin = p.q_offset + q0;
  const int qmax = p.q_offset + min(q0 + rows, p.Sq) - 1;
  int kend = p.kv_len;
  if (p.causal) kend = min(kend, qmax + 1);
  const int kbeg = p.window > 0 ? max(0, qmin - p.window + 1) : 0;
  jbeg = kbeg / kWCols;
  jend = (max(kend, 0) + kWCols - 1) / kWCols;
}

#ifdef __CUDACC__
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#endif  // __CUDACC__

// tanh(u) = 1 - 2 / (2^(2u log2 e) + 1): absolute error ~1e-7 over the
// whole range (2^x overflows to inf for large u, giving exactly 1)
__device__ __forceinline__ float tanh_acc(float u) {
  return 1.0f - __fdividef(2.0f, ex2(u * (2.0f * kLog2e)) + 1.0f);
}

// One consumer warpgroup (`c` = 0 or 1) of head h, q rows [q0, q0 + 64):
// the kv tiles [jbeg, jend) from the ring, then O and lse of its rows (the
// first kOutCols columns of O: the real head dim, Dv but at 112 and 224).  In
// the m64n64 fragment, thread t (warp w, lane l) holds rows 16w + l/4 (+8)
// and, for register i, column 8 (i / 4) + 2 (l % 4) + (i % 2) of row half
// (i / 2) % 2.
template <int D, int Dv, int kOutCols>
__device__ __forceinline__ void consume(const WParams& p,
                                        unsigned char* smem, uint64_t* bars,
                                        int c, int q0, int h, int b,
                                        int jbeg, int jend) {
  using L = WLayout<D, Dv>;
  constexpr int NA = L::kVAtoms;      // 64-column atoms of V and of O
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kWStages;
  uint64_t* empty = bars + 1 + 2 * kWStages;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = (t / 32) * 16 + lane / 4;   // and row + 8
  const int qlo = p.q_offset + q0;             // position of row 0
  const bool cap = p.softcap != 0.0f;
  // scores in log2 units: s scale log2(e), or cap log2(e) tanh(s scale / cap)
  const float kscale = cap ? p.scale / p.softcap : p.scale * kLog2e;
  const float cap2 = p.softcap * kLog2e;
  const uint32_t sq = smem_u32(smem + L::kQ0 + 64 * c * kRowBytes);

  float o[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  mbar_wait(q_full, 0);
  for (int j = jbeg, it = 0; j < jend; ++j, ++it) {
    const int s = it % kWStages;
    const uint32_t ph = (it / kWStages) & 1;
    const uint32_t sk = smem_u32(smem + L::kK + s * L::kKTileBytes);
    const uint32_t sv = smem_u32(smem + L::kV + s * L::kVTileBytes);

    // S = Q K^T: D/16 k-steps of 16 columns, 4 per 64-column atom
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    mbar_wait(k_full + s, ph);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<0, 0>(sc, make_desc(sq + (kk / 4) * L::kQAtom + col, 16, 1024),
               make_desc(sk + (kk / 4) * L::kKVAtom + col, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // scale, softcap and (on edge tiles only) the mask
    const int k0 = j * kWCols;
    const bool edge = (p.causal && k0 + kWCols - 1 > qlo)
                   || (p.window > 0 && qlo + 63 - k0 >= p.window)
                   || k0 + kWCols > p.kv_len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = cap ? cap2 * tanh_acc(sc[i] * kscale) : sc[i] * kscale;
      if (edge) {
        const int qpos = qlo + row + ((i >> 1) & 1) * 8;
        const int kpos = k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
        bool ok = kpos < p.kv_len;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        if (!ok) x = -INFINITY;
      }
      sc[i] = x;
    }

    // online softmax in log2 units; l stays a per-thread partial sum
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        mx = fmaxf(mx, fmaxf(sc[jj * 4 + 2 * r], sc[jj * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2(m[r] - mx);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = ex2(sc[jj * 4 + 2 * r + e] - mx);
          sc[jj * 4 + 2 * r + e] = pv;
          sum += pv;
        }
      l[r] = l[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] *= alpha[(i >> 1) & 1];

    // P = hi + lo, two bf16 parts (P's error 2^-18 relative, not bf16's
    // 2^-9: the reference keeps P in fp32).  Registers 8kk..8kk+7 (kv
    // columns 16kk..16kk+15) are the A fragment of k-step kk.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], hi[kk][e],
                   lo[kk][e]);

    // O += P V: per 16 kv rows, two n64 products (hi, lo) per 64-column
    // atom of V
    mbar_wait(v_full + s, ph);
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const uint64_t dv = make_desc(sv + a * L::kKVAtom
                                      + kk * 16 * kRowBytes, 1024, 1024);
        wgmma_rs(o[a], hi[kk], dv);
        wgmma_rs(o[a], lo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(o[a]);
    fence_regs(hi);
    fence_regs(lo);
    if (lane == 0) mbar_arrive(empty + s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int srow = q0 + row + 8 * r;
    if (srow >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.0f / lc;
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb
                      + srow * p.o_ss + h * p.o_sh + (lane & 3) * 2;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        if (a * kAtomCols + jj * 8 < kOutCols)   // a pair's 8-column group
          *reinterpret_cast<__nv_bfloat162*>(og + a * kAtomCols + jj * 8) =
              __floats2bfloat162_rn(o[a][jj * 4 + 2 * r] * inv,
                                    o[a][jj * 4 + 2 * r + 1] * inv);
    if ((lane & 3) == 0)
      p.lse[((long long)b * p.Sq + srow) * p.H + h] =
          (m[r] <= kNegInf ? kNegInf : m[r] * kLn2) + logf(lc);
  }
}

// kHeads q heads per block: 1 (the consumers take rows 0-63 and 64-127 of
// one head) or 2 (two heads of one kv head, 64 rows each, sharing every K
// and V tile).  Q's shared tile is 128 rows either way, consumer c's at row
// 64c.  kOutCols: the output columns stored (Dv, or 112 / 224 on 128- /
// 256-wide tiles).
template <int D, int Dv, int kHeads, int kOutCols>
__global__ void __launch_bounds__(kWThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const WParams p) {
  using L = WLayout<D, Dv>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  constexpr int kRows = kWRows / kHeads;                // q rows per head
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // last tile first
  const int h = blockIdx.y * kHeads;                    // first head
  const int b = blockIdx.z;
  int jbeg, jend;
  tile_range(p, q0, kRows, jbeg, jend);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);                                // q_full
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(bars + 1 + s, 1);                      // k_full
      mbar_init(bars + 1 + kWStages + s, 1);           // v_full
      mbar_init(bars + 1 + 2 * kWStages + s, kConsumerWarps);   // empty
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      const int kvh = h / (p.H / p.KV);
      mbar_expect_tx(bars, L::kQBytes);
      for (int a = 0; a < L::kQKAtoms; ++a)
        for (int hh = 0; hh < kHeads; ++hh)
          tma_load(smem + L::kQ0 + a * L::kQAtom + hh * kRows * kRowBytes,
                   &tm_q, bars, a * kAtomCols, h + hh, q0, b);
      for (int j = jbeg, it = 0; j < jend; ++j, ++it) {
        const int s = it % kWStages;
        uint64_t* k_full = bars + 1 + s;
        uint64_t* v_full = bars + 1 + kWStages + s;
        mbar_wait(bars + 1 + 2 * kWStages + s, ((it / kWStages) & 1) ^ 1);
        mbar_expect_tx(k_full, L::kKTileBytes);
        for (int a = 0; a < L::kQKAtoms; ++a)
          tma_load(smem + L::kK + s * L::kKTileBytes + a * L::kKVAtom, &tm_k,
                   k_full, a * kAtomCols, kvh, j * kWCols, b);
        mbar_expect_tx(v_full, L::kVTileBytes);
        for (int a = 0; a < L::kVAtoms; ++a)
          tma_load(smem + L::kV + s * L::kVTileBytes + a * L::kKVAtom, &tm_v,
                   v_full, a * kAtomCols, kvh, j * kWCols, b);
      }
    }
  } else {
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    consume<D, Dv, kOutCols>(p, smem, bars, c, kHeads == 1 ? q0 + 64 * c : q0,
                   kHeads == 1 ? h : h + c, b, jbeg, jend);
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

// the SIMT kernel's instantiations: float32 at every head dim, bf16 at the
// head dims the wgmma kernel does not take
template <typename T>
static cudaError_t dispatch(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
  }
  if constexpr (sizeof(T) == 4) {
    switch (D) {
      case 64: return launch<T, 64>(p, stream);
      case 112: return launch<T, 112>(p, stream);
      case 128: return launch<T, 128>(p, stream);
      case 224: return launch<T, 224>(p, stream);
      case 256: return launch<T, 256>(p, stream);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
static long long simt_smem(int D) {
  switch (D) {
    case 16: return smem_bytes<T, 16>();
    case 32: return smem_bytes<T, 32>();
  }
  if constexpr (sizeof(T) == 4) {
    switch (D) {
      case 64: return smem_bytes<T, 64>();
      case 112: return smem_bytes<T, 112>();
      case 128: return smem_bytes<T, 128>();
      case 224: return smem_bytes<T, 224>();
      case 256: return smem_bytes<T, 256>();
    }
  }
  return 0;
}

template <int D, int Dv, int kHeads, int kOutCols>
static cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                const CUtensorMap& tv, const WParams& p,
                                int B, cudaStream_t stream) {
  constexpr int smem = WLayout<D, Dv>::kBytes;
  constexpr int rows = kWRows / kHeads;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, Dv, kHeads, kOutCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + rows - 1) / rows, p.H / kHeads, B);
  flash_fwd_wgmma<D, Dv, kHeads, kOutCols><<<grid, kWThreads, smem, stream>>>(
      tq, tk, tv, p);
  return cudaGetLastError();
}

// tiles of (D, Dv); the output's first kOutCols columns are stored
template <int D, int Dv, int kOutCols = Dv>
static cudaError_t launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                const CUtensorMap& tv, const WParams& p,
                                int B, int heads_per_block,
                                cudaStream_t stream) {
  return heads_per_block == 2
             ? launch_wgmma<D, Dv, 2, kOutCols>(tq, tk, tv, p, B, stream)
             : launch_wgmma<D, Dv, 1, kOutCols>(tq, tk, tv, p, B, stream);
}

// the (D, Dv) pairs of the wgmma kernel
static bool wgmma_pair(int D, int Dv) {
  return (D == Dv && (D == 64 || D == 112 || D == 128 || D == 224
                      || D == 256))
      || (D == 192 && Dv == 128);
}

}  // namespace k2

// The SIMT kernel `flash_fwd`.  dtype: 0 = float32, 1 = bfloat16 (D 16 and
// 32 only).  Strides are in elements; the last dimension of every tensor
// has stride 1.  Returns cudaGetLastError() of the launch (0 on success).
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

// The wgmma kernel `flash_fwd_wgmma`: bf16 q/k/v with (D, Dv) in {(64, 64),
// (112, 112), (128, 128), (224, 224), (256, 256), (192, 128)}; D is the
// head dim of q and k, Dv
// that of v and the output.  q/k/v strides (elements) are those the TMA
// descriptors read by: 16-byte multiples, with a 16-byte-aligned base (the
// wrapper checks both).  Returns 0, a cudaError_t of the launch, or minus
// the CUresult of a failed tensor-map encoding.
extern "C" int k2_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int B, int Sq, int Skv, int H, int KV, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float softcap, float scale, int q_offset,
    int kv_len, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || KV <= 0 || H % KV != 0
      || !k2::wgmma_pair(D, Dv))
    return (int)cudaErrorInvalidValue;
  // two q heads per block when they share a kv head (H / KV even), so
  // each K and V tile serves both; else 128 rows of one head
  const int heads_per_block = (H / KV) % 2 == 0 ? 2 : 1;
  CUtensorMap tq, tk, tv;
  int r = sm90::make_map(&tq, q, D, H, Sq, B, q_sh, q_ss, q_sb,
                       k2::kWRows / heads_per_block);
  if (r == 0)
    r = sm90::make_map(&tk, k, D, KV, Skv, B, k_sh, k_ss, k_sb, k2::kWCols);
  if (r == 0)
    r = sm90::make_map(&tv, v, Dv, KV, Skv, B, v_sh, v_ss, v_sb, k2::kWCols);
  if (r != 0) return r;
  k2::WParams p;
  p.o = o; p.lse = lse; p.Sq = Sq; p.H = H; p.KV = KV;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.kv_len = kv_len; p.softcap = softcap; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hpb = heads_per_block;
  cudaError_t err =
      D == 64 ? k2::launch_wgmma<64, 64>(tq, tk, tv, p, B, hpb, st)
      : D == 112 ? k2::launch_wgmma<128, 128, 112>(tq, tk, tv, p, B, hpb, st)
      : D == 128 ? k2::launch_wgmma<128, 128>(tq, tk, tv, p, B, hpb, st)
      : D == 192 ? k2::launch_wgmma<192, 128>(tq, tk, tv, p, B, hpb, st)
      : D == 224 ? k2::launch_wgmma<256, 256, 224>(tq, tk, tv, p, B, hpb, st)
                 : k2::launch_wgmma<256, 256>(tq, tk, tv, p, B, hpb, st);
  return (int)err;
}

// dynamic shared memory of one block of the kernel that runs (dtype, D,
// Dv), in bytes (0 for an unsupported case)
extern "C" long long k2_smem_bytes(int dtype, int D, int Dv) {
  if (dtype == 1 && D == 192 && Dv == 128)
    return k2::WLayout<192, 128>::kBytes;
  if (D != Dv) return 0;
  if (dtype == 0) return k2::simt_smem<float>(D);
  if (dtype != 1) return 0;
  switch (D) {
    case 64: return k2::WLayout<64, 64>::kBytes;
    case 112:   // on the tiles of 128
    case 128: return k2::WLayout<128, 128>::kBytes;
    case 224:   // on the tiles of 256
    case 256: return k2::WLayout<256, 256>::kBytes;
  }
  return k2::simt_smem<__nv_bfloat16>(D);
}

extern "C" const char* k2_error_string(int code) {
  return sm90::error_string(code);
}
#endif  // __CUDACC__
