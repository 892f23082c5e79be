// Flash attention backward for Hopper (sm_90a): non-causal, causal and
// sliding-window masks, grouped-query attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_bwd and its TPU
// bodies _dq_kernel and _dkv_kernel: given q, k, v, the upstream gradient dO,
// the forward's per-row logsumexp and delta = rowsum(dO * O) (both f32),
//   p  = exp(q k^T * scale - lse),   dp = dO v^T,
//   ds = p * (dp - delta) * scale,
//   dq = ds k,   dk = ds^T q,   dv = p^T dO,
// for (BH, Sq, D) x (BKV, Sk, D) inputs in bf16 or f32, D % 4 == 0,
// D <= 128, BH a multiple of BKV (group = BH / BKV query heads per KV head).
//
// Design.  The TPU kernels carried f32 accumulators in VMEM scratch across a
// sequential grid axis; blocks here run in no order, so that axis is a loop
// inside the block, and each output tile is owned by exactly one block: no
// float atomics, so the gradients are deterministic (bitwise equal from run
// to run).  Both kernels use the forward kernel's layout: 8 warps, each
// owning 8 rows of the block's 64; lane j owns the two columns j and j + 32
// of a 64-wide score tile and dims j, j + 32, j + 64 of a row of D; tiles are
// staged in shared memory as f32, rows read by every lane of a warp at once
// (broadcast) keep stride D, rows read one per lane keep stride D + 4 so the
// lanes' float4 loads hit distinct banks.
//   * dq kernel: one block per (query head, 64 query rows).  q and dO stay
//     in shared memory; it walks the live keys of KV head bh / group in
//     tiles of 64 (k and v), and accumulates dq in registers.
//   * dkv kernel: one block per (KV head, 64 key rows).  k and v stay in
//     shared memory; it loops over the group's query heads and, for each,
//     walks the live queries in tiles of 64 (q, dO, lse, delta),
//     accumulating dk and dv in registers across the whole group (48
//     floats a lane at D = 72, 64 at D = 128).  JAX writes per-query-head
//     partials in q's dtype and sums the group in its wrapper; here the
//     group sum stays in f32 and each output is rounded once.  Only the
//     staged tiles take shared memory (about 166 KB at D = 128, above the
//     48 KB default: the launch opts in).
// Masks (_mask of the TPU kernels): query positions are right-aligned to the
// keys, q_pos = row + Sk - Sq; causal keeps k <= q_pos and a window keeps
// k > q_pos - window.  A masked pair has p = 0, so a query row with no live
// key gets dq = 0 and adds nothing to dk or dv.  The loop bounds skip every
// tile pair with no live entry (the TPU kernels' pl.when(live)): the dq
// kernel visits the KV tiles from the first key any of its rows can see to
// the last, the dkv kernel the Q tiles whose rows can see any of its keys.
// P is recomputed from lse, never stored.  All math is f32; each output is
// rounded once to the input dtype.  Ragged Sq / Sk are masked: rows past the
// end load as zero, their scores get p = 0, their outputs are not stored.
//
// Bound.  At the DiT's training shapes (BH 128, S 1024, D 72) the dq kernel
// does 6 S^2 D and the dkv kernel 8 S^2 D flops per head against about
// 10 S D bytes, far above the card's ridge, so both are bound by operations
// (the masked forms: the live pairs' share of them).  This first version
// uses the f32 FMA units, not the tensor cores, as the forward does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;               // rows of a tile, queries or keys
constexpr int kWarps = 8;
constexpr int kRows = kBlock / kWarps;   // rows per warp
constexpr int kThreads = kWarps * 32;

// The mask of one (query row, key) pair, with query positions right-aligned
// to the keys (q_pos = row + Sk - Sq); window 0 is none.  The kernels are
// compiled once with MASKED false, for the non-causal form without a
// window (the DiT's: only ragged edges are masked, and the dkv kernel
// keeps to 128 registers, so that at the DiT's D = 72 two blocks share an
// SM), and once with it true.
struct Mask {
  int Sq, Sk, causal, window;
  template <bool MASKED>
  __device__ __forceinline__ bool keep(int row, int key) const {
    if (!MASKED) return row < Sq && key < Sk;
    const int q_pos = row + Sk - Sq;
    return row < Sq && key < Sk && (!causal || key <= q_pos) &&
           (window <= 0 || key > q_pos - window);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Rows [row0, row0 + kBlock) of one head's (S, D) slice into shared memory
// as f32 with row stride ld; rows at or past S become zero.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int S,
                          int D) {
  const int n = kBlock * D;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < S ? to_f32(src[(size_t)gr * D + c]) : 0.f;
  }
}

// acc[r][c] += sum_j w[r][j] * x[j][lane + 32 c] over the tile's 64 rows of
// x (stride ld); w is the warp's (kRows, kBlock) buffer in shared memory.
template <int DPL>
__device__ __forceinline__ void accumulate(float (&acc)[kRows][DPL],
                                           const float* w, const float* x,
                                           int ld, int D, int lane) {
  for (int j = 0; j < kBlock; j += 4) {
    float xx[4][DPL];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        xx[jj][c] = d < D ? x[(j + jj) * ld + d] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(w + r * kBlock + j);
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        acc[r][c] += p.x * xx[0][c] + p.y * xx[1][c] + p.z * xx[2][c] + p.w * xx[3][c];
    }
  }
}

template <typename T, int DPL>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[kRows][DPL],
                                           int row0, int S, int D, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[(size_t)row * D + d] = from_f32<T>(acc[r][c]);
    }
  }
}

// Scores of the warp's 8 rows (a, stride D, broadcast reads) against tile
// rows lane and lane + 32 (b, stride ldb): s[r][0], s[r][1]; and the same
// for a second pair of operands (a2 against b2) into t.
__device__ __forceinline__ void scores2(float (&s)[kRows][2], float (&t)[kRows][2],
                                        const float* a, const float* a2,
                                        const float* b, const float* b2,
                                        int ldb, int D, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = t[r][0] = t[r][1] = 0.f;
  const float* b_lo = b + lane * ldb;
  const float* b_hi = b + (lane + 32) * ldb;
  const float* b2_lo = b2 + lane * ldb;
  const float* b2_hi = b2 + (lane + 32) * ldb;
  for (int d = 0; d < D; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(b_lo + d);
    const float4 x1 = *reinterpret_cast<const float4*>(b_hi + d);
    const float4 y0 = *reinterpret_cast<const float4*>(b2_lo + d);
    const float4 y1 = *reinterpret_cast<const float4*>(b2_hi + d);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(a + r * D + d);
      const float4 w = *reinterpret_cast<const float4*>(a2 + r * D + d);
      s[r][0] += dot4(u, x0);
      s[r][1] += dot4(u, x1);
      t[r][0] += dot4(w, y0);
      t[r][1] += dot4(w, y1);
    }
  }
}

template <typename T, int DPL, bool MASKED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk, int D, int group,
                    Mask mask, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 4;
  float* sq = smem;                          // [kBlock][D]
  float* sdo = sq + kBlock * D;              // [kBlock][D]
  float* sk = sdo + kBlock * D;              // [kBlock][ldk]
  float* sv = sk + kBlock * ldk;             // [kBlock][ldk]
  float* sds = sv + kBlock * ldk;            // [kWarps][kRows][kBlock]

  const int n_qt = (Sq + kBlock - 1) / kBlock;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = q0 + warp * kRows;
  const T* kb = k + (size_t)(bh / group) * Sk * D;
  const T* vb = v + (size_t)(bh / group) * Sk * D;
  float* dsw = sds + warp * kRows * kBlock;

  load_tile(sq, D, q + (size_t)bh * Sq * D, q0, Sq, D);
  load_tile(sdo, D, dout + (size_t)bh * Sq * D, q0, Sq, D);
  float row_lse[kRows], row_delta[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool valid = row0 + r < Sq;
    row_lse[r] = valid ? lse[(size_t)bh * Sq + row0 + r] : 0.f;
    row_delta[r] = valid ? delta[(size_t)bh * Sq + row0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // the live keys of the block's rows: the KV tiles from k_begin to k_end
  const int q_off = Sk - Sq;
  const int q_first = q0 + q_off;
  const int q_last = min(q0 + kBlock, Sq) - 1 + q_off;
  const int k_end = mask.causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = mask.window > 0
      ? max(0, q_first - mask.window + 1) / kBlock * kBlock : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlock) {
    __syncthreads();                         // the previous tile is consumed
    load_tile(sk, ldk, kb, k0, Sk, D);
    load_tile(sv, ldk, vb, k0, Sk, D);
    __syncthreads();

    // s = q k^T and dp = dO v^T for keys k0 + lane and k0 + lane + 32
    float s[kRows][2], dp[kRows][2];
    scores2(s, dp, sq + warp * kRows * D, sdo + warp * kRows * D, sk, sv,
            ldk, D, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      const float p0 = mask.keep<MASKED>(row, k0 + lane)
          ? expf(s[r][0] * scale - row_lse[r]) : 0.f;
      const float p1 = mask.keep<MASKED>(row, k0 + lane + 32)
          ? expf(s[r][1] * scale - row_lse[r]) : 0.f;
      dsw[r * kBlock + lane] = p0 * (dp[r][0] - row_delta[r]) * scale;
      dsw[r * kBlock + lane + 32] = p1 * (dp[r][1] - row_delta[r]) * scale;
    }
    __syncwarp();
    accumulate(acc, dsw, sk, ldk, D, lane);  // dq += ds k
  }
  store_rows(dq + (size_t)bh * Sq * D, acc, row0, Sq, D, lane);
}

template <typename T, int DPL, bool MASKED>
__global__ void __launch_bounds__(kThreads, DPL <= 3 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                     int D, int group, Mask mask, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = D + 4;
  float* sk = smem;                          // [kBlock][D]
  float* sv = sk + kBlock * D;               // [kBlock][D]
  float* sq = sv + kBlock * D;               // [kBlock][ldq]
  float* sdo = sq + kBlock * ldq;            // [kBlock][ldq]
  float* slse = sdo + kBlock * ldq;          // [kBlock]
  float* sdelta = slse + kBlock;             // [kBlock]
  float* sp = sdelta + kBlock;               // [kWarps][kRows][kBlock]
  float* sds = sp + kWarps * kRows * kBlock; // [kWarps][kRows][kBlock]

  const int n_kt = (Sk + kBlock - 1) / kBlock;
  const int bkv = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x - bkv * n_kt) * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = k0 + warp * kRows;
  float* pw = sp + warp * kRows * kBlock;
  float* dsw = sds + warp * kRows * kBlock;

  load_tile(sk, D, k + (size_t)bkv * Sk * D, k0, Sk, D);
  load_tile(sv, D, v + (size_t)bkv * Sk * D, k0, Sk, D);
  float dk_acc[kRows][DPL], dv_acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < DPL; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }

  // the queries that see any of the block's keys: rows q_begin .. q_end - 1
  // (causal: q_pos >= the first key; window: q_pos < the last key + window)
  const int q_off = Sk - Sq;
  const int k_last = min(k0 + kBlock, Sk) - 1;
  const int q_begin = mask.causal
      ? max(0, k0 - q_off) / kBlock * kBlock : 0;
  const int q_end = mask.window > 0 ? min(Sq, k_last + mask.window - q_off)
                                    : Sq;

  // one loop over (query head of the group, query tile) pairs: fewer live
  // registers than two nested loops, so the DiT's form (group 1, D 72)
  // stays within 128 registers
  const int n_q = max(0, (q_end - q_begin + kBlock - 1) / kBlock);
  for (int it = 0; it < group * n_q; ++it) {
    const int g = it / n_q;
    const int q0 = q_begin + (it - g * n_q) * kBlock;
    const size_t head = (size_t)(bkv * group + g) * Sq;   // its first row
    __syncthreads();                         // the previous tile is consumed
    load_tile(sq, ldq, q + head * D, q0, Sq, D);
    load_tile(sdo, ldq, dout + head * D, q0, Sq, D);
    if (threadIdx.x < kBlock) {
      const int i = q0 + threadIdx.x;
      slse[threadIdx.x] = i < Sq ? lse[head + i] : 0.f;
      sdelta[threadIdx.x] = i < Sq ? delta[head + i] : 0.f;
    }
    __syncthreads();

    // s = k q^T and dp = v dO^T for queries q0 + lane and q0 + lane + 32
    float s[kRows][2], dp[kRows][2];
    scores2(s, dp, sk + warp * kRows * D, sv + warp * kRows * D, sq, sdo,
            ldq, D, lane);
    const float lse_lo = slse[lane], lse_hi = slse[lane + 32];
    const float delta_lo = sdelta[lane], delta_hi = sdelta[lane + 32];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = row0 + r;
      const float p0 = mask.keep<MASKED>(q0 + lane, key)
          ? expf(s[r][0] * scale - lse_lo) : 0.f;
      const float p1 = mask.keep<MASKED>(q0 + lane + 32, key)
          ? expf(s[r][1] * scale - lse_hi) : 0.f;
      pw[r * kBlock + lane] = p0;
      pw[r * kBlock + lane + 32] = p1;
      dsw[r * kBlock + lane] = p0 * (dp[r][0] - delta_lo) * scale;
      dsw[r * kBlock + lane + 32] = p1 * (dp[r][1] - delta_hi) * scale;
    }
    __syncwarp();
    accumulate(dv_acc, pw, sdo, ldq, D, lane);    // dv += p^T dO
    accumulate(dk_acc, dsw, sq, ldq, D, lane);    // dk += ds^T q
  }
  store_rows(dk + (size_t)bkv * Sk * D, dk_acc, row0, Sk, D, lane);
  store_rows(dv + (size_t)bkv * Sk * D, dv_acc, row0, Sk, D, lane);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct Args {
  int bh, sq, sk, d, group;
  Mask mask;
  float scale;
};

template <typename T, int DPL>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, const Args& a, cudaStream_t stream) {
  const int d = a.d;
  const size_t smem = sizeof(float) *
      (2 * kBlock * d + 2 * kBlock * (d + 4) + kWarps * kRows * kBlock);
  auto kernel = a.mask.causal || a.mask.window > 0
      ? flash_bwd_dq_kernel<T, DPL, true> : flash_bwd_dq_kernel<T, DPL, false>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = a.bh * ((a.sq + kBlock - 1) / kBlock);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), a.sq, a.sk, d, a.group, a.mask, a.scale);
  return cudaGetLastError();
}

template <typename T, int DPL>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, const Args& a,
                       cudaStream_t stream) {
  const int d = a.d;
  const size_t smem = sizeof(float) *
      (2 * kBlock * d + 2 * kBlock * (d + 4) + 2 * kBlock +
       2 * kWarps * kRows * kBlock);
  auto kernel = a.mask.causal || a.mask.window > 0
      ? flash_bwd_dkv_kernel<T, DPL, true>
      : flash_bwd_dkv_kernel<T, DPL, false>;
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = a.bh / a.group * ((a.sk + kBlock - 1) / kBlock);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, d, a.group,
      a.mask, a.scale);
  return cudaGetLastError();
}

#define DISPATCH_DPL(d, CALL)                                  \
  switch (((d) + 31) / 32) {                                   \
    case 1: { constexpr int DPL = 1; return CALL; }            \
    case 2: { constexpr int DPL = 2; return CALL; }            \
    case 3: { constexpr int DPL = 3; return CALL; }            \
    case 4: { constexpr int DPL = 4; return CALL; }            \
    default: return cudaErrorInvalidValue;                     \
  }

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, const Args& a, cudaStream_t s) {
  DISPATCH_DPL(a.d, (launch_dq<T, DPL>(q, k, v, dout, lse, delta, dq, a, s)))
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, const Args& a, cudaStream_t s) {
  DISPATCH_DPL(a.d, (launch_dkv<T, DPL>(q, k, v, dout, lse, delta, dk, dv, a,
                                        s)))
}

bool valid(int bh, int d, int group, int window) {
  return d % 4 == 0 && d <= 128 && d > 0 && group > 0 && bh % group == 0 &&
         window >= 0;
}

}  // namespace

// q, dout, dq: (bh, sq, d); k, v, dk, dv: (bh / group, sk, d).  lse and
// delta are f32 (bh, sq).  causal: 0 or 1; window: the sliding window, 0 for
// none.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs).
// The caller checks shapes, dtypes and contiguity; D % 4 == 0 and D <= 128.
// Each returns its launch's CUDA error.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int sq, int sk, int d,
                                      int group, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (!valid(bh, d, group, window)) return (int)cudaErrorInvalidValue;
  const Args a{bh, sq, sk, d, group, Mask{sq, sk, causal, window}, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, a, s)
      : dispatch_dq<float>(q, k, v, dout, lse, delta, dq, a, s);
  return (int)err;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int sq,
                                       int sk, int d, int group, int causal,
                                       int window, float scale, int dtype,
                                       void* stream) {
  if (!valid(bh, d, group, window)) return (int)cudaErrorInvalidValue;
  const Args a{bh, sq, sk, d, group, Mask{sq, sk, causal, window}, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, a, s)
      : dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, a, s);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
