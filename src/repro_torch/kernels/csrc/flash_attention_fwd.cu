// Flash attention forward for Hopper (sm_90a): non-causal, causal and
// sliding-window masks, grouped-query attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_fwd and its TPU
// body _fwd_kernel: o = softmax(q k^T * scale) v and the per-row logsumexp,
// for (BH, Sq, D) x (BKV, Sk, D) inputs in bf16 or f32, D % 4 == 0, D <= 128.
//
// Design.  The TPU kernel carried (acc, m, l) in VMEM scratch across a
// sequential grid axis over KV tiles; blocks here run in no order, so the KV
// axis is a loop inside the block.  One block of 8 warps owns 64 query rows
// of one head (8 rows per warp) and walks the keys in tiles of 64 staged in
// shared memory as f32.  Lane j of a warp owns keys j and j + 32 of the tile
// for the scores and dims j, j + 32, ... of the output rows, so the online
// softmax's row max and row sum are warp shuffles.  All math is f32 with
// NEG_INF = -1e30 masking, the fully-masked-row guard and the l == 0 guard
// of _fwd_kernel.  Ragged Sq / Sk are masked in the kernel: rows past the end
// load as zero, their scores are masked, their outputs are not stored.
//
// Masks and groups (_mask and the index_map of the TPU kernel).  Query
// positions are right-aligned to the keys, q_pos = row + Sk - Sq; causal
// keeps k <= q_pos and a window keeps k > q_pos - window.  Query head bh
// reads KV head bh / group, so K/V are never repeated in memory.  The KV
// loop's bounds skip every tile with no live entry for the block's rows (the
// TPU kernel's pl.when(live)): causal prefill visits about half the tiles of
// the non-causal form, a window about window / Sk of them.
//
// Bound.  At the DiT's shapes (S = 1024, D = 72) the work is 4 S^2 D flops
// per head against 8 S D bytes moved, far above the card's ridge, so the
// bound is compute (causal: the live half of it).  This first version uses
// the f32 FMA units, not the tensor cores: q and k are read from shared
// memory as float4 so each 16-byte load feeds 4 to 8 FMAs, and the key rows
// use a stride of D + 4 floats so the 32 lanes' float4 loads hit distinct
// banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;   // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + nrows) of one head's (S, D) slice into shared memory as
// f32 with row stride ld; rows at or past S become zero.  The rows are
// contiguous in device memory, so consecutive threads read consecutive
// elements.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int row0, int nrows,
                          int S, int D) {
  const int n = nrows * D;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < S ? to_f32(src[(size_t)gr * D + c]) : 0.f;
  }
}

template <typename T, int DPL>   // DPL: output dims per lane, ceil(D / 32)
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int D, int group,
                 int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 4;                     // float4-aligned, bank-spread
  float* sq = smem;                          // [kBlockQ][D]
  float* sk = sq + kBlockQ * D;              // [kBlockK][ldk]
  float* sv = sk + kBlockK * ldk;            // [kBlockK][D]
  float* sp = sv + kBlockK * D;              // [kWarps][kRows][kBlockK]

  const int n_qt = (Sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)(bh / group) * Sk * D;
  const T* vb = v + (size_t)(bh / group) * Sk * D;
  const float* qw = sq + warp * kRows * D;
  float* pw = sp + warp * kRows * kBlockK;

  load_tile(sq, D, qb, q0, kBlockQ, Sq, D);

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // live keys of each row r: [lo[r], hi[r]]; of the block: the KV tiles
  // from k_begin up to k_end (tiles with no live entry are never visited)
  const int q_off = Sk - Sq;
  int lo[kRows], hi[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int q_pos = q0 + warp * kRows + r + q_off;
    hi[r] = causal ? min(q_pos, Sk - 1) : Sk - 1;
    lo[r] = window > 0 ? q_pos - window + 1 : 0;
  }
  const int q_first = q0 + q_off;
  const int q_last = min(q0 + kBlockQ, Sq) - 1 + q_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0
      ? max(0, q_first - window + 1) / kBlockK * kBlockK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                         // the previous tile is consumed
    load_tile(sk, ldk, kb, k0, kBlockK, Sk, D);
    load_tile(sv, D, vb, k0, kBlockK, Sk, D);
    __syncthreads();

    // scores for keys k0 + lane and k0 + lane + 32
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k_lo = sk + lane * ldk;
    const float* k_hi = sk + (lane + 32) * ldk;
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(k_lo + d);
      const float4 b = *reinterpret_cast<const float4*>(k_hi + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(qw + r * D + d);
        s[r][0] += x.x * a.x + x.y * a.y + x.z * a.z + x.w * a.w;
        s[r][1] += x.x * b.x + x.y * b.y + x.z * b.z + x.w * b.w;
      }
    }

    // online softmax update, one row at a time across the warp
    const int kp_lo = k0 + lane, kp_hi = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool keep_lo = kp_lo >= lo[r] && kp_lo <= hi[r];
      const bool keep_hi = kp_hi >= lo[r] && kp_hi <= hi[r];
      const float s0 = keep_lo ? s[r][0] * scale : kNegInf;
      const float s1 = keep_hi ? s[r][1] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[r] - m_new);
      // fully-masked guard: with m_new == NEG_INF, exp(s - m_new) would be 1
      const float p0 = keep_lo ? expf(s0 - m_new) : 0.f;
      const float p1 = keep_hi ? expf(s1 - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p v over the tile (masked keys have p == 0 and zero v rows)
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? sv[(j + jj) * D + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] += p.x * vv[0][c] + p.y * vv[1][c] + p.z * vv[2][c] + p.w * vv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= Sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];   // fully-masked rows -> 0
    T* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f32<T>(acc[r][c] / l_safe);
    }
    if (lane == 0) lse[(size_t)bh * Sq + row] = m[r] + logf(l_safe);
  }
}

struct Args {
  int bh, sq, sk, d, group, causal, window;
  float scale;
};

template <typename T, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Args& a, cudaStream_t stream) {
  const int d = a.d;
  const size_t smem = sizeof(float) *
      (kBlockQ * d + kBlockK * (d + 4) + kBlockK * d + kWarps * kRows * kBlockK);
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = a.bh * ((a.sq + kBlockQ - 1) / kBlockQ);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      a.sq, a.sk, d, a.group, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, const Args& a, cudaStream_t s) {
  switch ((a.d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, lse, a, s);
    case 2: return launch<T, 2>(q, k, v, o, lse, a, s);
    case 3: return launch<T, 3>(q, k, v, o, lse, a, s);
    case 4: return launch<T, 4>(q, k, v, o, lse, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (bh, sq, d); k, v: (bh / group, sk, d).  causal: 0 or 1; window: the
// sliding window, 0 for none.  dtype: 0 = float32, 1 = bfloat16.  The caller
// checks shapes, dtypes and contiguity; D % 4 == 0 and D <= 128.  Returns the
// launch's CUDA error.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int sq, int sk,
                                   int d, int group, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (d % 4 != 0 || d > 128 || d <= 0 || group <= 0 || bh % group != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{bh, sq, sk, d, group, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(q, k, v, o, lse, a, s)
      : dispatch<float>(q, k, v, o, lse, a, s);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
