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
// Two kernels, dq and dkv, on one of two routes (flash_attention_bwd_route):
// bf16 with D % 8 == 0 runs flash_bwd_dq_kernel_tc and
// flash_bwd_dkv_kernel_tc on the tensor cores; f32, and bf16 with D % 8 != 0
// (TMA needs 16-byte rows), run flash_bwd_dq_kernel and flash_bwd_dkv_kernel
// on the f32 FMA units.
//
// Both routes keep the TPU kernels' numerics and form.  S and dP are f32
// sums of exact bf16 products; p is f32 from the saved lse; a masked pair
// has p = 0, so a query row with no live key gets dq = 0 and adds nothing to
// dk or dv.  Masks (_mask): query positions are right-aligned to the keys,
// q_pos = row + Sk - Sq; causal keeps k <= q_pos and a window keeps k > q_pos
// - window.  Query head bh reads KV head bh / group: K/V are never repeated
// in memory.  The loop bounds skip every tile pair with no live entry (the
// TPU kernels' pl.when(live)).  The TPU kernels carried f32 accumulators in
// VMEM across a sequential grid axis; blocks here run in no order, so that
// axis is a loop inside the block, and each output tile is owned by exactly
// one block: no atomics, so the gradients are bitwise equal from run to run.
// JAX writes dk and dv per query head and sums the group in its wrapper;
// here the dkv block sums the group in f32 and rounds each output once.
// Ragged Sq / Sk: rows past the end load as zero, their pairs are masked,
// their outputs are not stored.
//
// Bound.  The work is 6 Sq Sk D flops per head for dq (S, dP, dS K) and 8
// for dkv (S, dP, P^T dO, dS^T Q), the masked forms' live pairs only,
// against about 10 S D bytes: far above the card's ridge, so both kernels
// are bound by the bf16 tensor cores (989 TFLOP/s), and by the f32 units
// (67) on the f32 route.
//
// The tensor-core route (flash_bwd_dq_kernel_tc, flash_bwd_dkv_kernel_tc,
// on the forward's machinery in sm90_tc.cuh).  A block has two consumer
// warpgroups of 64 rows and a producer warpgroup that hands its registers
// to them (setmaxnreg: 232 a consumer thread, 40 a producer one).  The
// producer's thread brings the block's own operands once and the tiles of a
// 2-stage ring with TMA (zero fill past the ragged edge and in D's padding
// to a multiple of 16), and mbarriers report each stage full and, after
// both warpgroups used it, empty.  Operands stay bf16 in shared memory in
// wgmma's no-swizzle core-matrix layout, where one copy serves as a K-major
// and as an MN-major operand (two descriptors over the same bytes).
//   * dq: a block owns 128 query rows of one query head (Q and dO) and walks
//     the live key tiles of 64 of KV head bh / group (K and V through the
//     ring), the heaviest query tiles first.  Per tile S = Q K^T and dP = dO
//     V^T are wgmma SS products (A and B K-major, as S in the forward); p and
//     dS are formed in f32 registers with the rows' lse and delta; dQ += dS
//     K is an RS product (A is dS from registers, B is K MN-major: the
//     forward's P V with K in V's place).
//   * dkv: a block owns 128 keys of one KV head (K and V) and loops over
//     (query head of the group, live query tile of 64), the lowest key
//     tiles (which see the most queries under a causal mask) first.  Q and
//     dO come through the ring by TMA; the tile's lse and delta by the
//     producer warp's plain loads (a TMA box starts on a 16-byte boundary,
//     a head's rows only when Sq % 4 == 0).  Per half tile of 32 queries
//     S^T = K Q^T and dP^T = V dO^T are SS products (m64n32); P^T and dS^T
//     are formed in registers with lse and delta by column; dV += P^T dO and
//     then dK += dS^T Q are RS products with dO and Q MN-major.
// Rounding P or dS once to bf16 would move the gradients by about 2.6e-3
// relative L2; each goes in as kBwdTerms bf16 terms (hi = bf16(x), lo =
// bf16(x - hi)), whose sum is x to about 2^-16, with Sum_term term B
// accumulated in f32 by the tensor cores.  That doubles the P and dS
// products' work: 8 flops issued per live pair and head dim for dq's 6 and
// 12 for dkv's 8.
// Registers decide the dkv kernel's geometry.  ptxas serialized the wgmmas
// and spilled while a thread held dK and dV (2 x D / 2) beside a 64-query
// tile's S^T, dP^T and terms, so a tile goes in two halves of 32 queries,
// with one set of terms live at a time.  Above D 96 even that spilled: the
// block then makes two passes over the same tiles, dV (stored) and then dK,
// one accumulator live at a time (S^T is computed twice: 14 flops issued).
// The tensor cores' f32 sums drop low bits toward zero; over qwen3-8b's 4
// heads x 32 tiles that bias read 3.5e-4 relative L2 in (dk, dv) on an
// H100 (chip_smoke.py phase 3; limit 1e-3), so the
// two-pass form starts its accumulator from zero every 4 tiles and adds it
// to a running f32 sum in shared memory (one rounded add; 1.1e-4 after).
// dQ and the one-pass dK and dV, over at most 32 and 16 x group tiles at
// the main paths' shapes, accumulate in wgmma throughout.
//
// The f32-FMA route (flash_bwd_dq_kernel, flash_bwd_dkv_kernel).  8 warps,
// each owning 8 rows of the block's 64; lane j owns the two columns j and
// j + 32 of a 64-wide score tile and dims j, j + 32, j + 64 of a row of D;
// tiles are staged in shared memory as f32 by synchronous loads, rows read
// by every lane of a warp at once (broadcast) keep stride D, rows read one
// per lane keep stride D + 4 so the lanes' float4 loads hit distinct banks.
// The dq kernel keeps q and dO and walks k and v; the dkv kernel keeps k
// and v and walks q, dO, lse and delta, accumulating dk and dv across the
// whole group (48 floats a lane at D = 72, 64 at D = 128; about 166 KB of
// shared memory at D = 128: the launch opts in).  The kernels are compiled
// once for the non-causal form without a window (only ragged edges masked:
// the dkv kernel keeps to 128 registers, so at D = 72 two blocks share an
// SM) and once masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tc.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 operands with D % 8 == 0.
// ---------------------------------------------------------------------------
namespace {
namespace tc {

using namespace sm90;   // TMA, mbarriers, wgmma (sm90_tc.cuh)

// The ring's tile and depth are build knobs (repro_torch.kernels.tuning,
// family "flash": bwd_block_n, bwd_stages), defined with -D by _build.
#ifndef FLASH_BWD_BLOCK_N
#define FLASH_BWD_BLOCK_N 64
#endif
#ifndef FLASH_BWD_STAGES
#define FLASH_BWD_STAGES 2
#endif
constexpr int kBlockM = 128;     // rows a block owns: two warpgroups of 64
constexpr int kBlockN = FLASH_BWD_BLOCK_N;   // rows of a ring tile
constexpr int kStages = FLASH_BWD_STAGES;
// the transposed scores' wgmma is n64 and the producer copies lse and
// delta rows of 64, so the layout takes tiles of 64 rows only; the ring
// needs two stages to overlap, and three fit the dkv kernel's shared
// memory at head dim 128 with its running sums (Layout below)
static_assert(kBlockN == 64, "FLASH_BWD_BLOCK_N: the layout takes 64");
static_assert(kStages >= 2 && kStages <= 3, "FLASH_BWD_STAGES: 2 or 3");
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 4) * 32;   // + the producer's group
// registers per thread after the split (setmaxnreg): the producer warp
// also copies lse and delta (dkv), so it keeps more than the forward's
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kConsumerWarps * 32 * kConsumerRegs + 128 * kProducerRegs <=
              65536, "the register file");
constexpr float kLog2e = 1.4426950408889634f;
// the bf16 terms of P and dS on flash_attention_bwd's path
// (kernels/flash_attention.py reads this line for BWD_TC_TERMS)
constexpr int kBwdTerms = 2;

// Dynamic shared memory of a block: the two operands it owns (Q and dO, or
// K and V: DP/8 column chunks of 128 rows x 16 bytes each), then the ring
// (a stage: two tiles of DP/8 chunks of 64 rows x 16 bytes, then the tile's
// lse and delta, 64 f32 each), then the barriers, after an alignment pad.
template <int DP, bool SUMS = false>
struct Layout {
  static constexpr int kChunks = DP / 8;
  static constexpr uint32_t kOwnBytes = kChunks * kBlockM * 16;
  static constexpr uint32_t kTileBytes = kChunks * kBlockN * 16;
  static constexpr uint32_t kVecBytes = kBlockN * 4;
  static constexpr uint32_t kStageBytes = 2 * kTileBytes + 2 * kVecBytes;
  // the dkv kernel's running f32 sums, one accumulator's worth a consumer
  // thread (two-pass form), after the ring
  static constexpr uint32_t kSumOffset = 2 * kOwnBytes + kStages * kStageBytes;
  static constexpr uint32_t kSumBytes = SUMS ? kConsumerWarps * 32 * DP / 2 * 4
                                             : 0;
  static constexpr uint32_t kBarOffset = kSumOffset + kSumBytes;
  static constexpr uint32_t kBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory (227 KB)");
};
// dkv's two-pass form (head dims above 96), see flash_bwd_dkv_kernel_tc
template <int DP> constexpr bool kTwoPass = DP > 96;

struct Smem {
  uint8_t* own;           // the block's two operands, kOwnBytes apart
  uint8_t* ring;
  uint64_t *full, *empty, *own_bar;
  float* sums;            // Layout's kSumBytes (dkv, two-pass form)
};

// The block's shared memory and barriers (initialised): `full_count`
// arrivals complete a ring stage.
template <int DP, bool SUMS = false>
__device__ __forceinline__ Smem carve(uint8_t* raw, int full_count) {
  using L = Layout<DP, SUMS>;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&full[kStages + s], kConsumerWarps);
    }
    mbar_init(&full[2 * kStages], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return Smem{smem, smem + 2 * L::kOwnBytes, full, full + kStages,
              full + 2 * kStages,
              reinterpret_cast<float*>(smem + L::kSumOffset)};
}

// TERMS bf16 terms of a 64 x 16 KK tile times B (MN-major: 16 KK rows of a
// ring tile from b_addr), smallest terms first, added to acc by the tensor
// cores.  Not committed.
template <int DP, int TERMS, int KK>
__device__ __forceinline__ void wgmma_terms(float (&acc)[DP / 2],
                                            const uint32_t (&a)[TERMS][KK][4],
                                            uint32_t b_addr) {
#pragma unroll
  for (int term = TERMS - 1; term >= 0; --term) {
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_rs(acc, a[term][kk], desc(b_addr + kk * 256, 128, kBlockN * 16));
  }
}

template <int TERMS, int KK>
__device__ __forceinline__ void pin_terms(uint32_t (&a)[TERMS][KK][4]) {
#pragma unroll
  for (int term = 0; term < TERMS; ++term)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pin(a[term][kk][r]);
}

// Rows row and row + 8 of a 64 x DP accumulator (the thread's) to out
// (rows of stride D), bf16, rows below S and columns below D only.
template <int DP>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out,
                                          const float (&acc)[DP / 2], int row,
                                          int S, int D, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    if (rr >= S) continue;
    __nv_bfloat16* orow = out + static_cast<size_t>(rr) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// dq: a block owns 128 query rows of query head bh (two consumer warpgroups
// of 64) and walks the live key tiles of KV head bh / group.
template <int DP, int TERMS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int BH, int Sq, int Sk,
                       int D, int group, Mask mask, float scale_log2,
                       float scale) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve<DP>(smem_raw, 1);

  // heaviest query tiles first: causal work grows with the tile index
  const int n_qt = (Sq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kBlockM;
  const int q_off = Sk - Sq;      // right-aligned query positions
  const int causal = mask.causal, window = mask.window;

  // the block's key tiles: [t_begin, t_begin + n_tiles)
  const int q_last = min(q0 + kBlockM, Sq) - 1 + q_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int t_begin = window > 0 ? max(0, q0 + q_off - window + 1) / kBlockN : 0;
  const int n_tiles =
      k_end > 0 ? max(0, (k_end + kBlockN - 1) / kBlockN - t_begin) : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // the producer: one thread keeps the TMA copies of the ring in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(sm.own_bar, 2 * L::kOwnBytes);
#pragma unroll 1
      for (int c = 0; c < L::kChunks; ++c) {
        tma_load(sm.own + c * kBlockM * 16, &map_q, sm.own_bar, 8 * c, q0, bh);
        tma_load(sm.own + L::kOwnBytes + c * kBlockM * 16, &map_do, sm.own_bar,
                 8 * c, q0, bh);
      }
      const int bkv = bh / group;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&sm.full[s], 2 * L::kTileBytes);
        const int k0 = (t_begin + i) * kBlockN;
        uint8_t* ks = sm.ring + s * L::kStageBytes;
#pragma unroll 1
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(ks + c * kBlockN * 16, &map_k, &sm.full[s], 8 * c, k0, bkv);
          tma_load(ks + L::kTileBytes + c * kBlockN * 16, &map_v, &sm.full[s],
                   8 * c, k0, bkv);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  // the consumers: warpgroup wg owns query rows [q0 + 64 wg, +64); thread
  // (w, lane) of it holds rows row = 16 w + lane / 4 and row + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1} of the accumulators (wgmma's layout)
  const int wg = warp / 4;
  const int w_row0 = q0 + 64 * wg;
  const int row = w_row0 + 16 * (warp % 4) + lane / 4;
  const int w_first = w_row0 + q_off;
  const int w_last = min(w_row0 + 64, Sq) - 1 + q_off;
  int w_tb = 0, w_te = 0;      // the warpgroup's own live tiles
  if (w_row0 < Sq) {
    const int w_kend = causal ? min(Sk, w_last + 1) : Sk;
    w_tb = window > 0 ? max(0, w_first - window + 1) / kBlockN : 0;
    w_te = w_kend > 0 ? (w_kend + kBlockN - 1) / kBlockN : 0;
  }
  // the rows' lse in log2 units and delta (rows past Sq: 0, as _dq_kernel)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
    const size_t i = static_cast<size_t>(bh) * Sq + rr;
    row_lse[r] = rr < Sq ? lse[i] * kLog2e : 0.f;
    row_delta[r] = rr < Sq ? delta[i] : 0.f;
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  if (n_tiles > 0) mbar_wait(sm.own_bar, 0);
  const uint32_t q_addr = smem_u32(sm.own) + 64 * 16 * wg;
  const uint32_t do_addr = q_addr + L::kOwnBytes;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, t = t_begin + i, k0 = t * kBlockN;
    mbar_wait(&sm.full[s], (i / kStages) & 1);
    if (t >= w_tb && t < w_te) {
      // S = Q K^T and dP = dO V^T, both K-major from shared memory
      const uint32_t k_addr = smem_u32(sm.ring + s * L::kStageBytes);
      const uint32_t v_addr = k_addr + L::kTileBytes;
      float sc[32], dp[32];
      wg_fence();
      wgmma_scores<DP>(sc, q_addr, kBlockM, k_addr, kBlockN);
      wgmma_scores<DP>(dp, do_addr, kBlockM, v_addr, kBlockN);
      wg_commit();
      wg_wait_all();
      pin_all(sc);
      pin_all(dp);

      // p = exp(s scale - lse) in f32, 0 where masked; only tiles that
      // need it are masked.  dS = p (dp - delta) scale, into dp
      const bool masked = k0 + kBlockN > Sk ||
                          (causal && k0 + kBlockN - 1 > w_first) ||
                          (window > 0 && k0 < w_last - window + 1);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        float p = ex2(fmaf(sc[j], scale_log2, -row_lse[r]));
        if (masked) {
          const int key = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
          p = mask.keep<true>(row + 8 * r, key) ? p : 0.f;
        }
        dp[j] = p * (dp[j] - row_delta[r]) * scale;
      }

      // dQ += dS K: dS as TERMS bf16 terms from registers, K MN-major
      uint32_t da[TERMS][4][4];
      split_terms(da, dp);
      wg_fence();
      wgmma_terms<DP>(acc, da, k_addr);
      wg_commit();
      wg_wait_all();
      pin_all(acc);
      pin_terms(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);    // the slot may be refilled
  }
  store_acc<DP>(dq + static_cast<size_t>(bh) * Sq * D, acc, row, Sq, D, lane);
}

// What a dkv consumer thread knows of its block's work (see the kernel).
struct DkvWork {
  Smem sm;
  uint32_t k_addr, v_addr;    // the warpgroup's 64 keys of K and V
  int key, kw0, wq_lo, wq_hi, q_begin, n_q, n_iter, Sq, Sk, q_off, lane;
  Mask mask;
  float scale_log2, scale;
};

// One pass of a dkv consumer warpgroup over the block's (query head, query
// tile) ring stages, ring iterations it .. it + n_iter - 1: dV += P^T dO when
// DV, dK += dS^T Q when DK.  A tile is taken in two halves of 32 queries, so
// that the accumulators and one half's S^T, dP^T and terms fit the
// registers.
template <int DP, int TERMS, bool DV, bool DK>
__device__ __forceinline__ void dkv_pass(float (&dv_acc)[DP / 2],
                                         float (&dk_acc)[DP / 2],
                                         const DkvWork& w, int it) {
  using L = Layout<DP, kTwoPass<DP>>;
  // the two-pass form's one accumulator is promoted every kPromoteTiles
  // tiles: the tensor cores' f32 sums drop low bits toward zero, a bias
  // that grows with the number of products summed in one accumulator (4
  // heads x 32 tiles at qwen3-8b's shape), so the accumulator starts from
  // zero and its sum joins the thread's running sum in shared memory with
  // one rounded f32 add
  constexpr bool kPromote = kTwoPass<DP>;
  constexpr int kPromoteTiles = 4;
  float* sums = w.sm.sums + (threadIdx.x % (kConsumerWarps * 32));
  float(&acc)[DP / 2] = DV ? dv_acc : dk_acc;
  if (kPromote) {
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) sums[j * kConsumerWarps * 32] = 0.f;
  }
  const Mask mask = w.mask;
  const int lane = w.lane;
  int q0 = w.q_begin;
  for (int i = it; i < it + w.n_iter; ++i) {
    const int s = i % kStages;
    mbar_wait(&w.sm.full[s], (i / kStages) & 1);
    const uint8_t* stage = w.sm.ring + s * L::kStageBytes;
    const float* t_lse = reinterpret_cast<const float*>(stage + 2 * L::kTileBytes);
    const float* t_delta = t_lse + kBlockN;
#pragma unroll 1
    for (int h = 0; h < kBlockN; h += 32) {
      const int qh = q0 + h;
      if (!(w.kw0 < w.Sk && qh + 32 > w.wq_lo && qh < w.wq_hi)) continue;
      // S^T = K Q^T (and dP^T = V dO^T), K-major from shared memory
      const uint32_t q_addr = smem_u32(stage) + h * 16;
      const uint32_t do_addr = q_addr + L::kTileBytes;
      float st[16], dpt[16];
      wg_fence();
      wgmma_scores<DP>(st, w.k_addr, kBlockM, q_addr, kBlockN);
      if (DK) wgmma_scores<DP>(dpt, w.v_addr, kBlockM, do_addr, kBlockN);
      wg_commit();
      wg_wait_all();
      pin_all(st);
      if (DK) pin_all(dpt);

      // P^T = exp(s scale - lse) (and dS^T = P^T (dP^T - delta) scale),
      // lse and delta by column, 0 where masked
      const bool masked = qh + 32 > w.Sq || w.kw0 + 64 > w.Sk ||
                          (mask.causal && w.kw0 + 63 > qh + w.q_off) ||
                          (mask.window > 0 &&
                           w.kw0 <= qh + 31 + w.q_off - mask.window);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = h + 8 * jj + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * jj + e;
          float p = ex2(fmaf(st[j], w.scale_log2,
                             -t_lse[c + (e & 1)] * kLog2e));
          if (masked)
            p = mask.keep<true>(q0 + c + (e & 1), w.key + ((e & 2) ? 8 : 0))
                    ? p : 0.f;
          st[j] = p;
          if (DK) dpt[j] = p * (dpt[j] - t_delta[c + (e & 1)]) * w.scale;
        }
      }

      // dV += P^T dO, then dK += dS^T Q: P^T and dS^T as TERMS bf16 terms
      // from registers, dO and Q MN-major; one set of terms is live at a
      // time
      if (DV) {
        uint32_t pa[TERMS][2][4];
        split_terms(pa, st);
        wg_fence();
        wgmma_terms<DP>(dv_acc, pa, do_addr);
        wg_commit();
        wg_wait_all();
        pin_all(dv_acc);
        pin_terms(pa);
      }
      if (DK) {
        pin_all(dpt);
        uint32_t da[TERMS][2][4];
        split_terms(da, dpt);
        wg_fence();
        wgmma_terms<DP>(dk_acc, da, q_addr);
        wg_commit();
        wg_wait_all();
        pin_all(dk_acc);
        pin_terms(da);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&w.sm.empty[s]);
    q0 += kBlockN;
    if (q0 >= w.q_begin + w.n_q * kBlockN) q0 = w.q_begin;
    if (kPromote && (i - it) % kPromoteTiles == kPromoteTiles - 1) {
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) {
        sums[j * kConsumerWarps * 32] += acc[j];
        acc[j] = 0.f;
      }
    }
  }
  if (kPromote) {
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] += sums[j * kConsumerWarps * 32];
  }
}

// dkv: a block owns 128 keys of KV head bkv (two consumer warpgroups of 64)
// and loops over (query head of the group, live query tile); Q and dO come
// through the ring by TMA, the tile's lse and delta by the producer warp's
// plain loads (a TMA box must start on a 16-byte boundary, and a head's
// rows start on one only when Sq % 4 == 0).  Up to D 96 one pass computes
// dK and dV together; above, the registers hold one of the two 64 x D
// accumulators at a time, so the block makes two passes over the same
// tiles (dV, stored, then dK: S^T is computed twice).
template <int DP, int TERMS>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int BKV, int Sq,
                        int Sk, int D, int group, Mask mask, float scale_log2,
                        float scale) {
  using L = Layout<DP, kTwoPass<DP>>;
  constexpr int kPasses = kTwoPass<DP> ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  // a stage's full barrier: the TMA thread's arrival (with the bytes) and
  // the 32 lanes' after their lse and delta stores
  const Smem sm = carve<DP, kTwoPass<DP>>(smem_raw, 1 + 32);

  // lowest keys first: under a causal mask they see the most queries
  const int bkv = blockIdx.x % BKV;
  const int k0 = static_cast<int>(blockIdx.x) / BKV * kBlockM;
  const int q_off = Sk - Sq;
  const int causal = mask.causal, window = mask.window;

  // the queries that see any of the block's keys: tiles from q_begin
  // (causal: q_pos >= k0) up to q_end (window: q_pos < the last key +
  // window), for each of the group's query heads
  const int k_last = min(k0 + kBlockM, Sk) - 1;
  const int q_begin = causal ? max(0, k0 - q_off) / kBlockN * kBlockN : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window - q_off) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + kBlockN - 1) / kBlockN
                                  : 0;
  const int n_iter = group * n_q;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == kConsumerWarps && n_iter > 0) {
      if (lane == 0) {
        mbar_expect_tx(sm.own_bar, 2 * L::kOwnBytes);
#pragma unroll 1
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(sm.own + c * kBlockM * 16, &map_k, sm.own_bar, 8 * c, k0,
                   bkv);
          tma_load(sm.own + L::kOwnBytes + c * kBlockM * 16, &map_v,
                   sm.own_bar, 8 * c, k0, bkv);
        }
      }
      int head = bkv * group, q0 = q_begin;
#pragma unroll 1
      for (int i = 0; i < kPasses * n_iter; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&sm.empty[s], (i / kStages - 1) & 1);
        uint8_t* qs = sm.ring + s * L::kStageBytes;
        if (lane == 0) {
          mbar_expect_tx(&sm.full[s], 2 * L::kTileBytes);
#pragma unroll 1
          for (int c = 0; c < L::kChunks; ++c) {
            tma_load(qs + c * kBlockN * 16, &map_q, &sm.full[s], 8 * c, q0,
                     head);
            tma_load(qs + L::kTileBytes + c * kBlockN * 16, &map_do,
                     &sm.full[s], 8 * c, q0, head);
          }
        }
        // lse and delta of rows q0 .. q0 + 63, two per lane (0 past Sq)
        float* vec = reinterpret_cast<float*>(qs + 2 * L::kTileBytes);
        const size_t base = static_cast<size_t>(head) * Sq;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = q0 + lane + 32 * h;
          vec[lane + 32 * h] = r < Sq ? lse[base + r] : 0.f;
          vec[kBlockN + lane + 32 * h] = r < Sq ? delta[base + r] : 0.f;
        }
        mbar_arrive(&sm.full[s]);
        q0 += kBlockN;
        if (q0 >= q_begin + n_q * kBlockN) {    // the next query head
          q0 = q_begin;
          head = head + 1 == (bkv + 1) * group ? bkv * group : head + 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  // the consumers: warpgroup wg owns keys [k0 + 64 wg, +64); thread (w,
  // lane) of it holds keys key = 16 w + lane / 4 and key + 8 (the rows of
  // S^T and of dK, dV) and queries 8 j + 2 (lane % 4) + {0, 1} of a tile
  const int wg = warp / 4;
  DkvWork w;
  w.sm = sm;
  w.kw0 = k0 + 64 * wg;
  w.key = w.kw0 + 16 * (warp % 4) + lane / 4;
  // the warpgroup's live query rows: [wq_lo, wq_hi)
  w.wq_lo = causal ? w.kw0 - q_off : 0;
  w.wq_hi = window > 0 ? min(Sq, min(w.kw0 + 64, Sk) - 1 + window - q_off)
                       : Sq;
  w.q_begin = q_begin;
  w.n_q = n_q;
  w.n_iter = n_iter;
  w.Sq = Sq;
  w.Sk = Sk;
  w.q_off = q_off;
  w.lane = lane;
  w.mask = mask;
  w.scale_log2 = scale_log2;
  w.scale = scale;
  w.k_addr = smem_u32(sm.own) + 64 * 16 * wg;
  w.v_addr = w.k_addr + L::kOwnBytes;
  if (n_iter > 0) mbar_wait(sm.own_bar, 0);

  const size_t head = static_cast<size_t>(bkv) * Sk * D;
  float dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dv_acc[i] = 0.f;
  if constexpr (kPasses == 1) {
    float dk_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = 0.f;
    dkv_pass<DP, TERMS, true, true>(dv_acc, dk_acc, w, 0);
    store_acc<DP>(dk + head, dk_acc, w.key, Sk, D, lane);
    store_acc<DP>(dv + head, dv_acc, w.key, Sk, D, lane);
  } else {
    dkv_pass<DP, TERMS, true, false>(dv_acc, dv_acc, w, 0);
    store_acc<DP>(dv + head, dv_acc, w.key, Sk, D, lane);
    float dk_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = 0.f;
    dkv_pass<DP, TERMS, false, true>(dk_acc, dk_acc, w, n_iter);
    store_acc<DP>(dk + head, dk_acc, w.key, Sk, D, lane);
  }
}

struct Ptrs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
};

template <int DP, int TERMS>
cudaError_t launch_dq(const Ptrs& p, const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, p.q, a.d, a.sq, a.bh, kBlockM) ||
      !make_map(&mdo, p.dout, a.d, a.sq, a.bh, kBlockM) ||
      !make_map(&mk, p.k, a.d, a.sk, a.bh / a.group, kBlockN) ||
      !make_map(&mv, p.v, a.d, a.sk, a.bh / a.group, kBlockN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_kernel_tc<DP, TERMS>;
  const int smem = static_cast<int>(Layout<DP>::kBytes);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = a.bh * ((a.sq + kBlockM - 1) / kBlockM);
  kernel<<<blocks, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(p.lse),
      static_cast<const float*>(p.delta), static_cast<__nv_bfloat16*>(p.dq),
      a.bh, a.sq, a.sk, a.d, a.group, a.mask, a.scale * kLog2e, a.scale);
  return cudaGetLastError();
}

template <int DP, int TERMS>
cudaError_t launch_dkv(const Ptrs& p, const Args& a, cudaStream_t stream) {
  const int bkv = a.bh / a.group;
  // with Sq == 0 no query map is made (or read): the kernel stores zeros
  CUtensorMap mq{}, mk, mv, mdo{};
  if (!make_map(&mk, p.k, a.d, a.sk, bkv, kBlockM) ||
      !make_map(&mv, p.v, a.d, a.sk, bkv, kBlockM) ||
      (a.sq > 0 && (!make_map(&mq, p.q, a.d, a.sq, a.bh, kBlockN) ||
                    !make_map(&mdo, p.dout, a.d, a.sq, a.bh, kBlockN))))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_kernel_tc<DP, TERMS>;
  const int smem = static_cast<int>(Layout<DP, kTwoPass<DP>>::kBytes);
  cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = bkv * ((a.sk + kBlockM - 1) / kBlockM);
  kernel<<<blocks, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(p.lse),
      static_cast<const float*>(p.delta), static_cast<__nv_bfloat16*>(p.dk),
      static_cast<__nv_bfloat16*>(p.dv), bkv, a.sq, a.sk, a.d, a.group, a.mask,
      a.scale * kLog2e, a.scale);
  return cudaGetLastError();
}

// DP: the head dim rounded up to wgmma's k16 (the zero columns past D come
// from TMA's out-of-bounds fill and add nothing)
#define DISPATCH_DP(d, CALL)                                   \
  switch (((d) + 15) / 16) {                                   \
    case 1: { constexpr int DP = 16; return CALL; }            \
    case 2: { constexpr int DP = 32; return CALL; }            \
    case 3: { constexpr int DP = 48; return CALL; }            \
    case 4: { constexpr int DP = 64; return CALL; }            \
    case 5: { constexpr int DP = 80; return CALL; }            \
    case 6: { constexpr int DP = 96; return CALL; }            \
    case 7: { constexpr int DP = 112; return CALL; }           \
    case 8: { constexpr int DP = 128; return CALL; }           \
    default: return cudaErrorInvalidValue;                     \
  }

template <int TERMS>
cudaError_t dispatch_dq(const Ptrs& p, const Args& a, cudaStream_t s) {
  DISPATCH_DP(a.d, (launch_dq<DP, TERMS>(p, a, s)))
}

template <int TERMS>
cudaError_t dispatch_dkv(const Ptrs& p, const Args& a, cudaStream_t s) {
  DISPATCH_DP(a.d, (launch_dkv<DP, TERMS>(p, a, s)))
}

// The controls of phase 3 and the card tests: other term counts at the
// head dims the main paths use (DiT 72 -> 80, qwen3 128), both kernels
template <int TERMS>
cudaError_t dispatch_control(const Ptrs& p, const Args& a, cudaStream_t s) {
  cudaError_t err;
  switch ((a.d + 15) / 16) {
    case 5:
      err = launch_dq<80, TERMS>(p, a, s);
      return err != cudaSuccess ? err : launch_dkv<80, TERMS>(p, a, s);
    case 8:
      err = launch_dq<128, TERMS>(p, a, s);
      return err != cudaSuccess ? err : launch_dkv<128, TERMS>(p, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace

// The route both entry points take: 1 for the tensor-core kernels (bf16
// with d % 8 == 0), 0 for the f32-FMA ones.
extern "C" int flash_attention_bwd_route(int dtype, int d) {
  return dtype == 1 && d % 8 == 0 ? 1 : 0;
}

// q, dout, dq: (bh, sq, d); k, v, dk, dv: (bh / group, sk, d).  lse and
// delta are f32 (bh, sq).  causal: 0 or 1; window: the sliding window, 0 for
// none.  dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs).
// The caller checks shapes, dtypes and contiguity; D % 4 == 0 and D <= 128;
// on the tensor-core route every operand starts on a 16-byte boundary.
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
  cudaError_t err;
  if (flash_attention_bwd_route(dtype, d))
    err = tc::dispatch_dq<tc::kBwdTerms>(
        tc::Ptrs{q, k, v, dout, lse, delta, dq, nullptr, nullptr}, a, s);
  else if (dtype == 1)
    err = dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, a, s);
  else
    err = dispatch_dq<float>(q, k, v, dout, lse, delta, dq, a, s);
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
  cudaError_t err;
  if (flash_attention_bwd_route(dtype, d))
    err = tc::dispatch_dkv<tc::kBwdTerms>(
        tc::Ptrs{q, k, v, dout, lse, delta, nullptr, dk, dv}, a, s);
  else if (dtype == 1)
    err = dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, a, s);
  else
    err = dispatch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, a, s);
  return (int)err;
}

// Both tensor-core kernels (dq, then dk and dv) with P and dS in `terms`
// bf16 terms (bf16 operands, d % 8 == 0): kBwdTerms, the entry points'; 1
// and 3 only for head dims 65-80 and 113-128, as controls of the numerics.
// Returns the first failing launch's CUDA error.
extern "C" int flash_attention_bwd_terms(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int bh,
                                         int sq, int sk, int d, int group,
                                         int causal, int window, float scale,
                                         int terms, void* stream) {
  if (!valid(bh, d, group, window) || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{bh, sq, sk, d, group, Mask{sq, sk, causal, window}, scale};
  const tc::Ptrs p{q, k, v, dout, lse, delta, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (terms) {
    case tc::kBwdTerms:
      err = tc::dispatch_dq<tc::kBwdTerms>(p, a, s);
      return (int)(err != cudaSuccess ? err
                                      : tc::dispatch_dkv<tc::kBwdTerms>(p, a, s));
    case 1: return (int)tc::dispatch_control<1>(p, a, s);
    case 3: return (int)tc::dispatch_control<3>(p, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
