// Flash attention forward for Hopper (sm_90a): non-causal, causal and
// sliding-window masks, grouped-query attention.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_fwd and its TPU
// body _fwd_kernel: o = softmax(q k^T * scale) v and the per-row logsumexp,
// for (BH, Sq, D) x (BKV, Sk, D) inputs in bf16 or f32, D % 4 == 0, D <= 128.
// Two kernels, routed by dtype and head dim (flash_attention_fwd_route):
// bf16 with D % 8 == 0 runs flash_fwd_kernel_tc on the tensor cores; f32,
// and bf16 with D % 8 != 0 (TMA needs 16-byte rows), run flash_fwd_kernel on
// the f32 FMA units.  Both keep _fwd_kernel's numerics: S in f32 from exact
// bf16 products, NEG_INF = -1e30 masking, the online (m, l, acc) with p in
// f32, the fully-masked-row guard, o = acc / l_safe, lse = m + log(l_safe).
//
// Masks and groups (_mask and the index_map of the TPU kernel).  Query
// positions are right-aligned to the keys, q_pos = row + Sk - Sq; causal
// keeps k <= q_pos and a window keeps k > q_pos - window.  Query head bh
// reads KV head bh / group, so K/V are never repeated in memory.  The KV
// loop's bounds skip every tile with no live entry for the block's rows (the
// TPU kernel's pl.when(live)): causal prefill visits about half the tiles of
// the non-causal form, a window about window / Sk of them.  The TPU kernel
// carried (acc, m, l) in VMEM scratch across a sequential grid axis over KV
// tiles; blocks here run in no order, so the KV axis is a loop in the block.
//
// Bound.  At the main paths' shapes (S 1024-2048, D 64-128) the work is
// 4 Sq Sk D flops per head (causal: the live half) against 8 S D bytes
// moved, far above the card's ridge: the bound is the bf16 tensor cores.
//
// flash_fwd_kernel_tc.  A block owns 128 query rows of one head: two
// consumer warpgroups of 64 rows and a producer warpgroup, which hands its
// registers to the consumers (setmaxnreg).  The producer's thread brings Q
// once and K/V tiles of 64 keys into a 2-stage ring with
// TMA (cp.async.bulk.tensor over a 3-D map (D, S, heads); out-of-bounds rows
// and the head dim's padding to a multiple of 16 arrive as zeros), and
// mbarriers report each tile full and, after both warpgroups' wgmmas read
// it, empty.  Tiles stay bf16 in shared memory, in wgmma's no-swizzle
// core-matrix layout (a TMA box is one 16-byte column chunk).  Per tile a
// warpgroup computes S = Q K^T with wgmma m64n64k16 (A and B from shared
// memory, f32 accumulate; products of bf16 values are exact in f32), scales
// and masks S in registers, updates (m, l) with l summed from the f32 p,
// and computes the tile's P V with wgmma m64nDk16, A from registers, V
// MN-major from shared memory.  Rounding P once to bf16 would move o by
// about 2e-3 relative L2; P goes in as TERMS bf16 terms (hi = bf16(p), mid
// = bf16(p - hi), lo = bf16(p - hi - mid)), whose sum is p to about 2^-24,
// so Sum_term term V, accumulated in f32, is the f32 p V of _fwd_kernel.
// That triples the P V work (8 Sq Sk D flops issued for 4 of the
// function's).  The tensor cores' f32 sums drop low bits toward zero, a
// bias that a running O accumulated over all the tiles in wgmma carries
// into o (on an H100, 1.3e-4 relative L2 against the plain version after
// the bf16 rounding at the DiT's shape, where this design reads 5e-5); so
// each tile's P V goes into a fresh accumulator, smallest terms first, and
// joins the running O with one rounded FMA (O = O alpha + PV).  Registers
// decide the geometry: 64-key tiles, and the consumers' 240 registers a
// thread (168 at entry; the producer drops to 24) hold O, a tile's P V and
// P's terms at D 128 without spilling.  Query tiles are launched heaviest
// first (causal work grows with the tile).
//
// flash_fwd_kernel (f32, and bf16 with D % 8 != 0).  One block of 8 warps
// owns 64 query rows of one head (8 rows per warp) and walks the keys in
// tiles of 64 staged in shared memory as f32.  Lane j of a warp owns keys j
// and j + 32 of the tile for the scores and dims j, j + 32, ... of the
// output rows, so the online softmax's row max and row sum are warp
// shuffles.  Ragged Sq / Sk are masked in the kernel: rows past the end
// load as zero, their scores are masked, their outputs are not stored.  It
// uses the f32 FMA units: q and k are read from shared memory as float4 so
// each 16-byte load feeds 4 to 8 FMAs, and the key rows use a stride of
// D + 4 floats so the 32 lanes' float4 loads hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tc.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 operands with D % 8 == 0.
// ---------------------------------------------------------------------------
namespace {
namespace tc {

using namespace sm90;   // TMA, mbarriers, wgmma (sm90_tc.cuh)

// The ring's tile and depth are build knobs (repro_torch.kernels.tuning,
// family "flash": fwd_block_n, fwd_stages), defined with -D by _build.
#ifndef FLASH_FWD_BLOCK_N
#define FLASH_FWD_BLOCK_N 64
#endif
#ifndef FLASH_FWD_STAGES
#define FLASH_FWD_STAGES 2
#endif
constexpr int kBlockM = 128;     // query rows per block: two warpgroups of 64
constexpr int kBlockN = FLASH_FWD_BLOCK_N;   // keys per tile
constexpr int kStages = FLASH_FWD_STAGES;    // K/V ring
// the scores' wgmma is m64 n64 and the softmax's lanes own 64-key rows, so
// the layout takes tiles of 64 keys only; the ring needs two stages to
// overlap, and four fit the shared memory at head dim 128 (Layout below)
static_assert(kBlockN == 64, "FLASH_FWD_BLOCK_N: the layout takes 64");
static_assert(kStages >= 2 && kStages <= 4, "FLASH_FWD_STAGES: 2 to 4");
constexpr int kConsumerWarps = 8;
constexpr int kThreads = (kConsumerWarps + 4) * 32;   // + the producer's group
// registers per thread after the split (setmaxnreg): the producer's
// warpgroup gives up what the consumers' accumulators need
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(kConsumerWarps * 32 * kConsumerRegs + 128 * kProducerRegs <=
              65536, "the register file");
constexpr float kLn2 = 0.69314718055994531f;
// the bf16 terms of P on flash_attention_fwd's path (kernels/flash_attention.py
// reads this line for TC_TERMS)
constexpr int kTcTerms = 3;

// Dynamic shared memory of a block: Q (DP/8 column chunks of 128 rows x 16
// bytes), then the K ring and the V ring (DP/8 chunks of 64 rows x 16 bytes
// a stage), then the barriers, all after an alignment pad.
template <int DP>
struct Layout {
  static constexpr int kChunks = DP / 8;
  static constexpr uint32_t kQBytes = kChunks * kBlockM * 16;
  static constexpr uint32_t kTileBytes = kChunks * kBlockN * 16;
  static constexpr uint32_t kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr uint32_t kBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "a block's shared memory (227 KB)");
};

template <int DP, int TERMS>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int BH, int Sq, int Sk, int D, int group, int causal,
                    int window, float scale_log2) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  uint8_t* sk = smem + L::kQBytes;
  uint8_t* sv = sk + kStages * L::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // heaviest query tiles first: causal work grows with the tile index
  const int n_qt = (Sq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kBlockM;
  const int q_off = Sk - Sq;      // right-aligned query positions

  // the block's key tiles: [t_begin, t_begin + n_tiles)
  const int q_last = min(q0 + kBlockM, Sq) - 1 + q_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int t_begin = window > 0 ? max(0, q0 + q_off - window + 1) / kBlockN : 0;
  const int n_tiles =
      k_end > 0 ? max(0, (k_end + kBlockN - 1) / kBlockN - t_begin) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // the producer: one thread keeps the TMA copies of the ring in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(sq + c * kBlockM * 16, &map_q, qbar, 8 * c, q0, bh);
      const int bkv = bh / group;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        const int k0 = (t_begin + i) * kBlockN;
        uint8_t* ks = sk + s * L::kTileBytes;
        uint8_t* vs = sv + s * L::kTileBytes;
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load(ks + c * kBlockN * 16, &map_k, &full[s], 8 * c, k0, bkv);
          tma_load(vs + c * kBlockN * 16, &map_v, &full[s], 8 * c, k0, bkv);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  // the consumers: warpgroup wg owns query rows [q0 + 64 wg, +64); thread
  // (w, lane) of it holds rows r0 = 16 w + lane / 4 and r0 + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1} of the accumulators (wgmma's layout)
  const int wg = warp / 4;
  const int w_row0 = q0 + 64 * wg;
  const int row = w_row0 + 16 * (warp % 4) + lane / 4;
  const int pos0 = row + q_off, pos1 = pos0 + 8;
  const int w_first = w_row0 + q_off;
  const int w_last = min(w_row0 + 64, Sq) - 1 + q_off;
  // the warpgroup's own live tiles (a causal diagonal or a window edge
  // may leave one warpgroup of the block without keys in a tile)
  int w_tb = 0, w_te = 0;
  if (w_row0 < Sq) {
    const int w_kend = causal ? min(Sk, w_last + 1) : Sk;
    w_tb = window > 0 ? max(0, w_first - window + 1) / kBlockN : 0;
    w_te = w_kend > 0 ? (w_kend + kBlockN - 1) / kBlockN : 0;
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) mbar_wait(qbar, 0);
  const uint32_t q_addr = smem_u32(sq) + 64 * 16 * wg;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, t = t_begin + i, k0 = t * kBlockN;
    mbar_wait(&full[s], (i / kStages) & 1);
    if (t >= w_tb && t < w_te) {
      // S = Q K^T: DP / 16 steps of k16 over the head dim
      const uint32_t k_addr = smem_u32(sk + s * L::kTileBytes);
      float sc[32];
      wg_fence();
      wgmma_scores<DP>(sc, q_addr, kBlockM, k_addr, kBlockN);
      wg_commit();
      wg_wait_all();
      pin_all(sc);

      // scale (log2 units) and mask: NEG_INF past Sk, above the causal
      // diagonal, outside the window; only tiles that need it are masked
      const bool masked = k0 + kBlockN > Sk ||
                          (causal && k0 + kBlockN - 1 > w_first) ||
                          (window > 0 && k0 < w_last - window + 1);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = sc[j] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
          const int pos = (j & 2) ? pos1 : pos0;
          const bool keep = key < Sk && (!causal || key <= pos) &&
                            (window <= 0 || key > pos - window);
          x = keep ? x : kNegInf;
        }
        sc[j] = x;
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
      }
      float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = ex2(m[r] - m_new);
        // fully-masked guard: a row with no live key so far keeps p == 0
        base[r] = m_new == kNegInf ? 0.f : m_new;
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        sc[j] = ex2(sc[j] - base[(j >> 1) & 1]);
        sum[(j >> 1) & 1] += sc[j];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];   // f32 p

      // P as TERMS bf16 terms: hi = bf16(p), mid = bf16(p - hi), ...; the
      // S accumulator's layout is the A fragment's (4 registers per k16)
      uint32_t pa[TERMS][4][4];
      split_terms(pa, sc);

      // the tile's P V = sum over terms of term V (keys kk * 16 .. + 15),
      // into a fresh accumulator, smallest terms first: the tensor cores'
      // f32 sums lose low bits toward zero, so the running O gets the
      // tile's sum with one rounded FMA, not a chain of tensor-core adds
      const uint32_t v_addr = smem_u32(sv + s * L::kTileBytes);
      float pv[DP / 2];
      wg_fence();
#pragma unroll
      for (int term = TERMS - 1; term >= 0; --term) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dv = desc(v_addr + kk * 256, 128, kBlockN * 16);
          if (term == TERMS - 1 && kk == 0)
            wgmma_rs_zero(pv, pa[term][kk], dv);
          else
            wgmma_rs(pv, pa[term][kk], dv);
        }
      }
      wg_commit();
      wg_wait_all();
      pin_all(pv);
#pragma unroll
      for (int term = 0; term < TERMS; ++term)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) pin(pa[term][kk][r]);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j)
        acc[j] = fmaf(acc[j], alpha[(j >> 1) & 1], pv[j]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);    // the slot may be refilled
  }

  // o = acc / l_safe and lse = m + log(l_safe), natural log; a row with
  // no live key stores o = 0 and lse = NEG_INF, as _fwd_kernel does
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int rr = row + 8 * r;
    if (rr >= Sq) continue;
    const float l_safe = l_row == 0.f ? 1.f : l_row;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * Sq + rr) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] / l_safe, acc[4 * j + 2 * r + 1] / l_safe);
    }
    if (lane % 4 == 0)
      lse[static_cast<size_t>(bh) * Sq + rr] =
          l_row == 0.f ? kNegInf : (m[r] + log2f(l_row)) * kLn2;
  }
}

template <int DP, int TERMS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, a.d, a.sq, a.bh, kBlockM) ||
      !make_map(&mk, k, a.d, a.sk, a.bh / a.group, kBlockN) ||
      !make_map(&mv, v, a.d, a.sk, a.bh / a.group, kBlockN))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel_tc<DP, TERMS>;
  const int smem = static_cast<int>(Layout<DP>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const double log2e = 1.4426950408889634;
  const int blocks = a.bh * ((a.sq + kBlockM - 1) / kBlockM);
  kernel<<<blocks, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      a.bh, a.sq, a.sk, a.d, a.group, a.causal, a.window,
      static_cast<float>(a.scale * log2e));
  return cudaGetLastError();
}

// DP: the head dim rounded up to wgmma's k16 (the zero columns past D come
// from TMA's out-of-bounds fill and add nothing to S or O)
template <int TERMS>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, const Args& a, cudaStream_t s) {
  switch ((a.d + 15) / 16) {
    case 1: return launch<16, TERMS>(q, k, v, o, lse, a, s);
    case 2: return launch<32, TERMS>(q, k, v, o, lse, a, s);
    case 3: return launch<48, TERMS>(q, k, v, o, lse, a, s);
    case 4: return launch<64, TERMS>(q, k, v, o, lse, a, s);
    case 5: return launch<80, TERMS>(q, k, v, o, lse, a, s);
    case 6: return launch<96, TERMS>(q, k, v, o, lse, a, s);
    case 7: return launch<112, TERMS>(q, k, v, o, lse, a, s);
    case 8: return launch<128, TERMS>(q, k, v, o, lse, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The controls of phase 3 and the card tests: fewer terms at the shapes
// whose head dims the main paths use (DiT 72 -> 80, qwen3 128)
template <int TERMS>
cudaError_t dispatch_control(const void* q, const void* k, const void* v,
                             void* o, void* lse, const Args& a,
                             cudaStream_t s) {
  switch ((a.d + 15) / 16) {
    case 5: return launch<80, TERMS>(q, k, v, o, lse, a, s);
    case 8: return launch<128, TERMS>(q, k, v, o, lse, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace

// q: (bh, sq, d); k, v: (bh / group, sk, d).  causal: 0 or 1; window: the
// sliding window, 0 for none.  dtype: 0 = float32, 1 = bfloat16.  The caller
// checks shapes, dtypes and contiguity; D % 4 == 0 and D <= 128; on the
// tensor-core route q, k and v start on 16-byte boundaries.  Returns the
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
  cudaError_t err;
  if (dtype == 1 && d % 8 == 0)
    err = tc::dispatch<tc::kTcTerms>(q, k, v, o, lse, a, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, lse, a, s);
  else
    err = dispatch<float>(q, k, v, o, lse, a, s);
  return (int)err;
}

// The route flash_attention_fwd takes: 1 for the tensor-core kernel, 0 for
// the f32-FMA one.
extern "C" int flash_attention_fwd_route(int dtype, int d) {
  return dtype == 1 && d % 8 == 0 ? 1 : 0;
}

// The tensor-core kernel with P in `terms` bf16 terms (bf16 operands, D % 8
// == 0): kTcTerms, flash_attention_fwd's; 1 and 2 only for head dims 65-80
// and 113-128, as controls of the numerics.  Returns the launch's CUDA
// error.
extern "C" int flash_attention_fwd_terms(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int bh, int sq, int sk, int d,
                                         int group, int causal, int window,
                                         float scale, int terms, void* stream) {
  if (d % 8 != 0 || d > 128 || d <= 0 || group <= 0 || bh % group != 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{bh, sq, sk, d, group, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (terms == tc::kTcTerms)
    return (int)tc::dispatch<tc::kTcTerms>(q, k, v, o, lse, a, s);
  switch (terms) {
    case 1: return (int)tc::dispatch_control<1>(q, k, v, o, lse, a, s);
    case 2: return (int)tc::dispatch_control<2>(q, k, v, o, lse, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
