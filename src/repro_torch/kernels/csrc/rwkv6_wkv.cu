// RWKV6 ("Finch") WKV recurrence, forward and backward, for Hopper (sm_90a).
//
// The forward replaces repro/kernels/rwkv6_scan.py::rwkv6_wkv_pallas and its
// TPU body _wkv_kernel.  Per batch x head, with decay_t = exp(-exp(w_t)):
//
//   out_t = r_t . (S + diag(u) k_t v_t^T)        (a row of Dv)
//   S     = diag(decay_t) S + k_t v_t^T          (Dk x Dv, f32)
//
// r, k, v: (BH, T, Dk / Dv) in bf16 or f32 (one dtype); w: (BH, T, Dk) f32
// decay logits; u: (H, Dk) f32, row bh % H; s0: (BH, Dk, Dv) f32.  Writes
// out (BH, T, Dv) in v's dtype and the final state s_T (BH, Dk, Dv) f32.
// The kernels take Dk <= 64 and Dk, Dv multiples of 8 (rows of 16 bytes
// or more, for the bulk copies); the wrapper pads other head dims.
//
// The recurrence stays sequential in f32 on the CUDA cores: the chunked
// "linear attention" form's decay ratios exp(cumlog) overflow f32 within
// two steps at the model's clip (w <= 4, log decay = -e^4 = -54.6 a step),
// and the state is a sum of rank-one updates with no tensor-core product.
// The TPU kernel carried the state in VMEM across a sequential grid axis
// over T-chunks; blocks here run in no order, so the T loop is inside the
// block, and the state is split over many blocks to fill the card.
//
// Forward (wkv_fwd_colgroup_kernel).  Column j of S and out_t,j depend on
// column j alone, so a block owns kFwdCols = 32 columns of one batch x
// head: grid (BH, ceil(Dv / 32)), 128 threads; 256 blocks at rwkv6-1.6b's
// prefill (BH 128) and 128 at its training shape (BH 64), one wave on 132
// SMs.  Thread (warp w, lane l) walks columns c0 = 2 (4 w + l / 8) and
// c0 + 1 and holds 8 of their rows in registers, 4 g .. 4 g + 3 and 32 +
// 4 g .. 32 + 4 g + 3 with g = l % 8 (see load_split).  A step costs it 16
// FMAs for its parts of r.S (four chains) and 16 MUL + 16 FMA for the
// update, against 6 shared loads of r, k and decay: two columns a lane
// halve the shared-memory traffic per FMA, which bounded a first design
// with one column a lane.  The 8 lanes of a column sum their parts by a
// transpose-reduce over 8 steps: after 8 steps each lane holds 8 partials
// a column, and three shuffle rounds (xor 4, 2, 1; 4 + 2 + 1 values) leave
// lane g with the whole sum of step g, so the sums of 8 steps cost 7
// shuffles a column and overlap the next steps' updates.  The bonus term
// is computed in its O(Dk) form, b_t = r_t.(u*k_t), by 8 threads a step
// while the chunk is converted: out_tj = sum_i r_ti S_ij + v_tj b_t.
//
// Staging.  kChunk = 16 steps of r, k, w and v come by cp.async.bulk into a
// raw stage reported to an mbarrier; the block converts them to f32 (r, k,
// decay = exp(-exp(w)), v) in shared memory and at once starts the next
// chunk's copies, which land while the current chunk computes.  Both
// column blocks of a batch x head read all Dk rows of r, k and w and
// convert them: at the prefill shape that is 2 x 640 B a step per batch x
// head, about 0.34 GB of L2 reads per call (half of them from DRAM), which
// L2 serves in about 0.06 ms at its ~5.5 TB/s spread over the call, and 2
// expf per decay, about 5 instructions a thread a step beside the step's
// ~60: less than a cluster's multicast and barriers would cost, so each
// block reads and converts for itself.
//
// Checkpoints.  For the backward, the forward can also write the state at
// the start of every chunk, ckpt (BH, ceil(T / kChunk), Dk, Dv) f32,
// through a pointer that is null when nothing needs a gradient (the serving
// path); each block writes its own columns.
//
// Bound.  At rwkv6-1.6b's prefill (BH 128, T 2048, Dk = Dv = 64) the
// function needs 5 flops per state element per step (r.S and d*S + k v^T)
// plus 3 Dk + 2 Dv for the bonus term: 5.45 GFLOP on the f32 units, 0.081
// ms at 67 TFLOP/s, against about 200 MB of streams (0.06 ms).
//
// Backward (wkv_bwd_rowgroup_kernel).  JAX has no kernel for it: it
// differentiates its oracle (repro/kernels/ops.py::_wkv_bwd, jax.vjp of
// ref.rwkv6_wkv).  Walking back from G = dL/dS_T (dsT, or 0), with S_{t-1}
// the state before step t, b_t = r_t.(u*k_t) and c_t = v_t.dout_t:
//
//   dr_t = S_{t-1} dout_t + (u*k_t) c_t       dk_t = G v_t + (u*r_t) c_t
//   dv_t = G^T k_t + b_t dout_t               du  += r_t*k_t c_t
//   dw_t = -rowsum(G * S_{t-1}) * decay_t * exp(w_t)
//   G    = diag(decay_t) G + r_t dout_t^T        (then ds0 = G)
//
// Row i of S and of G, and dr, dk, dw, du at row i, depend on row i alone;
// only dv_t (a sum over all rows) crosses rows.  So a block owns kBwdRows =
// 16 rows (Dk padded to 64) of one batch x head: grid (BH, 4), 128
// threads, 256 blocks at the training shape (BH 64), two an SM, one wave.
// Thread (warp w, lane l) holds row 4 w + l / 8 of the block, columns 4 q ..
// 4 q + 3 and 32 + 4 q .. 32 + 4 q + 3 with q = l % 8 (see load_split), of
// G in registers.  dr, dk and the dw row sum are sums over the 8 lanes of a
// row: one transpose-reduce of the three (4 shuffles) leaves dr, dk and dw
// in lanes 0, 2 and 4 of the row.  dv: each lane's 8 products G_ij k_i are
// summed over the warp's 4 rows by a transpose-reduce (6 shuffles) into 2
// columns per lane, kept per warp in shared memory for the chunk; at the
// chunk's end the block sums its 4 warps in order, adds its part of b_t
// dout_t and writes the sum as f32, (BH, 4, T, Dv); a second pass
// (wkv_bwd_dv_sum_kernel) sums the 4 row groups in order 0, 1, 2, 3 and
// rounds dv once.  That costs 134 MB written and read at the training shape,
// about 0.08 ms at 3.35 TB/s.  A first form summed the row groups inside a
// thread-block cluster of the 4 blocks through distributed shared memory
// instead, but the card held 62 such clusters at once (CUDA's
// cudaOccupancyMaxActiveClusters on the H100), fewer than the 64 of the
// training shape, so the last ones ran in a second wave.  The chunk loops
// always run kChunk steps, fully known to the compiler, so it interleaves
// one step's shuffle chains with the next step's FMAs (a dead step of the
// ragged last chunk has r = k = 0 and decay 1: it keeps S and G).
//
// S_{t-1} is never recovered by dividing by decay_t (at the model's clip it
// is exp(-54.6), about 2e-24): each chunk's 16 states are recomputed from
// the forward's checkpoint into shared memory (64 KB a block: each thread
// reads back only what it wrote), then read back in reverse.  While a chunk
// computes, the one before is staged: v and dout of all columns by
// cp.async.bulk into shared memory, r, k, w of the block's rows and the
// checkpoint by loads into registers (a first form's per-step bulk copies of
// the rows, 48 a chunk, ran one lane after another and held the
// block up).  du is written as
// per-(batch, head) partials that the wrapper sums over the batch in a fixed
// order.  No float atomics anywhere, every sum in a fixed order: two runs are
// bitwise equal.  Bound: 12 flops per state element per step (five
// multiply-adds in the walk back: dr, dk, the row sum, the dv term and the G
// update; one in the recompute) against 5 streams of (BH, T, 64) in and 4
// out: operation-bound, 0.098 ms at the training shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tc.cuh"

namespace {

using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int kChunk = 16;      // steps per staged chunk and per checkpoint
constexpr int kRows = 64;       // Dk, padded
constexpr int kMaxDv = 128;     // the forward's largest Dv
constexpr int kThreads = 128;
constexpr int kFwdCols = 32;    // state columns per forward block
constexpr int kBwdRows = 16;    // state rows per backward block
constexpr int kBwdGroups = kRows / kBwdRows;   // the backward's row groups
constexpr int kBwdCols = 64;    // the backward's Dv, padded
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive elements at p (16-byte aligned) as f32, or zeros.
__device__ __forceinline__ void load8(const float* p, bool live, float (&x)[8]) {
  const float4 a = live ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 b = live ? *reinterpret_cast<const float4*>(p + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, bool live, float (&x)[8]) {
  const uint4 a = live ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    x[2 * m] = __uint_as_float(w[m] << 16);
    x[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
}
// Four elements at p and four at p + 32 (f32, 16-byte aligned): a lane's
// two quads of a 64-wide row.  Lane g of 8 takes quads g and 8 + g, so the
// 8 lanes of a quarter warp read 128 contiguous bytes per load, free of
// bank conflicts (quads 2g, 2g + 1 would put lanes g and g + 4 on the same
// banks).
__device__ __forceinline__ void load_split(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 32);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// One contiguous global -> shared copy by the bulk-copy engine, counted in
// bytes on `bar` (both addresses 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory reads before the bulk copies
// it starts next into the same bytes.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The forward's column sums: lane g of 8 (lanes xor 1, 2, 4) holds p[s],
// its part of step s's sum, for s = 0..7; returns the 8 lanes' total of
// step g.  Each round keeps half of the values and adds the partner's
// copy of them, in a fixed order.
__device__ __forceinline__ float transpose_sum8(const float (&p)[8], int g) {
  const bool h2 = g & 4, h1 = g & 2, h0 = g & 1;
  float a[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float keep = h2 ? p[m + 4] : p[m], send = h2 ? p[m] : p[m + 4];
    a[m] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  float b[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float keep = h1 ? a[m + 2] : a[m], send = h1 ? a[m] : a[m + 2];
    b[m] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  const float keep = h0 ? b[1] : b[0], send = h0 ? b[0] : b[1];
  return keep + __shfl_xor_sync(kFull, send, 1);
}

// The backward's row sums: three quantities over the 8 lanes of a row
// (lanes xor 1, 2, 4, lane index q = l % 8).  Returns the total of
// quantity q / 2: lanes 0-1 dr's, 2-3 dk's, 4-5 dw's (6-7 zero).
__device__ __forceinline__ float transpose_sum3(float a0, float a1, float a2,
                                                int q) {
  const bool h2 = q & 4, h1 = q & 2;
  const float k0 = h2 ? a2 : a0, s0 = h2 ? a0 : a2;
  const float k1 = h2 ? 0.f : a1, s1 = h2 ? a1 : 0.f;
  const float b0 = k0 + __shfl_xor_sync(kFull, s0, 4);
  const float b1 = k1 + __shfl_xor_sync(kFull, s1, 4);
  const float keep = h1 ? b1 : b0, send = h1 ? b0 : b1;
  const float c = keep + __shfl_xor_sync(kFull, send, 2);
  return c + __shfl_xor_sync(kFull, c, 1);
}

// The backward's column sums over a warp's 4 rows (lanes xor 8, 16; rs =
// l / 8): p[m] is this lane's value of column 4 q + m (m < 4) or 28 + 4 q +
// m; returns the warp's sums of p[4 (rs / 2) + 2 (rs % 2) + {0, 1}].
__device__ __forceinline__ float2 transpose_sum_cols(const float (&p)[8],
                                                     int rs) {
  const bool h1 = rs & 2, h0 = rs & 1;
  float a[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float keep = h1 ? p[m + 4] : p[m], send = h1 ? p[m] : p[m + 4];
    a[m] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  const float k0 = h0 ? a[2] : a[0], s0 = h0 ? a[0] : a[2];
  const float k1 = h0 ? a[3] : a[1], s1 = h0 ? a[1] : a[3];
  return make_float2(k0 + __shfl_xor_sync(kFull, s0, 8),
                     k1 + __shfl_xor_sync(kFull, s1, 8));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv_fwd_colgroup_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ s0, T* __restrict__ out,
                        float* __restrict__ sT, float* __restrict__ ckpt,
                        int T_len, int H, int Dk, int Dv) {
  __shared__ __align__(128) T raw_r[kChunk * kRows];
  __shared__ __align__(128) T raw_k[kChunk * kRows];
  __shared__ __align__(128) float raw_w[kChunk * kRows];
  __shared__ __align__(128) T raw_v[kChunk * kMaxDv];
  __shared__ __align__(16) float sr[kChunk * kRows];
  __shared__ __align__(16) float sk[kChunk * kRows];
  __shared__ __align__(16) float sd[kChunk * kRows];     // decay
  __shared__ __align__(16) float sv[kChunk * kFwdCols];  // the block's columns
  __shared__ float sb[kChunk];                           // r.(u*k)
  __shared__ __align__(16) float so[kChunk * kFwdCols];  // out, before rounding
  __shared__ __align__(8) uint64_t bar;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, j0 = blockIdx.y * kFwdCols;
  const int c0 = 2 * (warp * 4 + (lane >> 3));   // its columns c0, c0 + 1
  const int j = j0 + c0;
  const int g = lane & 7;                   // its rows: row_of(m)
  const bool own = j < Dv;                  // Dv is even: j + 1 < Dv too
  const size_t tk = (size_t)bh * T_len * Dk, tv = (size_t)bh * T_len * Dv;
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const int ct = tid >> 3, cp = tid & 7;    // converts step ct, rows 8 cp..
  auto row_of = [g](int m) { return 4 * g + m + (m < 4 ? 0 : 28); };

  auto stage = [&](int c) {                 // thread 0: chunk c's inputs
    const int t0 = c * kChunk, n = min(kChunk, T_len - t0);
    const uint32_t bk = n * Dk * sizeof(T), bw = n * Dk * 4,
                   bv = n * Dv * sizeof(T);
    fence_async_shared();
    mbar_expect_tx(&bar, 2 * bk + bw + bv);
    bulk_load(raw_r, r + tk + (size_t)t0 * Dk, bk, &bar);
    bulk_load(raw_k, k + tk + (size_t)t0 * Dk, bk, &bar);
    bulk_load(raw_w, w + tk + (size_t)t0 * Dk, bw, &bar);
    bulk_load(raw_v, v + tv + (size_t)t0 * Dv, bv, &bar);
  };
  if (tid == 0) {
    init_barrier(&bar);
    stage(0);
  }

  float uc[8];                              // u at the rows it converts
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = cp * 8 + m;
    uc[m] = i < Dk ? u[(size_t)(bh % H) * Dk + i] : 0.f;
  }
  float S0[8], S1[8];                       // columns c0 and c0 + 1
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = row_of(m);
    const float2 x = own && i < Dk
        ? *reinterpret_cast<const float2*>(s0 + ((size_t)bh * Dk + i) * Dv + j)
        : make_float2(0.f, 0.f);
    S0[m] = x.x;
    S1[m] = x.y;
  }
  __syncthreads();                          // the barrier is initialised

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T_len - t0);
    if (ckpt != nullptr && own) {           // the state before step t0
      float* cq = ckpt + ((size_t)bh * n_chunks + c) * Dk * Dv + j;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (row_of(m) < Dk)
          *reinterpret_cast<float2*>(cq + (size_t)row_of(m) * Dv) =
              make_float2(S0[m], S1[m]);
    }
    mbar_wait(&bar, c & 1);
    {                                       // convert: step ct, rows 8 cp..
      const bool live = ct < n && cp * 8 < Dk;
      float rr[8], kk[8], ww[8];
      load8(raw_r + ct * Dk + cp * 8, live, rr);
      load8(raw_k + ct * Dk + cp * 8, live, kk);
      load8(raw_w + ct * Dk + cp * 8, live, ww);
      float b = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        b = fmaf(rr[m] * uc[m], kk[m], b);
        ww[m] = live ? expf(-expf(ww[m])) : 1.f;   // a dead step keeps S
      }
      store8(sr + ct * kRows + cp * 8, rr);
      store8(sk + ct * kRows + cp * 8, kk);
      store8(sd + ct * kRows + cp * 8, ww);
      b += __shfl_xor_sync(kFull, b, 1);
      b += __shfl_xor_sync(kFull, b, 2);
      b += __shfl_xor_sync(kFull, b, 4);
      if (cp == 0) sb[ct] = b;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = cp * 4 + e;
        sv[ct * kFwdCols + cc] = ct < n && j0 + cc < Dv
            ? to_f32(raw_v[ct * Dv + j0 + cc]) : 0.f;
      }
    }
    __syncthreads();                        // converted; the raw stage is free
    if (tid == 0 && c + 1 < n_chunks) stage(c + 1);

#pragma unroll 1
    for (int h = 0; h < n; h += 8) {        // 8 steps, then their sums
      float p0[8], p1[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int t = h + q;
        float rr[8], kk[8], dd[8];
        load_split(sr + t * kRows + 4 * g, rr);
        load_split(sk + t * kRows + 4 * g, kk);
        load_split(sd + t * kRows + 4 * g, dd);
        const float2 vj = *reinterpret_cast<const float2*>(sv + t * kFwdCols + c0);
        float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
        for (int m = 0; m < 8; m += 2) {
          a0 = fmaf(rr[m], S0[m], a0);
          a1 = fmaf(rr[m + 1], S0[m + 1], a1);
          b0 = fmaf(rr[m], S1[m], b0);
          b1 = fmaf(rr[m + 1], S1[m + 1], b1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            S0[m + e] = fmaf(dd[m + e], S0[m + e], kk[m + e] * vj.x);
            S1[m + e] = fmaf(dd[m + e], S1[m + e], kk[m + e] * vj.y);
          }
        }
        p0[q] = a0 + a1;
        p1[q] = b0 + b1;
      }
      const float sum0 = transpose_sum8(p0, g), sum1 = transpose_sum8(p1, g);
      const int t = h + g;
      const float2 vj = *reinterpret_cast<const float2*>(sv + t * kFwdCols + c0);
      *reinterpret_cast<float2*>(so + t * kFwdCols + c0) =
          make_float2(fmaf(vj.x, sb[t], sum0), fmaf(vj.y, sb[t], sum1));
    }
    __syncthreads();                        // the chunk's outputs are in so
    for (int e = tid; e < n * kFwdCols; e += kThreads) {
      const int t = e / kFwdCols, jj = j0 + e % kFwdCols;
      if (jj < Dv) out[tv + (size_t)(t0 + t) * Dv + jj] = from_f32<T>(so[e]);
    }
  }
  if (own) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (row_of(m) < Dk)
        *reinterpret_cast<float2*>(sT + ((size_t)bh * Dk + row_of(m)) * Dv + j) =
            make_float2(S0[m], S1[m]);
  }
}

// The backward's dynamic shared memory: the recomputed states of a chunk,
// float4 [kChunk][2][kThreads] (each thread's 8 values, two quads).  Its
// other buffers are static arrays, so the compiler knows that none of
// them aliases another and moves a step's loads above the previous step's
// stores.
constexpr size_t kBwdHistBytes = (size_t)kChunk * 2 * kThreads * 16;

// A row pair's r or k as f32 (r/k at p, 8-byte or 4-byte aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv_bwd_rowgroup_kernel(const T* __restrict__ r, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ w,
                        const float* __restrict__ u,
                        const float* __restrict__ ckpt,
                        const T* __restrict__ dout,
                        const float* __restrict__ dsT, T* __restrict__ dr,
                        T* __restrict__ dk, float* __restrict__ dv_part,
                        float* __restrict__ dw, float* __restrict__ du_part,
                        float* __restrict__ ds0, int T_len, int H, int Dk,
                        int Dv) {
  extern __shared__ __align__(128) float4 hist[];
  __shared__ __align__(16) float4 rows[kChunk * kBwdRows];  // r, k, decay, exp(w)
  __shared__ __align__(16) float sv[kChunk * kBwdCols];
  __shared__ __align__(16) float sdo[kChunk * kBwdCols];
  __shared__ __align__(16) float swp[kChunk * 4 * kBwdCols];   // [t][warp][col]
  __shared__ float sout[3 * kChunk * kBwdRows];               // [3][t][row]
  __shared__ float sc[kChunk], sbp[kChunk];                   // v.dout, r.(u*k)
  __shared__ __align__(128) T raw_v[kChunk * kBwdCols];
  __shared__ __align__(128) T raw_do[kChunk * kBwdCols];
  __shared__ __align__(8) uint64_t bar;

  const int rg = blockIdx.y;                  // the row group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, row0 = rg * kBwdRows;
  const int lr = warp * 4 + (lane >> 3);      // the block row it holds
  const int i = row0 + lr, q = lane & 7;      // columns col_of(m)
  const bool row = i < Dk;
  const size_t tk = (size_t)bh * T_len * Dk, tv = (size_t)bh * T_len * Dv;
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const int ct = tid >> 3, cp = tid & 7;      // converts step ct, rows 2 cp..
  const bool crow = row0 + 2 * cp < Dk;       // (Dk is even: both rows)

  auto stage = [&](int c) {                   // thread 0: chunk c's v, dout
    const int t0 = c * kChunk, n = min(kChunk, T_len - t0);
    const uint32_t bv = n * Dv * sizeof(T);
    fence_async_shared();
    mbar_expect_tx(&bar, 2 * bv);
    bulk_load(raw_v, v + tv + (size_t)t0 * Dv, bv, &bar);
    bulk_load(raw_do, dout + tv + (size_t)t0 * Dv, bv, &bar);
  };
  // r, k and w of the rows it converts, step ct of chunk c, into registers
  float2 pre_r, pre_k, pre_w;
  auto prefetch_rows = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, T_len - t0);
    const bool live = ct < n && crow;
    const size_t o = tk + (size_t)(t0 + (live ? ct : 0)) * Dk + row0 + 2 * cp;
    const float2 z = make_float2(0.f, 0.f);
    pre_r = live ? load2(r + o) : z;
    pre_k = live ? load2(k + o) : z;
    pre_w = live ? load2(w + o) : z;
  };
  if (tid == 0) {
    init_barrier(&bar);
    stage(n_chunks - 1);
  }
  prefetch_rows(n_chunks - 1);

  const float ui = row ? u[(size_t)(bh % H) * Dk + i] : 0.f;
  const float2 uc = crow ? load2(u + (size_t)(bh % H) * Dk + row0 + 2 * cp)
                         : make_float2(0.f, 0.f);
  auto col_of = [q](int m) { return 4 * q + m + (m < 4 ? 0 : 28); };
  const bool cols = row && 4 * q < Dv, cols_hi = row && 32 + 4 * q < Dv;
  float G[8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
    G[m] = row && col_of(m) < Dv && dsT != nullptr
        ? dsT[((size_t)bh * Dk + i) * Dv + col_of(m)] : 0.f;
  float du_acc = 0.f;
  const int rs = lane >> 3;
  const int colbase = col_of(4 * (rs >> 1) + 2 * (rs & 1));
  // row i of the checkpoint of chunk c, in col_of order
  auto load_ckpt = [&](int c, float (&S)[8]) {
    const float* cq = ckpt + (((size_t)bh * n_chunks + c) * Dk + (row ? i : 0)) * Dv + 4 * q;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = cols ? *reinterpret_cast<const float4*>(cq) : z;
    const float4 b = cols_hi ? *reinterpret_cast<const float4*>(cq + 32) : z;
    S[0] = a.x; S[1] = a.y; S[2] = a.z; S[3] = a.w;
    S[4] = b.x; S[5] = b.y; S[6] = b.z; S[7] = b.w;
  };
  float S_next[8];
  load_ckpt(n_chunks - 1, S_next);
  __syncthreads();                            // the barrier is initialised

  for (int it = 0; it < n_chunks; ++it) {
    const int c = n_chunks - 1 - it, t0 = c * kChunk;
    const int n = min(kChunk, T_len - t0);
    float S[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) S[m] = S_next[m];
    {                                         // convert step ct: its rows
      const float ew0 = expf(pre_w.x), ew1 = expf(pre_w.y);
      const bool live = ct < n && crow;       // a dead step keeps S and G
      rows[ct * kBwdRows + 2 * cp] =
          make_float4(pre_r.x, pre_k.x, live ? expf(-ew0) : 1.f, live ? ew0 : 0.f);
      rows[ct * kBwdRows + 2 * cp + 1] =
          make_float4(pre_r.y, pre_k.y, live ? expf(-ew1) : 1.f, live ? ew1 : 0.f);
      float b = fmaf(pre_r.x * uc.x, pre_k.x, pre_r.y * uc.y * pre_k.y);
      b += __shfl_xor_sync(kFull, b, 1);
      b += __shfl_xor_sync(kFull, b, 2);
      b += __shfl_xor_sync(kFull, b, 4);
      if (cp == 0) sbp[ct] = b;
    }
    mbar_wait(&bar, it & 1);
    {                                         // and its v, dout
      const bool live_c = ct < n && cp * 8 < Dv;
      float vv[8], oo[8];
      load8(raw_v + ct * Dv + cp * 8, live_c, vv);
      load8(raw_do + ct * Dv + cp * 8, live_c, oo);
      float cc = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) cc = fmaf(vv[m], oo[m], cc);
      store8(sv + ct * kBwdCols + cp * 8, vv);
      store8(sdo + ct * kBwdCols + cp * 8, oo);
      cc += __shfl_xor_sync(kFull, cc, 1);
      cc += __shfl_xor_sync(kFull, cc, 2);
      cc += __shfl_xor_sync(kFull, cc, 4);
      if (cp == 0) sc[ct] = cc;
    }
    __syncthreads();                          // converted; the raw stage is free
    if (c > 0) {                              // these land while this chunk runs
      if (tid == 0) stage(c - 1);
      prefetch_rows(c - 1);
      load_ckpt(c - 1, S_next);
    }

    // recompute the chunk's states from its checkpoint: hist[t] = S_{t-1}
    // of step t0 + t, this thread's row and columns (dead steps included:
    // they keep S)
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      hist[(2 * t) * kThreads + tid] = make_float4(S[0], S[1], S[2], S[3]);
      hist[(2 * t + 1) * kThreads + tid] = make_float4(S[4], S[5], S[6], S[7]);
      const float4 x = rows[t * kBwdRows + lr];
      float vv[8];
      load_split(sv + t * kBwdCols + 4 * q, vv);
#pragma unroll
      for (int m = 0; m < 8; ++m) S[m] = fmaf(x.z, S[m], x.y * vv[m]);
    }
    // walk back through the chunk
#pragma unroll 4
    for (int t = kChunk - 1; t >= 0; --t) {
      const float4 h0 = hist[(2 * t) * kThreads + tid];
      const float4 h1 = hist[(2 * t + 1) * kThreads + tid];
      const float Sp[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      const float4 x = rows[t * kBwdRows + lr];       // r, k, decay, exp(w)
      float vv[8], oo[8];
      load_split(sv + t * kBwdCols + 4 * q, vv);
      load_split(sdo + t * kBwdCols + 4 * q, oo);
      const float cct = sc[t];
      float pr = 0.f, pk = 0.f, pw = 0.f, pv[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        pr = fmaf(Sp[m], oo[m], pr);
        pk = fmaf(G[m], vv[m], pk);
        pw = fmaf(G[m], Sp[m], pw);
        pv[m] = G[m] * x.y;
        G[m] = fmaf(x.z, G[m], x.x * oo[m]);
      }
      const float tot = transpose_sum3(pr, pk, pw, q);
      const float2 cs = transpose_sum_cols(pv, rs);
      *reinterpret_cast<float2*>(swp + (t * 4 + warp) * kBwdCols + colbase) = cs;
      const int which = q >> 1;               // lanes 0, 2, 4 of the row
      const float val = which == 0 ? fmaf(ui * x.y, cct, tot)
                      : which == 1 ? fmaf(ui * x.x, cct, tot)
                                   : -tot * x.z * x.w;
      if ((q & 1) == 0 && q < 6) sout[(which * kChunk + t) * kBwdRows + lr] = val;
      du_acc = fmaf(x.x * x.y, cct, du_acc);
    }
    __syncthreads();                          // the chunk's partials are in
    float* part = dv_part + ((size_t)(bh * kBwdGroups + rg) * T_len + t0) * Dv;
    for (int e = tid; e < kChunk * kBwdCols; e += kThreads) {
      const int t = e / kBwdCols, col = e % kBwdCols;
      if (t < n && col < Dv) {                // the block's rows, warps in order
        const float* p = swp + t * 4 * kBwdCols + col;
        part[(size_t)t * Dv + col] = fmaf(
            sbp[t], sdo[e],
            ((p[0] + p[kBwdCols]) + p[2 * kBwdCols]) + p[3 * kBwdCols]);
      }
    }
    __syncthreads();                          // sbp and sdo are free again
    for (int e = tid; e < 3 * kChunk * kBwdRows; e += kThreads) {
      const int which = e / (kChunk * kBwdRows);
      const int t = (e / kBwdRows) % kChunk, lrow = e % kBwdRows;
      if (t < n && row0 + lrow < Dk) {
        const size_t o = tk + (size_t)(t0 + t) * Dk + row0 + lrow;
        if (which == 0) dr[o] = from_f32<T>(sout[e]);
        else if (which == 1) dk[o] = from_f32<T>(sout[e]);
        else dw[o] = sout[e];
      }
    }
  }
  if (row) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
      if (col_of(m) < Dv) ds0[((size_t)bh * Dk + i) * Dv + col_of(m)] = G[m];
    if (q == 0) du_part[(size_t)bh * Dk + i] = du_acc;
  }
}

// dv from the row groups' partials (BH, kBwdGroups, T, Dv) f32, summed in
// order 0, 1, 2, 3 and rounded once; four elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
wkv_bwd_dv_sum_kernel(const float* __restrict__ dv_part, T* __restrict__ dv,
                      int T_len, int Dv, size_t quads) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= quads) return;
  const size_t per_bh = (size_t)T_len * Dv / 4;
  const size_t bh = e / per_bh, rest = e - bh * per_bh;
  const float4* p = reinterpret_cast<const float4*>(dv_part)
                    + bh * kBwdGroups * per_bh + rest;
  float4 a = p[0];
#pragma unroll
  for (int g = 1; g < kBwdGroups; ++g) {
    const float4 b = p[g * per_bh];
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  T* o = dv + e * 4;
  o[0] = from_f32<T>(a.x);
  o[1] = from_f32<T>(a.y);
  o[2] = from_f32<T>(a.z);
  o[3] = from_f32<T>(a.w);
}

template <typename T>
cudaError_t launch_fwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s0, void* out,
                       void* sT, void* ckpt, int bh, int t, int h, int dk,
                       int dv, cudaStream_t stream) {
  const dim3 grid(bh, (dv + kFwdCols - 1) / kFwdCols);
  wkv_fwd_colgroup_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sT),
      static_cast<float*>(ckpt), t, h, dk, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t prepare_bwd() {
  auto kernel = wkv_bwd_rowgroup_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBwdHistBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* ckpt,
                       const void* dout, const void* dsT, void* dr, void* dk,
                       void* dv, void* dw, void* du_part, void* ds0,
                       void* dv_part, int bh, int t, int h, int dkd, int dvd,
                       cudaStream_t stream) {
  cudaError_t err = prepare_bwd<T>();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, kBwdGroups);
  wkv_bwd_rowgroup_kernel<T><<<grid, kThreads, kBwdHistBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(ckpt),
      static_cast<const T*>(dout), static_cast<const float*>(dsT),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<float*>(dv_part),
      static_cast<float*>(dw), static_cast<float*>(du_part),
      static_cast<float*>(ds0), t, h, dkd, dvd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t quads = (size_t)bh * t * dvd / 4;
  wkv_bwd_dv_sum_kernel<T><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(dv_part), static_cast<T*>(dv), t, dvd, quads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_info(bool bwd, int bh, int dv, int* info) {
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t err;
  if (bwd) {
    err = prepare_bwd<T>();
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, wkv_bwd_rowgroup_kernel<T>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wkv_bwd_rowgroup_kernel<T>, kThreads, kBwdHistBytes);
    info[0] = bh; info[1] = kBwdGroups;
    info[3] = (int)(attr.sharedSizeBytes + kBwdHistBytes);
  } else {
    err = cudaFuncGetAttributes(&attr, wkv_fwd_colgroup_kernel<T>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wkv_fwd_colgroup_kernel<T>, kThreads, 0);
    info[0] = bh; info[1] = (dv + kFwdCols - 1) / kFwdCols;
    info[3] = (int)attr.sharedSizeBytes;
  }
  info[2] = kThreads;
  info[4] = blocks;
  return err;
}

bool shapes_ok(int bh, int t, int h, int dk, int dv, int max_dv) {
  return bh >= 1 && t >= 1 && h >= 1 && dk >= 8 && dk <= kRows &&
         dk % 8 == 0 && dv >= 8 && dv <= max_dv && dv % 8 == 0;
}

}  // namespace

extern "C" int rwkv6_wkv_chunk() { return kChunk; }

// dtype (of r, k, v and out): 0 = float32, 1 = bfloat16.  ckpt: null, or
// (bh, ceil(t / kChunk), dk, dv) f32 for the state at each chunk's start.
// The caller checks dtypes and contiguity and passes 16-byte aligned
// pointers; 8 <= dk <= 64 and 8 <= dv <= 128, both multiples of 8, t >= 1.
// Returns the launch's CUDA error.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* sT, void* ckpt, int bh, int t,
                             int h, int dk, int dv, int dtype, void* stream) {
  if (!shapes_ok(bh, t, h, dk, dv, kMaxDv)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch_fwd<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h,
                                  dk, dv, s)
      : launch_fwd<float>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h, dk, dv,
                          s);
  return (int)err;
}

// The backward: r, k, v, dout and dr, dk, dv in dtype; w, dw (bh, t, dk),
// u (h, dk), ckpt (the forward's), dsT (null for zero) and ds0 (bh, dk, dv),
// du_part (bh, dk) f32; dv_part: scratch of (bh, 4, t, dv) f32 for the row
// groups' parts of dv; dk and dv as the forward's, dv <= 64.  Returns the
// launches' CUDA error.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* ckpt,
                             const void* dout, const void* dsT, void* dr,
                             void* dk, void* dv, void* dw, void* du_part,
                             void* ds0, void* dv_part, int bh, int t, int h,
                             int dkd, int dvd, int dtype, void* stream) {
  if (!shapes_ok(bh, t, h, dkd, dvd, kBwdCols))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch_bwd<__nv_bfloat16>(r, k, v, w, u, ckpt, dout, dsT, dr, dk, dv,
                                  dw, du_part, ds0, dv_part, bh, t, h, dkd,
                                  dvd, s)
      : launch_bwd<float>(r, k, v, w, u, ckpt, dout, dsT, dr, dk, dv, dw,
                          du_part, ds0, dv_part, bh, t, h, dkd, dvd, s);
  return (int)err;
}

// How a launch is laid out, for readings: info[0..4] = grid x, grid y,
// threads a block, shared bytes a block, resident blocks an SM (the
// occupancy calculator's).  bwd: 0 forward, 1 backward (its first pass).
extern "C" int rwkv6_wkv_launch_info(int bwd, int dtype, int bh, int dv,
                                     int* info) {
  const cudaError_t err = dtype == 1
      ? launch_info<__nv_bfloat16>(bwd != 0, bh, dv, info)
      : launch_info<float>(bwd != 0, bh, dv, info);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
