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
//
// Design.  The TPU kernel carried the f32 state in VMEM across a sequential
// grid axis over T-chunks; blocks here run in no order, so the T loop is
// inside the block.  One block per batch x head; thread j owns column j of
// the state, S[:, j], in registers, so the update needs no atomics and no
// reduction across threads, and two runs are bitwise equal.  The block
// stages kChunk timesteps of r, k, decay and v in shared memory as f32 at a
// time; every thread then reads the same r_t, k_t, decay_t (16-byte
// shared-memory broadcasts) and its own v_tj.  The bonus term is computed
// in its O(Dk) form, once per step for the whole block:
//
//   out_tj = sum_i r_ti S_ij + v_tj * b_t,   b_t = sum_i r_ti u_i k_ti
//
// (b_t for the chunk's steps right after staging, one thread per step), so
// the per-element loop is three instructions: acc += r_i S_ij, a = k_i v_j,
// S_ij = d_i S_ij + a.
// Dk is padded with zeros to the template's KMAX in shared memory, so a
// padded row of S stays 0 and adds nothing.  The sequential form is kept on
// purpose: the chunked-parallel form's exp(cumlog) decay ratios overflow f32
// for strongly decaying channels (see the rwkv6_scan.py docstring).
//
// Bound.  At rwkv6-1.6b's prefill (BH 128, T 2048, Dk = Dv = 64) the
// function needs 5 flops per state element per step (r.S and d*S + k v^T)
// plus 3 Dk + 2 Dv for the bonus term: 5.45 GFLOP against 2 bf16 and 1 f32
// streams of (BH, T, 64) in and one out (about 200 MB): operation-bound on
// paper (0.081 ms at the f32 peak), but each step's Dk-long chain per
// thread is latency-bound, and 128 blocks of 2 warps fill the card thinly.
// At T = 1 (a decode step) the launch dominates.
//
// Checkpoints.  For the backward, the forward can also write the state at
// the start of every chunk of kChunk steps, ckpt (BH, ceil(T / kChunk), Dk,
// Dv) f32, through a pointer that is null when nothing needs a gradient (the
// serving path).
//
// Backward (wkv_bwd_kernel).  JAX has no kernel for it: it differentiates
// its oracle (repro/kernels/ops.py::_wkv_bwd, jax.vjp of ref.rwkv6_wkv).
// Walking back from G = dL/dS_T (dsT, or 0), with S_{t-1} the state before
// step t, b_t = r_t.(u*k_t) and c_t = v_t.dout_t:
//
//   dr_t = S_{t-1} dout_t + (u*k_t) c_t       dk_t = G v_t + (u*r_t) c_t
//   dv_t = G^T k_t + b_t dout_t               du  += r_t*k_t c_t
//   dw_t = -rowsum(G * S_{t-1}) * decay_t * exp(w_t)
//   G    = diag(decay_t) G + r_t dout_t^T        (then ds0 = G)
//
// S_{t-1} is never recovered by dividing by decay_t (at the model's clip
// w <= 4 it is exp(-54.6), about 2e-24): each chunk's states are recomputed
// from the forward's checkpoint into a scratch buffer, (BH, kChunk, N, N)
// f32 (32 MB at rwkv6-1.6b's training shape), then read back in reverse.
// One block per batch x head; thread i owns row i of S and of G in
// registers, so dr, dk and the row sum for dw are sums inside the thread;
// dv_t sums over rows, once per step, through a padded shared-memory tile
// that thread j reads down its column in a fixed order.  du is written as
// per-(batch, head) partials that the wrapper sums over the batch in a
// fixed order: no float atomics anywhere, two runs are bitwise equal.
// Bound: 12 flops per state element per step (five multiply-adds in the
// walk back: dr, dk, the row sum, the dv term and the G update; one in the
// recompute) against 5 streams of (BH, T, 64) in and 4 out: operation-
// bound on paper, latency-bound per step like the forward, with half its
// blocks at batch 2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;    // timesteps staged per round of barriers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int KMAX>
__global__ void wkv_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ w,
                               const float* __restrict__ u,
                               const float* __restrict__ s0, T* __restrict__ out,
                               float* __restrict__ sT, float* __restrict__ ckpt,
                               int T_len, int H, int Dk, int Dv) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                          // [kChunk][KMAX]
  float* sk = sr + kChunk * KMAX;            // [kChunk][KMAX]
  float* sd = sk + kChunk * KMAX;            // [kChunk][KMAX] decay
  float* su = sd + kChunk * KMAX;            // [KMAX]
  float* sb = su + KMAX;                     // [kChunk] bonus r.(u*k)
  float* sv = sb + kChunk;                   // [kChunk][Dv]

  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  const bool own = j < Dv;
  const size_t tk = (size_t)bh * T_len * Dk, tv = (size_t)bh * T_len * Dv;

  for (int i = j; i < KMAX; i += blockDim.x)
    su[i] = i < Dk ? u[(size_t)(bh % H) * Dk + i] : 0.f;
  float S[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    S[i] = own && i < Dk ? s0[((size_t)bh * Dk + i) * Dv + j] : 0.f;

  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
    if (ckpt != nullptr && own) {            // the state before step t0
      float* c = ckpt + ((size_t)bh * n_chunks + t0 / kChunk) * Dk * Dv + j;
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        if (i < Dk) c[(size_t)i * Dv] = S[i];
    }
    __syncthreads();                         // the previous chunk is consumed
    for (int e = j; e < kChunk * KMAX; e += blockDim.x) {
      const int t = e / KMAX, i = e - t * KMAX;
      const bool live = t < n && i < Dk;
      const size_t g = tk + (size_t)(t0 + t) * Dk + i;
      sr[e] = live ? to_f32(r[g]) : 0.f;
      sk[e] = live ? to_f32(k[g]) : 0.f;
      sd[e] = live ? expf(-expf(w[g])) : 0.f;
    }
    for (int e = j; e < n * Dv; e += blockDim.x)
      sv[e] = to_f32(v[tv + (size_t)t0 * Dv + e]);
    __syncthreads();
    for (int t = j; t < n; t += blockDim.x) {
      const float* rt = sr + t * KMAX;
      const float* kt = sk + t * KMAX;
      float b = 0.f;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) b = fmaf(rt[i] * su[i], kt[i], b);
      sb[t] = b;
    }
    __syncthreads();
    if (!own) continue;
    for (int t = 0; t < n; ++t) {
      const float vj = sv[t * Dv + j];
      const float* rt = sr + t * KMAX;
      const float* kt = sk + t * KMAX;
      const float* dt = sd + t * KMAX;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, summed in order
#pragma unroll
      for (int i = 0; i < KMAX; i += 4) {    // 16-byte broadcast loads
        const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + i);
        const float4 d4 = *reinterpret_cast<const float4*>(dt + i);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c] = fmaf(rr[c], S[i + c], acc[c]);
          S[i + c] = fmaf(dd[c], S[i + c], kk[c] * vj);
        }
      }
      out[tv + (size_t)(t0 + t) * Dv + j] = from_f32<T>(
          fmaf(vj, sb[t], (acc[0] + acc[1]) + (acc[2] + acc[3])));
    }
  }
  if (own) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < Dk) sT[((size_t)bh * Dk + i) * Dv + j] = S[i];
  }
}

template <typename T, int KMAX>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* out, void* sT,
                   void* ckpt, int bh, int t, int h, int dk, int dv,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kChunk * KMAX + KMAX + kChunk + kChunk * dv);
  auto kernel = wkv_fwd_kernel<T, KMAX>;
  const int threads = (dv + 31) / 32 * 32;
  kernel<<<bh, threads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sT),
      static_cast<float*>(ckpt), t, h, dk, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* out, void* sT,
                     void* ckpt, int bh, int t, int h, int dk, int dv,
                     cudaStream_t s) {
  if (dk <= 16)
    return launch<T, 16>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h, dk, dv, s);
  if (dk <= 32)
    return launch<T, 32>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h, dk, dv, s);
  return launch<T, 64>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h, dk, dv, s);
}

// The backward of one batch x head.  N is Dk and Dv padded to 32 or 64, and
// the block has N threads.
template <typename T, int N>
__global__ void __launch_bounds__(64)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ ckpt,
               const T* __restrict__ dout, const float* __restrict__ dsT,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dw, float* __restrict__ du_part,
               float* __restrict__ ds0, float* __restrict__ hist, int T_len,
               int H, int Dk, int Dv) {
  constexpr int LD = N + 1;                  // the dv tile's padded row
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                          // [kChunk][N]
  float* sk = sr + kChunk * N;               // [kChunk][N]
  float* sd = sk + kChunk * N;               // [kChunk][N] decay
  float* sew = sd + kChunk * N;              // [kChunk][N] exp(w)
  float* sv = sew + kChunk * N;              // [kChunk][N]
  float* sdo = sv + kChunk * N;              // [kChunk][N]
  float* su = sdo + kChunk * N;              // [N]
  float* sb = su + N;                        // [kChunk] r.(u*k)
  float* sc = sb + kChunk;                   // [kChunk] v.dout
  float* sred = sc + kChunk;                 // [N][LD] G k for dv

  const int bh = blockIdx.x;
  const int i = threadIdx.x;                 // the row of S and G it owns
  const bool row = i < Dk;
  const size_t tk = (size_t)bh * T_len * Dk, tv = (size_t)bh * T_len * Dv;
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  float* hb = hist + (size_t)bh * kChunk * N * N + i;

  for (int e = i; e < N; e += blockDim.x)
    su[e] = e < Dk ? u[(size_t)(bh % H) * Dk + e] : 0.f;
  float G[N], S[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    G[j] = row && j < Dv && dsT != nullptr
        ? dsT[((size_t)bh * Dk + i) * Dv + j] : 0.f;
  float du_acc = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, T_len - t0);
    __syncthreads();                         // the previous chunk is consumed
    for (int e = i; e < kChunk * N; e += blockDim.x) {
      const int t = e / N, x = e - t * N;
      const bool live_k = t < n && x < Dk, live_v = t < n && x < Dv;
      const size_t g = tk + (size_t)(t0 + t) * Dk + x;
      const size_t gv = tv + (size_t)(t0 + t) * Dv + x;
      const float ew = live_k ? expf(w[g]) : 0.f;
      sr[e] = live_k ? to_f32(r[g]) : 0.f;
      sk[e] = live_k ? to_f32(k[g]) : 0.f;
      sew[e] = ew;
      sd[e] = live_k ? expf(-ew) : 0.f;
      sv[e] = live_v ? to_f32(v[gv]) : 0.f;
      sdo[e] = live_v ? to_f32(dout[gv]) : 0.f;
    }
    __syncthreads();
    for (int t = i; t < n; t += blockDim.x) {
      float b = 0.f, cc = 0.f;
#pragma unroll
      for (int x = 0; x < N; ++x) {
        b = fmaf(sr[t * N + x] * su[x], sk[t * N + x], b);
        cc = fmaf(sv[t * N + x], sdo[t * N + x], cc);
      }
      sb[t] = b;
      sc[t] = cc;
    }
    // recompute the chunk's states from its checkpoint: hist[tt] = S_{t-1}
    // of step t = t0 + tt, row i (each thread reads back only its own row)
    const float* ck = ckpt + ((size_t)bh * n_chunks + c) * Dk * Dv;
#pragma unroll
    for (int j = 0; j < N; ++j)
      S[j] = row && j < Dv ? ck[(size_t)i * Dv + j] : 0.f;
    for (int tt = 0; tt < n; ++tt) {
      float* h = hb + (size_t)tt * N * N;
      const float di = sd[tt * N + i], ki = sk[tt * N + i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        h[j * N] = S[j];
        S[j] = fmaf(di, S[j], ki * sv[tt * N + j]);
      }
    }
    __syncthreads();                         // sb and sc are ready
    for (int tt = n - 1; tt >= 0; --tt) {
      const float* h = hb + (size_t)tt * N * N;
#pragma unroll
      for (int j = 0; j < N; ++j) S[j] = h[j * N];
      const float ri = sr[tt * N + i], ki = sk[tt * N + i];
      const float di = sd[tt * N + i], ewi = sew[tt * N + i];
      const float ui = su[i], cc = sc[tt];
      float a_r[4] = {0.f, 0.f, 0.f, 0.f}, a_k[4] = {0.f, 0.f, 0.f, 0.f},
            a_d[4] = {0.f, 0.f, 0.f, 0.f};   // four chains, summed in order
#pragma unroll
      for (int j = 0; j < N; j += 4) {       // 16-byte broadcast loads
        const float4 v4 = *reinterpret_cast<const float4*>(sv + tt * N + j);
        const float4 o4 = *reinterpret_cast<const float4*>(sdo + tt * N + j);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float oo[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a_r[q] = fmaf(S[j + q], oo[q], a_r[q]);
          a_k[q] = fmaf(G[j + q], vv[q], a_k[q]);
          a_d[q] = fmaf(G[j + q], S[j + q], a_d[q]);
          sred[i * LD + j + q] = G[j + q] * ki;
          G[j + q] = fmaf(di, G[j + q], ri * oo[q]);
        }
      }
      const size_t g = tk + (size_t)(t0 + tt) * Dk + i;
      if (row) {
        const float dri = (a_r[0] + a_r[1]) + (a_r[2] + a_r[3]);
        const float dki = (a_k[0] + a_k[1]) + (a_k[2] + a_k[3]);
        const float ddi = (a_d[0] + a_d[1]) + (a_d[2] + a_d[3]);
        dr[g] = from_f32<T>(fmaf(ui * ki, cc, dri));
        dk[g] = from_f32<T>(fmaf(ui * ri, cc, dki));
        dw[g] = -ddi * di * ewi;
        du_acc = fmaf(ri * ki, cc, du_acc);
      }
      __syncthreads();                       // the dv tile is complete
      if (i < Dv) {                          // thread i sums column i
        float sum = 0.f;
        for (int x = 0; x < Dk; ++x) sum += sred[x * LD + i];
        dv[tv + (size_t)(t0 + tt) * Dv + i] =
            from_f32<T>(fmaf(sb[tt], sdo[tt * N + i], sum));
      }
      __syncthreads();                       // the tile is consumed
    }
  }
  if (row) {
    du_part[(size_t)bh * Dk + i] = du_acc;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < Dv) ds0[((size_t)bh * Dk + i) * Dv + j] = G[j];
  }
}

template <typename T, int N>
cudaError_t launch_bwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* ckpt,
                       const void* dout, const void* dsT, void* dr, void* dk,
                       void* dv, void* dw, void* du_part, void* ds0,
                       void* hist, int bh, int t, int h, int dkd, int dvd,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (6 * kChunk * N + N + 2 * kChunk + N * (N + 1));
  auto kernel = wkv_bwd_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<bh, N, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(ckpt),
      static_cast<const T*>(dout), static_cast<const float*>(dsT),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dw), static_cast<float*>(du_part),
      static_cast<float*>(ds0), static_cast<float*>(hist), t, h, dkd, dvd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* ckpt,
                         const void* dout, const void* dsT, void* dr,
                         void* dk, void* dv, void* dw, void* du_part,
                         void* ds0, void* hist, int bh, int t, int h, int dkd,
                         int dvd, int n, cudaStream_t s) {
  switch (n) {
    case 32: return launch_bwd<T, 32>(r, k, v, w, u, ckpt, dout, dsT, dr, dk,
                                      dv, dw, du_part, ds0, hist, bh, t, h,
                                      dkd, dvd, s);
    case 64: return launch_bwd<T, 64>(r, k, v, w, u, ckpt, dout, dsT, dr, dk,
                                      dv, dw, du_part, ds0, hist, bh, t, h,
                                      dkd, dvd, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rwkv6_wkv_chunk() { return kChunk; }

// dtype (of r, k, v and out): 0 = float32, 1 = bfloat16.  ckpt: null, or
// (bh, ceil(t / kChunk), dk, dv) f32 for the state at each chunk's start.
// The caller checks shapes, dtypes and contiguity; 1 <= Dk <= 64,
// 1 <= Dv <= 128, T >= 1.  Returns the launch's CUDA error.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* sT, void* ckpt, int bh, int t,
                             int h, int dk, int dv, int dtype, void* stream) {
  if (dk < 1 || dk > 64 || dv < 1 || dv > 128 || t < 1 || h < 1 || bh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h,
                                dk, dv, s)
      : dispatch<float>(r, k, v, w, u, s0, out, sT, ckpt, bh, t, h, dk, dv, s);
  return (int)err;
}

// The backward: r, k, v, dout and dr, dk, dv in dtype; w, dw (bh, t, dk),
// u (h, dk), ckpt (the forward's), dsT (null for zero) and ds0 (bh, dk, dv),
// du_part (bh, dk) f32; hist: scratch of (bh, kChunk, n, n) f32 with n = 32
// or 64 >= max(dk, dv).  Returns the launch's CUDA error.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* ckpt,
                             const void* dout, const void* dsT, void* dr,
                             void* dk, void* dv, void* dw, void* du_part,
                             void* ds0, void* hist, int bh, int t, int h,
                             int dkd, int dvd, int n, int dtype,
                             void* stream) {
  if (dkd < 1 || dvd < 1 || dkd > n || dvd > n || t < 1 || h < 1 || bh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch_bwd<__nv_bfloat16>(r, k, v, w, u, ckpt, dout, dsT, dr, dk,
                                    dv, dw, du_part, ds0, hist, bh, t, h, dkd,
                                    dvd, n, s)
      : dispatch_bwd<float>(r, k, v, w, u, ckpt, dout, dsT, dr, dk, dv, dw,
                            du_part, ds0, hist, bh, t, h, dkd, dvd, n, s);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
