// RWKV6 ("Finch") WKV recurrence, forward, for Hopper (sm_90a).
//
// Replaces repro/kernels/rwkv6_scan.py::rwkv6_wkv_pallas and its TPU body
// _wkv_kernel.  Per batch x head, with decay_t = exp(-exp(w_t)):
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
                               float* __restrict__ sT, int T_len, int H, int Dk,
                               int Dv) {
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

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = min(kChunk, T_len - t0);
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
                   const void* u, const void* s0, void* out, void* sT, int bh,
                   int t, int h, int dk, int dv, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (3 * kChunk * KMAX + KMAX + kChunk + kChunk * dv);
  auto kernel = wkv_fwd_kernel<T, KMAX>;
  const int threads = (dv + 31) / 32 * 32;
  kernel<<<bh, threads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(out), static_cast<float*>(sT), t, h, dk, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* out, void* sT, int bh,
                     int t, int h, int dk, int dv, cudaStream_t s) {
  if (dk <= 16) return launch<T, 16>(r, k, v, w, u, s0, out, sT, bh, t, h, dk, dv, s);
  if (dk <= 32) return launch<T, 32>(r, k, v, w, u, s0, out, sT, bh, t, h, dk, dv, s);
  return launch<T, 64>(r, k, v, w, u, s0, out, sT, bh, t, h, dk, dv, s);
}

}  // namespace

// dtype (of r, k, v and out): 0 = float32, 1 = bfloat16.  The caller checks
// shapes, dtypes and contiguity; 1 <= Dk <= 64, 1 <= Dv <= 128, T >= 1.
// Returns the launch's CUDA error.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* sT, int bh, int t, int h, int dk,
                             int dv, int dtype, void* stream) {
  if (dk < 1 || dk > 64 || dv < 1 || dv > 128 || t < 1 || h < 1 || bh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(r, k, v, w, u, s0, out, sT, bh, t, h, dk, dv, s)
      : dispatch<float>(r, k, v, w, u, s0, out, sT, bh, t, h, dk, dv, s);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
