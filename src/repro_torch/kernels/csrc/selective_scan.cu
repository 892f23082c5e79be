// Hymba's diagonal selective scan, forward, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX model runs this recurrence as a
// jax.lax.scan over the sequence (repro/models/hymba.py::_ssm_scan), which
// XLA compiles to one device loop.  In eager PyTorch that loop would be
// about ten small launches a step, 2048 steps a layer at hymba-1.5b's
// prefill, so the scan is a kernel.  With decay_t = exp(a * dt_t):
//
//   h   = decay_t * h + (dt_t * x_t) b_t        (din x n, f32)
//   y_t = sum_n h * c_t + D * x_t               (din)
//
// xs: (B, T, din) f32 with channel stride 1 and the given batch and time
// strides (the model's xs is the second half of a (B, T, 2 din) product,
// a strided view, read in place); dt: (B, T); bb, cc: (B, T, n); a =
// -exp(A_log): (din, n); D: (din,); h0: (B, din, n); all f32 and, but xs,
// contiguous.  Writes y (B, T, din) and the final state hT (B, din, n).
// The projections that make dt, bb and cc stay outside, as the JAX model
// computes them outside its scan.
//
// Design.  A lane owns one (channel, state) pair and carries that element
// of h through all T steps in a register: L lanes a channel (the wrapper's
// geometry: n rounded up to a power of two, at least 4; lanes past n hold
// zero), 256 / L channels a block of 256 threads, grid (ceil(din /
// channels), B).  At hymba-1.5b's width (din 1600, n 16) that is 16
// channels a block, 100 blocks a batch row and 102,400 threads at batch
// 4, where a thread per (batch, channel) would be only 6,400 on 132 SMs.  y_t is the sum of a
// channel's L lanes, by log2(L) __shfl_xor_sync rounds.  The state's
// recurrence is one FMA a step; exp, the input product and the reduction
// are off that chain.
//
// Staging.  Every channel of a batch row reads the same dt_t, b_t and c_t,
// so a block stages kChunk = 32 steps of them, and of its channels' x, in
// shared memory by cp.async (4-byte copies, double-buffered: the next
// chunk's copies are in flight while this chunk computes), and collects
// the chunk's y there to write it out row by row.
//
// Bound.  At hymba-1.5b's prefill (B 4, T 2048, din 1600, n 16) the
// function reads xs and writes y, 52.4 MB each, plus 1 MB of the rest:
// 0.032 ms at 3.35 TB/s.  It evaluates 210 M exponentials, one per state
// element and step, on the SFUs' 16 a clock an SM (0.050 ms at 1.98 GHz),
// beside about 5 flops per state element and step on the f32 units
// (0.016 ms), so operations bind (chip_smoke.py phase 3 prints both).
//
// The sums run in a fixed order (one owner per output, no atomics), so two
// runs are bitwise equal.  expf is the accurate libdevice form (the build
// sets no fast-math flag).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;          // steps staged a time
constexpr int kMaxState = 32;       // n <= 32: a channel within one warp

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int L>
struct Stage {
  static constexpr int kChannels = kThreads / L;
  float x[kChunk][kChannels];
  float b[kChunk][kMaxState];
  float c[kChunk][kMaxState];
  float dt[kChunk];
};

// Issues the copies of steps t0 .. t0 + steps - 1 into st.
template <int L>
__device__ __forceinline__ void stage_chunk(Stage<L>& st, const float* xs,
                                            long long sxt, const float* dt,
                                            const float* bb, const float* cc,
                                            int t0, int steps, int c0,
                                            int din, int n) {
  constexpr int kCh = Stage<L>::kChannels;
  for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
    const int t = i / kCh, ch = i % kCh;
    if (c0 + ch < din)
      cp_async4(&st.x[t][ch], xs + (long long)(t0 + t) * sxt + c0 + ch);
  }
  for (int i = threadIdx.x; i < steps * n; i += kThreads) {
    const int t = i / n, s = i % n;
    cp_async4(&st.b[t][s], bb + (long long)(t0 + t) * n + s);
    cp_async4(&st.c[t][s], cc + (long long)(t0 + t) * n + s);
  }
  for (int i = threadIdx.x; i < steps; i += kThreads)
    cp_async4(&st.dt[i], dt + t0 + i);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const float* __restrict__ xs, long long sxb,
                          long long sxt, const float* __restrict__ dt,
                          const float* __restrict__ bb,
                          const float* __restrict__ cc,
                          const float* __restrict__ a,
                          const float* __restrict__ dskip,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ hT,
                          int T, int din, int n) {
  constexpr int kCh = Stage<L>::kChannels;
  __shared__ Stage<L> stage[2];
  __shared__ float ys[kChunk][kCh];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int s = threadIdx.x % L;
  const int lc = threadIdx.x / L;            // the lane's channel in the block
  const int ch = c0 + lc;
  const bool ch_live = ch < din;
  const bool live = ch_live && s < n;
  const long long hidx = ((long long)b * din + ch) * n + s;

  const float a_s = live ? a[(long long)ch * n + s] : 0.f;
  const float d_c = ch_live ? dskip[ch] : 0.f;
  float h = live ? h0[hidx] : 0.f;

  const float* xs_b = xs + (long long)b * sxb;
  const float* dt_b = dt + (long long)b * T;
  const float* bb_b = bb + (long long)b * T * n;
  const float* cc_b = cc + (long long)b * T * n;
  float* y_b = y + (long long)b * T * din;

  const int chunks = (T + kChunk - 1) / kChunk;
  stage_chunk<L>(stage[0], xs_b, sxt, dt_b, bb_b, cc_b, 0,
                 min(kChunk, T), c0, din, n);
  cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * kChunk;
    const int steps = min(kChunk, T - t0);
    if (k + 1 < chunks)
      stage_chunk<L>(stage[(k + 1) & 1], xs_b, sxt, dt_b, bb_b, cc_b,
                     t0 + kChunk, min(kChunk, T - t0 - kChunk), c0, din, n);
    cp_async_commit();        // possibly empty: one group a chunk
    cp_async_wait_prev();     // this chunk's group has landed
    __syncthreads();

    const Stage<L>& st = stage[k & 1];
    for (int t = 0; t < steps; ++t) {
      const float dtt = st.dt[t];
      const float x = ch_live ? st.x[t][lc] : 0.f;
      const float bt = live ? st.b[t][s] : 0.f;
      const float ct = live ? st.c[t][s] : 0.f;
      const float decay = expf(a_s * dtt);
      h = decay * h + (dtt * x) * bt;
      float p = h * ct;
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (s == 0) ys[t][lc] = p + d_c * x;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int t = i / kCh, c = i % kCh;
      if (c0 + c < din) y_b[(long long)(t0 + t) * din + c0 + c] = ys[t][c];
    }
  }
  if (live) hT[hidx] = h;
}

template <int L>
cudaError_t launch(const float* xs, long long sxb, long long sxt,
                   const float* dt, const float* bb, const float* cc,
                   const float* a, const float* dskip, const float* h0,
                   float* y, float* hT, int B, int T, int din, int n,
                   cudaStream_t stream) {
  constexpr int kCh = Stage<L>::kChannels;
  const dim3 grid((din + kCh - 1) / kCh, B);
  selective_scan_fwd_kernel<L><<<grid, kThreads, 0, stream>>>(
      xs, sxb, sxt, dt, bb, cc, a, dskip, h0, y, hT, T, din, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_threads() { return kThreads; }

// xs strides in elements (its channel stride is 1); B, T, din >= 1, and
// lanes (a channel's; the caller's geometry) is 4, 8, 16 or 32 with
// 1 <= n <= lanes.  Returns the launch's CUDA error.
extern "C" int selective_scan_fwd(const void* xs, long long sxb,
                                  long long sxt, const void* dt,
                                  const void* bb, const void* cc,
                                  const void* a, const void* dskip,
                                  const void* h0, void* y, void* hT, int B,
                                  int T, int din, int n, int lanes,
                                  void* stream) {
  if (B < 1 || T < 1 || din < 1 || n < 1 || n > lanes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xs_ = static_cast<const float*>(xs),
              *dt_ = static_cast<const float*>(dt),
              *bb_ = static_cast<const float*>(bb),
              *cc_ = static_cast<const float*>(cc),
              *a_ = static_cast<const float*>(a),
              *d_ = static_cast<const float*>(dskip),
              *h0_ = static_cast<const float*>(h0);
  float *y_ = static_cast<float*>(y), *hT_ = static_cast<float*>(hT);
  switch (lanes) {
    case 4:
      return (int)launch<4>(xs_, sxb, sxt, dt_, bb_, cc_, a_, d_, h0_, y_,
                            hT_, B, T, din, n, st);
    case 8:
      return (int)launch<8>(xs_, sxb, sxt, dt_, bb_, cc_, a_, d_, h0_, y_,
                            hT_, B, T, din, n, st);
    case 16:
      return (int)launch<16>(xs_, sxb, sxt, dt_, bb_, cc_, a_, d_, h0_, y_,
                             hT_, B, T, din, n, st);
    case 32:
      return (int)launch<32>(xs_, sxb, sxt, dt_, bb_, cc_, a_, d_, h0_, y_,
                             hT_, B, T, din, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
