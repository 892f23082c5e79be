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
// Bound.  At hymba-1.5b's prefill (B 4, T 2048, din 1600, n 16) the
// function reads xs and writes y, 52.4 MB each, plus 1 MB of the rest:
// 0.032 ms at 3.35 TB/s.  It evaluates 210 M exponentials, one per state
// element and step, on the SFUs' 16 a clock an SM (0.050 ms at 1.98 GHz),
// beside about 5 flops per state element and step on the f32 units
// (0.016 ms), so operations bind (chip_smoke.py phase 3 prints both).
//
// What held the first design back (a lane per (channel, state), 16 lanes
// a channel, blocks of 16 channels, grid (100, 4); 0.59 ms, 11.8x the
// bound, on an H100).  For every 32 state elements of a step a warp issued
// four shared loads (dt, x, b, c), four shuffle rounds with their adds and
// a store: about 9 instructions on the shared-memory / shuffle pipe, which
// takes one warp instruction a clock an SM, so that pipe alone came near
// 0.3 ms.  Its 400 blocks of 256 threads put four on some SMs and three
// on the rest.  Each chunk of 32 steps cost two __syncthreads, a write-out
// of y in 64-byte rows and about 1,570 four-byte cp.async copies in each
// of the 100 blocks of a batch row, which all copied the same dt, B and
// C.  expf, the accurate form, costs about 8 f32 instructions beside its
// one SFU op.  Unrolling the step loop gained 10%: the instruction mix,
// not the schedule, was the limit.
//
// Design (each step below measured on an H100 with
// scripts/torch_scan_bench.py; PERF.md has the readings).
// * Several states a lane.  A lane owns R consecutive states of one
//   channel (R = states a lane, the wrapper's geometry: 4 at n 16) and
//   keeps their h, and a, in registers; a channel has L lanes (n padded to
//   the power of two NP = R L; states past n hold zero), 32 / L lanes
//   apart in one warp, so the 8 lanes of a quarter warp read the same b
//   and c.  A step reads b_t and c_t as one vector load each of R floats
//   (broadcasts: every channel of the warp reads the same ones), dt_t and
//   its channel's x_t.
// * y by a transpose-reduce.  Over a group of L steps each lane keeps its
//   partial sum of every step; log2(L) shuffle rounds, each keeping half
//   of the values and adding the partner's copy of the other half, leave
//   lane l of a channel with the whole sum of step l of the group: L - 1
//   shuffles a group (3 for 4 steps at n 16) instead of log2(L) a step.
//   Lane l then writes y of step l from its register by a predicated
//   store: no shared buffer, no barrier, and no branch, so that a chunk's
//   steps are one region the compiler schedules as a whole.
// * A group ahead.  A group's decays exp(a dt) and inputs (dt x) b do not
//   depend on h: they are computed, and the group's operands read, while
//   the group before runs its recurrence, which hides the SFU's and the
//   shared loads' latency.
// * The grid.  Blocks of C channels (64: eight compute warps at n 16) and
//   a producer warp, grid (ceil(din / C), B): 100 blocks at hymba's
//   prefill, one an SM, two compute warps a scheduler.  A warp's chain of
//   steps sets the time more than the SMs filled: in the sweep blocks of
//   64 channels read 4% faster than of 16 (400 blocks) and 15% faster
//   than of 32 at B 4, and within 1% of 16 at B 1.
// * Staging on an mbarrier ring, by a producer warp.  A block stages
//   kChunk = 64 steps of dt, B, C and of its channels' x in shared memory,
//   in S stages (4) with a full and an empty mbarrier each.  The producer
//   warp fills them: dt, B and C of a chunk are contiguous rows of the
//   batch row, one cp.async.bulk each; x is 16-byte cp.async copies (C
//   floats a step, rows sxt apart: one bulk copy a row would be issued
//   lane after lane, about 30 instructions each), whose completion the
//   same full barrier tracks (cp.async.mbarrier.arrive.noinc).  Where an
//   operand's start or rows are not on 16 bytes (a bulk copy there never
//   lands) it goes by 4-byte cp.async; the wrapper chooses the route per
//   operand and call.  Each compute warp releases a stage by the empty
//   barrier when it has read it; no __syncthreads in the loop.  Copies
//   issued by a compute warp held every warp of the block back; a chunk
//   of 64 steps halves the chunk boundaries of 32, where a warp waits for
//   its first group.  No cluster: the 100 blocks of a batch row read the
//   same 8 KB a chunk from L2 (105 MB a prefill call, under 1 TB/s over
//   the call), which L2 serves beside the x reads.
// * Exponentials: the accurate expf of the rounded product a dt, as the
//   twin computes it, so that the kernel's decays are the twin's bits.
//   exp2 of the prescaled product by ex2.approx read 1.8x faster at the
//   prefill shape, but a decay near 1 an ulp off the twin's moves h by
//   that ulp over (1 - decay): on the served model's layers y's rel L2
//   against the twin read 1.08e-6, over the 1e-6 limit (PERF.md).  The
//   build sets no fast-math flag.
// * A decode step (T 1) launches selective_scan_step_kernel instead:
//   direct loads, no producer warp (below).  The staged kernel took
//   3.6 us on the card there against the first design's 2.65.
//
// A ragged group at a chunk's end runs its dead steps with dt = 0: decay
// exp(0) = 1 and (0 * x) b = 0 leave h unchanged, and their y is not
// written.  The sums run in a fixed order (one owner per output, no
// atomics), so two runs are bitwise equal.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tc.cuh"

namespace {

using sm90::mbar_arrive;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int kChunk = 64;          // steps staged a time
constexpr int kMaxStages = 4;
// a block's compute threads (C L); the producer warp comes on top
constexpr int kMaxConsumers = 256;
constexpr unsigned kFull = 0xffffffffu;
// the wrapper's route bits: dt, B and C by cp.async.bulk, x by 16-byte
// cp.async (the others by 4-byte cp.async)
constexpr int kBulkDt = 1, kBulkBC = 2, kVecX = 4;
// the full barrier's arrivals a phase: each lane of the producer warp
// arrives once itself and once through its cp.async copies
constexpr int kFullArrivals = 64;

// One stage's arrays in shared memory, offsets in floats (each a multiple
// of 4: every array starts on a 16-byte boundary): x (kChunk, C), b and c
// (kChunk, NP), dt (kChunk).
struct Layout {
  int x, b, c, dt, floats;
};
__host__ __device__ __forceinline__ Layout layout(int C, int NP) {
  Layout l;
  l.x = 0;
  l.b = kChunk * C;
  l.c = l.b + kChunk * NP;
  l.dt = l.c + kChunk * NP;
  l.floats = l.dt + kChunk;
  return l;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(smem)), "l"(gmem) : "memory");
}

// The barrier's phase also waits for this thread's cp.async copies.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

// Adds bytes to the barrier's expected transactions, without arriving.
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One contiguous global -> shared copy by the bulk-copy engine, counted in
// bytes on `bar` (both addresses 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses, and those it has
// observed, before the bulk copies it starts next.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// R consecutive floats of shared memory (16-byte aligned when R >= 4).
template <int R>
__device__ __forceinline__ void load_states(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else if constexpr (R == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

// The L lanes of a channel (kSpread = 32 / L lanes apart: lane l of the
// channel is warp lane l kSpread + its channel in the warp) each hold
// p[j], their part of step j's sum, j < L; returns the L lanes' total of
// step l.
template <int L>
__device__ __forceinline__ float transpose_sum(float (&p)[L], int l) {
  constexpr int kSpread = 32 / L;
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const bool hi = l & o;
#pragma unroll
    for (int m = 0; m < o; ++m) {
      const float keep = hi ? p[m + o] : p[m], send = hi ? p[m] : p[m + o];
      p[m] = keep + __shfl_xor_sync(kFull, send, o * kSpread);
    }
  }
  return p[0];
}

// A group of L steps of one lane, ready for the recurrence: decay and
// input (dt x) b of each state and step, c, and x.
template <int R, int L>
struct Group {
  float d[L][R], u[L][R], c[L][R], x[L];
};

// Reads a group from the stage, from step t, and computes its decays and
// inputs: none of it depends on h, so it runs a group ahead.
template <int R, int L>
__device__ __forceinline__ void prepare(Group<R, L>& g, const float* st,
                                        const Layout& lay, int C, int lc,
                                        int l, int t,
                                        const float (&av)[R]) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float dtt = st[lay.dt + t + j];
    g.x[j] = st[lay.x + (t + j) * C + lc];
    const float dtx = dtt * g.x[j];
    float bv[R];
    load_states<R>(st + lay.b + (t + j) * (R * L) + l * R, bv);
    load_states<R>(st + lay.c + (t + j) * (R * L) + l * R, g.c[j]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      g.d[j][r] = expf(av[r] * dtt);
      g.u[j][r] = dtx * bv[r];
    }
  }
}

// The recurrence over a prepared group: updates h; returns y of the
// group's step l.
template <int R, int L>
__device__ __forceinline__ float recur(const Group<R, L>& g, float (&h)[R],
                                       int l, float d_c) {
  float p[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      h[r] = fmaf(g.d[j][r], h[r], g.u[j][r]);
      acc = fmaf(h[r], g.c[j][r], acc);
    }
    p[j] = acc;
  }
  float x_l = g.x[0];       // x of step l, without indexing registers
#pragma unroll
  for (int j = 1; j < L; ++j) x_l = l == j ? g.x[j] : x_l;
  return transpose_sum<L>(p, l) + d_c * x_l;
}

// A predicated store, so that no branch splits the unrolled steps into
// regions the compiler schedules apart.
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile("{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
               "@q st.global.f32 [%0], %1;\n}\n"
               :: "l"(p), "f"(v), "r"((int)pred));
}

// The steps of one staged chunk (kChunk of them when kWhole, else `steps`,
// run in groups of L, a ragged last group's dead steps at dt = 0), y of
// the live steps to y_k[t * din].  The next group is read and its decays
// computed while this one runs its recurrence.
template <int R, int L, bool kWhole>
__device__ __forceinline__ void scan_chunk(const float* st, const Layout& lay,
                                           int C, int lc, int l, int steps,
                                           const float (&av)[R],
                                           float (&h)[R], float d_c,
                                           bool ch_live, float* y_k,
                                           long long din) {
  const int end = kWhole ? kChunk : (steps + L - 1) / L * L;
  constexpr int kUnroll = kWhole ? kChunk / L : 1;
  Group<R, L> cur;
  prepare(cur, st, lay, C, lc, l, 0, av);
#pragma unroll kUnroll
  for (int t = 0; t < end; t += L) {
    Group<R, L> next;
    prepare(next, st, lay, C, lc, l, min(t + L, end - L), av);
    const float yv = recur(cur, h, l, d_c);
    store_if(y_k + (t + l) * din, yv, ch_live && t + l < steps);
    cur = next;
  }
}

template <int R, int L>
__global__ void __launch_bounds__(kMaxConsumers + 32)
selective_scan_fwd_kernel(const float* __restrict__ xs, long long sxb,
                          long long sxt, const float* __restrict__ dt,
                          const float* __restrict__ bb,
                          const float* __restrict__ cc,
                          const float* __restrict__ a,
                          const float* __restrict__ dskip,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ hT,
                          int T, int din, int n, int C, int S, int route) {
  constexpr int NP = R * L;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];

  const Layout lay = layout(C, NP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int consumers = C * L / 32;         // the last warp stages
  const int b = blockIdx.y, c0 = blockIdx.x * C;
  // lane l of a channel is warp lane l (32 / L) + the channel's place in
  // the warp: at L 4 the 8 lanes of a quarter warp read the same b and c
  const int l = lane / (32 / L);
  const int lc = warp * (32 / L) + lane % (32 / L);   // channel in the block
  const int ch = c0 + lc;
  const bool ch_live = ch < din;
  const int cols = min(C, din - c0);        // the block's live channels
  const int chunks = (T + kChunk - 1) / kChunk;

  float av[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = l * R + r;
    const bool live = ch_live && s < n;
    av[r] = live ? a[(long long)ch * n + s] : 0.f;
    h[r] = live ? h0[((long long)b * din + ch) * n + s] : 0.f;
  }
  const float d_c = ch_live ? dskip[ch] : 0.f;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kFullArrivals);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n != NP) {   // zeros in the padded state columns of every stage
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < S * lay.floats / 4; i += blockDim.x)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const float* xs_b = xs + (long long)b * sxb + c0;
  const float* dt_b = dt + (long long)b * T;
  const float* bb_b = bb + (long long)b * T * n;
  const float* cc_b = cc + (long long)b * T * n;

  // the producer warp: stage chunk j
  auto fill = [&](int j) {
    const int s = j % S, t0 = j * kChunk, steps = min(kChunk, T - t0);
    float* st = smem + s * lay.floats;
    const uint32_t dt_bytes = (route & kBulkDt) ? steps * 4 : 0;
    const uint32_t bc_bytes = (route & kBulkBC) ? steps * n * 4 : 0;
    fence_async_shared();
    if (lane == 0) expect_tx(&full[s], dt_bytes + 2 * bc_bytes);
    __syncwarp();
    if (dt_bytes) {
      if (lane == 0) bulk_load(st + lay.dt, dt_b + t0, dt_bytes, &full[s]);
    } else {
      for (int i = lane; i < steps; i += 32)
        cp_async4(st + lay.dt + i, dt_b + t0 + i);
    }
    if (bc_bytes) {
      if (lane == 1)
        bulk_load(st + lay.b, bb_b + (long long)t0 * n, bc_bytes, &full[s]);
      if (lane == 2)
        bulk_load(st + lay.c, cc_b + (long long)t0 * n, bc_bytes, &full[s]);
    } else {
      for (int i = lane; i < steps * n; i += 32) {
        const int t = i / n, k = i % n;
        cp_async4(st + lay.b + t * NP + k, bb_b + (long long)(t0 + t) * n + k);
        cp_async4(st + lay.c + t * NP + k, cc_b + (long long)(t0 + t) * n + k);
      }
    }
    if (route & kVecX) {      // a row is cols / 4 vectors of 16 bytes
      const int vec = cols / 4;
      for (int i = lane; i < steps * vec; i += 32) {
        const int t = i / vec, k = 4 * (i % vec);
        cp_async16(st + lay.x + t * C + k, xs_b + (long long)(t0 + t) * sxt + k);
      }
    } else {
      for (int i = lane; i < steps * cols; i += 32) {
        const int t = i / cols, k = i % cols;
        cp_async4(st + lay.x + t * C + k, xs_b + (long long)(t0 + t) * sxt + k);
      }
    }
    // a ragged group's dead steps: dt = 0, and zeros for x, b and c (the
    // copies above do not touch these rows, and no later chunk fills the
    // stage)
    const int dead = (steps + L - 1) / L * L - steps;
    for (int i = lane; i < dead * (1 + C + 2 * NP); i += 32) {
      const int t = steps + i % dead, k = i / dead;
      st[k == 0 ? lay.dt + t
         : k <= C ? lay.x + t * C + k - 1
         : k <= C + NP ? lay.b + t * NP + k - 1 - C
                       : lay.c + t * NP + k - 1 - C - NP] = 0.f;
    }
    cp_async_arrive(&full[s]);
    mbar_arrive(&full[s]);
  };

  if (warp == consumers) {                  // the producer warp
    for (int j = 0; j < chunks; ++j) {
      if (j >= S) mbar_wait(&empty[j % S], (j / S - 1) & 1);
      fill(j);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  float* y_ch = y + (long long)b * T * din + ch;
  for (int k = 0; k < chunks; ++k) {
    const int s = k % S, t0 = k * kChunk, steps = min(kChunk, T - t0);
    mbar_wait(&full[s], (k / S) & 1);
    const float* st = smem + s * lay.floats;
    float* y_k = y_ch + (long long)t0 * din;
    if (steps == kChunk)
      scan_chunk<R, L, true>(st, lay, C, lc, l, kChunk, av, h, d_c,
                             ch_live, y_k, din);
    else
      scan_chunk<R, L, false>(st, lay, C, lc, l, steps, av, h, d_c,
                              ch_live, y_k, din);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = l * R + r;
    if (ch_live && s < n) hT[((long long)b * din + ch) * n + s] = h[r];
  }
}

// A decode step (T 1): no producer warp, no staging, no mbarrier.  Each
// lane loads its dt, x, b and c from global memory beside a and h0, and
// the channel's lanes sum y by log2(L) shuffle rounds in the order of
// transpose_sum's step 0, so it gives the staged kernel's bits.  A kernel
// of its own: as a branch of the staged kernel it cost that kernel 13%
// at the prefill shape (registers 106 -> 111; PERF.md).
template <int R, int L>
__global__ void __launch_bounds__(kMaxConsumers)
selective_scan_step_kernel(const float* __restrict__ xs, long long sxb,
                           const float* __restrict__ dt,
                           const float* __restrict__ bb,
                           const float* __restrict__ cc,
                           const float* __restrict__ a,
                           const float* __restrict__ dskip,
                           const float* __restrict__ h0,
                           float* __restrict__ y, float* __restrict__ hT,
                           int din, int n, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int l = lane / (32 / L);
  const int ch = blockIdx.x * C + warp * (32 / L) + lane % (32 / L);
  const bool ch_live = ch < din;
  const float dtt = dt[b];
  const float xv = ch_live ? xs[(long long)b * sxb + ch] : 0.f;
  const float dtx = dtt * xv;
  float h[R], acc = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = l * R + r;
    const bool live = ch_live && s < n;
    const float av = live ? a[(long long)ch * n + s] : 0.f;
    const float hv = live ? h0[((long long)b * din + ch) * n + s] : 0.f;
    const float bv = live ? bb[(long long)b * n + s] : 0.f;
    const float cv = live ? cc[(long long)b * n + s] : 0.f;
    h[r] = fmaf(expf(av * dtt), hv, dtx * bv);
    acc = fmaf(h[r], cv, acc);
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(kFull, acc, o * (32 / L));
  if (ch_live && l == 0)
    y[(long long)b * din + ch] = acc + dskip[ch] * xv;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = l * R + r;
    if (ch_live && s < n) hT[((long long)b * din + ch) * n + s] = h[r];
  }
}

struct Args {
  const float *xs, *dt, *bb, *cc, *a, *dskip, *h0;
  long long sxb, sxt;
  float *y, *hT;
  int B, T, din, n, C, S, route;
};

template <int R, int L>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.din + p.C - 1) / p.C, p.B);
  if (p.T == 1) {
    selective_scan_step_kernel<R, L><<<grid, p.C * L, 0, stream>>>(
        p.xs, p.sxb, p.dt, p.bb, p.cc, p.a, p.dskip, p.h0, p.y, p.hT, p.din,
        p.n, p.C);
    return cudaGetLastError();
  }
  const int threads = p.C * L + 32;          // and the producer warp
  // no more stages than chunks
  const int stages = min(p.S, (p.T + kChunk - 1) / kChunk);
  const size_t smem = (size_t)stages * layout(p.C, R * L).floats * 4;
  if (smem > 48 * 1024) {       // above the default: asked once per card
    static size_t granted[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (granted[dev] < smem) {
      const cudaError_t e = cudaFuncSetAttribute(
          selective_scan_fwd_kernel<R, L>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      granted[dev] = smem;
    }
  }
  selective_scan_fwd_kernel<R, L><<<grid, threads, smem, stream>>>(
      p.xs, p.sxb, p.sxt, p.dt, p.bb, p.cc, p.a, p.dskip, p.h0, p.y, p.hT,
      p.T, p.din, p.n, p.C, stages, p.route);
  return cudaGetLastError();
}

}  // namespace

extern "C" int selective_scan_chunk() { return kChunk; }

// xs strides in elements (its channel stride is 1); B, T, din >= 1; states
// (R) and lanes (L) one of the compiled pairs below with 1 <= n <= R L;
// channels (C) a multiple of 4 with C L a multiple of 32, at most 256
// (a producer warp comes on top);
// 1 <= stages <= 4; route: kBulkDt | kBulkBC | kVecX for the operands the
// wrapper found aligned (kBulkBC needs n == R L).  Returns the launch's
// CUDA error.
extern "C" int selective_scan_fwd(const void* xs, long long sxb,
                                  long long sxt, const void* dt,
                                  const void* bb, const void* cc,
                                  const void* a, const void* dskip,
                                  const void* h0, void* y, void* hT, int B,
                                  int T, int din, int n, int states,
                                  int lanes, int channels, int stages,
                                  int route, void* stream) {
  const int np = states * lanes;
  if (B < 1 || T < 1 || din < 1 || n < 1 || n > np || channels < 4 ||
      channels % 4 != 0 || (channels * lanes) % 32 != 0 ||
      channels * lanes > kMaxConsumers || stages < 1 ||
      stages > kMaxStages || ((route & kBulkBC) && n != np))
    return (int)cudaErrorInvalidValue;
  const Args p{static_cast<const float*>(xs), static_cast<const float*>(dt),
               static_cast<const float*>(bb), static_cast<const float*>(cc),
               static_cast<const float*>(a), static_cast<const float*>(dskip),
               static_cast<const float*>(h0), sxb, sxt,
               static_cast<float*>(y), static_cast<float*>(hT), B, T, din, n,
               channels, stages, route};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states * 100 + lanes) {
    case 101: return (int)launch<1, 1>(p, st);
    case 201: return (int)launch<2, 1>(p, st);
    case 401: return (int)launch<4, 1>(p, st);
    case 402: return (int)launch<4, 2>(p, st);
    case 404: return (int)launch<4, 4>(p, st);
    case 408: return (int)launch<4, 8>(p, st);
#ifdef SCAN_SWEEP_INSTANCES     // scripts/torch_scan_bench.py's other knobs
    case 208: return (int)launch<2, 8>(p, st);    // n 16, 2 states a lane
    case 802: return (int)launch<8, 2>(p, st);    // n 16, 8 states a lane
#endif
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
