// Hymba's diagonal selective scan, forward and backward, for Hopper
// (sm_90a).  The backward is described where its kernels begin, below.
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
// contiguous.  Writes y (B, T, din) and the final state hT (B, din, n),
// and for a gradient (an instance of its own) the state at the start of
// every chunk and the final one, ckpt (B, ceil(T / kChunk) + 1, din, n).
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

// R consecutive floats of global memory (16-byte aligned when R >= 4).
template <int R>
__device__ __forceinline__ void store_states(float* p, const float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = v[i];
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

// kCkpt: also write the state at the start of every chunk, and the final
// one, to ckpt (B, chunks + 1, din, n) for the backward; an instance of its
// own, so that the served forward (kCkpt false) compiles as it did.
template <int R, int L, bool kCkpt>
__global__ void __launch_bounds__(kMaxConsumers + 32)
selective_scan_fwd_kernel(const float* __restrict__ xs, long long sxb,
                          long long sxt, const float* __restrict__ dt,
                          const float* __restrict__ bb,
                          const float* __restrict__ cc,
                          const float* __restrict__ a,
                          const float* __restrict__ dskip,
                          const float* __restrict__ h0,
                          float* __restrict__ y, float* __restrict__ hT,
                          float* __restrict__ ckpt, int T, int din, int n,
                          int C, int S, int route) {
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
  // the lane's states in checkpoint k: ck_ch[k * din * n + r]
  float* ck_ch = kCkpt ? ckpt + ((long long)b * (chunks + 1) * din + ch) * n
                             + l * R
                       : nullptr;
  const long long ck_step = (long long)din * n;
  for (int k = 0; k < chunks; ++k) {
    const int s = k % S, t0 = k * kChunk, steps = min(kChunk, T - t0);
    if constexpr (kCkpt) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (ch_live && l * R + r < n) ck_ch[k * ck_step + r] = h[r];
    }
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
    if (ch_live && s < n) {
      hT[((long long)b * din + ch) * n + s] = h[r];
      if constexpr (kCkpt) ck_ch[chunks * ck_step + r] = h[r];
    }
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

// ---------------------------------------------------------------------------
// The backward.
//
// It replaces no TPU kernel either: JAX differentiates its jax.lax.scan.
// With e_t = exp(a dt_t), h_t the state after step t, g_T = dhT and
// G_t = g_t + dy_t c_t (din x n), walking t from T down to 1:
//
//   dc_t  = sum_d dy_t[d] h_t[d, :]        db_t = sum_d G_t dt_t x_t
//   ddt_t = sum_{d,n} G_t (x_t b_t + a e_t h_{t-1})
//   dx_t  = D dy_t + dt_t sum_n G_t b_t    da += G_t dt_t e_t h_{t-1}
//   dD   += dy_t x_t                       g_{t-1} = e_t G_t,  dh0 = g_0
//
// (ref.selective_scan_bwd, its twin).  Lanes and states as the forward's:
// a lane keeps R states of one channel (and their g, a and da) in
// registers, L lanes a channel 32 / L lanes apart, blocks of C channels
// (the wrapper's BWD_CHANNELS_PER_BLOCK) and a producer warp.
//
// Segments of T.  The first design walked all T steps in each of its
// (ceil(din / C), B) blocks: 100 blocks of four compute warps at
// hymba-1.5b's training shape, 32 SMs idle and one warp a scheduler, and
// about the same time at B 1, 2 and 4 (0.61 ms), so each block's chain of
// steps set the time.  Only g crosses T, and its recurrence is linear and
// diagonal in the state and needs only dt, c and dy: over a segment,
// g at its start is P g_in + g_loc, with P the product of the segment's
// decays and g_loc its walk from a zero carry.  So T is cut into S
// segments of whole chunks, each starting on one of the forward's
// checkpoints (the wrapper's bwd_geometry), and two launches on the grid
// (ceil(din / C), B, S) walk them:
//   1. selective_scan_bwd_replay_kernel replays each segment's chunks from
//      the first, from the forward's checkpoint, by the forward's very
//      operations (so the states are its bits; no decay is divided out),
//      stores the state at the start of every kSub steps in a scratch of
//      device memory (starts), and sums, with the same decays, the
//      segment's P and g_loc in forward form, P <- P e_t, g_loc <- g_loc
//      + P dy_t c_t (the twin's backward walk g_loc <- e_t (g_loc + dy_t
//      c_t) unrolled: the same terms), into carries;
//   2. selective_scan_bwd_kernel folds the later segments' (P, g_loc) into
//      its segment's carry, from the last, g = fma(P, g, g_loc) from
//      g = dhT: the twin's order, so every segment starts from the carry a
//      walk over the segments would give; and
//   3. walks its segment's chunks from the last: from the last sub-chunk
//      to the first, it recomputes the sub-chunk's states and decays into
//      registers from the stored start and walks back through them.
// Each exponential is thus taken twice, as in the first design, which
// replayed each chunk before walking it back; the forward form of step 1
// costs two multiplies and an FMA a state and step beside the replay.  In
// each launch the producer warp stages the segment's chunks (dt, B, C, x
// and dy, by the forward's copy routes; dy by 16-byte cp.async where
// aligned) on a ring of kBwdStages stages, from the first (step 1) or the
// last (step 3).  Two launches, and not one with the segments of a (channel
// block, row) as the ranks of a thread-block cluster that exchange their
// carries through distributed shared memory: that read 0.428-0.433 ms at
// best at the training shape (6 ranks of 6 chunks), two launches 0.363
// (16 segments of 2 chunks; a cluster holds at most 8 blocks), and the
// replay, at 92 registers, runs 4 blocks an SM where the walk back runs 3
// (PERF.md).
//
// Sums over channels.  dB_t, dC_t (n each) and ddt_t sum over all din
// channels, which span the grid's blocks.  In a warp, a step's 2R values
// of db and dc are reduce-scattered over the 32 / L lanes of its channels
// by shuffles (2R - 2R / (32 / L) of them at n 16: 7), and ddt is summed
// over the warp; each warp writes its sums of a sub-chunk to shared
// memory, and after a barrier of the compute warps the block adds its
// warps' sums in warp order and writes them as the block's partials,
// (B, ceil(din / C), T, 2 NP + 1): each segment writes its own steps.
// (ddt summed over a channel's lanes only, with the channels left to the
// block's sum, read 11% slower.)  selective_scan_bwd_sum_kernel, a third
// launch, adds the blocks' partials in block order, and da's and dD's (B,
// S, din, n) and (B, S, din) partials over the rows and segments in row
// order.  Every sum has a fixed order: two runs are bitwise equal.  dx is
// summed over a channel's L lanes by shuffles and written by its first
// lane.
//
// Bound.  At hymba-1.5b's training shape (B 2, T 2048, din 1600, n 16) the
// backward reads xs, dy and the checkpoints and writes dx (26.2 MB each but
// the checkpoints, 6.8 MB), about 0.026 ms at 3.35 TB/s; it takes 105 M
// exponentials (one pass of the decays, 0.025 ms on the SFUs) beside about
// 16 f32 operations a state element and step (0.025 ms);
// chip_smoke.py phase 3 prints the bound from the operations it counts.
// The design spends two passes of exponentials, the starts (52 MB written
// and read back, mostly in L2) and the partials (27 MB) on top.
//
// Registers.  A block's compute threads are at most kBwdMaxConsumers, and
// the build caps the walk's registers for kBwdMinBlocks such blocks an SM
// (with their producer warps), the replay's for kReplayMinBlocks: more
// warps an SM to hide the latency of the exponentials, the shuffles and the
// shared loads.  The knobs are macros: build knobs of the tuning seam
// (repro_torch.kernels.tuning, family "selective_scan": bwd_sub,
// bwd_max_threads, bwd_min_blocks, bwd_replay_min_blocks), defined with -D
// by _build; scripts/torch_scan_bench.py --backward builds others too.
#ifndef SCAN_BWD_SUB
#define SCAN_BWD_SUB 8
#endif
#ifndef SCAN_BWD_MAX_CONSUMERS
#define SCAN_BWD_MAX_CONSUMERS 128
#endif
#ifndef SCAN_BWD_MIN_BLOCKS
#define SCAN_BWD_MIN_BLOCKS 3
#endif
#ifndef SCAN_BWD_REPLAY_MIN_BLOCKS
#define SCAN_BWD_REPLAY_MIN_BLOCKS 4
#endif
constexpr int kSub = SCAN_BWD_SUB;  // steps whose states a lane recomputes
constexpr int kSubs = kChunk / kSub;
constexpr int kBwdStages = 2;
constexpr int kBwdMaxConsumers = SCAN_BWD_MAX_CONSUMERS;
constexpr int kBwdMinBlocks = SCAN_BWD_MIN_BLOCKS;
constexpr int kReplayMinBlocks = SCAN_BWD_REPLAY_MIN_BLOCKS;
static_assert(kSub >= 1 && kChunk % kSub == 0,
              "SCAN_BWD_SUB: a chunk is whole sub-chunks");
static_assert(kBwdMaxConsumers >= 32 && kBwdMaxConsumers % 32 == 0 &&
                  kBwdMaxConsumers <= kMaxConsumers,
              "SCAN_BWD_MAX_CONSUMERS: whole warps, at most kMaxConsumers");
static_assert(kBwdMinBlocks >= 1 && kReplayMinBlocks >= 1,
              "SCAN_BWD_MIN_BLOCKS, SCAN_BWD_REPLAY_MIN_BLOCKS: at least 1");
// route bit of dy (the forward's bits hold for dt, B, C and x)
constexpr int kVecDy = 8;

// One backward stage's arrays, offsets in floats (each a multiple of 4):
// x and dy (kChunk, C), b and c (kChunk, NP), dt (kChunk).
struct BwdLayout {
  int x, dy, b, c, dt, floats;
};
__host__ __device__ __forceinline__ BwdLayout bwd_layout(int C, int NP) {
  BwdLayout l;
  l.x = 0;
  l.dy = kChunk * C;
  l.b = l.dy + kChunk * C;
  l.c = l.b + kChunk * NP;
  l.dt = l.c + kChunk * NP;
  l.floats = l.dt + kChunk;
  return l;
}

// A block's shared memory in floats: the stages, and for the walk back
// the warps' sums of two sub-chunks (double-buffered).
__host__ __device__ __forceinline__ int bwd_smem_floats(int C, int L, int NP,
                                                        int S, bool replay) {
  const int warps = C * L / 32;
  return S * bwd_layout(C, NP).floats
         + (replay ? 0 : 2 * warps * kSub * (2 * NP + 1));
}

// The reduce-scatter of V values over the S = 32 / L lanes of a warp's
// channels (lanes 0 .. S-1 apart by xor offsets below S; m = the lane's
// channel in the warp): rounds of offset O from S / 2 down to 1; while
// O >= the values held (Held), every value is summed with the partner's,
// after that each round keeps half and adds the partner's copy of the
// other half.  Leaves lane m with the totals of values m (V / S) .. + V / S
// - 1 when S < V, else of value m % V.
template <int V, int O, int Held>
__device__ __forceinline__ void channel_round(float (&p)[V], int m) {
  if constexpr (O > 0) {
    if constexpr (O >= Held) {
#pragma unroll
      for (int k = 0; k < Held; ++k) p[k] += __shfl_xor_sync(kFull, p[k], O);
      channel_round<V, O / 2, Held>(p, m);
    } else {
      constexpr int H = Held / 2;
      const bool hi = m & O;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float keep = hi ? p[k + H] : p[k], send = hi ? p[k] : p[k + H];
        p[k] = keep + __shfl_xor_sync(kFull, send, O);
      }
      channel_round<V, O / 2, H>(p, m);
    }
  }
}

// The backward's operands, one struct for both of its kernels.
struct BwdArgs {
  const float *xs, *dt, *bb, *cc, *a, *dskip, *ckpt, *dy, *dhT;
  long long sxb, sxt;
  float *dx, *dd_part, *da_part, *dh0, *partial, *starts, *carries;
  int B, T, din, n, C, seg_chunks, segments, route;
};

// The body of both backward kernels: kReplay, step 1 (the replay of the
// segment and its carry); otherwise step 3 (the walk back).  Block (bx,
// by, z): channels bx C .. of batch row by, segment z.
template <int R, int L, bool kReplay>
__device__ __forceinline__ void bwd_body(const BwdArgs& p) {
  constexpr int NP = R * L, kSpread = 32 / L, V = 2 * R;
  constexpr int kHeld = kSpread < V ? V / kSpread : 1;
  constexpr int W = 2 * NP + 1;              // a step's partials
  constexpr int S = kBwdStages;
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kBwdStages], empty[kBwdStages];

  const int T = p.T, din = p.din, n = p.n, C = p.C, route = p.route;
  const BwdLayout lay = bwd_layout(C, NP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int consumers = C * L / 32;         // the last warp stages
  const int b = blockIdx.y, c0 = blockIdx.x * C, nbx = gridDim.x;
  const int seg = blockIdx.z, segs = gridDim.z;
  const int l = lane / kSpread, m = lane % kSpread;
  const int lc = warp * kSpread + m;        // channel in the block
  const int ch = c0 + lc;
  const bool ch_live = ch < din;
  const int cols = min(C, din - c0);
  const int chunks = (T + kChunk - 1) / kChunk;
  const int k_lo = seg * p.seg_chunks;
  const int nck = min(chunks, k_lo + p.seg_chunks) - k_lo;  // its chunks

  float av[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = l * R + r;
    av[r] = ch_live && s < n ? p.a[(long long)ch * n + s] : 0.f;
  }

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], kFullArrivals);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // zeros in the padded state columns and the dead channels' x and dy
  // columns of every stage, which no copy writes: a dead lane's state,
  // carry and sums stay zero
  if (n != NP || cols < C) {
    float4* z = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < S * lay.floats / 4; i += blockDim.x)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the lane's start states: (seg_chunks, kSubs, C L, R) for the block
  float* my_starts = p.starts + ((long long)(b * segs + seg) * nbx
                                 + blockIdx.x) * p.seg_chunks * kSubs * C * L
                                    * R
                     + tid * R;
  const int start_stride = C * L * R;       // a sub-chunk's, in floats
  // the lane's carries: P and g_loc, each (B, segments, din, n)
  const long long carry_half = (long long)p.B * segs * din * n;
  const long long carry_at = ((long long)b * segs * din + ch) * n + l * R;

  if (warp == consumers) {                  // the producer warp
    const float* xs_b = p.xs + (long long)b * p.sxb + c0;
    const float* dy_b = p.dy + (long long)b * T * din + c0;
    const float* dt_b = p.dt + (long long)b * T;
    const float* bb_b = p.bb + (long long)b * T * n;
    const float* cc_b = p.cc + (long long)b * T * n;
    for (int j = 0; j < nck; ++j) {
      if (j >= S) mbar_wait(&empty[j % S], (j / S - 1) & 1);
      // stage chunk k in stage s: step 1 from the first, step 3 the last
      const int k = kReplay ? k_lo + j : k_lo + nck - 1 - j, s = j % S;
      const int t0 = k * kChunk, steps = min(kChunk, T - t0);
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
          const int t = i / n, k2 = i % n;
          cp_async4(st + lay.b + t * NP + k2,
                    bb_b + (long long)(t0 + t) * n + k2);
          cp_async4(st + lay.c + t * NP + k2,
                    cc_b + (long long)(t0 + t) * n + k2);
        }
      }
      if (route & kVecX) {
        const int vec = cols / 4;
        for (int i = lane; i < steps * vec; i += 32) {
          const int t = i / vec, k2 = 4 * (i % vec);
          cp_async16(st + lay.x + t * C + k2,
                     xs_b + (long long)(t0 + t) * p.sxt + k2);
        }
      } else {
        for (int i = lane; i < steps * cols; i += 32) {
          const int t = i / cols, k2 = i % cols;
          cp_async4(st + lay.x + t * C + k2,
                    xs_b + (long long)(t0 + t) * p.sxt + k2);
        }
      }
      if (route & kVecDy) {
        const int vec = cols / 4;
        for (int i = lane; i < steps * vec; i += 32) {
          const int t = i / vec, k2 = 4 * (i % vec);
          cp_async16(st + lay.dy + t * C + k2,
                     dy_b + (long long)(t0 + t) * din + k2);
        }
      } else {
        for (int i = lane; i < steps * cols; i += 32) {
          const int t = i / cols, k2 = i % cols;
          cp_async4(st + lay.dy + t * C + k2,
                    dy_b + (long long)(t0 + t) * din + k2);
        }
      }
      // a ragged sub-chunk's dead steps: dt = 0 and zeros for x, dy, b and
      // c (decay 1, input 0: the state and the carry pass through)
      const int dead = (steps + kSub - 1) / kSub * kSub - steps;
      const int row = 1 + 2 * C + 2 * NP;
      for (int i = lane; i < dead * row; i += 32) {
        const int t = steps + i % dead, k2 = i / dead;
        st[k2 == 0 ? lay.dt + t
           : k2 <= C ? lay.x + t * C + k2 - 1
           : k2 <= 2 * C ? lay.dy + t * C + k2 - 1 - C
           : k2 <= 2 * C + NP ? lay.b + t * NP + k2 - 1 - 2 * C
                              : lay.c + t * NP + k2 - 1 - 2 * C - NP] = 0.f;
      }
      cp_async_arrive(&full[s]);
      mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  if constexpr (kReplay) {
    // step 1: the segment's chunks from the first, each replayed from its
    // checkpoint, the state at the start of every sub-chunk stored; and
    // the segment's decay product and local carry, in forward form
    const long long ck_step = (long long)din * n;
    const float* ck_ch = p.ckpt + ((long long)b * (chunks + 1) * din + ch) * n
                         + l * R;
    float gl[R], pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      gl[r] = 0.f;
      pr[r] = 1.f;
    }
    for (int j = 0; j < nck; ++j) {
      const int k = k_lo + j, s = j % S;
      const int subs = (min(kChunk, T - k * kChunk) + kSub - 1) / kSub;
      float h[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        h[r] = ch_live && l * R + r < n ? ck_ch[k * ck_step + r] : 0.f;
      mbar_wait(&full[s], (j / S) & 1);
      const float* st = smem + s * lay.floats;
      for (int q = 0; q < subs; ++q) {
        store_states<R>(my_starts + (j * kSubs + q) * start_stride, h);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = q * kSub + i;
          const float dtt = st[lay.dt + t];
          const float dtx = dtt * st[lay.x + t * C + lc];
          const float dyv = st[lay.dy + t * C + lc];
          float bv[R], cv[R];
          load_states<R>(st + lay.b + t * NP + l * R, bv);
          load_states<R>(st + lay.c + t * NP + l * R, cv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float e = expf(av[r] * dtt);
            h[r] = fmaf(e, h[r], dtx * bv[r]);
            pr[r] *= e;
            gl[r] = fmaf(pr[r], dyv * cv[r], gl[r]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the first segment's carry is read by no segment
    if (seg > 0 && ch_live) {
      float* pc = p.carries + carry_at + (long long)seg * din * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (l * R + r < n) {
          pc[r] = pr[r];
          pc[carry_half + r] = gl[r];
        }
      }
    }
  } else {
    float* red = smem + S * lay.floats;     // [2][consumers][kSub][W]
    // step 2: the carry into the segment, folded over the later segments
    // from the last, g = fma(P, g, g_loc) from g = dhT: the twin's order
    float g[R], da[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = l * R + r;
      g[r] = ch_live && s < n && p.dhT
                 ? p.dhT[((long long)b * din + ch) * n + s] : 0.f;
      da[r] = 0.f;
    }
    if (ch_live) {
#pragma unroll 4
      for (int z = segs - 1; z > seg; --z) {
        const float* pc = p.carries + carry_at + (long long)z * din * n;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (l * R + r < n) g[r] = fmaf(pc[r], g[r], pc[carry_half + r]);
      }
    }
    const float d_c = ch_live ? p.dskip[ch] : 0.f;
    float dd = 0.f;

    // step 3: the segment's chunks from the last
    float* dx_ch = p.dx + (long long)b * T * din + ch;
    float* part_b = p.partial + ((long long)b * nbx + blockIdx.x) * T * W;
    int buf = 0;
    for (int j = 0; j < nck; ++j) {
      const int c = nck - 1 - j, k = k_lo + c, s = j % S;
      const int t0 = k * kChunk, steps = min(kChunk, T - t0);
      const int subs = (steps + kSub - 1) / kSub;
      mbar_wait(&full[s], (j / S) & 1);
      const float* st = smem + s * lay.floats;

      // back through the sub-chunks, each recomputed from its start state
      for (int q = subs - 1; q >= 0; --q) {
        float hp[kSub + 1][R], e[kSub][R];
        load_states<R>(my_starts + (c * kSubs + q) * start_stride, hp[0]);
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = q * kSub + i;
          const float dtt = st[lay.dt + t];
          const float dtx = dtt * st[lay.x + t * C + lc];
          float bv[R];
          load_states<R>(st + lay.b + t * NP + l * R, bv);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            e[i][r] = expf(av[r] * dtt);
            hp[i + 1][r] = fmaf(e[i][r], hp[i][r], dtx * bv[r]);
          }
        }
        float* red_w = red + (buf * consumers + warp) * kSub * W;
#pragma unroll
        for (int i = kSub - 1; i >= 0; --i) {
          const int t = q * kSub + i;
          const float dtt = st[lay.dt + t];
          const float xv = st[lay.x + t * C + lc];
          const float dyv = st[lay.dy + t * C + lc];
          const float dtx = dtt * xv;
          float bv[R], cv[R], pv[V];
          load_states<R>(st + lay.b + t * NP + l * R, bv);
          load_states<R>(st + lay.c + t * NP + l * R, cv);
          float gb = 0.f, pdt = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float G = fmaf(dyv, cv[r], g[r]);
            const float w = G * (e[i][r] * hp[i][r]);    // G e h_{t-1}
            pv[r] = G * dtx;                  // db
            pv[R + r] = dyv * hp[i + 1][r];   // dc
            gb = fmaf(G, bv[r], gb);
            pdt = fmaf(av[r], w, pdt);
            da[r] = fmaf(dtt, w, da[r]);
            g[r] = e[i][r] * G;
          }
          pdt = fmaf(xv, gb, pdt);
          dd = fmaf(dyv, xv, dd);
          // dx: the channel's L lanes' sum of G b
#pragma unroll
          for (int o = kSpread; o < 32; o <<= 1)
            gb += __shfl_xor_sync(kFull, gb, o);
          store_if(dx_ch + (long long)(t0 + t) * din,
                   fmaf(d_c, dyv, dtt * gb), ch_live && l == 0 && t < steps);
          // db, dc: over the warp's channels; ddt: over the whole warp
          channel_round<V, kSpread / 2, V>(pv, m);
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            pdt += __shfl_xor_sync(kFull, pdt, o);
          float* red_t = red_w + i * W;
          if (kSpread < V || m < V) {
#pragma unroll
            for (int u = 0; u < kHeld; ++u) {
              const int v = (kSpread < V ? m * kHeld : m) + u;
              red_t[v < R ? l * R + v : NP + l * R + v - R] = pv[u];
            }
          }
          if (lane == 0) red_t[2 * NP] = pdt;
        }
        // the block's sums of this sub-chunk, in warp order
        asm volatile("bar.sync 1, %0;\n" ::"r"(consumers * 32) : "memory");
        const float* red_b = red + buf * consumers * kSub * W;
        const int t_q = t0 + q * kSub, live = min(kSub, steps - q * kSub);
        for (int i = tid; i < live * W; i += consumers * 32) {
          float sum = 0.f;
          for (int w = 0; w < consumers; ++w) sum += red_b[w * kSub * W + i];
          part_b[(long long)t_q * W + i] = sum;
        }
        buf ^= 1;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = l * R + r;
      if (ch_live && s < n) {
        if (seg == 0) p.dh0[((long long)b * din + ch) * n + s] = g[r];
        p.da_part[((long long)(b * segs + seg) * din + ch) * n + s] = da[r];
      }
    }
    if (ch_live && l == 0)
      p.dd_part[(long long)(b * segs + seg) * din + ch] = dd;
  }
}

// Step 1 of the backward: replays each segment, stores its start states and
// its decay product and local carry.  Its registers are few: capped for 4
// blocks an SM, the stages' shared memory allows that many.
template <int R, int L>
__global__ void __launch_bounds__(kBwdMaxConsumers + 32, kReplayMinBlocks)
selective_scan_bwd_replay_kernel(const BwdArgs p) {
  bwd_body<R, L, true>(p);
}

// Steps 2 and 3 of the backward: folds the carries and walks back.
template <int R, int L>
__global__ void __launch_bounds__(kBwdMaxConsumers + 32, kBwdMinBlocks)
selective_scan_bwd_kernel(const BwdArgs p) {
  bwd_body<R, L, false>(p);
}

// The second pass: one thread an output.  dB, dC (B, T, n) and ddt (B, T)
// add the channel blocks' partials (B, blocks, T, 2 NP + 1) in block
// order; da (din, n) and dD (din) add the partials of the rows and
// segments, (B, S, din, n) and (B, S, din), in row order.
__global__ void selective_scan_bwd_sum_kernel(
    const float* __restrict__ partial, const float* __restrict__ da_part,
    const float* __restrict__ dd_part, float* __restrict__ ddt,
    float* __restrict__ dbb, float* __restrict__ dcc, float* __restrict__ da,
    float* __restrict__ dd, int B, int T, int din, int n, int NP, int nbx,
    int segs) {
  const int W = 2 * NP + 1, per_t = 2 * n + 1;
  const long long steps = (long long)B * T * per_t;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < steps) {
    const long long bt = i / per_t;
    const int k = i % per_t, b = bt / T;
    const int t = bt % T;
    // the partial's column: db states, then dc states, then ddt
    const int col = k < n ? k : k < 2 * n ? NP + k - n : 2 * NP;
    const float* p = partial + ((long long)b * nbx * T + t) * W + col;
    float sum = 0.f;
    for (int x = 0; x < nbx; ++x) sum += p[(long long)x * T * W];
    if (k < n) dbb[bt * n + k] = sum;
    else if (k < 2 * n) dcc[bt * n + k - n] = sum;
    else ddt[bt] = sum;
    return;
  }
  const long long j = i - steps;
  const long long per_b = (long long)din * n;
  const int rows = B * segs;
  if (j < per_b) {
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += da_part[r * per_b + j];
    da[j] = sum;
  } else if (j < per_b + din) {
    const long long c = j - per_b;
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += dd_part[(long long)r * din + c];
    dd[c] = sum;
  }
}

// Raises a kernel's dynamic shared memory limit once per card (above the
// default 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t (&granted)[64]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (granted[dev] < smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted[dev] = smem;
  }
  return cudaSuccess;
}

struct Args {
  const float *xs, *dt, *bb, *cc, *a, *dskip, *h0;
  long long sxb, sxt;
  float *y, *hT, *ckpt;
  int B, T, din, n, C, S, route;
};

template <int R, int L, bool kCkpt>
cudaError_t launch_fwd(const Args& p, cudaStream_t stream) {
  static size_t granted[64] = {};
  const dim3 grid((p.din + p.C - 1) / p.C, p.B);
  const int threads = p.C * L + 32;          // and the producer warp
  // no more stages than chunks
  const int stages = min(p.S, (p.T + kChunk - 1) / kChunk);
  const size_t smem = (size_t)stages * layout(p.C, R * L).floats * 4;
  const cudaError_t e =
      allow_smem(selective_scan_fwd_kernel<R, L, kCkpt>, smem, granted);
  if (e != cudaSuccess) return e;
  selective_scan_fwd_kernel<R, L, kCkpt><<<grid, threads, smem, stream>>>(
      p.xs, p.sxb, p.sxt, p.dt, p.bb, p.cc, p.a, p.dskip, p.h0, p.y, p.hT,
      p.ckpt, p.T, p.din, p.n, p.C, stages, p.route);
  return cudaGetLastError();
}

template <int R, int L>
cudaError_t launch(const Args& p, cudaStream_t stream) {
  if (p.ckpt) return launch_fwd<R, L, true>(p, stream);
  if (p.T == 1) {
    const dim3 grid((p.din + p.C - 1) / p.C, p.B);
    selective_scan_step_kernel<R, L><<<grid, p.C * L, 0, stream>>>(
        p.xs, p.sxb, p.dt, p.bb, p.cc, p.a, p.dskip, p.h0, p.y, p.hT, p.din,
        p.n, p.C);
    return cudaGetLastError();
  }
  return launch_fwd<R, L, false>(p, stream);
}

// One launch of the replay (step 1) or of the walk back (steps 2 and 3):
// grid (ceil(din / C), B, segments).
template <int R, int L>
cudaError_t launch_bwd(const BwdArgs& p, bool replay, cudaStream_t stream) {
  static size_t granted_replay[64] = {}, granted_walk[64] = {};
  const dim3 grid((p.din + p.C - 1) / p.C, p.B, p.segments);
  const int threads = p.C * L + 32;
  const size_t smem =
      (size_t)bwd_smem_floats(p.C, L, R * L, kBwdStages, replay) * 4;
  cudaError_t e;
  if (replay) {
    e = allow_smem(selective_scan_bwd_replay_kernel<R, L>, smem,
                   granted_replay);
    if (e != cudaSuccess) return e;
    selective_scan_bwd_replay_kernel<R, L><<<grid, threads, smem, stream>>>(p);
  } else {
    e = allow_smem(selective_scan_bwd_kernel<R, L>, smem, granted_walk);
    if (e != cudaSuccess) return e;
    selective_scan_bwd_kernel<R, L><<<grid, threads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

bool bad_geometry(int B, int T, int din, int n, int states, int lanes,
                  int channels) {
  const int np = states * lanes;
  return B < 1 || T < 1 || din < 1 || n < 1 || n > np || channels < 4 ||
         channels % 4 != 0 || (channels * lanes) % 32 != 0 ||
         channels * lanes > kMaxConsumers;
}

}  // namespace

extern "C" int selective_scan_chunk() { return kChunk; }

// xs strides in elements (its channel stride is 1); B, T, din >= 1; states
// (R) and lanes (L) one of the compiled pairs below with 1 <= n <= R L;
// channels (C) a multiple of 4 with C L a multiple of 32, at most 256
// (a producer warp comes on top);
// 1 <= stages <= 4; route: kBulkDt | kBulkBC | kVecX for the operands the
// wrapper found aligned (kBulkBC needs n == R L).  ckpt: null, or
// (B, ceil(T / kChunk) + 1, din, n) for the state at the start of every
// chunk and the final one (selective_scan_fwd_ckpt).  Returns the launch's
// CUDA error.
static int fwd(const void* xs, long long sxb, long long sxt,
               const void* dt, const void* bb, const void* cc, const void* a,
               const void* dskip, const void* h0, void* y, void* hT,
               void* ckpt, int B, int T, int din, int n, int states,
               int lanes, int channels, int stages, int route, void* stream) {
  if (bad_geometry(B, T, din, n, states, lanes, channels) || stages < 1 ||
      stages > kMaxStages || ((route & kBulkBC) && n != states * lanes))
    return (int)cudaErrorInvalidValue;
  const Args p{static_cast<const float*>(xs), static_cast<const float*>(dt),
               static_cast<const float*>(bb), static_cast<const float*>(cc),
               static_cast<const float*>(a), static_cast<const float*>(dskip),
               static_cast<const float*>(h0), sxb, sxt,
               static_cast<float*>(y), static_cast<float*>(hT),
               static_cast<float*>(ckpt), B, T, din, n, channels, stages,
               route};
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

extern "C" int selective_scan_fwd(const void* xs, long long sxb,
                                  long long sxt, const void* dt,
                                  const void* bb, const void* cc,
                                  const void* a, const void* dskip,
                                  const void* h0, void* y, void* hT, int B,
                                  int T, int din, int n, int states,
                                  int lanes, int channels, int stages,
                                  int route, void* stream) {
  return fwd(xs, sxb, sxt, dt, bb, cc, a, dskip, h0, y, hT, nullptr, B, T,
             din, n, states, lanes, channels, stages, route, stream);
}

extern "C" int selective_scan_fwd_ckpt(const void* xs, long long sxb,
                                       long long sxt, const void* dt,
                                       const void* bb, const void* cc,
                                       const void* a, const void* dskip,
                                       const void* h0, void* y, void* hT,
                                       void* ckpt, int B, int T, int din,
                                       int n, int states, int lanes,
                                       int channels, int stages, int route,
                                       void* stream) {
  if (!ckpt) return (int)cudaErrorInvalidValue;
  return fwd(xs, sxb, sxt, dt, bb, cc, a, dskip, h0, y, hT, ckpt, B, T, din,
             n, states, lanes, channels, stages, route, stream);
}

// One of the backward's two main launches, after the geometry's checks.
static int bwd(const BwdArgs& p, int states, int lanes, bool replay,
               void* stream) {
  const int chunks = (p.T + kChunk - 1) / kChunk;
  if (bad_geometry(p.B, p.T, p.din, p.n, states, lanes, p.C) ||
      p.C * lanes > kBwdMaxConsumers || p.seg_chunks < 1 ||
      p.segments != (chunks + p.seg_chunks - 1) / p.seg_chunks ||
      ((p.route & kBulkBC) && p.n != states * lanes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (states * 100 + lanes) {
    case 101: return (int)launch_bwd<1, 1>(p, replay, st);
    case 201: return (int)launch_bwd<2, 1>(p, replay, st);
    case 401: return (int)launch_bwd<4, 1>(p, replay, st);
    case 402: return (int)launch_bwd<4, 2>(p, replay, st);
    case 404: return (int)launch_bwd<4, 4>(p, replay, st);
    case 408: return (int)launch_bwd<4, 8>(p, replay, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward's first launch (selective_scan_bwd_replay_kernel): step 1.
// Operands as the forward's, with ckpt its checkpoints and dy (B, T, din)
// contiguous; writes starts, each block's lanes' state at the start of
// every kSub steps of its segment (B, segments, ceil(din / C), seg_chunks
// kChunk / kSub, C L, R), and carries, the decay product and local carry
// of each segment but the first, (2, B, segments, din, n).  route: the
// forward's bits and kVecDy.  The geometry's rules are the forward's, with
// C L at most kBwdMaxConsumers; T is cut into `segments` segments of
// `seg_chunks` chunks (the last may hold fewer, none is empty).
extern "C" int selective_scan_bwd_replay(
    const void* xs, long long sxb, long long sxt, const void* dt,
    const void* bb, const void* cc, const void* a, const void* ckpt,
    const void* dy, void* starts, void* carries, int B, int T, int din,
    int n, int states, int lanes, int channels, int seg_chunks, int segments,
    int route, void* stream) {
  BwdArgs p{};
  p.xs = static_cast<const float*>(xs);
  p.dt = static_cast<const float*>(dt);
  p.bb = static_cast<const float*>(bb);
  p.cc = static_cast<const float*>(cc);
  p.a = static_cast<const float*>(a);
  p.ckpt = static_cast<const float*>(ckpt);
  p.dy = static_cast<const float*>(dy);
  p.sxb = sxb;
  p.sxt = sxt;
  p.starts = static_cast<float*>(starts);
  p.carries = static_cast<float*>(carries);
  p.B = B; p.T = T; p.din = din; p.n = n; p.C = channels;
  p.seg_chunks = seg_chunks; p.segments = segments; p.route = route;
  return bwd(p, states, lanes, true, stream);
}

// The backward's second launch (selective_scan_bwd_kernel): steps 2 and 3
// from the first launch's starts and carries, with dhT (B, din, n) or null
// (zeros); writes dx (B, T, din), dh0 and the partials: da_part (B,
// segments, din, n), dd_part (B, segments, din) and partial (B,
// ceil(din / C), T, 2 R L + 1).  The geometry as the first launch's.
extern "C" int selective_scan_bwd(
    const void* xs, long long sxb, long long sxt, const void* dt,
    const void* bb, const void* cc, const void* a, const void* dskip,
    const void* dy, const void* dhT, const void* starts,
    const void* carries, void* dx, void* dd_part, void* da_part, void* dh0,
    void* partial, int B, int T, int din, int n, int states, int lanes,
    int channels, int seg_chunks, int segments, int route, void* stream) {
  BwdArgs p{};
  p.xs = static_cast<const float*>(xs);
  p.dt = static_cast<const float*>(dt);
  p.bb = static_cast<const float*>(bb);
  p.cc = static_cast<const float*>(cc);
  p.a = static_cast<const float*>(a);
  p.dskip = static_cast<const float*>(dskip);
  p.dy = static_cast<const float*>(dy);
  p.dhT = static_cast<const float*>(dhT);
  p.sxb = sxb;
  p.sxt = sxt;
  p.starts = static_cast<float*>(const_cast<void*>(starts));
  p.carries = static_cast<float*>(const_cast<void*>(carries));
  p.dx = static_cast<float*>(dx);
  p.dd_part = static_cast<float*>(dd_part);
  p.da_part = static_cast<float*>(da_part);
  p.dh0 = static_cast<float*>(dh0);
  p.partial = static_cast<float*>(partial);
  p.B = B; p.T = T; p.din = din; p.n = n; p.C = channels;
  p.seg_chunks = seg_chunks; p.segments = segments; p.route = route;
  return bwd(p, states, lanes, false, stream);
}

// The backward's second pass (selective_scan_bwd_sum_kernel): np = R L,
// blocks = ceil(din / C) and segments of the first pass's launch.
extern "C" int selective_scan_bwd_sum(const void* partial,
                                      const void* da_part,
                                      const void* dd_part, void* ddt,
                                      void* dbb, void* dcc, void* da,
                                      void* dd, int B, int T, int din, int n,
                                      int np, int blocks, int segments,
                                      void* stream) {
  if (B < 1 || T < 1 || din < 1 || n < 1 || n > np || blocks < 1 ||
      segments < 1)
    return (int)cudaErrorInvalidValue;
  const long long outs = (long long)B * T * (2 * n + 1) + (long long)din * n
                         + din;
  const int threads = 256;
  selective_scan_bwd_sum_kernel<<<(unsigned)((outs + threads - 1) / threads),
                                  threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<const float*>(da_part),
      static_cast<const float*>(dd_part), static_cast<float*>(ddt),
      static_cast<float*>(dbb), static_cast<float*>(dcc),
      static_cast<float*>(da), static_cast<float*>(dd), B, T, din, n, np,
      blocks, segments);
  return (int)cudaGetLastError();
}

// The backward's shared memory a block, in bytes, for the wrapper's check.
extern "C" int selective_scan_bwd_smem(int states, int lanes, int channels) {
  return bwd_smem_floats(channels, lanes, states * lanes, kBwdStages, false)
         * 4;
}

// The backward's compile-time knobs as built (0: steps a sub-chunk, 1:
// compute threads a block at most, 2 and 3: blocks an SM of the register
// cap, the walk's and the replay's).
extern "C" int selective_scan_bwd_knobs(int which) {
  return which == 0 ? kSub : which == 1 ? kBwdMaxConsumers
         : which == 2 ? kBwdMinBlocks : kReplayMinBlocks;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
