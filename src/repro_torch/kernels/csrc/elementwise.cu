// The sampler's fused elementwise passes for Hopper (sm_90a): the DDIM step
// and the Parareal update with its L1 residual, with or without the
// previous iterate, each one launch.
//
// ddim_fused_kernel replaces repro/kernels/elementwise.py::ddim_fused_pallas
// (TPU body _ddim_kernel).  Per element, in f32, rounded once to the
// output's type:
//
//   out = sqrt(b) * (x - sqrt(1 - a) * e) / sqrt(a) + sqrt(1 - b) * e
//
// with one (a, b) per row of x's leading axis, or one pair for all.  The
// formula is the plain version's (repro_torch/kernels/ref.py::ddim_fused):
// "/ sqrt(a)", where the TPU kernel writes "* rsqrt(a)" (ROADMAP C4 lists
// the spellings); the four square roots are taken once per row and vector,
// never folded into two coefficients of x and e.
//
// parareal_resid_cluster_kernel replaces elementwise.py::
// parareal_update_residual_pallas (TPU body _parareal_resid_kernel): out =
// y + cur - prev from f32, rounded once, and per slice of the preserved
// leading axes the f32 sum of |out_f32 - old|.
//
// parareal_update_cluster_kernel replaces elementwise.py::
// parareal_update_pallas (TPU body _parareal_kernel): the same out, and
// the f32 sum of |cur - prev| over the whole tensor (the size of the
// correction, which norm='l2_mean' and 'linf' runs compute but do not
// gate on).  The TPU kernel writes one partial per (rows, 128) tile and
// ops.py sums them; here the whole tensor is one slice of the residual's
// cluster scheme below, so the sum is finished inside the one launch.
//
// Bound.  All three move bytes and compute almost nothing: at the DiT's
// latents ((10, 64, 64, 4) f32 for a fine DDIM step, (2, 64, 64, 4) for a
// corrector block) one call moves 0.2-2 MB, under a microsecond at 3.35
// TB/s, so in practice the launch bounds them.  The design does what it can
// about that: one launch per call (no second pass and no scratch tensor for
// the residual), 16-byte accesses (4 f32 or 8 bf16/f16 per thread access),
// and a plain C interface behind ctypes, so the host path is a few
// microseconds.
//
// DDIM: the wrapper's grid (ddim_geometry in elementwise.py) gives each
// 16-byte vector, and each element after the vectors, a thread of its own.
// On an H100 at (10, 64, 64, 4) f32 one vector a thread (160 blocks) ran
// 1.9-2.1 us a launch against 2.7 us for a grid-stride loop over 132
// blocks and 3.1 us over 66, which is why there is no loop.  The vector
// path runs when x, e and out are 16-byte aligned and a row's length is a
// multiple of the vector, so no vector straddles two rows and a row's
// coefficients load once per vector; otherwise (n_vec = 0), and for the
// ragged tail of a scalar-coefficient call, threads take one element each
// with the same arithmetic, so both paths give the same bits.
// Every operation is rounded on its own, in the plain version's order.
//
// Residual (B1, and B4 with one slice): each slice is one thread-block
// cluster of up to 8 blocks (the portable limit), launched with cudaLaunchKernelEx and the cluster
// dimension as an attribute.  The cluster size, the blocks' spans and the
// thread count depend on the slice's length alone (resid_geometry in
// elementwise.py), so a slice's sum is bitwise the same whatever other
// slices ride in the batch.  At the corrector's slices of 32768 f32 that
// is 8 blocks of 1024 threads, one 16-byte group a thread: 4.1 us a launch
// on an H100, against 4.4-9.5 us for fewer blocks or threads, whose
// threads wait on one group's loads before the next's.  In a fixed order:
//   1. each thread sums |out - old| (B4: |cur - prev|) over its groups of
//      16 bytes' worth of elements, element by element in index order (the scalar path, for
//      unaligned operands or a slice length that is no multiple of the
//      vector, keeps that order, so it gives the vector path's bits);
//   2. each warp by a shuffle tree (xor 16, 8, 4, 2, 1; lane 0's value),
//      the block's warps by warp 0 in the same tree, into the block's own
//      shared memory;
//   3. cluster.sync();
//   4. rank 0 reads the ranks' partials through distributed shared memory
//      (cluster.map_shared_rank) in rank order and writes resid[slice];
//   5. cluster.sync() again, so that no block exits while its shared
//      memory is being read.
// No float atomics, no partials tensor, no second launch: two runs are
// bitwise equal.  One device body (update_cluster_body) serves both
// kernels; each has its own __global__ entry and name, so a profile tells
// them apart.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDdimThreads = 256;
constexpr int kResidMaxThreads = 1024;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float2 to_f32(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_f32(__half2 v) { return __half22float2(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <typename T2> __device__ __forceinline__ T2 from_f32(float lo, float hi);
template <> __device__ __forceinline__ __nv_bfloat162 from_f32<__nv_bfloat162>(float lo, float hi) {
  return __floats2bfloat162_rn(lo, hi);
}
template <> __device__ __forceinline__ __half2 from_f32<__half2>(float lo, float hi) {
  return __floats2half2_rn(lo, hi);
}

// 16 bytes of T (N elements) as floats, and back, rounding to nearest even
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<__half> { using type = __half2; };

template <typename T> struct Vec {          // bf16, f16: 8 a vector
  static constexpr int N = 8;
  using T2 = typename Pair<T>::type;
  __device__ __forceinline__ static void load(const T* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const T2* h = reinterpret_cast<const T2*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = to_f32(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    uint4 v;
    T2* h = reinterpret_cast<T2*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = from_f32<T2>(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <> struct Vec<float> {             // f32: 4 a vector
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// The square roots of one (a, b) pair, shared by the elements of a vector,
// and the formula with every operation rounded on its own (the _rn
// intrinsics are never contracted into an FMA), as the plain version's
// separate tensor operations round them.
struct Ddim {
  float sqrt_1ma, sqrt_a, sqrt_b, sqrt_1mb;
  __device__ __forceinline__ Ddim(float a, float b) {
    // set in the body: nvcc's host pass keeps a device constructor's
    // member initializers, where the device intrinsics do not exist
    sqrt_1ma = __fsqrt_rn(__fsub_rn(1.0f, a));
    sqrt_a = __fsqrt_rn(a);
    sqrt_b = __fsqrt_rn(b);
    sqrt_1mb = __fsqrt_rn(__fsub_rn(1.0f, b));
  }
  __device__ __forceinline__ float operator()(float x, float e) const {
    const float x0 = __fdiv_rn(__fsub_rn(x, __fmul_rn(sqrt_1ma, e)), sqrt_a);
    return __fadd_rn(__fmul_rn(sqrt_b, x0), __fmul_rn(sqrt_1mb, e));
  }
};

// x, e, out: n elements; a, b: one pair per row of n_row elements
// (coef_stride 1) or one for all (coef_stride 0).  Thread t < n_vec takes
// vector t (n_vec = 0 when the wrapper found the operands unfit for it);
// thread n_vec + k takes element n_vec * N + k while that is below n.
// Indices are 64-bit: a 32-bit form ran no faster on an H100 (2.09 against
// 2.05 us a launch at (10, 64, 64, 4) f32 per-row).
using Index = unsigned long long;

template <typename T>
__global__ void __launch_bounds__(kDdimThreads)
ddim_fused_kernel(const T* __restrict__ x, const T* __restrict__ e,
                  const float* __restrict__ a, const float* __restrict__ b,
                  T* __restrict__ out, Index n, Index n_vec, Index n_row,
                  int coef_stride) {
  using V = Vec<T>;
  const Index t = (Index)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n_vec) {
    const Index i = t * V::N;
    const Index row = coef_stride ? i / n_row : 0;
    const Ddim step(a[row], b[row]);
    float xv[V::N], ev[V::N];
    V::load(x + i, xv);
    V::load(e + i, ev);
#pragma unroll
    for (int j = 0; j < V::N; ++j) xv[j] = step(xv[j], ev[j]);
    V::store(out + i, xv);
  } else if (n_vec * (V::N - 1) + t < n) {
    const Index i = n_vec * (V::N - 1) + t;
    const Index row = coef_stride ? i / n_row : 0;
    const Ddim step(a[row], b[row]);
    out[i] = from_f32<T>(step(to_f32(x[i]), to_f32(e[i])));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The body of both cluster kernels.  One slice per cluster (grid: cluster
// size x slices, clusters along x).  Block r of a cluster owns groups
// r * per_block .. (r + 1) * per_block - 1 of its slice, a group being the
// N elements of one 16-byte vector (the last one cut at n_slice); thread t
// walks groups t, t + blockDim.x, ...  kVector: the 16-byte path (operands
// aligned, n_slice a multiple of N).  kOld: the residual is |out - old|
// (B1); otherwise it is |cur - prev| (B4), and old is never read.
template <typename T, bool kVector, bool kOld>
__device__ __forceinline__ void update_cluster_body(
    const T* __restrict__ y, const T* __restrict__ cur,
    const T* __restrict__ prev, const T* __restrict__ old,
    T* __restrict__ out, float* __restrict__ resid, long long n_slice,
    long long per_block) {
  using V = Vec<T>;
  __shared__ float warp_part[kResidMaxThreads / 32];
  __shared__ float block_part;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long slice = blockIdx.x / cluster.num_blocks();
  const long long base = slice * n_slice;
  const long long groups = (n_slice + V::N - 1) / V::N;
  const long long g_end = min(groups, (rank + 1) * per_block);
  float acc = 0.0f;
  for (long long g = rank * per_block + threadIdx.x; g < g_end;
       g += blockDim.x) {
    const long long i = base + g * V::N;
    if (kVector) {
      float yv[V::N], cv[V::N], pv[V::N], ov[V::N];
      V::load(y + i, yv);
      V::load(cur + i, cv);
      V::load(prev + i, pv);
      if constexpr (kOld) V::load(old + i, ov);
#pragma unroll
      for (int j = 0; j < V::N; ++j) {
        if constexpr (!kOld) acc += fabsf(cv[j] - pv[j]);
        yv[j] = __fsub_rn(__fadd_rn(yv[j], cv[j]), pv[j]);
        if constexpr (kOld) acc += fabsf(yv[j] - ov[j]);
      }
      V::store(out + i, yv);
    } else {
      const int m = (int)min((long long)V::N, base + n_slice - i);
      for (int j = 0; j < m; ++j) {
        const float c = to_f32(cur[i + j]), p = to_f32(prev[i + j]);
        const float o = __fsub_rn(__fadd_rn(to_f32(y[i + j]), c), p);
        out[i + j] = from_f32<T>(o);
        if constexpr (kOld)
          acc += fabsf(o - to_f32(old[i + j]));
        else
          acc += fabsf(c - p);
      }
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  acc = warp_sum(acc);
  if (lane == 0) warp_part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x / 32) ? warp_part[lane] : 0.0f;
    v = warp_sum(v);
    if (lane == 0) block_part = v;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float s = 0.0f;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r)
      s += *cluster.map_shared_rank(&block_part, r);
    resid[slice] = s;
  }
  cluster.sync();
}

// B1: per slice, out = y + cur - prev and resid[slice] = sum |out - old|.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kResidMaxThreads)
parareal_resid_cluster_kernel(const T* __restrict__ y,
                              const T* __restrict__ cur,
                              const T* __restrict__ prev,
                              const T* __restrict__ old,
                              T* __restrict__ out, float* __restrict__ resid,
                              long long n_slice, long long per_block) {
  update_cluster_body<T, kVector, true>(y, cur, prev, old, out, resid,
                                        n_slice, per_block);
}

// B4: one cluster for the whole tensor of n elements, out = y + cur - prev
// and resid[0] = sum |cur - prev|.  Its own entry, so that a profile keeps
// it apart from B1.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kResidMaxThreads)
parareal_update_cluster_kernel(const T* __restrict__ y,
                               const T* __restrict__ cur,
                               const T* __restrict__ prev,
                               T* __restrict__ out, float* __restrict__ resid,
                               long long n, long long per_block) {
  update_cluster_body<T, kVector, false>(y, cur, prev, nullptr, out, resid,
                                         n, per_block);
}

template <typename T>
cudaError_t launch_ddim(const void* x, const void* e, const void* a,
                        const void* b, void* out, long long n,
                        long long n_vec, long long n_row, int coef_stride,
                        int blocks, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* et = static_cast<const T*>(e);
  const float* at = static_cast<const float*>(a);
  const float* bt = static_cast<const float*>(b);
  T* ot = static_cast<T*>(out);
  ddim_fused_kernel<T><<<blocks, kDdimThreads, 0, stream>>>(
      xt, et, at, bt, ot, (Index)n, (Index)n_vec, (Index)n_row, coef_stride);
  return cudaGetLastError();
}

cudaLaunchConfig_t cluster_config(int cluster, int clusters, int threads,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * clusters), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch of a cluster kernel over `clusters` clusters of `cluster`
// blocks of `threads` threads.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int cluster, int clusters,
                           int threads, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, clusters, threads, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_resid(const void* y, const void* c, const void* p,
                         const void* o, void* out, void* resid,
                         long long n_slice, long long per_block, int slices,
                         int cluster, int threads, bool vector,
                         cudaStream_t stream) {
  return launch_cluster(vector ? &parareal_resid_cluster_kernel<T, true>
                               : &parareal_resid_cluster_kernel<T, false>,
                        cluster, slices, threads, stream,
                        static_cast<const T*>(y), static_cast<const T*>(c),
                        static_cast<const T*>(p), static_cast<const T*>(o),
                        static_cast<T*>(out), static_cast<float*>(resid),
                        n_slice, per_block);
}

template <typename T>
cudaError_t launch_update(const void* y, const void* c, const void* p,
                          void* out, void* resid, long long n,
                          long long per_block, int cluster, int threads,
                          bool vector, cudaStream_t stream) {
  return launch_cluster(vector ? &parareal_update_cluster_kernel<T, true>
                               : &parareal_update_cluster_kernel<T, false>,
                        cluster, 1, threads, stream,
                        static_cast<const T*>(y), static_cast<const T*>(c),
                        static_cast<const T*>(p), static_cast<T*>(out),
                        static_cast<float*>(resid), n, per_block);
}

// The cluster kernel of B4 (update_only) or B1, on its vector path or not.
template <typename T>
const void* cluster_kernel(bool update_only, bool vector) {
  if (update_only)
    return vector ? (const void*)&parareal_update_cluster_kernel<T, true>
                  : (const void*)&parareal_update_cluster_kernel<T, false>;
  return vector ? (const void*)&parareal_resid_cluster_kernel<T, true>
                : (const void*)&parareal_resid_cluster_kernel<T, false>;
}

template <typename T>
cudaError_t max_clusters(bool update_only, bool vector, int cluster,
                         int threads, int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, 1, threads, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(
      out, cluster_kernel<T>(update_only, vector), &cfg);
}

bool resid_shape_ok(long long n_slice, long long per_block, int slices,
                    int cluster, int threads) {
  return n_slice >= 1 && per_block >= 1 && slices >= 1 && cluster >= 1 &&
         cluster <= kMaxCluster && threads >= 32 &&
         threads <= kResidMaxThreads && threads % 32 == 0 &&
         (long long)cluster * slices <= 0x7fffffffLL;
}

}  // namespace

// dtype (of x, e and out): 0 = float32, 1 = bfloat16, 2 = float16.  a, b:
// f32, one per row of n_row elements (coef_stride 1) or one (0).  n_vec:
// the 16-byte vectors to take first (0, or n / N when the caller found x,
// e and out 16-byte aligned and n_row a multiple of N); blocks: the grid.
// Returns the launch's CUDA error.
extern "C" int ddim_fused(const void* x, const void* e, const void* a,
                          const void* b, void* out, long long n,
                          long long n_vec, long long n_row, int coef_stride,
                          int blocks, int dtype, void* stream) {
  if (n < 1 || n_vec < 0 || n_row < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_ddim<__nv_bfloat16>(x, e, a, b, out, n, n_vec, n_row,
                                     coef_stride, blocks, s);
  else if (dtype == 2)
    err = launch_ddim<__half>(x, e, a, b, out, n, n_vec, n_row, coef_stride,
                              blocks, s);
  else
    err = launch_ddim<float>(x, e, a, b, out, n, n_vec, n_row, coef_stride,
                             blocks, s);
  return (int)err;
}

// y, cur, prev, old, out: slices x n_slice elements of dtype (as above);
// resid: slices f32.  per_block, cluster and threads from the wrapper's
// resid_geometry; vector: 1 when the five operands are 16-byte aligned and
// n_slice is a multiple of the vector.  Returns the launch's CUDA error.
extern "C" int parareal_update_residual(const void* y, const void* c,
                                        const void* p, const void* o,
                                        void* out, void* resid,
                                        long long n_slice,
                                        long long per_block, int slices,
                                        int cluster, int threads, int vector,
                                        int dtype, void* stream) {
  if (!resid_shape_ok(n_slice, per_block, slices, cluster, threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_resid<__nv_bfloat16>(y, c, p, o, out, resid, n_slice,
                                      per_block, slices, cluster, threads,
                                      vector != 0, s);
  else if (dtype == 2)
    err = launch_resid<__half>(y, c, p, o, out, resid, n_slice, per_block,
                               slices, cluster, threads, vector != 0, s);
  else
    err = launch_resid<float>(y, c, p, o, out, resid, n_slice, per_block,
                              slices, cluster, threads, vector != 0, s);
  return (int)err;
}

// y, cur, prev, out: n elements of dtype (as above); resid: one f32, the
// sum of |cur - prev| over all n.  One cluster for the whole tensor:
// per_block, cluster and threads from the wrapper's resid_geometry(n);
// vector: 1 when the four operands are 16-byte aligned and n is a multiple
// of the vector.  Returns the launch's CUDA error.
extern "C" int parareal_update(const void* y, const void* c, const void* p,
                               void* out, void* resid, long long n,
                               long long per_block, int cluster, int threads,
                               int vector, int dtype, void* stream) {
  if (!resid_shape_ok(n, per_block, 1, cluster, threads))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = launch_update<__nv_bfloat16>(y, c, p, out, resid, n, per_block,
                                       cluster, threads, vector != 0, s);
  else if (dtype == 2)
    err = launch_update<__half>(y, c, p, out, resid, n, per_block, cluster,
                                threads, vector != 0, s);
  else
    err = launch_update<float>(y, c, p, out, resid, n, per_block, cluster,
                               threads, vector != 0, s);
  return (int)err;
}

// How many clusters of `cluster` blocks of `threads` threads a cluster
// kernel (update_only: B4's, else B1's; dtype; vector path) can hold at
// once on the current device (cudaOccupancyMaxActiveClusters), into *out.
// 0 means the configuration cannot launch.  Returns the query's CUDA error.
extern "C" int parareal_resid_max_clusters(int update_only, int dtype,
                                           int vector, int cluster,
                                           int threads, int* out) {
  if (cluster < 1 || cluster > kMaxCluster || threads < 32 ||
      threads > kResidMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 1)
    err = max_clusters<__nv_bfloat16>(update_only != 0, vector != 0, cluster,
                                      threads, out);
  else if (dtype == 2)
    err = max_clusters<__half>(update_only != 0, vector != 0, cluster,
                               threads, out);
  else
    err = max_clusters<float>(update_only != 0, vector != 0, cluster,
                              threads, out);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
