// Hopper (sm_90a) tile machinery shared by the flash-attention kernels on
// the tensor cores (flash_attention_fwd.cu, flash_attention_bwd.cu): TMA
// copies into shared memory reported to mbarriers, wgmma shared-memory
// descriptors for the no-swizzle core-matrix layout, and the wgmma
// instructions (bf16 in, f32 accumulate) the kernels issue.
//
// Operand layout.  A bf16 tile of R rows x DP columns lies in shared memory
// as DP / 8 column chunks of R rows x 16 bytes (one TMA box of the map
// make_map builds): element (r, c) at byte (c / 8) * R * 16 + r * 16 +
// (c % 8) * 2.  Eight rows of a chunk are one 128-byte core matrix, so the
// same bytes serve as a K-major operand (rows are M or N, columns are K:
// desc(addr, R * 16, 128), k16 steps 2 * R * 16 bytes apart) and as an
// MN-major B operand (rows are K, columns are N: desc(addr + 256 kk, 128,
// R * 16) for rows 16 kk .. 16 kk + 15, with B transposed).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that never ends (a copy that never lands) traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (tries == (1u << 24)) __trap();
  }
}

// One TMA box of the 3-D map (D, S, heads) into shared memory; completion
// is counted in bytes on `bar`.  Elements out of bounds arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}


// A wgmma shared-memory descriptor, no swizzle: start address, LBO and SBO
// in 16-byte units (bits 0-13, 16-29, 32-45), layout type 0 (bits 62-63).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins a register's value at this point, so the compiler moves no read of
// an accumulator above the wait and reuses no A fragment before it.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin_all(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(x[i]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (lo, hi) rounded to bf16 and packed, lo in the low half; the values the
// packed pair stands for are subtracted from (lo, hi).
__device__ __forceinline__ uint32_t take_bf16x2(float& lo, float& hi) {
  __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  uint32_t u = *reinterpret_cast<uint32_t*>(&b);
  lo -= __uint_as_float(u << 16);
  hi -= __uint_as_float(u & 0xFFFF0000u);
  return u;
}

// A 64 x 16 KK f32 accumulator (wgmma's layout: thread (w, lane) of the
// warpgroup holds rows 16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4)
// + {0, 1}) as TERMS bf16 terms in A-fragment form, 4 registers per k16:
// term 0 is bf16(x), term 1 bf16(x - term 0), ...
template <int TERMS, int KK>
__device__ __forceinline__ void split_terms(uint32_t (&a)[TERMS][KK][4],
                                            const float (&x)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float lo = x[8 * kk + 2 * r], hi = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int term = 0; term < TERMS; ++term)
        a[term][kk][r] = take_bf16x2(lo, hi);
    }
  }
}

#define WG_F8(i)                                                        \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),  \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define WG_Z8(i)                                                        \
  "=f"(d[(i)]), "=f"(d[(i) + 1]), "=f"(d[(i) + 2]), "=f"(d[(i) + 3]),  \
      "=f"(d[(i) + 4]), "=f"(d[(i) + 5]), "=f"(d[(i) + 6]), "=f"(d[(i) + 7])

// The wgmma instructions (bf16 in, f32 accumulate): `wgmma_ss_n64`, a 64 x
// 64 product with A and B K-major in shared memory; `wgmma_rs`, a 64 x N
// product with A a bf16 fragment in registers (the accumulator's layout)
// and B MN-major in shared memory.  Each adds to its accumulator; the
// `_zero` forms overwrite it (scale-d false), so the accumulator is
// write-only there and not live before.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64_zero(float (&d)[32], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_Z8(0), WG_Z8(8), WG_Z8(16), WG_Z8(24)
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32_zero(float (&d)[16], uint64_t da,
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_Z8(0), WG_Z8(8)
      : "l"(da), "l"(db), "r"(0));
}

// The scores wgmma of a 64 x 64 or a 64 x 32 accumulator.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, bool zero) {
  if (zero) wgmma_ss_n64_zero(d, da, db); else wgmma_ss_n64(d, da, db);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, bool zero) {
  if (zero) wgmma_ss_n32_zero(d, da, db); else wgmma_ss_n32(d, da, db);
}

// S = A B^T over the head dim, A (64 rows) and B (N rows) K-major tiles
// of DP / 8 column chunks with row counts ra and rb (LBO ra * 16 and
// rb * 16; N = 64 or 32, the accumulator's columns / 2 registers): DP / 16
// steps of k16, the first overwriting S.  Not committed.
template <int DP, int R>
__device__ __forceinline__ void wgmma_scores(float (&s)[R], uint32_t a_addr,
                                             int ra, uint32_t b_addr,
                                             int rb) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss(s, desc(a_addr + ks * 2 * ra * 16, ra * 16, 128),
             desc(b_addr + ks * 2 * rb * 16, rb * 16, 128), ks == 0);
}

// wgmma_rs and wgmma_rs_zero for N = 16 K (K = 1..8): the accumulator's
// N / 2 registers are operands 0 .. N/2 - 1 (WG_D##K, WG_OUT##K), then the
// four A registers A0..A3, B's descriptor and the scale-d flag P.
#define WG_D1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_D2 WG_D1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_D3 WG_D2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_D4 WG_D3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_D5 WG_D4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_D6 WG_D5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_D7 WG_D6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_D8 WG_D7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_OUT1(M) M(0)
#define WG_OUT2(M) WG_OUT1(M), M(8)
#define WG_OUT3(M) WG_OUT2(M), M(16)
#define WG_OUT4(M) WG_OUT3(M), M(24)
#define WG_OUT5(M) WG_OUT4(M), M(32)
#define WG_OUT6(M) WG_OUT5(M), M(40)
#define WG_OUT7(M) WG_OUT6(M), M(48)
#define WG_OUT8(M) WG_OUT7(M), M(56)
#define WG_RS_ASM(K, N, A0, A1, A2, A3, B, P, OUT, SCALE_D)                \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "          \
      "{" WG_D##K "}, "                                                    \
      "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n" \
      : WG_OUT##K(OUT)                                                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SCALE_D))
#define WG_RS(K, N, A0, A1, A2, A3, B, P)                                  \
  __device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],              \
      const uint32_t (&a)[4], uint64_t db) {                               \
    WG_RS_ASM(K, N, A0, A1, A2, A3, B, P, WG_F8, 1);                       \
  }                                                                        \
  __device__ __forceinline__ void wgmma_rs_zero(float (&d)[N / 2],         \
      const uint32_t (&a)[4], uint64_t db) {                               \
    WG_RS_ASM(K, N, A0, A1, A2, A3, B, P, WG_Z8, 0);                       \
  }
WG_RS(1, 16, 8, 9, 10, 11, 12, 13)
WG_RS(2, 32, 16, 17, 18, 19, 20, 21)
WG_RS(3, 48, 24, 25, 26, 27, 28, 29)
WG_RS(4, 64, 32, 33, 34, 35, 36, 37)
WG_RS(5, 80, 40, 41, 42, 43, 44, 45)
WG_RS(6, 96, 48, 49, 50, 51, 52, 53)
WG_RS(7, 112, 56, 57, 58, 59, 60, 61)
WG_RS(8, 128, 64, 65, 66, 67, 68, 69)
#undef WG_RS
#undef WG_RS_ASM
#undef WG_D1
#undef WG_D2
#undef WG_D3
#undef WG_D4
#undef WG_D5
#undef WG_D6
#undef WG_D7
#undef WG_D8
#undef WG_OUT1
#undef WG_OUT2
#undef WG_OUT3
#undef WG_OUT4
#undef WG_OUT5
#undef WG_OUT6
#undef WG_OUT7
#undef WG_OUT8
#undef WG_F8
#undef WG_Z8

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The (D, S, heads) bf16 tensor as a TMA map of (8, rows, 1) boxes: one box
// is a 16-byte column chunk of `rows` rows, which lands in shared memory as
// rows x 16 contiguous bytes, wgmma's no-swizzle core-matrix layout.
inline bool make_map(CUtensorMap* map, const void* ptr, int d, int s,
                     int heads, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                        static_cast<cuuint64_t>(heads)};
  cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                           static_cast<cuuint64_t>(s) * d * 2};
  cuuint32_t box[3] = {8, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
