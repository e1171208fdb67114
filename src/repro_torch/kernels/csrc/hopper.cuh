// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_wgmma.cuh, ssd_scan.cu): mbarriers, TMA loads, cp.async,
// wgmma shared-memory descriptors and the wgmma instructions themselves,
// the fences between them, the 128-byte swizzle that ties the descriptors
// to the bytes in shared memory, and the split of float32 into bf16 (or
// float16) pieces.  Every 16-bit element type has bf16's layout: 64
// columns to a 128-byte atom.
//
// Operand layout.  A bf16 operand tile of rows x cols is cols / 64 column
// blocks ("atoms") of rows x 128 bytes, each atom 1024-byte aligned; inside
// an atom the 16-byte chunk c of row r sits at chunk c ^ (r % 8) (the
// 128-byte swizzle, as TMA's SWIZZLE_128B writes it and wgmma reads it).
// K-major operands (K contiguous: Q, K, C, B_mat, h^T) step K by 32 bytes
// inside an atom and jump an atom after four k16 steps; MN-major operands
// (M or N contiguous: V, dtx, B_mat^T) step K by 16 rows (2048 bytes), SBO
// being 8 rows (1024 bytes) and LBO the next atom along M or N.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int kAtom = 64;        // bf16 columns of one 128-byte swizzle atom
constexpr int kAtomBytes = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (row, col) of a swizzled operand tile with
// `rows` rows (rows a multiple of 8; see the layout above).
__device__ __forceinline__ uint32_t swizzle_offset(int row, int col, int rows) {
  const int c = col % kAtom;
  return (uint32_t)((col / kAtom) * rows * kAtomBytes + row * kAtomBytes +
                    ((((c * 2) >> 4) ^ (row & 7)) << 4) + ((c * 2) & 15));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One count-based arrival (release): the arriving thread's earlier shared
// memory stores are visible to the threads that wait on the phase.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// One TMA box of a 4-D (d, heads, L, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// cp.async: 16 bytes (both addresses 16-byte aligned, L1 bypassed), 8 or 4.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Make this thread's generic-proxy shared-memory stores visible to the
// async proxy (wgmma operand reads); a block barrier must follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B).
// K-major operands: rows 128 B apart, 8-row groups 1024 B apart (SBO); LBO
// unused.  MN-major operands: SBO steps 8 rows of K (1024 B), LBO the next
// atom along M or N.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accumulator accesses across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16 WG_D8(0), WG_D8(8)
#define WG_D32 WG_D16, WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_R16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32                                                            \
  WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31"
#define WG_R64                                                              \
  WG_R32                                                                    \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "   \
  "%60, %61, %62, %63"

#define WG_D128                                                    \
  WG_D64, WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88), WG_D8(96),   \
      WG_D8(104), WG_D8(112), WG_D8(120)
#define WG_R128 \
  WG_R64 \
  ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127"

// d (+)= A B for a 64 x 64 tile, A and B from shared memory, both K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x 32 tile, A and B from shared memory, both K-major.
__device__ __forceinline__ void mma_ss_n32(float (&d)[16], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_D16
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x N tile (N 96, 128 or 192), A and B from shared
// memory, both K-major.
#define WG_D48 WG_D32, WG_D8(32), WG_D8(40)
#define WG_R48                                                            \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47"
#define WG_D96 WG_D64, WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88)
#define WG_R96 \
  WG_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95"
#define HOPPER_MMA_SS_K(NAME, N, DN, RN, A, B, P)                         \
  __device__ __forceinline__ void NAME(float(&d)[N / 2], uint64_t a,      \
                                       uint64_t b, int accumulate) {      \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" P ", 0;\n"       \
                 " wgmma.mma_async.sync.aligned.m64n" #N                  \
                 "k16.f32.bf16.bf16 {" RN "}, %" A ", %" B                \
                 ", p, 1, 1, 0, 0;\n}\n"                                   \
                 : DN                                                     \
                 : "l"(a), "l"(b), "r"(accumulate));                      \
  }
HOPPER_MMA_SS_K(mma_ss_n96, 96, WG_D48, WG_R48, "48", "49", "50")
HOPPER_MMA_SS_K(mma_ss_n128, 128, WG_D64, WG_R64, "64", "65", "66")
HOPPER_MMA_SS_K(mma_ss_n192, 192, WG_D96, WG_R96, "96", "97", "98")
#undef HOPPER_MMA_SS_K

// d (+)= A B for a 64 x N tile, A and B from shared memory, both MN-major
// (both transpose bits set).
template <int N>
__device__ __forceinline__ void mma_ss_mn(float (&d)[N / 2], uint64_t a,
                                          uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void mma_ss_mn<64>(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void mma_ss_mn<128>(float (&d)[64], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B, A from registers (four bf16x2 per thread, the layout of a
// 64 x 16 slice of an m64 accumulator), B from shared memory, MN-major
// (transpose bit set).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The 16-bit kinds flash attention's tensor-core kernel runs in, bf16 and
// float16 (flash_wgmma.cuh): the same shapes and operand layouts, the
// element type a template argument.  mma_ss_t: a 64 x 64 tile, A and B
// from shared memory, both K-major; mma_rs_t<E, N>: a 64 x N tile (N 64,
// 128 or 256), A from registers (the m64 accumulator's slice layout) and B
// from shared memory, MN-major.
#define HOPPER_MMA_SS64(NAME, TY)                                          \
  __device__ __forceinline__ void NAME(float(&d)[32], uint64_t a,          \
                                       uint64_t b, int accumulate) {       \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"            \
                 " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY  \
                 " {" WG_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"            \
                 : WG_D32                                                  \
                 : "l"(a), "l"(b), "r"(accumulate));                       \
  }
#define HOPPER_MMA_RS(NAME, TY, N, DN, RN, A0, A1, A2, A3, B, P)          \
  __device__ __forceinline__ void NAME(float(&d)[N / 2],                  \
                                       const uint32_t(&a)[4], uint64_t b,  \
                                       int accumulate) {                   \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" P ", 0;\n"        \
                 " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." \
                 TY " {" RN "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B  \
                 ", p, 1, 1, 1;\n}\n"                                      \
                 : DN                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),     \
                   "r"(accumulate));                                       \
  }
HOPPER_MMA_SS64(mma_ss_f16, "f16")
HOPPER_MMA_RS(mma_rs_f16_64, "f16", 64, WG_D32, WG_R32, "32", "33", "34",
              "35", "36", "37")
HOPPER_MMA_RS(mma_rs_f16_128, "f16", 128, WG_D64, WG_R64, "64", "65", "66",
              "67", "68", "69")
HOPPER_MMA_RS(mma_rs_f16_256, "f16", 256, WG_D128, WG_R128, "128", "129",
              "130", "131", "132", "133")
HOPPER_MMA_RS(mma_rs_bf16_256, "bf16", 256, WG_D128, WG_R128, "128", "129",
              "130", "131", "132", "133")
#undef HOPPER_MMA_SS64
#undef HOPPER_MMA_RS

template <typename E>
__device__ __forceinline__ void mma_ss_t(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (std::is_same<E, __half>::value)
    mma_ss_f16(d, a, b, accumulate);
  else
    mma_ss(d, a, b, accumulate);
}

template <typename E, int N>
__device__ __forceinline__ void mma_rs_t(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  constexpr bool kF16 = std::is_same<E, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kF16) mma_rs_f16_64(d, a, b, accumulate);
    else mma_rs<64>(d, a, b, accumulate);
  } else if constexpr (N == 128) {
    if constexpr (kF16) mma_rs_f16_128(d, a, b, accumulate);
    else mma_rs<128>(d, a, b, accumulate);
  } else {
    static_assert(N == 256, "wgmma widths 64, 128 and 256");
    if constexpr (kF16) mma_rs_f16_256(d, a, b, accumulate);
    else mma_rs_bf16_256(d, a, b, accumulate);
  }
}

// x0, x1 as K pieces of bf16x2: p[0] = bf16(x), p[k] = bf16(x - p[0] - ...
// - p[k-1]).  Each remainder is exact in float32, so two pieces carry x to
// about 16 bits and three to about 24 (float32's own 24).
template <int K>
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&p)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    p[k] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// x0, x1 as a hi/lo pair of E x2 (bf16 or float16): p[0] = E(x), p[1] =
// E(x - p[0]), the remainder exact in float32.
template <typename E>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t (&p)[2]) {
  if constexpr (std::is_same<E, __half>::value) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const __half2 h = __floats2half2_rn(x0, x1);
      const float2 hf = __half22float2(h);
      p[k] = *reinterpret_cast<const uint32_t*>(&h);
      x0 -= hf.x;
      x1 -= hf.y;
    }
  } else {
    split_bf16(x0, x1, p);
  }
}

// Eight float32 values as K 16-byte chunks of bf16 pieces (piece k of all
// eight in out[k]).
template <int K>
__device__ __forceinline__ void split8(const float (&v)[8], uint4 (&out)[K]) {
  uint32_t p[4][K];
#pragma unroll
  for (int k = 0; k < 4; ++k) split_bf16(v[2 * k], v[2 * k + 1], p[k]);
#pragma unroll
  for (int k = 0; k < K; ++k)
    out[k] = make_uint4(p[0][k], p[1][k], p[2][k], p[3][k]);
}

}  // namespace hopper
