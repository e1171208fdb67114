// Loads of 16-bit rows from any 2-byte-aligned address, for the flash
// kernels that cannot read their inputs by TMA or cp.async
// (flash_wgmma.cuh's loaded route, flash_simt.cuh's flash_wide_kernel on
// 16-bit inputs off 16-byte boundaries).  TMA needs a 16-byte base and
// 16-byte row strides, cp.async a source aligned to its copy size; a
// contiguous (B, L, heads, d) 16-bit tensor one element off a boundary, or
// at a head dim that is not a multiple of 8, gives neither.  So a row's
// 8-element chunks are read as the aligned 16-byte words that cover them
// (one or two a chunk, the second shared with the next chunk and served
// by L1) and shifted into place with funnel shifts: two loads a chunk,
// never one 2-byte load an element.  Only words that hold a byte of the
// row are read, so no load leaves the row's 16-byte-aligned span.
// flash_wgmma.cuh's producer loads the words itself (__ldg into registers)
// and stores shift_chunk's result into the swizzled atoms.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_load {

// The 16 bytes at byte `off` (even, < 16) of w0:w1, elements past `valid`
// (of the eight) zeroed: chunk c of a row whose aligned words c and c + 1
// are w0 and w1, off the row's start within its first word.
__device__ __forceinline__ uint4 shift_chunk(const uint4& w0, const uint4& w1,
                                             uint32_t off, int valid) {
  const uint32_t u[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  // words off / 4 .. off / 4 + 4 of w0:w1, by selects (a run-time index
  // into u would put it in local memory)
  const uint32_t s = off >> 2;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    x[i] = s == 0 ? u[i] : s == 1 ? u[i + 1] : s == 2 ? u[i + 2] : u[i + 3];
  const uint32_t sh = (off & 2) ? 16u : 0u;
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __funnelshift_r(x[i], x[i + 1], sh);
  if (valid < 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (2 * i >= valid) out[i] = 0u;
      else if (2 * i + 1 >= valid) out[i] &= 0xFFFFu;
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Elements [8 c, 8 c + 8) of a row of n 16-bit elements that starts at
// `row` (2-byte aligned), zeros past n, as one 16-byte chunk read from
// global memory.  c >= 0.
__device__ __forceinline__ uint4 row_chunk(const void* row, int c, int n) {
  const int first = 8 * c;
  if (first >= n) return make_uint4(0u, 0u, 0u, 0u);
  const uintptr_t start = reinterpret_cast<uintptr_t>(row);
  const uintptr_t addr = start + 16 * (uintptr_t)c;
  const uintptr_t end = start + 2 * (uintptr_t)n;
  const uintptr_t a0 = addr & ~(uintptr_t)15;
  const uint32_t off = (uint32_t)(addr & 15);
  const uint4 w0 = __ldg(reinterpret_cast<const uint4*>(a0));
  uint4 w1 = make_uint4(0u, 0u, 0u, 0u);
  if (off != 0 && a0 + 16 < end)
    w1 = __ldg(reinterpret_cast<const uint4*>(a0 + 16));
  return shift_chunk(w0, w1, off, n - first);
}

}  // namespace flash_load
