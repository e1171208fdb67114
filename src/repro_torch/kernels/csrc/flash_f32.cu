// The float32 kind of flash_wgmma_kernel (flash_wgmma.cuh; the route's
// notes are flash_attention.cu's): float32 q, k and v on the tensor cores
// at float32 accuracy.  It replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel) on
// float32 inputs on 16-byte boundaries at head dims that are multiples of 4
// up to 128 (and on q, k, v of mixed dtypes, which the wrapper casts to
// float32); flash_kernel (flash_simt.cuh, CUDA cores) keeps the other
// float32 inputs.  A source of its own, so that nvcc builds its two
// instantiations beside the other sources.
//
// What bounds it on an H100.  At yi-6b's prefill slice in float32 (1 x
// 8192, 32 query heads over 4, d 128, causal) attention is 5.5e11
// operations against 302 MB: 8.2 ms on float32 CUDA cores (67 TFLOP/s),
// which bounds flash_kernel, and 0.09 ms of bytes.  On the tensor cores
// each float32 operand enters as three bf16 pieces x = x0 + x1 + x2 (each
// remainder exact in float32, so the pieces carry float32's 24 bits), and
// a product of two operands is the six piece products x_a y_b with a + b <
// 3 (the terms dropped are below 2^-24 of the product), as
// ssd_chunk_wgmma_kernel runs its float32 tiles (ssd_scan.cu): six times
// 0.556 ms of bf16 products, 3.34 ms.  TF32 keeps 10 bits of mantissa and
// is not used; a hi/lo pair (two pieces, three products) keeps about 16
// bits, which lands outside the float32 tolerance on the reference's
// cases (tests/test_torch_flash_attention.py emulates both).
//
// Design.  The loaded route's body (flash_wgmma_kernel<E, W, true>): a
// producer warpgroup and two consumer warpgroups of 64 q rows each.
//   - The producer reads each float32 row of Q (once a block), K and V
//     (each kv tile) as 16-byte words, eight columns a thread, splits them
//     into three bf16 pieces in registers (hopper::split8) and stores each
//     piece's 16-byte chunk into that piece's 128-byte-swizzled tile, the
//     layout TMA writes for bf16: Q's pieces once, K's and V's into a ring
//     of stages released by the consumers' arrivals, zeros past d and past
//     L.  No tensor map: TMA cannot split, and three bf16 tiles written
//     from one float32 read cost the producer one pass over the row.
//   - S = Q K^T: the six products on wgmma with both operands' pieces in
//     shared memory.  A K tile holds its three pieces as one operand of 3
//     x 32 rows (K_0, K_1, K_2), so Q_a [K_0 .. K_{2-a}]^T is one wgmma of
//     (3 - a) x 32 columns a k16 step (n96, n64, n32: three in place of
//     six, and a third less shared memory read than six n32 products),
//     each into the columns of an accumulator of three 32-column blocks
//     that sum one order each: block 0 the main product Q_0 K_0, block 1
//     Q_1 K_0 + Q_0 K_1, block 2 Q_2 K_0 + Q_1 K_1 + Q_0 K_2, issued a =
//     2, 1, 0 (smallest first); S = block 0 + (block 2 + block 1) in
//     float32.  wgmma adds each k16 block into its float32 accumulator with
//     an alignment of its own, and an addition into a large accumulator
//     costs about 2^-23 of it (ssd_scan.cu, "Accumulation order"), so the
//     main product keeps an accumulator of its own.
//   - The online softmax runs in float32 in the accumulator registers,
//     masks before the exponential, exactly as the 16-bit kinds.
//   - P (float32, in the accumulator layout, which is wgmma's A-fragment
//     layout) is split into three bf16 pieces in registers; P V is the six
//     products of P's and V's pieces, smallest first, for each 64-column
//     atom of O into a fresh accumulator that is added to O in float32
//     (round to nearest), as float16's kind adds each tile's P V: O stays
//     out of wgmma's accumulation across the kv tiles.
// Shared memory.  At width 128 Q's three pieces for the two consumer
// warpgroups take 96 KiB, and K's and V's pieces 96 KiB a stage of 64
// keys: two such stages do not fit 227 KiB.  The kernel takes kv tiles of
// kF32BlockN = 32 keys in two stages (48 KiB each: 197,672 bytes a block,
// one block an SM; S is wgmma m64n32k16), so that the producer fills one
// stage while the consumers read the other; at width 64, four stages of
// 32 keys (148,552 bytes).  The alternative, 64-key tiles in one stage
// (the consumers wait while the producer fills it; S's accumulator then
// spills at 168 registers), is tools/flash_copies.py's f32_kv64 copy: on
// an H100 80GB HBM3 at 700 W it took 12.45 ms at yi-6b's float32 slice
// against 8.83 for the 32-key ring, 11.76 against 7.94 at phi3-mini's d 96
// and 0.803 against 0.578 at phi-2's d 80.  The copies with one side alone
// put the time in the consumers: 7.71 ms at yi-6b's slice without the
// producer's stores, 3.36 with the consumers' arithmetic skipped.
// Registers: the launch's 384 threads get at most 168 a thread; a consumer
// holds O (64 floats at width 128), S's three blocks (48), P's pieces (24)
// and one atom's P V (32).  Fixed order, no atomics: two launches give
// bitwise-equal outputs.

#include "flash_wgmma.cuh"

extern "C" {

// float32 q, k, v and o, contiguous, each on a 16-byte boundary; head dim
// D a multiple of 4 up to 128 (width 64 up to 64, else 128).
int flash_attention_wgmma_f32_launch(const void* q, const void* k,
                                     const void* v, int B, int Lq, int Lk,
                                     int H, int KVH, int D, int causal,
                                     int window, void* o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (D >= 1 && D <= wg::kAtom) return (int)wg::launch_f32<64>(WG_ARGS);
  if (D > wg::kAtom && D <= 2 * wg::kAtom)
    return (int)wg::launch_f32<128>(WG_ARGS);
#undef WG_ARGS
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the float32 kind at head dim D, -1
// past 128.
int flash_wgmma_f32_smem_bytes(int D) {
  if (D < 1 || D > 2 * wg::kAtom) return -1;
  return D <= wg::kAtom ? wg::LayoutF32<64>::kBytes : wg::LayoutF32<128>::kBytes;
}

// Blocks of the float32 kind an SM holds at once at head dim D; -1 if the
// query failed or D is past 128.
int flash_wgmma_f32_blocks_per_sm(int D) {
  if (D < 1 || D > 2 * wg::kAtom) return -1;
  return D <= wg::kAtom ? wg::blocks_per_sm_f32<64>() : wg::blocks_per_sm_f32<128>();
}

}  // extern "C"
