// Hopper (sm_90a) kernels for blockwise online-softmax attention with GQA,
// causal and sliding-window masks, bound to Python through a plain C
// interface and ctypes (repro_torch/kernels/flash_attention.py).  Both
// replace the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel):
//
//   o[b, i, h] = sum_j softmax_j(q_i . k_j d^-1/2 | mask) v_j,
//   kv head of query head h = h / (H / KVH),
//   visible iff j < Lk, (causal) j <= i, (window w) j > i - w,
//
// with query rows i < Lq and keys j < Lk both counted from 0, as in the
// Pallas kernel, so Lk may differ from Lq (the encoder-decoder's
// cross-attention: Lq decoder tokens over Lk = 1024 frames).  Masked
// scores take -1e30, the running max, normalizer and accumulator are
// float32, and the output is in q's dtype.  A row that sees no key (a
// window with Lk < Lq) is outside the contract, as it is the Pallas
// kernel's, whose output there differs from its reference's.
// The wrapper routes every bf16 and float16 input with a head dim up to 256
// to flash_wgmma_kernel (fed by TMA where q, k and v sit on 16-byte
// boundaries and the head dim is a multiple of 8, by a producer warpgroup
// of its own otherwise), head dims above 256 to flash_wide_kernel and
// float32 to flash_kernel; q, k and v of mixed dtypes arrive cast to
// float32.
//
// What bounds them on an H100.  At yi-6b's prefill (B = 1, L = 8192, 32
// query heads, 4 kv heads, d = 128) causal attention is about 5.5e11
// operations against 151 MB of q, k, v and o, so the arithmetic bounds it:
// 0.556 ms on bf16 tensor cores (989 TFLOP/s), 8.2 ms on float32 CUDA cores
// (67 TFLOP/s).  seamless-m4t-medium's cross-attention (B = 4, Lq = 8192
// tokens over Lk = 1024 frames, 16 heads, d = 64, no mask) is 1.4e11
// operations against 151 MB: 0.139 ms on the tensor cores, 0.045 ms of
// bytes, so the arithmetic bounds it too.
//
// flash_wgmma_kernel (flash_wgmma.cuh; bf16 or float16, d a multiple of 8
// up to 256): both products on the tensor cores, so it can run below the
// 8.2 ms CUDA-core floor, which flash_kernel cannot.  The element type is a
// template argument: float16 runs wgmma's f16 kind at the same m64nNk16
// shapes, its tensor maps TMA's FLOAT16 type.  One block per (query head,
// q tile of 128 rows, batch row), two warpgroups of 64 rows each.  Q (once) and every 64-key K and V tile
// arrive by TMA into 128-byte-swizzled shared memory, tracked by
// mbarriers; the K/V tiles go through a ring of kStages = 2 stages that
// both warpgroups read, and one thread issues the loads of tile t + 2 as
// soon as both are done with tile t, so a tile's copy overlaps the
// previous tile's arithmetic.  At d = 128 a block takes 96 KB of shared
// memory, so two blocks (four warpgroups) share an SM and one block's
// softmax overlaps another's products.  (One warpgroup per block, one
// warpgroup with 128-key tiles, a 3- or 4-stage ring at one block per SM,
// and releasing a stage per warpgroup instead of by one block barrier were
// all slower on the H100.)  The tensor maps are 4-D over (d, heads, L,
// B), L = Lq for Q and Lk for K and V, so rows past either length read as
// zeros within their own batch row.  S = Q K^T
// is wgmma m64n64k16 with both operands in shared memory (K-major: d
// contiguous); d^-1/2 (times log2 e, for exp2) is applied to the float32
// scores after the product, never to 16-bit Q.
// The online softmax runs in the accumulator registers: a thread holds two
// rows, each row spread over the 4 threads of a quad, reduced by a fixed
// xor order.  P V is wgmma m64n{d}k16 with P from registers (the S
// accumulator layout is the A-fragment layout) and V from shared memory
// (MN-major: the transpose bit).  P enters as a hi/lo pair of bf16,
// P_hi = bf16(P), P_lo = bf16(P - P_hi), O += P_hi V + P_lo V (float16's
// pair for float16 inputs): the
// reference multiplies a float32 P by V, and a single bf16 P would add a
// rounding that neither the reference nor the plain path has.  The split
// costs 1.5x the tensor-core products of a single bf16 P (8.3e11 instead
// of 5.5e11 operations at the slice shape: 0.83 ms at the bf16 peak).
// Masks are evaluated only on tiles that some row of the warpgroup cannot
// fully see; tiles no row can see are skipped (exact, as in flash_kernel),
// and q tiles run longest first (the q tile is the slower grid axis, so
// every head of a tile is dispatched before the next shorter tile).  No
// atomics: two launches give bitwise-equal outputs.
//
// Head dims.  The kernel runs at a width W of 64, 128 or 256 columns, the
// head dim d a run-time argument: d up to 64 at W 64, up to 128 at W 128
// (d 96, phi3-mini, as 1.5 of the 64-column atoms), up to 256 at W 256.
// The tensor maps keep the true d, so a box past it reads zeros (TMA's fill):
// the atoms that hold a column below d are loaded, the rest never.  S = Q
// K^T takes only the k16 steps that cover d (six at d 96); P V runs at nW
// (wgmma's MN-major V needs whole 64-column atoms) and output columns past
// d are never stored.  The scale stays d^-1/2.  Through TMA d must be a
// multiple of 8 (a tensor map's row stride is a multiple of 16 bytes, its
// base 16-byte aligned); the loaded route below takes any d.  At W 256 a
// block takes 64 KB
// of Q and 2 x 32 KB each of K and V (193 KB), so one block an SM, and a
// warpgroup's 64 x 256 float32 O is 128 registers a thread; this was
// chosen over two blocks of 128 output columns each that recompute S over
// all 256 (as flash_wide_kernel splits its columns), which would do 4/3 of
// the products (S twice beside P_hi V and P_lo V) for a second block an SM.
// float16's P: P_hi = f16(P), P_lo = f16(P - P_hi) as bf16's pair; P in [0,
// 1] fits, and below P ~ 2^-3 P_lo is subnormal, its absolute error near
// 2^-25, which the smoke's float16-ulp check reads.  float16's ulp is 8x
// finer than bf16's, and that check is where a long O accumulation on the
// tensor cores shows: with O accumulated over every tile in wgmma's float32
// accumulator (as bf16 does), yi-6b's float16 slice read 1.67 float16 ulps
// from the float32 reference on the H100 (0.59 bf16 ulps in bf16, whose
// rounding hides it), an error that grows with the number of keys (0.5 at
// a few hundred).  So for float16 each tile's P V goes, one 64-column atom
// at a time, into a fresh accumulator that is added to O in float32 with
// round to nearest: 32 more registers a thread.
//
// The loaded route (flash_wgmma_kernel<E, W, true>, flash_loaded.cu):
// 16-bit q, k and v that TMA cannot read, because one of them starts off a
// 16-byte boundary (a view, or a slice of a packed buffer) or the head dim
// is not a multiple of 8, so that rows start 2 bytes into a word.  A
// tensor map needs a 16-byte base and 16-byte row strides, and cp.async a
// source aligned to its copy size, so neither can copy such a row into
// place; one 2-byte load an element would cost eight times the
// instructions.  So a third warpgroup, the producer, reads each row as the
// aligned 16-byte words that span it: thread t takes 16-byte chunk c = t %
// (W / 8) of every (128 / (W / 8))-th row, loads words c and c + 1 (the
// second an L1 hit, shared with the next lane's first; addresses clamped
// to the row's last word, never past it), shifts the chunk into place with
// funnel shifts (flash_load.cuh) and stores it into the same
// 128-byte-swizzled atoms TMA writes, zeros past d and past L.  Two
// batches of four rows a thread are in flight: the next batch's loads
// overlap this one's shifts.  Its generic-proxy stores are made visible to
// wgmma's async proxy (fence.proxy.async) before each producer warp
// arrives on the stage's mbarrier (four arrivals in place of TMA's
// expected bytes), and the consumers release a stage by a warp's arrival
// on an "empty" barrier of their own (eight) in place of the block
// barrier, which the producer no longer shares.  Three K/V stages up to
// width 128 (the producer may run two tiles ahead), two at 256.  The
// consumers' arithmetic is TMA's route's, so at a head dim that is a
// multiple of 8 an input off a boundary gives the same bits as the same
// values on one (at width 256 bf16's P V runs as four 64-column products,
// each column's sums in the same order: the same bits, with 608 bytes of
// spill stores where one 256-column product has 4552, and 4.3x faster at
// gemma-7b's d 256 slice; PERF.md).  The output is stored column by column
// below d, a pair in one 4-byte store where it starts on a 4-byte
// boundary.  The block is 384 threads, so a thread gets at most 168
// registers: enough at widths 64 and 128, while at 256 the consumers
// (239-241 on TMA's route) spill; setmaxnreg, moving the producer's
// registers to them, did not stop ptxas spilling on the H100's toolchain
// (nvcc 12.9), nor did a one-warp producer (the register file is split
// over four schedulers, so 288 threads are allotted as 384).  What the
// producer costs beside TMA, and what was tried, is in PERF.md.
//
// flash_kernel (float32): every product in float32 on CUDA cores (never
// TF32), so it cannot beat the 8.2 ms floor; it is the checked float32
// route.  It is instantiated at widths D of 16, 32, 64, 96, 128 and 256;
// any head dim up to 256 runs the next width, the true dim a run-time
// argument: columns past it load as zeros (each adds an exact 0 to a
// score, so a dim that is a width gets the same bits as before the
// argument existed) and are not stored.  At D = 256 a block takes 213,760
// bytes of float32 shared memory, one block an SM.  One block per (q tile
// of 64 rows, query head, batch row), 256 threads in a 16 x 16 grid;
// thread (ty, tx) owns score rows ty + 16 r and columns tx + 16 c (r, c <
// 4) and output columns tx + 16 c (c < d / 16), so neighbouring threads
// read neighbouring shared-memory words and the 16 threads of one row are
// one half-warp, which reduces the row's max and sum with a fixed xor
// butterfly.  The sequential kv axis of the Pallas grid is the loop inside
// the block: a 64-row K and V tile is staged in shared memory, the 64 x 64
// scores stay in registers, the probabilities go through shared memory
// into P V.  Causal and window masks let the loop skip kv tiles that no
// row of the q tile can see (exact: every row sees its own position, so a
// skipped tile would only have added terms that the online rescale
// multiplies by exp(-1e30) = 0), which halves the causal work; q tiles are
// scheduled longest first.  GQA reads the shared kv head in place, never
// expanded.  No atomics: two launches give bitwise-equal outputs.  (It
// once also took the 16-bit inputs TMA cannot read, widened to float32:
// 26-28 ms at yi-6b's and gemma-7b's prefill shapes on an H100 80GB HBM3 at
// 700 W, against 1.5-2.1 ms on the tensor cores.)
//
// flash_wide_kernel (head dims above 256, any dtype, CUDA cores): one
// block per (q tile, head, batch row) computes each score once.  A block
// of 16 RT q rows (RT 4, 2, 1 for d up to 512, 1024, 2048) keeps Q
// resident in shared memory (float32, pre-scaled, up to 132 KB) and all
// 512 / 1024 / 2048 output columns in registers (128 floats a thread);
// each kv tile of 64 keys is a stream of K chunks (64 keys x 64 columns:
// S over all of d, each score the same ascending fmaf chain as
// flash_kernel's) and V chunks (4 RT keys x every output column: P V,
// each output's sum over keys in key order), double-buffered: chunk i + 1
// is copied by cp.async (16 bytes where base and row stride allow, 4 for
// float32 elsewhere) or by flash_load.cuh's byte-permute loads (16-bit off
// 4-byte boundaries) while chunk i runs.  P goes through shared memory as
// in flash_kernel; thread tx reads four neighbouring V columns a group
// of 64 with one vector load.  An earlier design kept 128 output columns a
// block and recomputed S over all of d in each, (d / 128)(d + 128) fmaf a
// (q, key) pair against 2 d here (2.1x at d 320, 2.5x at d 512); the
// arithmetic and its order are that design's, so its outputs are expected
// bit for bit (tools/kernel_bits_vs_tree.py's wide cases hold them
// against an older tree's).  Past 2048
// the columns split over blocks again (Q then streams by chunk beside K),
// each slice recomputing S: a head dim no model has.  Up to 215 KB of
// shared memory, one block an SM.  No atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_simt.cuh"
#include "flash_wgmma.cuh"

namespace {

// float32 at head dims up to 128: its own width or the next of 16, 32, 64,
// 96 and 128 (flash_contract.cu launches the rest).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, int B,
                     int Lq, int Lk, int H, int KVH, int D, int causal,
                     int window, void* o, cudaStream_t s) {
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  if (D <= 16) return launch<T, 16>(FLASH_ARGS);
  if (D <= 32) return launch<T, 32>(FLASH_ARGS);
  if (D <= 64) return launch<T, 64>(FLASH_ARGS);
  if (D <= 96) return launch<T, 96>(FLASH_ARGS);
  return launch<T, 128>(FLASH_ARGS);
#undef FLASH_ARGS
}

}  // namespace

extern "C" {

int flash_contract_launch(const void* q, const void* k, const void* v,
                          int dtype, int B, int Lq, int Lk, int H, int KVH,
                          int D, int causal, int window, void* o,
                          void* stream);

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o alike): float32
// at any head dim D >= 1 (up to 128 flash_kernel here, the rest through
// flash_contract.cu), 16-bit past 256 (flash_wide_kernel); 16-bit at D <=
// 256 is refused (the tensor cores' routes take it).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           int dtype, int B, int Lq, int Lk, int H, int KVH,
                           int D, int causal, int window, void* o,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH || Lk < 1) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (dtype == 0 && D <= 128) return (int)dispatch<float>(FLASH_ARGS);
#undef FLASH_ARGS
  return flash_contract_launch(q, k, v, dtype, B, Lq, Lk, H, KVH, D, causal,
                               window, o, stream);
}

int flash_wgmma_contract_launch(int dtype, const void* q, const void* k,
                                const void* v, int B, int Lq, int Lk, int H,
                                int KVH, int D, int causal, int window,
                                void* o, void* stream);
int flash_wgmma_contract_blocks_per_sm(int dtype, int D);

// bf16 q, k, v and o (16-byte aligned) with D a multiple of 8 up to 256, on
// the tensor cores: widths 64 and 128 here, 256 through flash_contract.cu.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 int B, int Lq, int Lk, int H, int KVH, int D,
                                 int causal, int window, void* o,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WG_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (D >= 1 && D <= 64) return (int)wg::launch<__nv_bfloat16, 64>(WG_ARGS);
  if (D > 64 && D <= 128) return (int)wg::launch<__nv_bfloat16, 128>(WG_ARGS);
#undef WG_ARGS
  return flash_wgmma_contract_launch(1, q, k, v, B, Lq, Lk, H, KVH, D, causal,
                                     window, o, stream);
}

// Dynamic shared memory of one flash_wgmma_kernel block at head dim D (any
// 16-bit type), -1 past 256.
int flash_attention_wgmma_smem_bytes(int D) {
  if (D < 1 || D > 4 * wg::kAtom) return -1;
  switch (wg::width_of(D)) {
    case 64: return wg::Layout<64>::kBytes;
    case 128: return wg::Layout<128>::kBytes;
    default: return wg::Layout<256>::kBytes;
  }
}

// Blocks of the bf16 flash_wgmma_kernel an SM holds at once at head dim D;
// -1 if the query failed.
int flash_attention_wgmma_blocks_per_sm(int D) {
  if (D < 1 || D > 4 * wg::kAtom) return -1;
  switch (wg::width_of(D)) {
    case 64: return wg::blocks_per_sm<__nv_bfloat16, 64>();
    case 128: return wg::blocks_per_sm<__nv_bfloat16, 128>();
    default: return flash_wgmma_contract_blocks_per_sm(1, D);
  }
}

}  // extern "C"
