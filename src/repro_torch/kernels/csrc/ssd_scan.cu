// Hopper (sm_90a) kernels for the Mamba2 SSD (arXiv:2405.21060 §6), bound
// to Python through a plain C interface and ctypes
// (repro_torch/kernels/ssd_scan.py).  Three of them replace the Pallas TPU
// kernel src/repro/kernels/ssd_scan.py::ssd_chunk_tiles (_ssd_chunk_kernel),
// the intra-chunk tile: for every (batch x chunk, head)
//
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dtx_j      (Q x P)
//   state = sum_j exp(cum_Q - cum_j) B_j (x) dtx_j                (N x P)
//
// with the decay masked before the exponential and float32 accumulation (B
// and C arrive in the model's dtype).  The wrapper routes Q in {64, 128}
// and N, P in {64, 128} to ssd_chunk_wgmma_kernel (tensor cores), the same
// Q and P at N = 16 (jamba's state width) to ssd_chunk_wgmma_n16_kernel
// (tensor cores), every other shape up to 128 (and inputs off a 16-byte
// boundary) to ssd_chunk_kernel (float32 CUDA cores), and wider tiles or
// float16 B and C to ssd_chunk_generic_kernel.  The other three replace
// the XLA code around the Pallas tile in
// ssd_chunked_pallas (the inter-chunk lax.scan and the inter-chunk output
// term, src/repro/kernels/ssd_scan.py:133-145):
//
//   y_c[i] = y_intra_c[i] + exp(cum_c,i) C_c,i . h_{c-1},
//   h_c    = exp(cum_c,Q) h_{c-1} + state_c,    h_{-1} = 0,
//
// written straight into the (B, L, H, P) output in its dtype, pad rows
// dropped, and the final state h.  The wrapper routes Q in {64, 128}, N a
// multiple of 16 and P a multiple of 32 to ssd_state_pass_wgmma_kernel
// (tensor cores), other shapes with Q, N <= 128, P a multiple of 4 and
// 16-byte rows of C (the reference's small cases: Q 32, N 8, P 16) to
// ssd_state_pass_kernel (float32 CUDA cores), and everything else (wider,
// ragged, float16, unaligned) to ssd_state_pass_generic_kernel.
//
// What bounds them on an H100.  At mamba2-370m's prefill (B = 4, L = 8192:
// 256 chunks x 32 heads, Q = 128, N = 128, P = 64, bf16 B and C) the tile
// moves about 0.82 GB (dtx, y and the states at 268 MB each): 0.245 ms at
// 3.35 TB/s (0.62 GB when the tile reads the model's bf16 x and dt in
// place of dtx).  On the pairs the decay lets through (j <= i) its
// function is 2.6e10 float32 operations, 0.39 ms on CUDA cores (67
// TFLOP/s), which bounds ssd_chunk_kernel; as the bf16 pieces below they
// are 1.0e11 tensor-core operations (989 TFLOP/s): 0.11 ms, so the
// tensor-core tile is bound by memory.  The state pass moves 0.69 GB (y_intra and the states read at
// 268 MB each, y written in bf16, 134 MB; 0.205 ms).  C . h is 1.7e10
// float32 operations, 0.26 ms on CUDA cores, which bounds
// ssd_state_pass_kernel; as the two products of bf16 C and h's hi/lo pair
// it is 3.4e10 tensor-core operations, 0.035 ms, so the tensor-core pass is
// bound by its bytes.  Measured (tools/ssd_probe.py), the per-chunk work of
// its serial walk, more than its bytes, holds it at about 1.7x that bound.
// At jamba's prefill (B = 1, L = 8192: 64 chunks x 128 heads, P = 64, N =
// 16) the tile moves 0.58 GB (0.172 ms; 0.45 GB, 0.133 ms, with dt x on
// load): its state product is an eighth of mamba2's, so it is bound by
// dtx and y alone, as its loads, splits and stores are (tools/ssd_probe.py
// has the copies without products and without stores).
//
// ssd_chunk_wgmma_kernel.  One block of two warpgroups takes kHeadsTc = 8
// heads of one chunk.  B and C are shared by the heads (ngroups = 1), so
// G = C B^T is made once per block, on the tensor cores, and stays in the
// accumulator registers: warpgroup w holds rows 64 w .. 64 w + 63 and only
// the 64-column halves that its rows can see (j <= i), so at Q = 128 the
// first warpgroup skips a quarter of G and of the y product.  For each head:
//   - dtx (Q x P float32), or the model's x (in B's dtype) and dt, arrives
//     by cp.async in a staging buffer, issued while the previous head's
//     products run (one head ahead), with the head's cum (and dt;
//     double-buffered by head);
//   - the block splits dtx (formed as dt x, rounded as the plain path
//     rounds it) into bf16 pieces in 128-byte-swizzled shared memory,
//     MN-major (P contiguous), and likewise w_j dtx_j with
//     w_j = exp(cum_Q - cum_j), so that a bf16 B^T needs no split;
//   - each warpgroup forms G * decay in registers (masked before the
//     exponential), one 64-column half at a time, splits it into pieces of
//     A fragments in place (the accumulator layout is the A-fragment
//     layout, as P in flash_wgmma_kernel) and runs y on wgmma (A from
//     registers, dtx with the transpose bit);
//   - the state is B^T (w dtx): A = B^T read from B's own tiles as an
//     MN-major operand.
// Arithmetic.  Every float32 operand enters the tensor cores as three bf16
// pieces x = x_0 + x_1 + x_2 (each remainder exact in float32, so the
// pieces carry float32's 24 bits), and a product of two such operands is
// the six products x_a y_b with a + b < 3; the terms dropped are below
// 2^-24 of the product.  A bf16 operand (B and C in the bf16 model) enters
// as it is: C B^T is one exact product, B^T (w dtx) three.  A hi/lo pair
// (two pieces, three products) keeps about 16 bits, which the random
// inputs of the reference's tile test show: the sums cancel, and y lands
// outside the 1e-4 tolerance (tests/test_torch_ssd.py emulates both).  The pieces cost 2x the tensor-core products of a hi/lo
// pair, which stays below the time of the bytes.
// Accumulation order.  wgmma adds each k16 block into the float32
// accumulator with its own alignment, so an addition into a large
// accumulator costs about 2^-23 of it; with the 48 additions of six
// products over 8 k-steps in k order the tile was farther from a float64
// reference than the plain float32 path.  So the products run smallest
// first (pieces a + b = 2, then 1, then 0), and y keeps the main product
// (piece 0 x piece 0) in an accumulator of its own, added to the rest
// once at the end, which puts the tile below the plain path
// (tools/ssd_probe.py); y is made 64 columns at a time so that both
// accumulators fit the registers.
// Shared memory: B's pieces, C's pieces (dead after G, then the six tiles
// of dtx and w dtx), the staging buffer, cum and dt: 163 KB at the slice
// with bf16 B/C, one block per SM (G, the A fragments and the accumulators
// take most of a thread's registers; PERF.md has the counts).
// Where dtx's and w dtx's tiles and the staging buffer do not fit beside B
// (bf16 at P = 128), w dtx is split into dtx's tiles after the y product
// instead ("two-phase") and the next head is fetched after that; float32
// B/C at Q = N = P = 128 fits neither way, and the wrapper routes it to
// ssd_chunk_kernel.  Fixed order, no atomics: two launches give
// bitwise-equal results.
//
// ssd_chunk_wgmma_n16_kernel (N = 16).  The same body (chunk_tile), the
// same arithmetic and order, with three changes:
//   - B and C share one 128-byte swizzle atom a row and a piece: B in
//     columns 0-15, C in 16-31, zeros in 32-63.  G = C B^T is one k16 step
//     whose A descriptor starts 32 bytes into the atom, as the second k16
//     step of a wider tile does;
//   - the state B^T (w dtx) keeps wgmma's M = 64: its A is the whole atom
//     as an MN-major operand, so rows 16-31 (C's) and 32-63 (zeros) are
//     computed and dropped, and only the first warp stores.  That is 4x a
//     16-row product, still below the bytes' time; the first warpgroup's
//     state product then matches the second's extra half of y;
//   - two blocks an SM (kN16Blocks = 2, at most 128 registers a thread):
//     G costs one k16 step a half, so it is made for each head where it is
//     used instead of held in 64 registers across the heads, and w dtx
//     always reuses dtx's tiles (two-phase).  101,376 bytes a block with
//     bf16 B/C, 134,144 with float32 (one block an SM).  Measured on an
//     H100 (tools/ssd_probe.py, PERF.md), this is about a quarter faster
//     than one block an SM holding G in registers (kN16Blocks = 1),
//     though ptxas spills about 120 bytes a thread to fit 128 registers.
//
// ssd_state_pass_wgmma_kernel.  One block per (P slice of 32 columns, head,
// batch row) walks the chunks in order, since the recurrence is serial in
// c: 256 blocks at the slice, two to an SM, so that one block's per-chunk
// latency hides under the other's.  A block has one warpgroup per 64 rows
// of Q, and for each chunk
//   - y_inter = C_c h_{c-1} (Q x 32) runs on wgmma.m64n32k16: A is C from
//     shared memory in its own layout (N contiguous, K-major, 128-byte
//     swizzle), B is h_{c-1}^T's bf16 pieces, written by the block into a
//     swizzled K-major tile;
//   - bf16 C, copied by cp.async straight into a ring of two swizzled
//     stages one chunk ahead, enters exact and h as a hi/lo pair: two
//     products.  The CPU emulation (tests/test_torch_ssd.py,
//     tools/ssd_pass_pieces.py) keeps that within the chunked path's 2e-4
//     of the Pallas path, where a single bf16 h is far outside; float32 C
//     and h take three pieces each (six products a + b < 3), since a hi/lo
//     pair of both comes to 0.2-1.3 of the tolerance.  Float32 C is staged
//     by cp.async and split by the block, with one stage (its 230 KB leave
//     one block an SM);
//   - the products run smallest first, the main one (piece 0 x piece 0) in
//     an accumulator of its own, added at the end ("Accumulation order");
//   - while they run, each thread forms h_c = exp(cum_c,Q) h_{c-1} + state_c
//     in float32 registers for the elements it owns (fixed: 8 rows of one
//     column a vector, the plain version's addcmul order), writes its pieces
//     into the other half of the double-buffered B tile, and loads chunk
//     c + 1's states and cum into registers, C_{c+1} by cp.async, and (after
//     the epilogue) y_intra_{c+1} by cp.async into its own shared-memory
//     slots, so that every input arrives a chunk ahead of its use;
//   - the epilogue writes y = y_intra + exp(cum_i) acc straight from the
//     accumulator layout to global memory in y's dtype.
// One block barrier a chunk (two with float32 C).  Shared memory: 115,712
// bytes a block with bf16 C (two C stages, two B tiles of two pieces,
// y_intra), 230,400 with float32 C.  Fixed order, no atomics: two launches
// give bitwise-equal results.
//
// ssd_state_pass_kernel (every other pass shape; float32 on CUDA cores).
// One block per (P slice of 32 columns, head, batch row) walks the chunks
// in order, carrying h (N x 32, float32) in shared memory, twice: h_{c-1}
// is read while h_c is written, so a chunk needs one block barrier.  Chunk
// c + 1's C arrives by cp.async into the other half of a double buffer
// while chunk c computes; each thread's rows of y_intra, the state and cum
// are loaded into registers before C . h and used after it.  C . h runs on
// CUDA cores in float32 (thread (ty, tx) of a 32 x 8 grid owns rows ty + 32
// r and 4 consecutive columns; C's rows are padded by 16 bytes so that the
// four rows a warp reads fall in distinct banks).  With bf16 C a block
// takes 100 KB of shared memory, so two share an SM.  Fixed order, no
// atomics.
//
// ssd_chunk_kernel (every other tile shape: the reference's small cases
// and float32 B/C at Q = N = P = 128; float32 on CUDA cores).  One
// block takes kHeads = 8 heads of one chunk: it computes G once into
// registers, then for each head forms G * decay in shared memory and runs
// the two products.  8 heads per block gives 1,024 blocks at the slice and
// computes G 4 times per chunk instead of 32.  Q = 128 and N = 128 in
// float32 make B and C 64 KB each, above the 48 KB static limit, so the
// block uses dynamic shared memory (B, then C aliased with G * decay, dtx of
// one head and cum: 165 KB at the full shape).  Every product is a 256-
// thread register tile: thread (ty, tx) of a 16 x 16 grid owns rows
// ty + 16 r and columns tx + 16 c (r, c < 8), so one block covers up to
// 128 x 128 outputs and neighbouring threads read neighbouring shared-memory
// words.  Rows of B, C and G * decay are padded by one float so that a
// column walk does not hit one bank.  Each output is a fixed-order fmaf
// chain, so two launches give bitwise-equal results.


#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;     // threads per side of the 16 x 16 grid
constexpr int kTile = 8;      // outputs per thread per side
constexpr int kMaxDim = kSide * kTile;   // 128: largest Q, N or P (ssd_scan.MAX_DIM)
constexpr int kHeads = 8;     // heads per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// dtx (BC, Q, H, P) f32; cum (BC, Q, H) f32; bm, cm (BC, Q, N);
// y (BC, Q, H, P) f32; states (BC, H, N, P) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ dtx, const float* __restrict__ cum,
                 const T* __restrict__ bm, const T* __restrict__ cm, int Q,
                 int H, int N, int P, float* __restrict__ y,
                 float* __restrict__ states) {
  extern __shared__ float smem[];
  const int NB = N + 1, QB = Q + 1;
  float* Bs = smem;                               // Q x NB
  float* Ms = Bs + Q * NB;                        // C (Q x NB), then G*decay (Q x QB)
  float* Xs = Ms + Q * (NB > QB ? NB : QB);       // Q x P: dtx of one head
  float* cs = Xs + Q * P;                         // Q: cum of one head

  const int64_t bc = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int h1 = min(h0 + kHeads, H);
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;

  const T* bsrc = bm + bc * Q * N;
  const T* csrc = cm + bc * Q * N;
  for (int e = tid; e < Q * N; e += kThreads) {
    const int j = e / N, n = e - j * N;
    Bs[j * NB + n] = to_f32(bsrc[e]);
    Ms[j * NB + n] = to_f32(csrc[e]);
  }
  __syncthreads();

  // G = C B^T, kept in registers for every head of the block.
  float g[kTile][kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r)
#pragma unroll
    for (int c = 0; c < kTile; ++c) g[r][c] = 0.f;
  for (int n = 0; n < N; ++n) {
    float a[kTile], b[kTile];
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int i = ty + kSide * r;
      a[r] = i < Q ? Ms[i * NB + n] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const int j = tx + kSide * c;
      b[c] = j < Q ? Bs[j * NB + n] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) g[r][c] = fmaf(a[r], b[c], g[r][c]);
  }
  __syncthreads();  // C is dead: Ms now holds G * decay

  for (int h = h0; h < h1; ++h) {
    for (int e = tid; e < Q * P; e += kThreads) {
      const int j = e / P, p = e - j * P;
      Xs[e] = dtx[((bc * Q + j) * H + h) * P + p];
    }
    for (int j = tid; j < Q; j += kThreads) cs[j] = cum[(bc * Q + j) * H + h];
    __syncthreads();

    // the 1-semiseparable decay, masked before the exponential
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int i = ty + kSide * r;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int j = tx + kSide * c;
        if (i < Q && j < Q)
          Ms[i * QB + j] = j <= i ? g[r][c] * expf(cs[i] - cs[j]) : 0.f;
      }
    }
    __syncthreads();

    float acc[kTile][kTile];
    // y = (G * decay) @ dtx
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < Q; ++j) {
      float a[kTile], x[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int i = ty + kSide * r;
        a[r] = i < Q ? Ms[i * QB + j] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int p = tx + kSide * c;
        x[c] = p < P ? Xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(a[r], x[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int i = ty + kSide * r;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int p = tx + kSide * c;
        if (i < Q && p < P) y[((bc * Q + i) * H + h) * P + p] = acc[r][c];
      }
    }

    // state = (B * exp(cum_Q - cum))^T @ dtx
    const float last = cs[Q - 1];
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[r][c] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float w = expf(last - cs[j]);
      float a[kTile], x[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int n = ty + kSide * r;
        a[r] = n < N ? Bs[j * NB + n] * w : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int p = tx + kSide * c;
        x[c] = p < P ? Xs[j * P + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[r][c] = fmaf(a[r], x[c], acc[r][c]);
    }
    float* st = states + (bc * H + h) * N * P;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int n = ty + kSide * r;
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int p = tx + kSide * c;
        if (n < N && p < P) st[n * P + p] = acc[r][c];
      }
    }
    __syncthreads();  // Xs, cs and Ms are rewritten for the next head
  }
}

size_t smem_bytes(int Q, int N, int P) {
  const int NB = N + 1, QB = Q + 1;
  return sizeof(float) *
         ((size_t)Q * NB + (size_t)Q * (NB > QB ? NB : QB) + (size_t)Q * P + Q);
}

template <typename T>
cudaError_t launch(const float* dtx, const float* cum, const void* bm,
                   const void* cm, int bc, int Q, int H, int N, int P,
                   float* y, float* states, cudaStream_t s) {
  const size_t bytes = smem_bytes(Q, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bc, (H + kHeads - 1) / kHeads);
  ssd_chunk_kernel<T><<<grid, kThreads, bytes, s>>>(
      dtx, cum, static_cast<const T*>(bm), static_cast<const T*>(cm), Q, H, N,
      P, y, states);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// ssd_chunk_wgmma_kernel: the tile on the tensor cores (wgmma).
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

constexpr int kWarpgroups = 2;
constexpr int kThreadsTc = 128 * kWarpgroups;
constexpr int kHeadsTc = 8;           // heads per block
constexpr int kPieces = 3;            // bf16 pieces of a float32 operand
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block can use
constexpr int kNarrowN = 16;          // the state width of the narrow tile
// Blocks of ssd_chunk_wgmma_n16_kernel an SM: 2 makes G per head and runs
// two-phase, so that two blocks fit; 1 keeps G in registers across the
// heads, as ssd_chunk_wgmma_kernel does (tools/ssd_probe.py times both).
constexpr int kN16Blocks = 2;

// Byte offsets from the 1024-aligned base.  parts: bf16 pieces of B and C
// (kPieces for float32, 1 for bf16).  Every operand tile is rows x cols
// bf16 in the swizzled layout of hopper.cuh: B and C Q x N (K-major for
// G), the pieces of dtx and w dtx Q x P (MN-major).  Piece k of an operand
// sits one tile after piece k - 1.  C's tiles are dead once G is made and
// then hold the dtx operands; two-phase, w dtx reuses dtx's tiles.  At N
// 16, B and C share one atom-wide tile a piece (B in columns 0-15, C in
// 16-31, zeros in 32-63: c is C's byte offset in a row), kept for every
// head, and the operands follow it.
struct Layout {
  int b, c, x, w, stage, cum, bytes;
  __host__ __device__ Layout(int Q, int N, int P, int parts, int split) {
    const int x_tiles = kPieces * Q * P * 2;
    const int ops = (split ? 1 : 2) * x_tiles;
    b = 0;
    if (N == kNarrowN) {
      c = 2 * kNarrowN;
      x = parts * Q * kAtomBytes;
      stage = x + ops;
    } else {
      const int bc_tiles = parts * Q * N * 2;
      c = bc_tiles;
      x = c;
      stage = c + (bc_tiles > ops ? bc_tiles : ops);
    }
    w = split ? x : x + x_tiles;
    cum = stage + Q * P * 4;           // cum, then dt, of two heads
    bytes = cum + 4 * Q * 4 + 1024;    // + alignment of the base
  }
};

// Eight consecutive values as float32.
__device__ __forceinline__ void load8(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Eight consecutive values of B or C as their bf16 pieces: a bf16 value
// is its own single piece.
__device__ __forceinline__ void pieces8(const float* src,
                                        uint4 (&out)[kPieces]) {
  float v[8];
  load8(src, v);
  split8(v, out);
}
__device__ __forceinline__ void pieces8(const __nv_bfloat16* src,
                                        uint4 (&out)[kPieces]) {
  out[0] = *reinterpret_cast<const uint4*>(src);
}

// The body of both tensor-core tiles.  xs (BC, Q, H, P) and dt (BC, Q, H)
// f32: dtx = dt * xs, formed on load (dt null: xs is dtx, f32); cum (BC,
// Q, H) f32; bm, cm (BC, Q, N); y (BC, Q, H, P) f32; states (BC, H, N, P)
// f32.  kNarrow: N = 16 in B's tile (Layout); kPerHead: G made for each
// head where it is used instead of once a block.
template <typename T, typename X, int Q, int P, bool kNarrow, bool kPerHead>
__device__ __forceinline__ void chunk_tile(
    const X* __restrict__ xs, const float* __restrict__ dt,
    const float* __restrict__ cum, const T* __restrict__ bm,
    const T* __restrict__ cm, int H, int N, int split, float* __restrict__ y,
    float* __restrict__ states) {
  constexpr int parts = sizeof(T) == 4 ? kPieces : 1;
  constexpr int kHalf = 4;                 // k16 steps of a 64-column half
  const Layout lay(Q, N, P, parts, split);
  const int bc_tile = kNarrow ? Q * kAtomBytes : Q * N * 2, x_tile = Q * P * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const X* stage = reinterpret_cast<const X*>(gbase + lay.stage);
  const float* cs = reinterpret_cast<const float*>(gbase + lay.cum);
  const float* dts = cs + 2 * Q;

  const int64_t bc = blockIdx.x;
  const int h0 = blockIdx.y * kHeadsTc;
  const int h1 = min(h0 + kHeadsTc, H);
  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, quad = lane / 4, t4 = lane % 4;
  const int row_a = ((tid % 128) / 32) * 16 + quad;   // row in the wg's 64
  const bool has_y = 64 * wg < Q;          // this warpgroup's G / y rows
  const bool has_state = 64 * wg < N;      // this warpgroup's state rows

  // head h's xs into the staging buffer, its cum (and dt) into buffer buf
  auto prefetch = [&](int h, int buf) {
    constexpr int kRow = P * (int)sizeof(X) / 16;   // 16-byte pieces a row
    const X* src = xs + (bc * Q * H + h) * P;
    for (int e = tid; e < Q * kRow; e += kThreadsTc) {
      const int j = e / kRow, k = e % kRow;
      cp_async16(base + lay.stage + j * P * (int)sizeof(X) + 16 * k,
                 reinterpret_cast<const uint8_t*>(src + (int64_t)j * H * P) +
                     16 * k);
    }
    for (int j = tid; j < Q; j += kThreadsTc) {
      cp_async4(base + lay.cum + (buf * Q + j) * 4,
                cum + (bc * Q + j) * H + h);
      if (dt != nullptr)
        cp_async4(base + lay.cum + ((2 + buf) * Q + j) * 4,
                  dt + (bc * Q + j) * H + h);
    }
    cp_async_commit();
  };
  // staging (row-major Q x P) -> the pieces of dtx = dt x at `dst`, scaled
  // by w_j = exp(cum_Q - cum_j) when `weighted` (dtx rounded first, as the
  // plain path forms it)
  auto split_dtx = [&](const float* csb, const float* dtb, int dst,
                       bool weighted) {
    const float last = csb[Q - 1];
    for (int e = tid; e < Q * P / 8; e += kThreadsTc) {
      const int j = e / (P / 8), p = (e % (P / 8)) * 8;
      float v[8];
      load8(stage + j * P + p, v);
      const float d = dt != nullptr ? dtb[j] : 1.f;
      const float w = weighted ? expf(last - csb[j]) : 1.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = (v[k] * d) * w;
      uint4 pc[kPieces];
      split8(v, pc);
      const uint32_t off = dst + swizzle_offset(j, p, Q);
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        *reinterpret_cast<uint4*>(gbase + off + k * x_tile) = pc[k];
    }
  };

  prefetch(h0, 0);

  // B and C -> their bf16 pieces
  {
    const T* bsrc = bm + bc * Q * N;
    const T* csrc = cm + bc * Q * N;
    for (int e = tid; e < Q * N / 8; e += kThreadsTc) {
      const int j = e / (N / 8), n = (e % (N / 8)) * 8;
      const uint32_t off = swizzle_offset(j, n, Q);
      uint4 v[kPieces];
      pieces8(bsrc + j * N + n, v);
#pragma unroll
      for (int k = 0; k < parts; ++k)
        *reinterpret_cast<uint4*>(gbase + lay.b + off + k * bc_tile) = v[k];
      pieces8(csrc + j * N + n, v);
      const uint32_t c_off =
          kNarrow ? swizzle_offset(j, kNarrowN + n, Q) : lay.c + off;
#pragma unroll
      for (int k = 0; k < parts; ++k)
        *reinterpret_cast<uint4*>(gbase + c_off + k * bc_tile) = v[k];
    }
    if constexpr (kNarrow) {
      // zeros in columns 32-63, which the padded rows of the M-64 state
      // product read
      for (int e = tid; e < Q * 4; e += kThreadsTc) {
        const uint32_t off = swizzle_offset(e / 4, 2 * kNarrowN + (e % 4) * 8, Q);
#pragma unroll
        for (int k = 0; k < parts; ++k)
          *reinterpret_cast<uint4*>(gbase + lay.b + off + k * bc_tile) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  fence_proxy_async();
  __syncthreads();

  // G = C B^T into acc (zeroed, fenced): this warpgroup's rows, column half
  // hf; for float32 the six products C_a B_b with a + b < 3, smallest first
  // (see "Accumulation order" above).  At N 16 one k16 step: C's columns
  // sit 32 bytes into B's tile, as a second k16 step of a wider tile would.
  const int ksteps = kNarrow ? 1 : N / 16;
  auto make_g = [&](float (&acc)[32], int hf) {
#pragma unroll
    for (int ord = parts - 1; ord >= 0; --ord)
#pragma unroll
      for (int pa = 0; pa <= ord; ++pa)
        for (int kk = 0; kk < ksteps; ++kk) {
          const uint32_t koff = (kk / 4) * Q * kAtomBytes + (kk % 4) * 32;
          mma_ss(acc,
                 desc(base + lay.c + koff + wg * 64 * kAtomBytes +
                          pa * bc_tile, 16, 1024),
                 desc(base + lay.b + koff + hf * 64 * kAtomBytes +
                          (ord - pa) * bc_tile, 16, 1024), 1);
        }
  };

  // G once a block, kept in registers for every head (unless kPerHead)
  float g[Q / 64][32];
  if constexpr (!kPerHead) {
#pragma unroll
    for (int hf = 0; hf < Q / 64; ++hf)
#pragma unroll
      for (int e = 0; e < 32; ++e) g[hf][e] = 0.f;
    if (has_y) {
      wg_fence();
#pragma unroll
      for (int hf = 0; hf < Q / 64; ++hf) {
        if (hf > wg) continue;
        make_g(g[hf], hf);
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int hf = 0; hf < Q / 64; ++hf) fence_regs(g[hf]);
    }
    __syncthreads();   // C is dead: its tiles now hold the dtx operands
  }

  const int i0 = 64 * wg + row_a, i1 = i0 + 8;
  for (int h = h0, it = 0; h < h1; ++h, ++it) {
    const float* csb = cs + (it & 1) * Q;
    const float* dtb = dts + (it & 1) * Q;
    cp_async_wait<0>();
    __syncthreads();   // staging and cum arrived; last head's products done
    split_dtx(csb, dtb, lay.x, false);
    if (!split) split_dtx(csb, dtb, lay.w, true);
    fence_proxy_async();
    __syncthreads();
    if (!split && h + 1 < h1) prefetch(h + 1, (it + 1) & 1);

    if (has_y) {
      // y = (G * decay) dtx, 64 columns of y and one 64-column half of G
      // at a time: G * decay as three bf16 pieces of A fragments (k-step
      // kk of the half takes g[hf][8 kk .. 8 kk + 7]) times dtx's pieces;
      // the main product (piece 0 x piece 0) in its own accumulator.
      const float c_i0 = csb[i0], c_i1 = csb[i1];
#pragma unroll 1
      for (int ch = 0; ch < P / 64; ++ch) {
        float y_main[32], y_cross[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) y_main[e] = y_cross[e] = 0.f;
#pragma unroll
        for (int hf = 0; hf < Q / 64; ++hf) {
          if (hf > wg) continue;
          if constexpr (kPerHead) {
#pragma unroll
            for (int e = 0; e < 32; ++e) g[hf][e] = 0.f;
            wg_fence();
            make_g(g[hf], hf);
            wg_commit();
            wg_wait0();
            fence_regs(g[hf]);
          }
          uint32_t a[kHalf][4][kPieces];
#pragma unroll
          for (int kk = 0; kk < kHalf; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int e = 8 * kk + 2 * r;
              const int j = 64 * hf + 8 * (e / 4) + 2 * t4;
              const int i = (r & 1) ? i1 : i0;
              const float ci = (r & 1) ? c_i1 : c_i0;
              const float x0 = j <= i ? g[hf][e] * expf(ci - csb[j]) : 0.f;
              const float x1 =
                  j + 1 <= i ? g[hf][e + 1] * expf(ci - csb[j + 1]) : 0.f;
              split_bf16(x0, x1, a[kk][r]);
            }
          wg_fence();
#pragma unroll
          for (int ord = kPieces - 1; ord >= 0; --ord)
#pragma unroll
            for (int pa = 0; pa <= ord; ++pa)
#pragma unroll
              for (int kk = 0; kk < kHalf; ++kk) {
                const uint32_t frag[4] = {a[kk][0][pa], a[kk][1][pa],
                                          a[kk][2][pa], a[kk][3][pa]};
                const uint64_t bx = desc(
                    base + lay.x + (ord - pa) * x_tile + ch * Q * kAtomBytes +
                        (4 * hf + kk) * 16 * kAtomBytes,
                    Q * kAtomBytes, 1024);
                if (ord)
                  mma_rs<64>(y_cross, frag, bx, 1);
                else
                  mma_rs<64>(y_main, frag, bx, 1);
              }
          wg_commit();
          wg_wait0();
          fence_regs(y_main);
          fence_regs(y_cross);
        }
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int i = (e % 4) ? i1 : i0;
          const int p = 64 * ch + 8 * (e / 4) + 2 * t4;
          *reinterpret_cast<float2*>(y + ((bc * Q + i) * H + h) * P + p) =
              make_float2(y_main[e] + y_cross[e], y_main[e + 1] + y_cross[e + 1]);
        }
      }
    }

    if (split) {
      __syncthreads();   // every warpgroup is done with dtx's operands
      split_dtx(csb, dtb, lay.w, true);
      fence_proxy_async();
      __syncthreads();
      if (h + 1 < h1) prefetch(h + 1, (it + 1) & 1);
    }

    if (has_state) {
      // state = B^T (w dtx): A = B^T, MN-major from B's tiles (atom wg),
      // B_a times (w dtx)_b with a + b < 3
      float acc[P / 2];
#pragma unroll
      for (int e = 0; e < P / 2; ++e) acc[e] = 0.f;
      wg_fence();
      // smallest products first (see "Accumulation order" above)
#pragma unroll
      for (int ord = kPieces - 1; ord >= 0; --ord)
#pragma unroll
        for (int pa = 0; pa < parts && pa <= ord; ++pa)
#pragma unroll 1
          for (int kk = 0; kk < Q / 16; ++kk)
            mma_ss_mn<P>(
                acc,
                desc(base + lay.b + pa * bc_tile + wg * Q * kAtomBytes +
                         kk * 16 * kAtomBytes, Q * kAtomBytes, 1024),
                desc(base + lay.w + (ord - pa) * x_tile + kk * 16 * kAtomBytes,
                     Q * kAtomBytes, 1024), 1);
      wg_commit();
      wg_wait0();
      fence_regs(acc);
      const int n0 = 64 * wg + row_a;
      float* st = states + (bc * H + h) * N * P;
      // at N 16 the first warp's rows are the state's, the rest padding
      if (kNarrow && n0 >= kNarrowN) continue;
#pragma unroll
      for (int e = 0; e < P / 2; e += 2) {
        const int n = (e % 4) ? n0 + 8 : n0;
        const int p = 8 * (e / 4) + 2 * t4;
        *reinterpret_cast<float2*>(st + n * P + p) =
            make_float2(acc[e], acc[e + 1]);
      }
    }
  }
}

// ssd_chunk_wgmma_kernel: Q, P in {64, 128}, N in {64, 128}.
template <typename T, typename X, int Q, int P>
__global__ void __launch_bounds__(kThreadsTc, 1)
ssd_chunk_wgmma_kernel(const X* __restrict__ xs, const float* __restrict__ dt,
                       const float* __restrict__ cum,
                       const T* __restrict__ bm, const T* __restrict__ cm,
                       int H, int N, int split, float* __restrict__ y,
                       float* __restrict__ states) {
  chunk_tile<T, X, Q, P, false, false>(xs, dt, cum, bm, cm, H, N, split, y,
                                       states);
}

// ssd_chunk_wgmma_n16_kernel: the same tile at N = 16 (jamba's state width).
template <typename T, typename X, int Q, int P>
__global__ void __launch_bounds__(kThreadsTc, kN16Blocks)
ssd_chunk_wgmma_n16_kernel(const X* __restrict__ xs,
                           const float* __restrict__ dt,
                           const float* __restrict__ cum,
                           const T* __restrict__ bm, const T* __restrict__ cm,
                           int H, int N, int split, float* __restrict__ y,
                           float* __restrict__ states) {
  chunk_tile<T, X, Q, P, true, kN16Blocks == 2>(xs, dt, cum, bm, cm, H, N,
                                                split, y, states);
}

// Whether a block runs two-phase: the N 16 tile with G per head always
// (two blocks an SM), every other where w dtx does not fit beside dtx.
int split_of(int Q, int N, int P, int parts) {
  if (N == kNarrowN && kN16Blocks == 2) return 1;
  return Layout(Q, N, P, parts, 0).bytes > kMaxSmem;
}

// Dynamic shared memory of a block, or -1 for a shape it does not take
// (float32 B and C at Q = N = P = 128).
int smem_bytes(int Q, int N, int P, int parts) {
  const int bytes = Layout(Q, N, P, parts, split_of(Q, N, P, parts)).bytes;
  return bytes <= kMaxSmem ? bytes : -1;
}

template <typename T, typename X, int Q, int P>
cudaError_t launch(const X* xs, const float* dt, const float* cum,
                   const void* bm, const void* cm, int bc, int H, int N,
                   float* y, float* states, cudaStream_t s) {
  constexpr int parts = sizeof(T) == 4 ? kPieces : 1;
  const int bytes = smem_bytes(Q, N, P, parts);
  if (bytes < 0) return cudaErrorInvalidValue;
  const bool narrow = N == kNarrowN;
  void (*kernel)(const X*, const float*, const float*, const T*, const T*, int,
                 int, int, float*, float*) =
      narrow ? &ssd_chunk_wgmma_n16_kernel<T, X, Q, P>
             : &ssd_chunk_wgmma_kernel<T, X, Q, P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && narrow)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid(bc, (H + kHeadsTc - 1) / kHeadsTc);
  kernel<<<grid, kThreadsTc, bytes, s>>>(
      xs, dt, cum, static_cast<const T*>(bm), static_cast<const T*>(cm), H, N,
      split_of(Q, N, P, parts), y, states);
  return cudaGetLastError();
}

template <typename T, typename X>
cudaError_t dispatch(const X* xs, const float* dt, const float* cum,
                     const void* bm, const void* cm, int bc, int Q, int H,
                     int N, int P, float* y, float* states, cudaStream_t s) {
  if (N != kNarrowN && N != 64 && N != 128) return cudaErrorInvalidValue;
  if (Q == 64 && P == 64)
    return launch<T, X, 64, 64>(xs, dt, cum, bm, cm, bc, H, N, y, states, s);
  if (Q == 64 && P == 128)
    return launch<T, X, 64, 128>(xs, dt, cum, bm, cm, bc, H, N, y, states, s);
  if (Q == 128 && P == 64)
    return launch<T, X, 128, 64>(xs, dt, cum, bm, cm, bc, H, N, y, states, s);
  if (Q == 128 && P == 128)
    return launch<T, X, 128, 128>(xs, dt, cum, bm, cm, bc, H, N, y, states, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// ssd_state_pass_kernel: the inter-chunk recurrence and output term.
// ---------------------------------------------------------------------------
namespace pass {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int kThreadsPass = 256;
constexpr int kSlice = 32;    // P columns of one block
constexpr int kMaxRows = 128; // largest Q and N (ssd_scan.MAX_DIM)

// Four consecutive C values from shared memory, as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Shared memory in bytes: C of two chunks (rows padded by 16 bytes) and h
// twice (h_{c-1} read while h_c is written).  At N = 128 with bf16 C that
// is 100 KB, so two blocks share an SM.
template <typename T>
__host__ __device__ int ldc(int N) { return N + 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ int smem_bytes(int Q, int N) {
  return 2 * Q * ldc<T>(N) * (int)sizeof(T) + 4 * 2 * N * kSlice;
}

// y_intra (B, nc, Q, H, P) f32; states (B, nc, H, N, P) f32; cum (B, nc,
// Q, H) f32; cm (B, nc, Q, N); y (B, L, H, P); final_state (B, H, N, P).
template <typename T, typename Y>
__global__ void __launch_bounds__(kThreadsPass)
ssd_state_pass_kernel(const float* __restrict__ y_intra,
                      const float* __restrict__ states,
                      const float* __restrict__ cum, const T* __restrict__ cm,
                      int nc, int Q, int H, int N, int P, int L,
                      Y* __restrict__ y, float* __restrict__ final_state) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lc = ldc<T>(N);
  T* Cs = reinterpret_cast<T*>(smem);                          // 2 x Q x lc
  float* hs = reinterpret_cast<float*>(Cs + 2 * Q * lc);       // 2 x N x 32

  const int p0 = blockIdx.x * kSlice, hd = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int pw = min(kSlice, P - p0);      // a multiple of 4
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const bool col = 4 * tx < pw;

  // chunk c's C into buffer buf, by cp.async (one group)
  auto load_c = [&](int c, int buf) {
    const int64_t row0 = (b * nc + c) * Q;
    const int cpr = N * (int)sizeof(T) / 16;    // 16-byte pieces of a row
    for (int e = tid; e < Q * cpr; e += kThreadsPass) {
      const int j = e / cpr, k = e % cpr;
      cp_async16(smem_u32(Cs + (buf * Q + j) * lc) + 16 * k,
                 reinterpret_cast<const uint8_t*>(cm + (row0 + j) * N) + 16 * k);
    }
    cp_async_commit();
  };

  for (int e = tid; e < 2 * N * kSlice; e += kThreadsPass) hs[e] = 0.f;
  load_c(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1;
    const int64_t row0 = (b * nc + c) * Q;
    cp_async_wait<0>();
    __syncthreads();   // C_c has arrived, h_{c-1} is complete, and every
                       // thread is done with chunk c - 1's buffers
    if (c + 1 < nc) load_c(c + 1, buf ^ 1);

    // this thread's y_intra rows, state rows and cum, in flight while
    // C_c . h_{c-1} runs
    float4 yi[4], sv[4];
    float ce[4];
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 32 * r;
      const bool ok = col && i < Q;
      yi[r] = ok ? __ldg(reinterpret_cast<const float4*>(
                       y_intra + ((row0 + i) * H + hd) * P + p0 + 4 * tx))
                 : zero;
      ce[r] = i < Q ? __ldg(cum + (row0 + i) * H + hd) : 0.f;
      sv[r] = col && i < N
                  ? __ldg(reinterpret_cast<const float4*>(
                        states + (((b * nc + c) * H + hd) * N + i) * P + p0 +
                        4 * tx))
                  : zero;
    }
    const float dec = expf(__ldg(cum + (row0 + Q - 1) * H + hd));

    // acc = C_c . h_{c-1} over this thread's rows and 4 columns, n ascending
    const T* cb = Cs + buf * Q * lc;
    const float* hp = hs + buf * N * kSlice;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
#pragma unroll 8
    for (int n = 0; n < N; n += 4) {
      float4 hv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hv[k] = *reinterpret_cast<const float4*>(hp + (n + k) * kSlice + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 32 * r;
        const float4 cv = i < Q ? load4(cb + i * lc + n) : zero;
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[r][0] = fmaf(cc[k], hv[k].x, acc[r][0]);
          acc[r][1] = fmaf(cc[k], hv[k].y, acc[r][1]);
          acc[r][2] = fmaf(cc[k], hv[k].z, acc[r][2]);
          acc[r][3] = fmaf(cc[k], hv[k].w, acc[r][3]);
        }
      }
    }

    // y_c = y_intra_c + exp(cum_c) acc, pad rows dropped
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 32 * r;
      const int64_t t = (int64_t)c * Q + i;
      if (!col || i >= Q || t >= L) continue;
      const float e = expf(ce[r]);
      store4(y + ((b * L + t) * H + hd) * P + p0 + 4 * tx,
             make_float4(fmaf(e, acc[r][0], yi[r].x),
                         fmaf(e, acc[r][1], yi[r].y),
                         fmaf(e, acc[r][2], yi[r].z),
                         fmaf(e, acc[r][3], yi[r].w)));
    }
    // h_c = exp(cum_c,Q) h_{c-1} + state_c, into the other buffer (each
    // thread its own rows and columns)
    float* hn = hs + (buf ^ 1) * N * kSlice;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = ty + 32 * r;
      if (n >= N) continue;
      const float4 hv = *reinterpret_cast<const float4*>(hp + n * kSlice + 4 * tx);
      *reinterpret_cast<float4*>(hn + n * kSlice + 4 * tx) =
          make_float4(fmaf(dec, hv.x, sv[r].x), fmaf(dec, hv.y, sv[r].y),
                      fmaf(dec, hv.z, sv[r].z), fmaf(dec, hv.w, sv[r].w));
    }
  }
  __syncthreads();
  const float* hf = hs + (nc & 1) * N * kSlice;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = ty + 32 * r;
    if (!col || n >= N) continue;
    *reinterpret_cast<float4*>(final_state + ((b * H + hd) * N + n) * P + p0 +
                               4 * tx) =
        *reinterpret_cast<const float4*>(hf + n * kSlice + 4 * tx);
  }
}

template <typename T, typename Y>
cudaError_t launch(const float* y_intra, const float* states, const float* cum,
                   const void* cm, int B, int nc, int Q, int H, int N, int P,
                   int L, void* y, float* final_state, cudaStream_t s) {
  const int bytes = smem_bytes<T>(Q, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_pass_kernel<T, Y>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((P + kSlice - 1) / kSlice, H, B);
  ssd_state_pass_kernel<T, Y><<<grid, kThreadsPass, bytes, s>>>(
      y_intra, states, cum, static_cast<const T*>(cm), nc, Q, H, N, P, L,
      static_cast<Y*>(y), final_state);
  return cudaGetLastError();
}

}  // namespace pass

// ---------------------------------------------------------------------------
// ssd_state_pass_wgmma_kernel: the inter-chunk pass on the tensor cores.
// ---------------------------------------------------------------------------
namespace pass_tc {

using namespace hopper;

constexpr int kSlice = 32;    // P columns of one block: the wgmma's n
constexpr int kMaxN = 128;

// bf16 pieces of h (two with bf16 C, three with float32 C), pieces of C
// (a bf16 C is its own), and C stages in flight (float32 C's three pieces
// leave room for one).
template <typename T>
__host__ __device__ constexpr int h_pieces() { return sizeof(T) == 4 ? 3 : 2; }
template <typename T>
__host__ __device__ constexpr int c_pieces() { return sizeof(T) == 4 ? 3 : 1; }
template <typename T>
__host__ __device__ constexpr int c_stages() { return sizeof(T) == 4 ? 1 : 2; }

// Byte offsets from the 1024-aligned base: the C stages (each c_pieces
// tiles of Q x N, K-major), float32 C's staging buffer (its cp.async
// target, each thread's own slots), two buffers of h^T's pieces (kSlice x
// N, K-major: h_{c-1} read by the products while h_c is written), and the
// y_intra buffer (16 values a thread, its own slots).
struct Layout {
  int c_tile, h_tile, stage, h, yi, bytes;
  __host__ __device__ Layout(int Q, int N, int cp, int hp, int stages) {
    const int atoms = (N + kAtom - 1) / kAtom;
    c_tile = Q * kAtomBytes * atoms;
    h_tile = kSlice * kAtomBytes * atoms;
    stage = stages * cp * c_tile;
    h = stage + (cp > 1 ? Q * N * 4 : 0);
    yi = h + 2 * hp * h_tile;
    bytes = yi + 2 * Q * 16 * 4 + 1024;   // + alignment of the base
  }
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// y_intra (B, nc, Q, H, P) f32; states (B, nc, H, N, P) f32; cum (B, nc,
// Q, H) f32; cm (B, nc, Q, N); y (B, L, H, P); final_state (B, H, N, P).
// One warpgroup per 64 rows of Q.
template <typename T, typename Y, int Q>
__global__ void __launch_bounds__(2 * Q, sizeof(T) == 4 ? 1 : 2)
ssd_state_pass_wgmma_kernel(const float* __restrict__ y_intra,
                            const float* __restrict__ states,
                            const float* __restrict__ cum,
                            const T* __restrict__ cm, int nc, int H, int N,
                            int P, int L, Y* __restrict__ y,
                            float* __restrict__ final_state) {
  constexpr int kThr = 2 * Q;
  constexpr int kCP = c_pieces<T>(), kHP = h_pieces<T>();
  constexpr int kStages = c_stages<T>();
  // at most: 8-vectors of h a thread owns, of C a thread loads
  constexpr int kVec = 4 * kMaxN / kThr;
  constexpr int kCVec = Q * kMaxN / 8 / kThr;
  const Layout lay(Q, N, kCP, kHP, kStages);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);

  const int p0 = blockIdx.x * kSlice, hd = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, t4 = lane % 4;
  // this thread's accumulator rows (and the y rows it writes)
  const int i0 = 64 * wg + ((tid % 128) / 32) * 16 + lane / 4, i1 = i0 + 8;
  // h is N x kSlice; thread tid owns the 8-vectors v = tid + kThr j: column
  // p = v % 32 (a warp's lanes read a state row's 128 bytes together) and
  // rows 8 (v / 32) .. + 7 (one 16-byte chunk of each piece of h^T)
  const int nvec = 4 * N;
  // C's 8-vectors e = tid + kThr m: row j, columns n .. n + 7.  Where N / 8
  // divides kThr into whole swizzle periods of rows (N a power of two), each
  // m moves both offsets by a constant; otherwise j and n step with a carry.
  const int cpr = N / 8, cvec = Q * cpr;
  const int cj0 = tid / cpr, cn0 = (tid % cpr) * 8;
  const int dcj = kThr / cpr, dcn = (kThr % cpr) * 8;
  const bool c_even = dcn == 0 && dcj % 8 == 0;
  auto for_c = [&](auto&& fn) {   // fn(m, swizzled offset, offset in C_c)
    int j = cj0, n = cn0;
    uint32_t off = swizzle_offset(j, n, Q);
    int g = j * N + n;
#pragma unroll 1
    for (int m = 0; m < kCVec && tid + kThr * m < cvec; ++m) {
      fn(m, off, g);
      if (c_even) {
        off += dcj * kAtomBytes;
        g += dcj * N;
      } else {
        j += dcj;
        n += dcn;
        if (n >= N) {
          n -= N;
          ++j;
        }
        off = swizzle_offset(j, n, Q);
        g = j * N + n;
      }
    }
  };

  // chunk 0's rows of each input for this block (and, for y_intra, cum
  // and y, this thread's row i0); chunk c is c strides on
  const int64_t HP = (int64_t)H * P;
  const T* c_base = cm + b * nc * Q * N;
  const float* st_base = states + (b * nc * H + hd) * (int64_t)N * P + p0;
  const float* cum_base = cum + b * nc * Q * H + hd;
  const float* yi_base = y_intra + (b * nc * Q + i0) * HP + hd * P + p0 + 2 * t4;
  Y* y_base = y + (b * L + i0) * HP + hd * P + p0 + 2 * t4;

  // chunk c's C by cp.async: bf16 straight into stage s's swizzled tile,
  // float32 into this thread's slots of the staging buffer
  auto issue_c = [&](int c, int s) {
    const T* src = c_base + (int64_t)c * Q * N;
    for_c([&](int m, uint32_t off, int g) {
      if constexpr (kCP == 1) {
        cp_async16(base + s * lay.c_tile + off, src + g);
      } else {
        const uint32_t slot = base + lay.stage + ((2 * m) * kThr + tid) * 16;
        cp_async16(slot, src + g);
        cp_async16(slot + kThr * 16, src + g + 4);
      }
    });
  };
  // float32 C: this thread's staged values -> their pieces in the stage
  auto split_c = [&]() {
    for_c([&](int m, uint32_t off, int) {
      const float* slot = reinterpret_cast<const float*>(
          gbase + lay.stage + ((2 * m) * kThr + tid) * 16);
      const float4 a = *reinterpret_cast<const float4*>(slot);
      const float4 c = *reinterpret_cast<const float4*>(slot + 4 * kThr);
      const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
      uint4 pc[kCP];
      split8(v, pc);
#pragma unroll
      for (int k = 0; k < kCP; ++k)
        *reinterpret_cast<uint4*>(gbase + off + k * lay.c_tile) = pc[k];
    });
  };

  // chunk c's y_intra at this thread's accumulator positions, by cp.async
  // into its own slots (read back by this thread alone)
  auto issue_rows = [&](int c) {
    const float* src = yi_base + c * Q * HP;
#pragma unroll
    for (int e = 0; e < 16; e += 2)
      cp_async8(base + lay.yi + ((e / 2) * kThr + tid) * 8,
                src + ((e & 2) ? 8 * HP : 0) + 8 * (e / 4));
  };

  // chunk c's state rows of this thread's vectors, and its rows' cum and
  // cum_Q, into registers a chunk ahead of their use
  float sn[kVec][8], cn[2], dn;
  auto load_states = [&](int c) {
    const float* src = st_base + c * H * (int64_t)N * P;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int v = tid + kThr * j;
      if (v >= nvec) continue;
      const float* row = src + (8 * (v / 32)) * P + v % 32;
#pragma unroll
      for (int k = 0; k < 8; ++k) sn[j][k] = __ldg(row + k * P);
    }
    const float* cu = cum_base + (int64_t)c * Q * H;
    cn[0] = __ldg(cu + i0 * H);
    cn[1] = __ldg(cu + i1 * H);
    dn = __ldg(cu + (Q - 1) * H);
  };

  // h_c (float32, this thread's vectors) and its bf16 pieces in buffer buf
  float h[kVec][8];
  auto store_h = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int v = tid + kThr * j;
      if (v >= nvec) continue;
      uint4 pc[kHP];
      split8(h[j], pc);
      const uint32_t off = lay.h + buf * kHP * lay.h_tile +
                           swizzle_offset(v % 32, 8 * (v / 32), kSlice);
#pragma unroll
      for (int k = 0; k < kHP; ++k)
        *reinterpret_cast<uint4*>(gbase + off + k * lay.h_tile) = pc[k];
    }
  };

#pragma unroll
  for (int j = 0; j < kVec; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) h[j][k] = 0.f;
  store_h(0);    // h_{-1} = 0
  issue_c(0, 0);
  cp_async_commit();
  issue_rows(0);
  cp_async_commit();
  load_states(0);
  if constexpr (kCP > 1) {
    cp_async_wait<0>();
    split_c();
  }

  for (int c = 0; c < nc; ++c) {
    const int s = kStages == 2 ? (c & 1) : 0, buf = c & 1;
    // cp.async groups in flight: C_c's, then y_intra_c's
    cp_async_wait<1>();   // this thread's copies of C_c (bf16)
    fence_proxy_async();
    __syncthreads();      // C_c and h_{c-1}'s pieces are in place, and every
                          // warpgroup is done with chunk c - 1's products

    // y_inter = C_c h_{c-1}, smallest products first, the main product
    // (piece 0 x piece 0) in its own accumulator
    float acc_main[16], acc_cross[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc_main[e] = acc_cross[e] = 0.f;
    // descriptors of this warpgroup's rows of C_c and of h_{c-1}'s tile;
    // an operand's k-step adds its byte offset / 16 to the address field
    const uint64_t dc = desc(base + s * kCP * lay.c_tile + wg * 64 * kAtomBytes,
                             16, 1024);
    const uint64_t dh = desc(base + lay.h + buf * kHP * lay.h_tile, 16, 1024);
    wg_fence();
#pragma unroll
    for (int ord = kHP - 1; ord >= 0; --ord)
#pragma unroll
      for (int pa = 0; pa < kCP && pa <= ord; ++pa)
#pragma unroll 1
        for (int kk = 0; kk < N / 16; ++kk) {
          const int k_off = (kk / 4) * kAtomBytes, k_in = (kk % 4) * 32;
          const uint64_t da =
              dc + ((pa * lay.c_tile + k_off * Q + k_in) >> 4);
          const uint64_t db =
              dh + (((ord - pa) * lay.h_tile + k_off * kSlice + k_in) >> 4);
          if (ord)
            mma_ss_n32(acc_cross, da, db, 1);
          else
            mma_ss_n32(acc_main, da, db, 1);
        }
    wg_commit();

    // while they run: h_c = exp(cum_c,Q) h_{c-1} + state_c (the plain
    // version's addcmul), chunk c + 1's loads, h_c's pieces into the other
    // buffer
    const float e0 = expf(cn[0]), e1 = expf(cn[1]), dec = expf(dn);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k) h[j][k] = fmaf(dec, h[j][k], sn[j][k]);
    if (c + 1 < nc) {
      issue_c(c + 1, s ^ 1);
      cp_async_commit();
      load_states(c + 1);
      store_h(buf ^ 1);
    }

    // groups in flight: y_intra_c's, then C_{c+1}'s
    if (c + 1 < nc)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    wg_wait0();
    fence_regs(acc_main);
    fence_regs(acc_cross);
    // y_c = y_intra_c + exp(cum_c) y_inter, pad rows dropped
    const int t0 = c * Q;
    Y* yc = y_base + t0 * HP;
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const int i = (e & 2) ? i1 : i0;
      const float2 yi = *reinterpret_cast<const float2*>(
          gbase + lay.yi + ((e / 2) * kThr + tid) * 8);
      if (t0 + i >= L) continue;
      const float ex = (e & 2) ? e1 : e0;
      store2(yc + ((e & 2) ? 8 * HP : 0) + 8 * (e / 4),
             fmaf(ex, acc_main[e] + acc_cross[e], yi.x),
             fmaf(ex, acc_main[e + 1] + acc_cross[e + 1], yi.y));
    }
    if (c + 1 < nc) {
      issue_rows(c + 1);   // after this thread's reads of its slots
      cp_async_commit();
      if constexpr (kCP > 1) {
        __syncthreads();     // every warpgroup is done reading C_c's pieces
        cp_async_wait<1>();  // this thread's staged C_{c + 1}
        split_c();
      }
    }
  }

  float* dst = final_state + (b * H + hd) * (int64_t)N * P + p0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int v = tid + kThr * j;
    if (v >= nvec) continue;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[(8 * (v / 32) + k) * P + v % 32] = h[j][k];
  }
}

template <typename T>
int smem_bytes(int Q, int N) {
  return Layout(Q, N, c_pieces<T>(), h_pieces<T>(), c_stages<T>()).bytes;
}

template <typename T, typename Y, int Q>
cudaError_t launch(const float* y_intra, const float* states, const float* cum,
                   const void* cm, int B, int nc, int H, int N, int P, int L,
                   void* y, float* final_state, cudaStream_t s) {
  const int bytes = smem_bytes<T>(Q, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_pass_wgmma_kernel<T, Y, Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(P / kSlice, H, B);
  ssd_state_pass_wgmma_kernel<T, Y, Q><<<grid, 2 * Q, bytes, s>>>(
      y_intra, states, cum, static_cast<const T*>(cm), nc, H, N, P, L,
      static_cast<Y*>(y), final_state);
  return cudaGetLastError();
}

template <typename T, typename Y>
cudaError_t dispatch(const float* y_intra, const float* states,
                     const float* cum, const void* cm, int B, int nc, int Q,
                     int H, int N, int P, int L, void* y, float* final_state,
                     cudaStream_t s) {
  if (Q == 64)
    return launch<T, Y, 64>(y_intra, states, cum, cm, B, nc, H, N, P, L, y,
                            final_state, s);
  return launch<T, Y, 128>(y_intra, states, cum, cm, B, nc, H, N, P, L, y,
                           final_state, s);
}

}  // namespace pass_tc


}  // namespace


extern "C" {

// dtype of B and C: 0 float32, 1 bfloat16.  bc = batch x chunks.
int ssd_chunk_launch(const void* dtx, const void* cum, const void* bm,
                     const void* cm, int dtype, int bc, int Q, int H, int N,
                     int P, void* y, void* states, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dtx);
  const float* c = static_cast<const float*>(cum);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(states);
  if (Q < 1 || Q > kMaxDim || N < 1 || N > kMaxDim || P < 1 || P > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 0
          ? launch<float>(d, c, bm, cm, bc, Q, H, N, P, yo, so, s)
          : launch<__nv_bfloat16>(d, c, bm, cm, bc, Q, H, N, P, yo, so, s);
  return (int)err;
}

// The tensor-core tile: Q in {64, 128}, N in {16, 64, 128} (16:
// ssd_chunk_wgmma_n16_kernel), P in {64, 128}; every pointer 16-byte
// aligned.  dtype of B and C: 0 float32, 1 bfloat16.
int ssd_chunk_wgmma_launch(const void* dtx, const void* cum, const void* bm,
                           const void* cm, int dtype, int bc, int Q, int H,
                           int N, int P, void* y, void* states, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dtx);
  const float* c = static_cast<const float*>(cum);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(states);
  cudaError_t err =
      dtype == 0
          ? tc::dispatch<float>(d, nullptr, c, bm, cm, bc, Q, H, N, P, yo, so, s)
          : tc::dispatch<__nv_bfloat16>(d, nullptr, c, bm, cm, bc, Q, H, N, P,
                                        yo, so, s);
  return (int)err;
}

// The same tile with dtx = dt * xh formed on load: xh (bc, Q, H, P) in the
// dtype of B and C, dt (bc, Q, H) float32.
int ssd_chunk_wgmma_xdt_launch(const void* xh, const void* dt, const void* cum,
                               const void* bm, const void* cm, int dtype,
                               int bc, int Q, int H, int N, int P, void* y,
                               void* states, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* c = static_cast<const float*>(cum);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(states);
  cudaError_t err =
      dtype == 0
          ? tc::dispatch<float>(static_cast<const float*>(xh), d, c, bm, cm,
                                bc, Q, H, N, P, yo, so, s)
          : tc::dispatch<__nv_bfloat16>(
                static_cast<const __nv_bfloat16*>(xh), d, c, bm, cm, bc, Q, H,
                N, P, yo, so, s);
  return (int)err;
}

// Dynamic shared memory of one ssd_chunk_wgmma_kernel block.
int ssd_chunk_wgmma_smem_bytes(int Q, int N, int P, int dtype) {
  return tc::smem_bytes(Q, N, P, dtype == 0 ? tc::kPieces : 1);
}

// The inter-chunk pass.  c_dtype (C): 0 float32, 1 bfloat16; y_dtype (the
// output, xh's dtype) likewise.  Q, N <= 128, P a multiple of 4, a row of C
// a multiple of 16 bytes, every pointer 16-byte aligned.
int ssd_state_pass_launch(const void* y_intra, const void* states,
                          const void* cum, const void* cm, int c_dtype,
                          int y_dtype, int B, int nc, int Q, int H, int N,
                          int P, int L, void* y, void* final_state,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int csize = c_dtype == 0 ? 4 : 2;
  if (Q < 1 || Q > pass::kMaxRows || N < 1 || N > pass::kMaxRows || P < 4 ||
      P % 4 || (N * csize) % 16 || L < 1 || L > nc * Q)
    return (int)cudaErrorInvalidValue;
  const float* yi = static_cast<const float*>(y_intra);
  const float* st = static_cast<const float*>(states);
  const float* cu = static_cast<const float*>(cum);
  float* fs = static_cast<float*>(final_state);
  cudaError_t err;
  if (c_dtype == 0 && y_dtype == 0)
    err = pass::launch<float, float>(yi, st, cu, cm, B, nc, Q, H, N, P, L, y,
                                     fs, s);
  else if (c_dtype == 0)
    err = pass::launch<float, __nv_bfloat16>(yi, st, cu, cm, B, nc, Q, H, N,
                                             P, L, y, fs, s);
  else if (y_dtype == 0)
    err = pass::launch<__nv_bfloat16, float>(yi, st, cu, cm, B, nc, Q, H, N,
                                             P, L, y, fs, s);
  else
    err = pass::launch<__nv_bfloat16, __nv_bfloat16>(yi, st, cu, cm, B, nc, Q,
                                                     H, N, P, L, y, fs, s);
  return (int)err;
}

// Dynamic shared memory of one ssd_state_pass_kernel block.
int ssd_state_pass_smem_bytes(int Q, int N, int c_dtype) {
  return c_dtype == 0 ? pass::smem_bytes<float>(Q, N)
                      : pass::smem_bytes<__nv_bfloat16>(Q, N);
}

// The tensor-core pass: Q in {64, 128}, N a multiple of 16 up to 128, P
// a multiple of 32, every pointer 16-byte aligned.  Dtypes as above.
int ssd_state_pass_wgmma_launch(const void* y_intra, const void* states,
                                const void* cum, const void* cm, int c_dtype,
                                int y_dtype, int B, int nc, int Q, int H,
                                int N, int P, int L, void* y,
                                void* final_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((Q != 64 && Q != 128) || N < 16 || N > pass_tc::kMaxN || N % 16 ||
      P < pass_tc::kSlice || P % pass_tc::kSlice || L < 1 || L > nc * Q)
    return (int)cudaErrorInvalidValue;
  const float* yi = static_cast<const float*>(y_intra);
  const float* st = static_cast<const float*>(states);
  const float* cu = static_cast<const float*>(cum);
  float* fs = static_cast<float*>(final_state);
  cudaError_t err;
  if (c_dtype == 0 && y_dtype == 0)
    err = pass_tc::dispatch<float, float>(yi, st, cu, cm, B, nc, Q, H, N, P,
                                          L, y, fs, s);
  else if (c_dtype == 0)
    err = pass_tc::dispatch<float, __nv_bfloat16>(yi, st, cu, cm, B, nc, Q, H,
                                                  N, P, L, y, fs, s);
  else if (y_dtype == 0)
    err = pass_tc::dispatch<__nv_bfloat16, float>(yi, st, cu, cm, B, nc, Q, H,
                                                  N, P, L, y, fs, s);
  else
    err = pass_tc::dispatch<__nv_bfloat16, __nv_bfloat16>(
        yi, st, cu, cm, B, nc, Q, H, N, P, L, y, fs, s);
  return (int)err;
}

// Dynamic shared memory of one ssd_state_pass_wgmma_kernel block.
int ssd_state_pass_wgmma_smem_bytes(int Q, int N, int c_dtype) {
  return c_dtype == 0 ? pass_tc::smem_bytes<float>(Q, N)
                      : pass_tc::smem_bytes<__nv_bfloat16>(Q, N);
}

// Blocks of one kernel an SM holds at once, with bf16 B/C and output at
// Q = 128, P = 64 and the given N: which 0 the tensor-core tile, 1 the
// CUDA-core pass, 2 the tensor-core pass, 3 the CUDA-core tile, 4 the
// tensor-core tile at N 16; -1 if the query failed.
int ssd_blocks_per_sm(int which, int N) {
  auto query = [](auto kernel, int threads, int bytes) {
    int n = -1;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                          bytes);
    return err == cudaSuccess ? n : -1;
  };
  using bf = __nv_bfloat16;
  switch (which) {
    case 0:
      return query(tc::ssd_chunk_wgmma_kernel<bf, bf, 128, 64>, tc::kThreadsTc,
                   tc::smem_bytes(128, N, 64, 1));
    case 1:
      return query(pass::ssd_state_pass_kernel<bf, bf>, pass::kThreadsPass,
                   pass::smem_bytes<bf>(128, N));
    case 2:
      return query(pass_tc::ssd_state_pass_wgmma_kernel<bf, bf, 128>, 2 * 128,
                   pass_tc::smem_bytes<bf>(128, N));
    case 3:
      return query(ssd_chunk_kernel<bf>, kThreads, (int)smem_bytes(128, N, 64));
    case 4: {
      auto kernel = tc::ssd_chunk_wgmma_n16_kernel<bf, bf, 128, 64>;
      if (cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared) != cudaSuccess)
        return -1;   // as its launch sets it
      return query(kernel, tc::kThreadsTc,
                   tc::smem_bytes(128, tc::kNarrowN, 64, 1));
    }
    default:
      return -1;
  }
}

}  // extern "C"
