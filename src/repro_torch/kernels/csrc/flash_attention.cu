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
// The wrapper routes 16-byte-aligned bf16 inputs with head dim 64, 96 or
// 128 to flash_wgmma_kernel, head dims above 256 to flash_wide_kernel and
// everything else (float32, float16, bf16 at other head dims or off a
// 16-byte boundary) to flash_kernel; q, k and v of mixed dtypes arrive cast
// to float32.
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
// flash_wgmma_kernel (bf16, d = 64, 96 or 128): both products on the tensor
// cores, so it can run below the 8.2 ms CUDA-core floor, which flash_kernel
// cannot.  One block per (query head, q tile of 128 rows, batch row), two
// warpgroups of 64 rows each.  Q (once) and every 64-key K and V tile
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
// scores after the product, never to bf16 Q.
// The online softmax runs in the accumulator registers: a thread holds two
// rows, each row spread over the 4 threads of a quad, reduced by a fixed
// xor order.  P V is wgmma m64n{d}k16 with P from registers (the S
// accumulator layout is the A-fragment layout) and V from shared memory
// (MN-major: the transpose bit).  P enters as a hi/lo pair of bf16,
// P_hi = bf16(P), P_lo = bf16(P - P_hi), O += P_hi V + P_lo V: the
// reference multiplies a float32 P by V, and a single bf16 P would add a
// rounding that neither the reference nor the plain path has.  The split
// costs 1.5x the tensor-core products of a single bf16 P (8.3e11 instead
// of 5.5e11 operations at the slice shape: 0.83 ms at the bf16 peak).
// Masks are evaluated only on tiles that some row of the warpgroup cannot
// fully see; tiles no row can see are skipped (exact, as in flash_kernel),
// and q tiles run longest first (the q tile is the slower grid axis, so
// every head of a tile is dispatched before the next shorter tile).  No
// atomics: two launches give bitwise-equal outputs.
// Head dim 96 (phi3-mini) is 1.5 of the 64-column atoms: the kernel runs as
// at d = 128 with every tile 128 columns wide in shared memory.  The tensor
// maps keep d = 96, so the second atom's TMA box reads columns 64-127 and
// TMA fills 96-127 with zeros.  S = Q K^T takes only the six k16 steps of
// the real columns; P V runs at n128 (wgmma's MN-major V needs whole
// 64-column atoms) and the last 32 output columns, zero, are never stored:
// 4/3 of the P V products.  The scale stays 96^-1/2.  Shared memory and
// blocks per SM are d = 128's.
//
// flash_kernel (float32, float16, and bf16 off the tensor cores' shapes):
// every product in float32 on CUDA cores (bf16 and float16 inputs are
// widened on load; float32 inputs get true float32, never TF32), so it
// cannot beat the 8.2 ms floor; it is the checked float32 route.  It is
// instantiated at widths D of 16, 32, 64, 96, 128 and 256; any head dim up
// to 256 runs the next width, the true dim a run-time argument: columns
// past it load as zeros (each adds an exact 0 to a score, so a dim that is
// a width gets the same bits as before the argument existed) and are not
// stored.  At D = 256 a block takes 213,760 bytes of float32 shared memory,
// one block an SM.  One block per (q tile of 64 rows, query head,
// batch row), 256 threads in a 16 x 16 grid; thread (ty, tx) owns score
// rows ty + 16 r and columns tx + 16 c (r, c < 4) and output columns
// tx + 16 c (c < d / 16), so neighbouring threads read neighbouring
// shared-memory words and the 16 threads of one row are one half-warp,
// which reduces the row's max and sum with a fixed xor butterfly.  The
// sequential kv axis of the Pallas grid is the loop inside the block: a
// 64-row K and V tile is staged in shared memory, the 64 x 64 scores stay
// in registers, the probabilities go through shared memory into P V.
// Causal and window masks let the loop skip kv tiles that no row of the q
// tile can see (exact: every row sees its own position, so a skipped tile
// would only have added terms that the online rescale multiplies by
// exp(-1e30) = 0), which halves the causal work; q tiles are scheduled
// longest first.  GQA reads the shared kv head in place, never expanded.
// No atomics: two launches give bitwise-equal outputs.
//
// flash_wide_kernel (head dims above 256, any dtype): Q and K no longer fit
// a block beside V, so the block stages them in 64-column chunks and keeps
// 128 output columns of its own (blocks of one row tile split the head
// dim's columns); each recomputes the scores over the whole head dim, the
// same ascending fmaf chain as flash_kernel's, so every slice sees the same
// softmax.  82,688 bytes of shared memory a block.  At d = 512 the scores
// are computed four times, so it does (d / 128 + 1) / 2 times flash_kernel's
// work per output; a route no config takes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#include "flash_simt.cuh"

namespace {

// float32 and bf16 at head dims up to 128: each its own width or the next
// of 16, 32, 64, 96 and 128 (flash_contract.cu launches the rest).
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

// ---------------------------------------------------------------------------
// flash_wgmma_kernel: bf16 on the tensor cores (wgmma), K/V through TMA.
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;   // kAtom, kAtomBytes, mbarriers, TMA, wgmma

constexpr int kRows = 64;        // q rows of one warpgroup (wgmma's M)
constexpr int kWarpgroups = 2;   // consumer warpgroups of a block
constexpr int kQRows = kWarpgroups * kRows;   // q rows of a block
constexpr int kBlockN = 64;      // keys of a K/V tile (S = m64n64)
constexpr int kThreadsWg = 128 * kWarpgroups;
constexpr int kStages = 2;       // K/V ring
constexpr float kLog2e = 1.4426950408889634f;

// Head dim D held as whole 64-column atoms (96 -> 128).
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + kAtom - 1) / kAtom * kAtom;
}

// Shared memory, every region 1024-byte aligned (a 128-byte swizzle repeats
// every 8 rows).  A (rows x d) bf16 tile is padded<D>() / 64 column blocks
// ("atoms") of rows x 128 bytes, one TMA box each, as wgmma's
// 128-byte-swizzled layouts want them.
template <int D>
struct Layout {
  static constexpr int kQBytes = kQRows * padded<D>() * 2;
  static constexpr int kTileBytes = kBlockN * padded<D>() * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;   // q, full[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + align
};

// q, o (B, Lq, H, D); k, v (B, Lk, KVH, D) bf16, all contiguous; the
// tensor maps describe q, k and v.  Block (h, q tile, b), kWarpgroups
// warpgroups.
template <int D>
__global__ void __launch_bounds__(kThreadsWg)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int Lq, int Lk,
                   int H, int KVH, int causal, int window, float scale_log2,
                   __nv_bfloat16* __restrict__ o) {
  using Lay = Layout<D>;
  constexpr int DP = padded<D>();   // columns of a tile and of acc
  constexpr int kAtoms = DP / kAtom;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + Lay::kK, sv = base + Lay::kV;
  const uint32_t bar_q = base + Lay::kBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQRows;   // longest first
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int lane = tid % 32, quad = lane / 4, t4 = lane % 4;
  // this thread's two rows of the block's q tile
  const int row_a = q0 + wgi * kRows + ((tid % 128) / 32) * 16 + quad;

  // kv tiles that some row of the block's q tile can see
  const int q_last = min(q0 + kQRows, Lq) - 1;
  const int k_end = causal ? min(q_last + 1, Lk) : Lk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBlockN * kBlockN : 0;
  const int n_tiles = (k_end - k_begin + kBlockN - 1) / kBlockN;

  auto load_kv = [&](int st, int k0) {
    mbar_expect_tx(bar_full(st), 2 * Lay::kTileBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
      const uint32_t off = st * Lay::kTileBytes + a * kBlockN * kAtomBytes;
      tma_load(sk + off, &kmap, bar_full(st), a * kAtom, kvh, k0, b);
      tma_load(sv + off, &vmap, bar_full(st), a * kAtom, kvh, k0, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(bar_full(st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, Lay::kQBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load(sq + a * kQRows * kAtomBytes, &qmap, bar_q, a * kAtom, h, q0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      load_kv(st, k_begin + st * kBlockN);
  }

  float acc[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // rows of this warpgroup, for the test of a fully visible tile
  const int wg_first = q0 + wgi * kRows, wg_last = wg_first + kRows - 1;
  const uint32_t q_wg = sq + wgi * kRows * kAtomBytes;

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const int k0 = k_begin + t * kBlockN;
    mbar_wait(bar_full(st), (t / kStages) & 1);
    const uint32_t k_st = sk + st * Lay::kTileBytes;
    const uint32_t v_st = sv + st * Lay::kTileBytes;

    // S = Q K^T over the real d in steps of 16 (32 bytes inside a 128-byte
    // atom)
    float s[kBlockN / 2];
#pragma unroll
    for (int e = 0; e < kBlockN / 2; ++e) s[e] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      mma_ss(s, desc(q_wg + (kk / 4) * kQRows * kAtomBytes + off, 16, 1024),
             desc(k_st + (kk / 4) * kBlockN * kAtomBytes + off, 16, 1024),
             kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // scale (log2 domain) and mask; only tiles a row cannot fully see
    const bool full = k0 + kBlockN <= Lk &&
                      (!causal || k0 + kBlockN - 1 <= wg_first) &&
                      (window <= 0 || k0 > wg_last - window);
#pragma unroll
    for (int e = 0; e < kBlockN / 2; ++e) {
      float x = s[e] * scale_log2;
      if (!full) {
        const int i = row_a + 8 * ((e % 4) / 2);
        const int j = k0 + 8 * (e / 4) + 2 * t4 + (e % 2);
        bool vis = j < Lk;
        if (causal) vis = vis && j <= i;
        if (window > 0) vis = vis && j > i - window;
        if (!vis) x = kNegInf;
      }
      s[e] = x;
    }

    // online softmax over the quad of each row, fixed xor order
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int e = 0; e < kBlockN / 2; ++e)
      mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], s[e]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < kBlockN / 2; ++e) {
      const float p = exp2f(s[e] - mx[(e % 4) / 2]);
      s[e] = p;
      sum[(e % 4) / 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = l_run[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] *= corr[(e % 4) / 2];

    // P as hi/lo bf16 A fragments: k-step kk takes s[8 kk .. 8 kk + 7]
    uint32_t p_hi[kBlockN / 16][4], p_lo[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t pieces[2];
        split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pieces);
        p_hi[kk][r] = pieces[0];
        p_lo[kk][r] = pieces[1];
      }

    // O += P_hi V + P_lo V over the tile's keys in steps of 16 (2 KB of V)
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint64_t bv =
          desc(v_st + kk * 16 * kAtomBytes, kBlockN * kAtomBytes, 1024);
      mma_rs<DP>(acc, p_hi[kk], bv, 1);
      mma_rs<DP>(acc, p_lo[kk], bv, 1);
    }
    wg_commit();
    wg_wait0();
    fence_regs(acc);

    __syncthreads();   // every warpgroup is done with stage st
    if (tid == 0 && t + kStages < n_tiles) load_kv(st, k0 + kStages * kBlockN);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_a + 8 * r;
    if (i >= Lq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* dst = o + (((int64_t)b * Lq + i) * H + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the link needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D (d, heads, L, B) map of a contiguous (B, L, heads, d) bf16 tensor,
// read in boxes of 64 columns of d x rows positions of one head and batch
// row; positions past L, and columns past d, read as zeros.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
                int heads, int L, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, int B, int Lq,
                   int Lk, int H, int KVH, int causal, int window, void* o,
                   cudaStream_t s) {
  using Lay = Layout<D>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!tensor_map(enc, &qm, q, D, H, Lq, B, kQRows) ||
      !tensor_map(enc, &km, k, D, KVH, Lk, B, kBlockN) ||
      !tensor_map(enc, &vm, v, D, KVH, Lk, B, kBlockN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));
  dim3 grid(H, (Lq + kQRows - 1) / kQRows, B);
  flash_wgmma_kernel<D><<<grid, kThreadsWg, Lay::kBytes, s>>>(
      qm, km, vm, Lq, Lk, H, KVH, causal, window, scale_log2,
      static_cast<__nv_bfloat16*>(o));
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

int flash_contract_launch(const void* q, const void* k, const void* v,
                          int dtype, int B, int Lq, int Lk, int H, int KVH,
                          int D, int causal, int window, void* o,
                          void* stream);

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o alike); any
// head dim D >= 1.  float32 and bf16 up to D 128 launch flash_kernel here,
// the rest go through flash_contract.cu.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           int dtype, int B, int Lq, int Lk, int H, int KVH,
                           int D, int causal, int window, void* o,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH || Lk < 1) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (dtype == 0 && D <= 128) return (int)dispatch<float>(FLASH_ARGS);
  if (dtype == 1 && D <= 128) return (int)dispatch<__nv_bfloat16>(FLASH_ARGS);
#undef FLASH_ARGS
  return flash_contract_launch(q, k, v, dtype, B, Lq, Lk, H, KVH, D, causal,
                               window, o, stream);
}

// bf16 q, k, v and o with D 64, 96 or 128, on the tensor cores.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 int B, int Lq, int Lk, int H, int KVH, int D,
                                 int causal, int window, void* o,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH || Lk < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return (int)wg::launch<64>(q, k, v, B, Lq, Lk, H, KVH, causal, window, o, s);
    case 96: return (int)wg::launch<96>(q, k, v, B, Lq, Lk, H, KVH, causal, window, o, s);
    case 128: return (int)wg::launch<128>(q, k, v, B, Lq, Lk, H, KVH, causal, window, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one flash_wgmma_kernel block at head dim D.
int flash_attention_wgmma_smem_bytes(int D) {
  switch (D) {
    case 64: return wg::Layout<64>::kBytes;
    case 96: return wg::Layout<96>::kBytes;
    case 128: return wg::Layout<128>::kBytes;
    default: return -1;
  }
}

// Blocks of flash_wgmma_kernel an SM holds at once at head dim D; -1 if the
// query failed.
int flash_attention_wgmma_blocks_per_sm(int D) {
  auto query = [](auto kernel, int bytes) {
    int n = -1;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                          wg::kThreadsWg, bytes);
    return err == cudaSuccess ? n : -1;
  };
  switch (D) {
    case 64: return query(wg::flash_wgmma_kernel<64>, wg::Layout<64>::kBytes);
    case 96: return query(wg::flash_wgmma_kernel<96>, wg::Layout<96>::kBytes);
    case 128: return query(wg::flash_wgmma_kernel<128>, wg::Layout<128>::kBytes);
    default: return -1;
  }
}

}  // extern "C"
