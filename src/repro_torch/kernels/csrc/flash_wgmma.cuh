// flash_wgmma_kernel, the tensor-core route of the port's flash attention:
// its notes are flash_attention.cu's.  Included by flash_attention.cu (bf16
// at widths 64 and 128, the main paths' instantiations) and
// flash_contract.cu (bf16 at width 256 and float16 at every width), so that
// nvcc builds the two beside each other; each source instantiates what it
// launches.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {
namespace wg {

using namespace hopper;   // kAtom, kAtomBytes, mbarriers, TMA, wgmma

constexpr int kRows = 64;        // q rows of one warpgroup (wgmma's M)
constexpr int kWarpgroups = 2;   // consumer warpgroups of a block
constexpr int kQRows = kWarpgroups * kRows;   // q rows of a block
constexpr int kBlockN = 64;      // keys of a K/V tile (S = m64n64)
constexpr int kThreadsWg = 128 * kWarpgroups;
constexpr int kStages = 2;       // K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInfWg = -1e30f;

// The tile width a head dim d runs at: 64, 128 (d 96 included) or 256.
__host__ __device__ constexpr int width_of(int d) {
  return d <= kAtom ? kAtom : d <= 2 * kAtom ? 2 * kAtom : 4 * kAtom;
}

// Shared memory, every region 1024-byte aligned (a 128-byte swizzle repeats
// every 8 rows).  A (rows x W) 16-bit tile is W / 64 column blocks
// ("atoms") of rows x 128 bytes, one TMA box each, as wgmma's
// 128-byte-swizzled layouts want them.
template <int W>
struct Layout {
  static constexpr int kQBytes = kQRows * W * 2;
  static constexpr int kTileBytes = kBlockN * W * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;   // q, full[kStages]
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + align
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// q, o (B, Lq, H, d); k, v (B, Lk, KVH, d) of element type E (bf16 or
// float16), all contiguous; the tensor maps describe q, k and v at their
// true head dim d <= W.  Block (h, q tile, b), kWarpgroups warpgroups.
template <typename E, int W>
__global__ void __launch_bounds__(kThreadsWg)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int Lq, int Lk,
                   int H, int KVH, int d, int causal, int window,
                   float scale_log2, E* __restrict__ o) {
  using Lay = Layout<W>;
  // float16 keeps each tile's P V apart before adding it to O (the notes
  // of flash_attention.cu say why); bf16 accumulates O on the tensor cores
  constexpr bool kSplitAcc = std::is_same<E, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + Lay::kK, sv = base + Lay::kV;
  const uint32_t bar_q = base + Lay::kBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  // atoms that hold a column below d (the rest are never loaded: S reads
  // none of them, and P V's columns there are never stored), and the k16
  // steps of S = Q K^T that cover d
  const int atoms = (d + kAtom - 1) / kAtom;
  const int ksteps = (d + 15) / 16;

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
    mbar_expect_tx(bar_full(st), 2 * atoms * kBlockN * kAtomBytes);
    for (int a = 0; a < atoms; ++a) {
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
    mbar_expect_tx(bar_q, atoms * kQRows * kAtomBytes);
    for (int a = 0; a < atoms; ++a)
      tma_load(sq + a * kQRows * kAtomBytes, &qmap, bar_q, a * kAtom, h, q0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st)
      load_kv(st, k_begin + st * kBlockN);
  }

  float acc[W / 2];
#pragma unroll
  for (int e = 0; e < W / 2; ++e) acc[e] = 0.f;
  float m_run[2] = {kNegInfWg, kNegInfWg}, l_run[2] = {0.f, 0.f};
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
    for (int kk = 0; kk < W / 16; ++kk) {
      if (kk < ksteps) {
        const uint32_t off = (kk % 4) * 32;
        mma_ss_t<E>(s,
                    desc(q_wg + (kk / 4) * kQRows * kAtomBytes + off, 16, 1024),
                    desc(k_st + (kk / 4) * kBlockN * kAtomBytes + off, 16, 1024),
                    kk > 0);
      }
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
        if (!vis) x = kNegInfWg;
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
    for (int e = 0; e < W / 2; ++e) acc[e] *= corr[(e % 4) / 2];

    // P as hi/lo E A fragments: k-step kk takes s[8 kk .. 8 kk + 7]
    uint32_t p_hi[kBlockN / 16][4], p_lo[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t pieces[2];
        split_pair<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pieces);
        p_hi[kk][r] = pieces[0];
        p_lo[kk][r] = pieces[1];
      }

    // O += P_hi V + P_lo V over the tile's keys in steps of 16 (W / 64
    // atoms of 2 KB of V)
    fence_regs(acc);
    if constexpr (kSplitAcc) {
      // float16: each atom's 64 columns of the tile's products in a fresh
      // accumulator, added to acc in float32 (round to nearest)
#pragma unroll
      for (int a = 0; a < W / kAtom; ++a) {
        if (a < atoms) {
          float part[kAtom / 2];
#pragma unroll
          for (int e = 0; e < kAtom / 2; ++e) part[e] = 0.f;
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockN / 16; ++kk) {
            const uint64_t bv =
                desc(v_st + a * kBlockN * kAtomBytes + kk * 16 * kAtomBytes,
                     kBlockN * kAtomBytes, 1024);
            mma_rs_t<E, kAtom>(part, p_hi[kk], bv, kk > 0);
            mma_rs_t<E, kAtom>(part, p_lo[kk], bv, 1);
          }
          wg_commit();
          wg_wait0();
          fence_regs(part);
#pragma unroll
          for (int e = 0; e < kAtom / 2; ++e) acc[a * kAtom / 2 + e] += part[e];
        }
      }
    } else {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t bv =
            desc(v_st + kk * 16 * kAtomBytes, kBlockN * kAtomBytes, 1024);
        mma_rs_t<E, W>(acc, p_hi[kk], bv, 1);
        mma_rs_t<E, W>(acc, p_lo[kk], bv, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(acc);
    }

    __syncthreads();   // every warpgroup is done with stage st
    if (tid == 0 && t + kStages < n_tiles) load_kv(st, k0 + kStages * kBlockN);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row_a + 8 * r;
    if (i >= Lq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    E* dst = o + (((int64_t)b * Lq + i) * H + h) * d + 2 * t4;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      if (j < d / 8)
        store2(dst + 8 * j, acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the link needs no -lcuda.
inline EncodeTiled encode_tiled() {
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

// A 4-D (d, heads, L, B) map of a contiguous (B, L, heads, d) 16-bit tensor
// of element type E, read in boxes of 64 columns of d x rows positions of
// one head and batch row; positions past L, and columns past d, read as
// zeros.  d * 2 bytes, the row stride, must be a multiple of 16.
template <typename E>
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
                int heads, int L, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = std::is_same<E, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Head dim D: a multiple of 8 up to W (the tensor maps' row stride), q, k
// and v 16-byte aligned (TMA); refused otherwise.
template <typename E, int W>
cudaError_t launch(const void* q, const void* k, const void* v, int B, int Lq,
                   int Lk, int H, int KVH, int D, int causal, int window,
                   void* o, cudaStream_t s) {
  using Lay = Layout<W>;
  if (D < 1 || D > W || D % 8 != 0 || KVH < 1 || H % KVH || Lk < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!tensor_map<E>(enc, &qm, q, D, H, Lq, B, kQRows) ||
      !tensor_map<E>(enc, &km, k, D, KVH, Lk, B, kBlockN) ||
      !tensor_map<E>(enc, &vm, v, D, KVH, Lk, B, kBlockN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<E, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));
  dim3 grid(H, (Lq + kQRows - 1) / kQRows, B);
  flash_wgmma_kernel<E, W><<<grid, kThreadsWg, Lay::kBytes, s>>>(
      qm, km, vm, Lq, Lk, H, KVH, D, causal, window, scale_log2,
      static_cast<E*>(o));
  return cudaGetLastError();
}

// Blocks of flash_wgmma_kernel<E, W> an SM holds at once; -1 if the query
// failed.
template <typename E, int W>
int blocks_per_sm() {
  int n = -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<E, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<W>::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_wgmma_kernel<E, W>, kThreadsWg, Layout<W>::kBytes);
  return err == cudaSuccess ? n : -1;
}

}  // namespace wg
}  // namespace
