// flash_wgmma_kernel, the tensor-core route of the port's flash attention:
// its notes are flash_attention.cu's.  Two loaders feed one body: TMA
// (kLoaded false: 16-byte-aligned inputs at a head dim that is a multiple
// of 8) and a producer warpgroup's own loads (kLoaded true: any 2-byte
// boundary, any head dim up to 256).  The float32 kind (E = float, always
// loaded: flash_f32.cu) runs the same body on three bf16 pieces of every
// float32 operand.  Included by flash_attention.cu (TMA's bf16 at widths
// 64 and 128, the main paths' instantiations), flash_contract.cu (TMA's
// bf16 at width 256 and float16 at every width), flash_loaded.cu (the
// loaded route) and flash_f32.cu (float32), so that nvcc builds them
// beside each other; each source instantiates what it launches.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_load.cuh"
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
template <int W, bool kLoaded = false>
struct Layout {
  // K/V stages: the loaded route takes a third where shared memory allows
  // (W up to 128), so that its producer runs up to two tiles ahead
  static constexpr int kNStages = kLoaded && W <= 2 * kAtom ? 3 : kStages;
  static constexpr int kQBytes = kQRows * W * 2;
  static constexpr int kTileBytes = kBlockN * W * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kNStages * kTileBytes;
  // q, full[kNStages] and, on the loaded route, empty[kNStages]
  static constexpr int kBar = kV + kNStages * kTileBytes;
  static constexpr int kBarriers = 1 + kNStages * (kLoaded ? 2 : 1);
  static constexpr int kBytes = kBar + 8 * kBarriers + 1024;  // + align
};

// The loaded route (flash_attention.cu's notes): a producer warpgroup of
// its own beside the kWarpgroups consumers.
constexpr int kProducerThreads = 128;
constexpr int kThreadsLoaded = kThreadsWg + kProducerThreads;

// The float32 kind (flash_f32.cu's notes): every float32 operand as
// kPieces bf16 pieces in shared memory; kv tiles of kF32BlockN keys.  Q's
// pieces are three tiles of Layout's shape; a K or V tile is one 16-bit
// tile whose atoms hold kPieces x kF32BlockN rows, piece p in rows p
// kF32BlockN .. (p + 1) kF32BlockN - 1, so that the pieces 0 .. n - 1 of
// K are one operand of n kF32BlockN rows.  Its stages hold 128 keys at
// width 64 and 64 at width 128 (two stages of 32 keys: the 96 KB of Q's
// pieces and 48 KB of K's and V's a stage leave no room for a third).
constexpr int kPieces = 3;
constexpr int kF32BlockN = 32;
template <int W>
struct LayoutF32 {
  static constexpr int kNStages = (W <= kAtom ? 128 : 64) / kF32BlockN;
  static constexpr int kQPiece = kQRows * W * 2;
  static constexpr int kAtomRows = kPieces * kF32BlockN;   // a K or V atom's
  static constexpr int kQBytes = kPieces * kQPiece;
  static constexpr int kTileBytes = kAtomRows * W * 2;   // a stage of K or V
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kNStages * kTileBytes;
  static constexpr int kBar = kV + kNStages * kTileBytes;
  static constexpr int kBarriers = 1 + 2 * kNStages;
  static constexpr int kBytes = kBar + 8 * kBarriers + 1024;  // + align
};

// The pieces (a, b) of P V's products P_a V_b with a + b < 3 but the main
// one (0, 0), smallest first: (0, 2), (1, 1), (2, 0), (0, 1), (1, 0).
constexpr int kSmallPairs = 5;
__host__ __device__ constexpr int piece_a(int pr) { return pr < 3 ? pr : pr - 3; }
__host__ __device__ constexpr int piece_b(int pr) { return pr < 3 ? 2 - pr : 4 - pr; }

// d (+)= A B for a 64 x N tile, both operands K-major in shared memory:
// S's products Q_a [K_0 .. K_{2-a}]^T of the float32 kind, N = (3 - a)
// kF32BlockN (32, 64 or 96; 64, 128 or 192 at 64-key tiles).
template <int N>
__device__ __forceinline__ void mma_ss_cols(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  float(&dn)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(d);
  if constexpr (N == 32) mma_ss_n32(dn, a, b, accumulate);
  else if constexpr (N == 64) mma_ss(dn, a, b, accumulate);
  else if constexpr (N == 96) mma_ss_n96(dn, a, b, accumulate);
  else if constexpr (N == 128) mma_ss_n128(dn, a, b, accumulate);
  else mma_ss_n192(dn, a, b, accumulate);
}

// q, k and v of the loaded route (unused by TMA's, which reads tensor maps)
struct Srcs {
  const void* q;
  const void* k;
  const void* v;
};

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void store1(__half* p, float a) {
  *p = __float2half_rn(a);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// q, o (B, Lq, H, d); k, v (B, Lk, KVH, d) of element type E (bf16,
// float16 or float32), all contiguous.  TMA's route (kLoaded false): the
// tensor maps describe q, k and v at their true head dim d <= W, a
// multiple of 8.  The loaded route: `src` holds q, k and v at any
// 2-byte-aligned address, any d <= W, and a producer warpgroup loads them;
// float32 (always loaded) on 16-byte boundaries at a d that is a multiple
// of 4.  Block (h, q tile, b), kWarpgroups consumer warpgroups.
// (No minimum of blocks an SM in the bounds: with one, ptxas gave the bf16
// width-128 instantiation 161 registers and one block an SM, 1.2x slower
// than its 128 and two.)
template <typename E, int W, bool kLoaded = false>
__global__ void __launch_bounds__(kLoaded ? kThreadsLoaded : kThreadsWg)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, Srcs src,
                   int Lq, int Lk, int H, int KVH, int d, int causal,
                   int window, float scale_log2, E* __restrict__ o) {
  // float32 runs on kPieces bf16 pieces of each operand (flash_f32.cu)
  constexpr bool kF32 = std::is_same<E, float>::value;
  static_assert(kLoaded || !kF32, "float32 has a producer warpgroup");
  using Lay = typename std::conditional<kF32, LayoutF32<W>,
                                        Layout<W, kLoaded>>::type;
  constexpr int kBN = kF32 ? kF32BlockN : kBlockN;   // keys of a kv tile
  // float16 keeps each tile's P V apart before adding it to O (the notes
  // of flash_attention.cu say why); bf16 accumulates O on the tensor cores
  constexpr bool kSplitAcc = std::is_same<E, __half>::value;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + Lay::kK, sv = base + Lay::kV;
  const uint32_t bar_q = base + Lay::kBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  constexpr int kNS = Lay::kNStages;
  auto bar_empty = [&](int st) { return bar_q + 8u * (1 + kNS + st); };
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
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBN * kBN : 0;
  const int n_tiles = (k_end - k_begin + kBN - 1) / kBN;

  auto load_kv = [&](int st, int k0) {
    mbar_expect_tx(bar_full(st), 2 * atoms * kBlockN * kAtomBytes);
    for (int a = 0; a < atoms; ++a) {
      const uint32_t off = st * Lay::kTileBytes + a * kBlockN * kAtomBytes;
      tma_load(sk + off, &kmap, bar_full(st), a * kAtom, kvh, k0, b);
      tma_load(sv + off, &vmap, bar_full(st), a * kAtom, kvh, k0, b);
    }
  };

  if (tid == 0) {
    // TMA's loads complete by bytes after one arrival, the loaded route's
    // stages by an arrival from each producer warp, a stage's release by
    // one from each consumer warp
    const int producers = kLoaded ? kProducerThreads / 32 : 1;
    mbar_init(bar_q, producers);
    for (int st = 0; st < kNS; ++st) {
      mbar_init(bar_full(st), producers);
      if constexpr (kLoaded) mbar_init(bar_empty(st), kThreadsWg / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the consumer warpgroups: S, the online softmax and P V over every
  // kv tile, then the rows of O
  auto consume = [&]() {
    float acc[W / 2];
#pragma unroll
    for (int e = 0; e < W / 2; ++e) acc[e] = 0.f;
    float m_run[2] = {kNegInfWg, kNegInfWg}, l_run[2] = {0.f, 0.f};
    // rows of this warpgroup, for the test of a fully visible tile
    const int wg_first = q0 + wgi * kRows, wg_last = wg_first + kRows - 1;
    const uint32_t q_wg = sq + wgi * kRows * kAtomBytes;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kNS;
      const int k0 = k_begin + t * kBN;
      mbar_wait(bar_full(st), (t / kNS) & 1);
      const uint32_t k_st = sk + st * Lay::kTileBytes;
      const uint32_t v_st = sv + st * Lay::kTileBytes;

      float s[kBN / 2];
      if constexpr (kF32) {
        // S = Q K^T as the six piece products a + b < 3 over the real d in
        // steps of 16: Q_a [K_0 .. K_{2-a}]^T, one wgmma of (3 - a) kBN
        // columns a step, into columns a kBN .. 3 kBN - 1 of blocks, so
        // that block b (columns b kBN ..) sums the products of order b:
        // block 0 the main one, block 1 Q_1 K_0 + Q_0 K_1, block 2 Q_2 K_0
        // + Q_1 K_1 + Q_0 K_2, in that order (smallest first; flash_f32.cu)
        float blocks[kPieces * kBN / 2];
#pragma unroll
        for (int e = 0; e < kPieces * kBN / 2; ++e) blocks[e] = 0.f;
        wg_fence();
#pragma unroll
        for (int a = kPieces - 1; a >= 0; --a) {
#pragma unroll
          for (int kk = 0; kk < W / 16; ++kk) {
            if (kk < ksteps) {
              const uint32_t off = (kk % 4) * 32;
              const uint64_t da = desc(q_wg + a * Lay::kQPiece +
                                       (kk / 4) * kQRows * kAtomBytes + off, 16, 1024);
              const uint64_t db = desc(k_st + (kk / 4) * Lay::kAtomRows * kAtomBytes + off,
                                       16, 1024);
              if (a == 2) mma_ss_cols<kBN>(blocks + kBN, da, db, 1);
              else if (a == 1) mma_ss_cols<2 * kBN>(blocks + kBN / 2, da, db, 1);
              else mma_ss_cols<3 * kBN>(blocks, da, db, 1);
            }
          }
        }
        wg_commit();
        wg_wait0();
        fence_regs(blocks);
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e)
          s[e] = blocks[e] + (blocks[kBN + e] + blocks[kBN / 2 + e]);
      } else {
        // S = Q K^T over the real d in steps of 16 (32 bytes inside a
        // 128-byte atom)
#pragma unroll
        for (int e = 0; e < kBN / 2; ++e) s[e] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
          if (kk < ksteps) {
            const uint32_t off = (kk % 4) * 32;
            mma_ss_t<E>(s,
                        desc(q_wg + (kk / 4) * kQRows * kAtomBytes + off, 16, 1024),
                        desc(k_st + (kk / 4) * kBN * kAtomBytes + off, 16, 1024),
                        kk > 0);
          }
        }
        wg_commit();
        wg_wait0();
        fence_regs(s);
      }

      // scale (log2 domain) and mask; only tiles a row cannot fully see
      const bool full = k0 + kBN <= Lk &&
                        (!causal || k0 + kBN - 1 <= wg_first) &&
                        (window <= 0 || k0 > wg_last - window);
#pragma unroll
      for (int e = 0; e < kBN / 2; ++e) {
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
      for (int e = 0; e < kBN / 2; ++e)
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
      for (int e = 0; e < kBN / 2; ++e) {
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

      if constexpr (kF32) {
        // P (float32, in the accumulator layout, which is the A-fragment
        // layout) as three bf16 pieces: k-step kk takes s[8 kk .. 8 kk + 7]
        uint32_t pp[kPieces][kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t pieces[kPieces];
            split_bf16<kPieces>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pieces);
#pragma unroll
            for (int a = 0; a < kPieces; ++a) pp[a][kk][r] = pieces[a];
          }
        // O += P V: for each atom of 64 columns, the tile's six piece
        // products (P's piece a, V's piece b), smallest first, in a fresh
        // accumulator, added to acc in float32 (round to nearest); one
        // 128-column product for both atoms spills at 168 registers
        fence_regs(acc);
#pragma unroll
        for (int a = 0; a < W / kAtom; ++a) {
          if (a < atoms) {
            float part[kAtom / 2];
#pragma unroll
            for (int e = 0; e < kAtom / 2; ++e) part[e] = 0.f;
            wg_fence();
#pragma unroll
            for (int pr = 0; pr <= kSmallPairs; ++pr) {
              const int pa = pr < kSmallPairs ? piece_a(pr) : 0;
              const int pb = pr < kSmallPairs ? piece_b(pr) : 0;
#pragma unroll
              for (int kk = 0; kk < kBN / 16; ++kk)
                mma_rs<kAtom>(part, pp[pa][kk],
                              desc(v_st + (a * Lay::kAtomRows + pb * kBN + kk * 16) *
                                              kAtomBytes,
                                   Lay::kAtomRows * kAtomBytes, 1024), 1);
            }
            wg_commit();
            wg_wait0();
            fence_regs(part);
#pragma unroll
            for (int e = 0; e < kAtom / 2; ++e) acc[a * kAtom / 2 + e] += part[e];
          }
        }
      } else {
        // P as hi/lo E A fragments: k-step kk takes s[8 kk .. 8 kk + 7]
        uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
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
              for (int kk = 0; kk < kBN / 16; ++kk) {
                const uint64_t bv =
                    desc(v_st + a * kBN * kAtomBytes + kk * 16 * kAtomBytes,
                         kBN * kAtomBytes, 1024);
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
        } else if constexpr (kLoaded && W == 4 * kAtom) {
          // the loaded route at width 256: O as four 64-column products, each
          // atom's columns taking the same accumulations in the same order
          // as in one 256-column product (the same bits), with fewer
          // registers live in one wgmma.  The launch's 168 registers a thread
          // spill either way (the producer warpgroup shares the register
          // file), but one 256-column product spills 4552 bytes where this
          // spills 608, and runs 4.3x slower at gemma-7b's d 256 slice
          // (PERF.md; tools/flash_copies.py's one_pv copy)
          wg_fence();
#pragma unroll
          for (int a = 0; a < W / kAtom; ++a) {
            if (a < atoms) {
              float(&acc_a)[kAtom / 2] =
                  *reinterpret_cast<float(*)[kAtom / 2]>(acc + a * kAtom / 2);
#pragma unroll
              for (int kk = 0; kk < kBN / 16; ++kk) {
                const uint64_t bv =
                    desc(v_st + a * kBN * kAtomBytes + kk * 16 * kAtomBytes,
                         kBN * kAtomBytes, 1024);
                mma_rs_t<E, kAtom>(acc_a, p_hi[kk], bv, 1);
                mma_rs_t<E, kAtom>(acc_a, p_lo[kk], bv, 1);
              }
            }
          }
          wg_commit();
          wg_wait0();
          fence_regs(acc);
        } else {
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk) {
            const uint64_t bv =
                desc(v_st + kk * 16 * kAtomBytes, kBN * kAtomBytes, 1024);
            mma_rs_t<E, W>(acc, p_hi[kk], bv, 1);
            mma_rs_t<E, W>(acc, p_lo[kk], bv, 1);
          }
          wg_commit();
          wg_wait0();
          fence_regs(acc);
        }
      }

      if constexpr (kLoaded) {
        __syncwarp();   // this warp is done with stage st
        if (lane == 0) mbar_arrive(bar_empty(st));
      } else {
        __syncthreads();   // every warpgroup is done with stage st
        if (tid == 0 && t + kStages < n_tiles) load_kv(st, k0 + kStages * kBN);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row_a + 8 * r;
      if (i >= Lq) continue;
      const float l = fmaxf(l_run[r], 1e-30f);
      if constexpr (kLoaded) {
        // every column below any d; a pair in one store only where it
        // starts on a boundary of the pair's size (at an odd d every other
        // 16-bit row starts 2 bytes into a word)
        E* row = o + (((int64_t)b * Lq + i) * H + h) * d;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int c = 8 * j + 2 * t4;
          if (c < d) {
            const float x0 = acc[4 * j + 2 * r] / l;
            const float x1 = acc[4 * j + 2 * r + 1] / l;
            if (c + 1 < d &&
                reinterpret_cast<uintptr_t>(row + c) % (2 * sizeof(E)) == 0) {
              store2(row + c, x0, x1);
            } else {
              store1(row + c, x0);
              if (c + 1 < d) store1(row + c + 1, x1);
            }
          }
        }
      } else {
        E* dst = o + (((int64_t)b * Lq + i) * H + h) * d + 2 * t4;
#pragma unroll
        for (int j = 0; j < W / 8; ++j)
          if (j < d / 8)
            store2(dst + 8 * j, acc[4 * j + 2 * r] / l, acc[4 * j + 2 * r + 1] / l);
      }
    }
  };

  if constexpr (kF32) {
    if (tid >= kThreadsWg) {
      // the float32 kind's producer warpgroup: Q once, then every K/V tile
      // into the ring, each stage once all consumers have released it.
      // Thread t reads float32 columns 8 c .. 8 c + 7 (two 16-byte loads)
      // of every kStep-th row, splits them into kPieces bf16 pieces and
      // stores each piece's 16-byte chunk into that piece's swizzled tile,
      // zeros past d and past L
      constexpr int kCW = W / 8;                      // chunks of a piece row
      constexpr int kStep = kProducerThreads / kCW;   // rows between mine
      constexpr int kPer = kBN / kStep < 4 ? kBN / kStep : 4;   // my rows
      constexpr int kB = kStep * kPer;                // rows of a batch
      static_assert(kQRows % kB == 0 && kBN % kB == 0, "whole batches");
      const int t = tid - kThreadsWg;
      const int c = t % kCW, r_first = t / kCW;
      const bool read = c < 8 * atoms;   // a chunk some wgmma reads
      uint8_t* const tiles = smem_raw + (base - smem_u32(smem_raw));
      const int qb = kQRows / kB, kvb = kBN / kB;
      const int n_batches = qb + n_tiles * 2 * kvb;
      struct Rows {
        const float* p0;   // the batch's first row
        int64_t stride;    // floats between rows
        int rows;          // rows before L
        int tile_rows, tile_row0, tile;   // rows of an atom, my first, tile
        uint8_t* dst;      // the tile (piece 0's rows)
        int piece;         // bytes between the pieces' rows
      };
      auto batch = [&](int i) {
        if (i < qb) {
          const int r0 = q0 + i * kB;
          return Rows{static_cast<const float*>(src.q) +
                          (((int64_t)b * Lq + r0) * H + h) * d,
                      (int64_t)H * d, Lq - r0, kQRows, i * kB, -1, tiles,
                      Lay::kQPiece};
        }
        const int j = i - qb, tt = j / (2 * kvb), part = j % kvb;
        const bool is_v = (j / kvb) % 2;
        const int r0 = k_begin + tt * kBN + part * kB;
        return Rows{static_cast<const float*>(is_v ? src.v : src.k) +
                        (((int64_t)b * Lk + r0) * KVH + kvh) * d,
                    (int64_t)KVH * d, Lk - r0, Lay::kAtomRows, part * kB, tt,
                    tiles + (is_v ? Lay::kV : Lay::kK) +
                        (tt % kNS) * Lay::kTileBytes,
                    kBN * kAtomBytes};
      };
      struct Vals {
        float4 lo[kPer], hi[kPer];
      };
      // my columns of my rows of batch i into registers
      auto fetch = [&](int i, Vals& x) {
        const Rows R = batch(i);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int r = r_first + kStep * k;
          x.lo[k] = x.hi[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < R.rows && 8 * c < d) {
            const float* p = R.p0 + r * R.stride + 8 * c;
            x.lo[k] = __ldg(reinterpret_cast<const float4*>(p));
            if (8 * c + 4 < d) x.hi[k] = __ldg(reinterpret_cast<const float4*>(p + 4));
          }
        }
      };
      uint32_t chunk_at[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int r = r_first + kStep * k;
        chunk_at[k] = r * kAtomBytes + (((c % 8) ^ (r % 8)) << 4);
      }
      // batch i's pieces into the swizzled tiles, once the stage is free;
      // after Q's or a kv tile's last batch, this thread's stores are made
      // visible to wgmma's async proxy and its warp arrives
      auto put = [&](int i, const Vals& x) {
        const Rows R = batch(i);
        const int j = i - qb;
        if (i >= qb && j % (2 * kvb) == 0 && R.tile >= kNS)
          mbar_wait(bar_empty(R.tile % kNS), (R.tile / kNS - 1) & 1);
        uint8_t* const dst = R.dst + (c / 8) * R.tile_rows * kAtomBytes +
                             R.tile_row0 * kAtomBytes;
        if (read) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const float v[8] = {x.lo[k].x, x.lo[k].y, x.lo[k].z, x.lo[k].w,
                                x.hi[k].x, x.hi[k].y, x.hi[k].z, x.hi[k].w};
            uint4 pieces[kPieces];
            split8<kPieces>(v, pieces);
#pragma unroll
            for (int a = 0; a < kPieces; ++a)
              *reinterpret_cast<uint4*>(dst + a * R.piece + chunk_at[k]) = pieces[a];
          }
        }
        const bool q_done = i == qb - 1;
        if (q_done || (i >= qb && j % (2 * kvb) == 2 * kvb - 1)) {
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(q_done ? bar_q : bar_full(R.tile % kNS));
        }
      };
      // two batches in flight: batch i + 1's loads overlap batch i's split
      Vals x0, x1;
      fetch(0, x0);
      for (int i = 0; i < n_batches; i += 2) {
        if (i + 1 < n_batches) fetch(i + 1, x1);
        put(i, x0);
        if (i + 1 < n_batches) {
          if (i + 2 < n_batches) fetch(i + 2, x0);
          put(i + 1, x1);
        }
      }
    } else {
      consume();
    }
  } else if constexpr (kLoaded) {
    if (tid >= kThreadsWg) {
      // the producer warpgroup: Q once, then every K/V tile into the ring,
      // each stage once all consumers have released it; generic-proxy
      // stores, made visible to wgmma's async proxy before the arrival
      constexpr int kCW = W / 8;                      // chunks of a full row
      constexpr int kStep = kProducerThreads / kCW;   // rows between mine
      constexpr int kPer = 4;                         // my rows of a batch
      constexpr int kB = kStep * kPer;                // rows of a batch
      const int t = tid - kThreadsWg;
      // this thread's chunk c of rows t / kCW + kStep k
      const int c = t % kCW, r_first = t / kCW;
      const bool in_atoms = c < 8 * atoms;   // a chunk some wgmma reads
      const bool live = 8 * c < d;           // ... holding a column below d
      uint8_t* const tiles = smem_raw + (base - smem_u32(smem_raw));
      // batches of kB rows: Q's kQRows / kB, then each kv tile's K and V
      const int qb = kQRows / kB, kvb = kBlockN / kB;
      const int n_batches = qb + n_tiles * 2 * kvb;
      struct Batch {
        uintptr_t p0;      // the batch's first row
        int64_t stride;    // bytes between rows
        int rows;          // rows before L
        int tile_rows, tile_row0, tile;
        uint8_t* dst;
      };
      auto batch = [&](int i) {
        if (i < qb) {
          const int r0 = q0 + i * kB;
          return Batch{reinterpret_cast<uintptr_t>(
                           static_cast<const E*>(src.q) +
                           (((int64_t)b * Lq + r0) * H + h) * d),
                       (int64_t)H * d * 2, Lq - r0, kQRows, i * kB, -1, tiles};
        }
        const int j = i - qb, tt = j / (2 * kvb), part = j % kvb;
        const bool is_v = (j / kvb) % 2;
        const int r0 = k_begin + tt * kBlockN + part * kB;
        return Batch{reinterpret_cast<uintptr_t>(
                         static_cast<const E*>(is_v ? src.v : src.k) +
                         (((int64_t)b * Lk + r0) * KVH + kvh) * d),
                     (int64_t)KVH * d * 2, Lk - r0, kBlockN, part * kB, tt,
                     tiles + (is_v ? Lay::kV : Lay::kK) +
                         (tt % kNS) * Lay::kTileBytes};
      };
      struct Words {
        uint4 w0[kPer], w1[kPer];
        uint32_t off[kPer];
      };
      // the aligned words c and c + 1 of each of my rows of batch i, into
      // registers (rows past L repeat the batch's last row; word c + 1 past
      // the row's last word repeats word c: what lies past the row is
      // masked in the shift, and no load leaves the row's span)
      auto load = [&](int i, Words& x) {
        const Batch B = batch(i);
        if (B.rows <= 0) return;
        const uintptr_t p_first = B.p0 + r_first * B.stride;
        const int64_t step = (int64_t)kStep * B.stride;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const uintptr_t p =
              r_first + kStep * k < B.rows ? p_first + k * step
                                           : B.p0 + (B.rows - 1) * B.stride;
          const uintptr_t a = (p & ~(uintptr_t)15) + 16 * c;
          const uintptr_t last = (p + 2 * d - 1) & ~(uintptr_t)15;
          const uintptr_t a0 = a < last ? a : last;
          x.w0[k] = __ldg(reinterpret_cast<const uint4*>(a0));
          x.w1[k] = __ldg(reinterpret_cast<const uint4*>(a0 < last ? a0 + 16 : a0));
          x.off[k] = (uint32_t)(p & 15);
        }
      };
      // this thread's swizzled chunk in each of its rows of a batch (rows
      // of a batch start on a multiple of 8, so r % 8 is the thread's own)
      uint32_t chunk_at[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int r = r_first + kStep * k;
        chunk_at[k] = r * kAtomBytes + (((c % 8) ^ (r % 8)) << 4);
      }
      // batch i's chunks shifted into the swizzled tile, once the stage is
      // free; after Q's or a kv tile's last batch, this thread's stores are
      // made visible to wgmma's async proxy and its warp arrives
      auto store = [&](int i, const Words& x) {
        const Batch B = batch(i);
        const int j = i - qb;
        if (i >= qb && j % (2 * kvb) == 0 && B.tile >= kNS)
          mbar_wait(bar_empty(B.tile % kNS), (B.tile / kNS - 1) & 1);
        uint8_t* const dst = B.dst + (c / 8) * B.tile_rows * kAtomBytes +
                             B.tile_row0 * kAtomBytes;
        if (in_atoms) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (live && r_first + kStep * k < B.rows)
              v = flash_load::shift_chunk(x.w0[k], x.w1[k], x.off[k], d - 8 * c);
            *reinterpret_cast<uint4*>(dst + chunk_at[k]) = v;
          }
        }
        const bool q_done = i == qb - 1;
        if (q_done || (i >= qb && j % (2 * kvb) == 2 * kvb - 1)) {
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(q_done ? bar_q : bar_full(B.tile % kNS));
        }
      };
      // two batches in flight: batch i + 1's loads overlap batch i's shift
      Words x0, x1;
      load(0, x0);
      for (int i = 0; i < n_batches; i += 2) {
        if (i + 1 < n_batches) load(i + 1, x1);
        store(i, x0);
        if (i + 1 < n_batches) {
          if (i + 2 < n_batches) load(i + 2, x0);
          store(i + 1, x1);
        }
      }
    } else {
      consume();
    }
  } else {
    if (tid == 0) {
      mbar_expect_tx(bar_q, atoms * kQRows * kAtomBytes);
      for (int a = 0; a < atoms; ++a)
        tma_load(sq + a * kQRows * kAtomBytes, &qmap, bar_q, a * kAtom, h, q0, b);
      for (int st = 0; st < kStages && st < n_tiles; ++st)
        load_kv(st, k_begin + st * kBlockN);
    }
    consume();
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
      qm, km, vm, Srcs{nullptr, nullptr, nullptr}, Lq, Lk, H, KVH, D, causal,
      window, scale_log2, static_cast<E*>(o));
  return cudaGetLastError();
}

// The loaded route: head dim D from 1 to W, q, k, v and o at any 2-byte
// boundary (contiguous, as the wrapper checks); refused otherwise.
template <typename E, int W>
cudaError_t launch_loaded(const void* q, const void* k, const void* v, int B,
                          int Lq, int Lk, int H, int KVH, int D, int causal,
                          int window, void* o, cudaStream_t s) {
  using Lay = Layout<W, true>;
  if (D < 1 || D > W || KVH < 1 || H % KVH || Lk < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 2)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<E, W, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));
  dim3 grid(H, (Lq + kQRows - 1) / kQRows, B);
  CUtensorMap none = {};
  flash_wgmma_kernel<E, W, true><<<grid, kThreadsLoaded, Lay::kBytes, s>>>(
      none, none, none, Srcs{q, k, v}, Lq, Lk, H, KVH, D, causal, window,
      scale_log2, static_cast<E*>(o));
  return cudaGetLastError();
}

// The float32 kind: head dim D a multiple of 4 up to W, q, k, v and o on
// 16-byte boundaries (contiguous, as the wrapper checks); refused
// otherwise.
template <int W>
cudaError_t launch_f32(const void* q, const void* k, const void* v, int B,
                       int Lq, int Lk, int H, int KVH, int D, int causal,
                       int window, void* o, cudaStream_t s) {
  using Lay = LayoutF32<W>;
  if (D < 1 || D > W || D % 4 != 0 || KVH < 1 || H % KVH || Lk < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<float, W, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::kBytes);
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(kLog2e / sqrt((double)D));
  dim3 grid(H, (Lq + kQRows - 1) / kQRows, B);
  CUtensorMap none = {};
  flash_wgmma_kernel<float, W, true><<<grid, kThreadsLoaded, Lay::kBytes, s>>>(
      none, none, none, Srcs{q, k, v}, Lq, Lk, H, KVH, D, causal, window,
      scale_log2, static_cast<float*>(o));
  return cudaGetLastError();
}

// Blocks of the float32 kind at width W an SM holds at once; -1 if the
// query failed.
template <int W>
int blocks_per_sm_f32() {
  int n = -1;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<float, W, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LayoutF32<W>::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_wgmma_kernel<float, W, true>, kThreadsLoaded,
        LayoutF32<W>::kBytes);
  return err == cudaSuccess ? n : -1;
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
