// Hopper (sm_90a) kernels for the gain hot spot of Algorithm 1 (paper eq. 13,
// eq. 15, eq. 9 and eq. 6), bound to Python through a plain C interface and
// ctypes (repro_torch/kernels/gain.py).  Each one replaces a Pallas TPU
// kernel of src/repro/kernels/gain.py:
//
//   matvec_gain_kernel   <- gain_matvec (_matvec_kernel) + practical_gain.
//       proj_t = phi_t . g and eq. 15, -eps ||g||^2 + eps^2 sum_t proj_t^2 / T,
//       for every agent of every run in one launch (the leading batch axis
//       replaces the per-agent vmap of gain_dispatch.mode_gains), each
//       agent's T rows cut into tiles spread over the card (below).
//   family_stats_kernel  <- gain_family_stats (_family_kernel), and
//       megastep_call's first half.  Per agent [||g||^2, sum_t proj_t^2,
//       g.gradJ, g^T Phi g], or the 2-column prefix, which never reads Phi
//       or grad J.
//   gate_update_kernel   <- megastep_call (_megastep_kernel), second half.
//       Per run: mode-selected gains, the eq. 9 gate with the random /
//       always / never baselines, the optional channel keep mask, and
//       w - eps * sum_i(alpha_i keep_i g_i) / max(sum_i alpha_i keep_i, 1).
//
// What bounds them on an H100.  Each kernel streams phi once: at the main
// path's shape (192 runs x 64 agents x T=128 x n=256, float32) that is
// 1.61 GB per step against ~2.4 GFLOP, so device memory (3.35 TB/s) bounds
// them by two orders of magnitude over the float32 rate.  phi is read
// exactly once, coalesced.  The one other large operand is a run's n x n
// Phi (256 KB at n = 256) in the quadratic form g^T Phi g.  Read once per
// agent it costs 3.2 GB of L2 traffic per launch, and a kernel laid out
// that way ran at half the speed of the plain torch version on an H100
// SXM, whose matmul reads Phi once per run.  So family_stats_kernel reads
// each piece of Phi once for up to kQuadAgents = 4 agents of one run.
//
// The TPU kernels lean on the grid running in order: the n-tile axis
// accumulates into VMEM scratch, the family kernel's T axis adds each
// tile's sum into its output block, and megastep carries the gated sum
// across agent blocks.  A CUDA grid has no order.  gate_update_kernel keeps
// a sequential axis as a loop inside one block; matvec_gain_kernel and
// family_stats_kernel spread an agent's T-tiles over blocks and combine
// their results in a fixed order (below).  megastep is two launches
// from one C entry: family_stats_kernel writes the statistics, then
// gate_update_kernel runs one block per run.  Two launches were chosen
// over one block per run because the statistics pass is the part that
// moves phi: a block per run would stream 8 MB per block through 192
// blocks on 132 SMs (a 1.45-wave tail, one block per SM), while the
// family kernel's units fill the card; the statistics round trip through
// device memory is 4 floats per agent.
//
// matvec_gain_kernel's layout.  A unit of work is (agent, T-tile of bt
// rows), bt a run-time parameter (kernels/gain.py: block_t, the Pallas
// kernel's name); an agent's units are consecutive blocks.  One block per
// agent put the kernel suite's one agent (T 4096 x n 2048, 33.5 MB) on one
// SM of 132; the wrapper's default bt gives a tile about MATVEC_TILE_BYTES
// of phi, so long-T agents spread over the card while every sweep (T <=
// 128) keeps one tile an agent, whose unit writes its gain directly with
// no scratch and no counter.  Over several tiles the last unit of an agent
// redoes the one-tile sum from the agent's projections (below), so no bit
// depends on bt, nor on how a tile's rows meet its warps: rows wider than
// one vec_rows chunk (the kernel suite's n 2048) take vec_tile_rows there,
// two rows a warp step with a chunk of eight 16-byte vectors a lane, all
// its loads issued before its sums (one block an agent ran such rows at
// 2.1 ms against torch.matmul's 0.024 on the H100).  The fold is the one
// serial part: eight fmaf chains of T / 8 rows, staged through shared
// memory, beside ||g||^2 on another warp.
//
// The row passes.  The generic pass (scalar_rows, for ragged shapes) makes
// 4-byte loads with kRowsInFlight rows of a warp in flight, each lane
// loading g[j] once for all of them, and sq_norm reads g a second time.
// The vector pass (vec_rows; the family kernel's vec_step below) takes
// n % (16 / sizeof(T)) == 0 and 16-byte-aligned phi and g; the wrappers'
// Python predicate (kernels/gain.py::matvec_vector_pass) picks the pass
// and the launchers refuse the vector pass where its loads would not be
// whole and aligned.
// A lane loads its slice of g's first chunk once into registers (kHeldVecs
// = 2 16-byte vectors: 256 columns float32, 512 bf16 a warp; at n = 256
// float32 that is 8 floats a lane) and then streams kRowsInFlight = 8
// consecutive rows per warp with every 16-byte load of the group issued
// before the group's sums (64 KB of phi in flight per 256-thread block at
// n = 256), then one fixed xor butterfly per row; lanes 0-7 store the
// group's eight projections together (32 contiguous bytes).  phi's loads
// skip L1 and ask L2 for 256-byte prefetches: it is read once (g, reused
// by every row, stays cached).  Timed on the H100 at the main path's
// shape, this beat 4 rows in flight, cached phi loads, an L2 prefetch that
// still fills L1, a persistent grid, 128 or 512 threads, and per-warp row
// tiles with one store each.  Columns past the held ones go in chunks of
// the same width, g's vectors of a chunk read again with each group (from
// L1) and every row's loads of the chunk issued together, so a group keeps
// kRowsInFlight x kHeldVecs loads in flight however wide the row.  One
// instantiation per dtype.
//
// family_stats_kernel's passes go in steps of a warp.  Its vector step
// (vec_step) is the vector pass's loads and order with the columns in
// blocks of kHeldVecs vectors a lane: g's vectors for the block, then every
// row's, so kFamilyRows x kHeldVecs 16-byte loads stay in flight however
// wide the row, as in vec_rows.  Its lane-group step (group_step) is for rows
// the vector pass does not take: a row gets L = 8, 16 or 32 lanes (the
// least that covers n, up to 32), so a warp takes 32 / L rows side by
// side (at Fig. 3's n = 6 and TD's n = 10 four and two rows instead of one
// with 6 or 10 of 32 lanes busy), kGroupRowsInFlight such rows a lane,
// each lane loading g[j] once per column for all of them.
//
// family_stats_kernel's layout.  A unit of work is (run, block of bm
// agents, T-tile of bt rows): bm and bt are run-time parameters
// (kernels/gain.py: block_m / megastep_block_m and family_block_t, the
// Pallas kernel's names).  The units of one agent block are consecutive
// blocks of the grid, so they run together and share the run's Phi in L2.
// A unit's steps over its agents' tile rows are spread over its warps with
// the agents rotated (item (a, s) to warp (s + a) % 8), so at T = 8 (TD)
// four agents run on four warps at once; each warp keeps a sum per agent
// in shared memory, and a thread an agent adds them in a fixed order.
// The quadratic form is cut by rows of Phi into chunks of kQuadRows = 64
// rows (g^T Phi g = sum_c sum_{i in c} g_i (Phi_i . g)); chunk c goes to
// T-tile c mod tiles, so at n = 512 and T = 1024 each unit of an agent
// block reads at most one eighth of Phi.  Inside a chunk thread j owns
// columns j and j + 256: it walks the chunk's rows in order, 8 rows of
// both in flight, one coalesced load of Phi_ij per row used for every
// agent of a group of kQuadAgents (their g_i in shared memory).  A warp
// beside the agent's first step sums ||g||^2 and g . grad J on tile 0.
// The last unit of an agent block to finish folds the partials, a thread
// an agent: an integer arrival counter per agent block (atomicAdd after a
// __threadfence).  The counters sit at the end of the call's scratch, which
// the wrapper takes from torch's allocator, and the launcher zeroes them
// with cudaMemsetAsync on the launch's stream before each launch: no state
// outlives a call, and a CUDA graph replays the memset with the kernel.
// With one tile the unit writes its sums straight out and takes no
// scratch.
//
// Registers set the layout's speed at the main path's shape, where 3,072
// or more units queue for the SMs: the vector variant takes 128 registers
// (kVecBlocks = 2 blocks an SM) and runs 8 rows in flight; 64 registers
// with 4 rows (4 blocks an SM) or 85 with 8 (3) were slower there, and a
// row-wise quadratic form (Phi's rows streamed like phi's, 16-byte loads)
// was no faster than the column walk.  bm = 4 and bt = 64 by default: at
// wide-192 two tiles an agent split the quadratic form over two units
// (0.676 ms against 0.721 at bt = 128, on a par with the one-block-per-
// agent-group layout before it), and
// 8 or 16 agents a unit were slower at the kernel suite's shape
// (tools/gain_family_timing.py; PERF.md).
//
// Determinism: no float atomics.  Each lane sums its strided elements in
// index order with fmaf, warps (or lane groups) reduce by a fixed xor
// butterfly (every lane ends with the same value), lane groups and then
// warps combine in their order, and family_stats_kernel folds an agent's
// tile partials in tile order and its quadratic-form chunks in chunk
// order with __fadd_rn, whichever unit folds them.  The order depends on
// T, n, bt, dtype and the pass only, never on R, m, bm or the count of
// SMs: an agent's statistics are the same bits launched alone or in any
// batch, and under any block_m.  matvec_gain_kernel's bits depend on T, n,
// dtype and the pass only, not on its bt either: its fold redoes the
// one-tile order.  So two launches on the same inputs give
// bitwise-equal outputs, and every trigger decision is reproducible.  All
// arithmetic is float32 on CUDA cores (no tensor cores, so no TF32); bf16
// and float16 inputs are widened on load (each kernel is instantiated for
// float32, bf16 and float16; phi and g of different dtypes reach the
// float32 kernels cast, exactly, by the wrapper).
// The gain formulas use __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc
// cannot contract them into FMAs: they round like the plain torch version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQuadAgents = 4;  // agents that share one read of Phi
constexpr int kQuadRows = 64;   // rows of Phi in a quadratic-form chunk
// family_stats_kernel's blocks an SM, for nvcc's register budget: the
// vector pass and the lane-group pass
constexpr int kVecBlocks = 2;
constexpr int kGroupBlocks = 4;
constexpr int kFamilyRows = 8;          // vector pass: rows a warp streams
constexpr int kGroupRowsInFlight = 8;   // lane-group pass: steps in flight
constexpr int kPassAgents = 32;         // agents a unit passes over at once
constexpr int kGateAgents = 4096;       // agents gate_update_kernel holds at once

// Mode ids of repro_torch.kernels.ref.MODES (pinned by a test).
constexpr float kModeTheoretical = 0.f;
constexpr float kModeNorm = 2.f;
constexpr float kModeRandom = 3.f;
constexpr float kModeAlways = 4.f;
constexpr float kModeNever = 5.f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Fixed xor butterfly: every lane ends with the same, order-fixed sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum of one value per warp (lane-uniform within each warp), combined in
// warp order by thread 0 and returned to every thread.
__device__ float block_sum_of_warps(float warp_val, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = warp_val;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
    for (int i = 1; i < kWarps; ++i) s = __fadd_rn(s, red[i]);
    red[kWarps] = s;
  }
  __syncthreads();
  return red[kWarps];
}

// Sum of one value per thread, in a fixed order.
__device__ float block_sum(float v, float* red) {
  return block_sum_of_warps(warp_sum(v), red);
}

template <typename T>
__device__ float sq_norm(const T* __restrict__ g, int n, float* red) {
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float v = to_f32(g[j]);
    s = fmaf(v, v, s);
  }
  return block_sum(s, red);
}

// 16 bytes at p (16-byte aligned).  g goes through L1 (every row reuses
// it); phi is read once, so it streams past L1 with a 256-byte L2 prefetch.
__device__ __forceinline__ uint4 load_cached(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 16 bytes of T widened to float.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void widen(uint4 v, float (&x)[4]) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
  }
};
// The 16-bit widenings read the vector's 32-bit words by value (no
// address of a register taken, so nothing goes through local memory); the
// element at the lower address is a word's low half.  Both are exact.
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void widen(uint4 v, float (&x)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec16<__half> {
  static constexpr int kN = 8;
  __device__ static void widen(uint4 v, float (&x)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __half2float(__ushort_as_half((unsigned short)(w[i] & 0xffffu)));
      x[2 * i + 1] = __half2float(__ushort_as_half((unsigned short)(w[i] >> 16)));
    }
  }
};

constexpr int kRowsInFlight = 8;   // rows a warp streams at once
constexpr int kHeldVecs = 2;       // 16-byte vectors of g a lane holds
// the tiled vector pass on rows wider than kHeldVecs vectors a lane: rows
// a warp step, 16-byte vectors a lane a chunk
constexpr int kTileRows = 2;
constexpr int kTileVecs = 8;
constexpr int kFoldRows = 4096;    // projections a fold stages at a time

// ---------------------------------------------------------------------------
// gain_matvec / practical_gain: one block per unit (agent, T-tile of bt
// rows), an agent's units consecutive blocks of the grid.  A unit's rows go
// in steps of kRowsInFlight rows (vector pass: consecutive rows; generic
// pass: rows kWarps apart), step s to warp s % kWarps; a row's dot product
// stays whole in one warp.  Each unit writes its rows' projections (to proj,
// or, for a gain alone over several tiles, to the call's scratch).
//
// The gain's bits do not depend on the tiling.  With one tile (every
// sweep) the unit is the whole agent: warp w's rows are those of class w of
// the one-block-per-agent pass (vector: the steps t / kRowsInFlight = w mod
// kWarps; generic: t = w mod kWarps), so its fmaf chain of squared
// projections, the warps' sum in warp order and ||g||^2 are computed in
// place and the unit writes the gain.  With several tiles the last unit of
// an agent to finish (an arrival counter after a __threadfence, as in
// family_stats_kernel) reads the agent's T projections back and redoes
// the same chains: one thread a class, rows in order, then the classes in
// warp order.  Either way proj_t, sum_t proj_t^2, ||g||^2 and the gain are
// the bits of the one-block-per-agent pass at any bt, alone or in any
// batch.
// ---------------------------------------------------------------------------

// ||g||^2 in the vector pass's order: lane l's columns (l + 32 c) V ..
// + V - 1 ascending, then the warp's butterfly (every lane gets it).
template <typename T>
__device__ float vec_sq_norm(const T* __restrict__ g, int n) {
  constexpr int V = Vec16<T>::kN;
  const int lane = threadIdx.x & 31;
  float g2 = 0.f;
#pragma unroll 8
  for (int col = lane * V; col < n; col += 32 * V) {
    float x[V];
    Vec16<T>::widen(load_cached(g + col), x);
#pragma unroll
    for (int i = 0; i < V; ++i) g2 = fmaf(x[i], x[i], g2);
  }
  return warp_sum(g2);
}

// The vector pass over a unit's rows: step t0 .. t0 + kRowsInFlight - 1
// goes to warp (t0 / kRowsInFlight) % kWarps.  Columns go in chunks of
// kHeld = 32 V kHeldVecs: lane l's vectors l + 32 c of the first chunk of g
// stay in registers for every step; a later chunk's are loaded again with
// each step (from L1).  Inside a chunk every row's loads of the step are
// issued together, so kRowsInFlight kHeldVecs 16-byte loads stay in flight
// however wide the row.  A row's sum runs over the lane's columns in
// ascending order, then one butterfly; lanes 0..7 store a step's
// projections (32 contiguous bytes).  Returns the warp's fmaf chain of
// squared projections in row order.
template <typename T>
__device__ float vec_rows(const T* __restrict__ phi, const T* __restrict__ g,
                          int rows, int n, float* __restrict__ proj) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kHeld = 32 * V * kHeldVecs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gr[kHeldVecs][V];
#pragma unroll
  for (int c = 0; c < kHeldVecs; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < n) {
      Vec16<T>::widen(load_cached(g + col), gr[c]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) gr[c][i] = 0.f;
    }
  }
  float sq = 0.f;
  for (int t0 = warp * kRowsInFlight; t0 < rows;
       t0 += kWarps * kRowsInFlight) {
    float acc[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      // a row past the end repeats the last row; its sum is dropped below
      const T* row = phi + (size_t)min(t0 + r, rows - 1) * n;
      acc[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kHeldVecs; ++c) {
        const int col = (lane + 32 * c) * V;
        if (col < n) {
          float x[V];
          Vec16<T>::widen(load_stream(row + col), x);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[r] = fmaf(x[i], gr[c][i], acc[r]);
        }
      }
    }
    for (int c0 = kHeld; c0 < n; c0 += kHeld) {
      float gc[kHeldVecs][V];
#pragma unroll
      for (int c = 0; c < kHeldVecs; ++c) {
        const int col = c0 + (lane + 32 * c) * V;
        if (col < n) {
          Vec16<T>::widen(load_cached(g + col), gc[c]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) gc[c][i] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        const T* row = phi + (size_t)min(t0 + r, rows - 1) * n;
#pragma unroll
        for (int c = 0; c < kHeldVecs; ++c) {
          const int col = c0 + (lane + 32 * c) * V;
          if (col < n) {
            float x[V];
            Vec16<T>::widen(load_stream(row + col), x);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[r] = fmaf(x[i], gc[c][i], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) acc[r] = warp_sum(acc[r]);
    float mine = acc[0];
#pragma unroll
    for (int r = 1; r < kRowsInFlight; ++r)
      if (lane == r) mine = acc[r];
    if (proj != nullptr && lane < kRowsInFlight && t0 + lane < rows)
      proj[t0 + lane] = mine;
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r)
      if (t0 + r < rows) sq = fmaf(acc[r], acc[r], sq);
  }
  return sq;
}

// The vector pass over a tile of rows wider than one chunk of vec_rows
// (n > 32 V kHeldVecs), for units of several tiles, whose order does not
// depend on how a unit's rows meet its warps (the fold redoes the one-tile
// sum): steps of kTileRows consecutive rows, step s to warp s % kWarps,
// columns in chunks of 32 V kTileVecs, a chunk's loads of g and of every
// row issued before its sums, so twice vec_rows' steps a tile run at once
// with as many loads in flight each.  A row's sum runs over the lane's
// columns in ascending order, as in vec_rows, then one butterfly.
template <typename T>
__device__ void vec_tile_rows(const T* __restrict__ phi,
                              const T* __restrict__ g, int rows, int n,
                              float* __restrict__ proj) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kChunk = 32 * V * kTileVecs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int t0 = warp * kTileRows; t0 < rows; t0 += kWarps * kTileRows) {
    float acc[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
    for (int c0 = 0; c0 < n; c0 += kChunk) {
      uint4 gv[kTileVecs], xv[kTileRows][kTileVecs];
#pragma unroll
      for (int c = 0; c < kTileVecs; ++c) {
        const int col = c0 + (lane + 32 * c) * V;
        gv[c] = col < n ? load_cached(g + col) : zero;
      }
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        // a row past the end repeats the last row; its sum is not stored
        const T* row = phi + (size_t)min(t0 + r, rows - 1) * n;
#pragma unroll
        for (int c = 0; c < kTileVecs; ++c) {
          const int col = c0 + (lane + 32 * c) * V;
          xv[r][c] = col < n ? load_stream(row + col) : zero;
        }
      }
#pragma unroll
      for (int c = 0; c < kTileVecs; ++c) {
        if (c0 + (lane + 32 * c) * V < n) {
          float y[V];
          Vec16<T>::widen(gv[c], y);
#pragma unroll
          for (int r = 0; r < kTileRows; ++r) {
            float x[V];
            Vec16<T>::widen(xv[r][c], x);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[r] = fmaf(x[i], y[i], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) acc[r] = warp_sum(acc[r]);
    float mine = acc[0];
#pragma unroll
    for (int r = 1; r < kTileRows; ++r)
      if (lane == r) mine = acc[r];
    if (proj != nullptr && lane < kTileRows && t0 + lane < rows)
      proj[t0 + lane] = mine;
  }
}

// The generic pass (any n, any alignment) over a unit's rows: warp w takes
// rows w, w + kWarps, ..., kRowsInFlight of them at a time, each lane
// loading g[j] once for all of them.  A row's sum runs over j = lane,
// lane + 32, ... in order, then one butterfly.  Returns the warp's fmaf
// chain of squared projections in row order.
template <typename T>
__device__ float scalar_rows(const T* __restrict__ phi,
                             const T* __restrict__ g, int rows, int n,
                             float* __restrict__ proj) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sq = 0.f;
  for (int s0 = warp; s0 < rows; s0 += kWarps * kRowsInFlight) {
    float acc[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) acc[r] = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float gj = to_f32(g[j]);
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
        // a row past the end repeats the last row; its sum is dropped below
        const int t = min(s0 + kWarps * r, rows - 1);
        acc[r] = fmaf(to_f32(phi[(size_t)t * n + j]), gj, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const float p = warp_sum(acc[r]);
      const int t = s0 + kWarps * r;
      if (t < rows) {
        if (proj != nullptr && lane == 0) proj[t] = p;
        sq = fmaf(p, p, sq);
      }
    }
  }
  return sq;
}

// The fold of an agent's several tiles, by its last unit: {sum_t proj_t^2,
// ||g||^2} in the one-tile order.  Thread w < kWarps chains class w's rows
// in order (steps of S rows, step s of class s % kWarps), then thread 0
// adds the classes in warp order.  The projections are staged kFoldRows
// at a time (stage: dynamic shared memory), a multiple of the classes'
// period, so every stage starts at class 0.  ||g||^2 is the vector pass's
// (warp 1, beside the chains of warp 0) or the generic pass's sq_norm.
template <typename T, int S, bool kVector>
__device__ float2 fold(const float* __restrict__ src,
                       const T* __restrict__ g, int rows, int n,
                       float* stage, float* red) {
  static_assert(kFoldRows % (kWarps * S) == 0, "a stage starts a period");
  const int warp = threadIdx.x >> 5;
  float sq = 0.f, gg = 0.f;
  for (int c0 = 0; c0 < rows; c0 += kFoldRows) {
    const int nr = min(kFoldRows, rows - c0);
    __syncthreads();   // the previous stage is consumed
#pragma unroll (kFoldRows / kThreads)
    for (int i = threadIdx.x; i < nr; i += kThreads)
      stage[i] = __ldcg(src + c0 + i);
    __syncthreads();
    if (threadIdx.x < kWarps) {
#pragma unroll (32 / S)
      for (int t0 = threadIdx.x * S; t0 < nr; t0 += kWarps * S) {
#pragma unroll
        for (int r = 0; r < S; ++r)
          if (t0 + r < nr) sq = fmaf(stage[t0 + r], stage[t0 + r], sq);
      }
    }
    if constexpr (kVector) {
      if (warp == 1 && c0 == 0) gg = vec_sq_norm<T>(g, n);
    }
  }
  __syncthreads();
  if (threadIdx.x < kWarps) red[threadIdx.x] = sq;
  if (kVector && threadIdx.x == 32) red[kWarps + 1] = gg;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = red[0];
    for (int i = 1; i < kWarps; ++i) s = __fadd_rn(s, red[i]);
    red[kWarps] = s;
  }
  __syncthreads();
  const float sp = red[kWarps];
  if constexpr (kVector)
    gg = red[kWarps + 1];
  else
    gg = sq_norm<T>(g, n, red);
  return make_float2(sp, gg);
}

// kPass: 0 the generic pass, 1 the vector pass (vec_rows), 2 the vector
// pass over rows wider than a vec_rows chunk in several tiles
// (vec_tile_rows).  proj and gain may each be null (not asked for).
// scratch: with several tiles and a gain, agents * rows floats of
// projections when proj is null, then one arrival counter per agent
// (zeroed by launch_matvec); with several tiles and a gain the launch
// takes kFoldRows floats of dynamic shared memory (fewer for fewer rows).
template <typename T, int kPass>
__global__ void __launch_bounds__(kThreads)
matvec_gain_kernel(const T* __restrict__ phi, const T* __restrict__ g,
                   int rows, int n, int bt, int tiles, float neg_eps,
                   float eps2, float* __restrict__ proj,
                   float* __restrict__ gain, float* __restrict__ scratch,
                   unsigned* __restrict__ tickets) {
  __shared__ float red[kWarps + 2];
  __shared__ int last;
  extern __shared__ float fold_stage[];
  const size_t b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int t0 = tile * bt, trows = max(0, min(bt, rows - t0));
  const T* gb = g + b * n;
  float* pb = proj != nullptr ? proj + b * rows
              : (gain != nullptr && tiles > 1 ? scratch + b * rows : nullptr);
  const T* tp = phi + (b * rows + t0) * n;
  float* tproj = pb == nullptr ? nullptr : pb + t0;
  float sq = 0.f;
  if constexpr (kPass == 0)
    sq = scalar_rows<T>(tp, gb, trows, n, tproj);
  else if constexpr (kPass == 1)
    sq = vec_rows<T>(tp, gb, trows, n, tproj);
  else
    vec_tile_rows<T>(tp, gb, trows, n, tproj);
  if (gain == nullptr) return;
  float2 r;
  if (tiles == 1) {
    r.x = block_sum_of_warps(sq, red);
    if constexpr (kPass == 0)
      r.y = sq_norm<T>(gb, n, red);
    else
      r.y = vec_sq_norm<T>(gb, n);
  } else {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(tickets + b, 1u) == (unsigned)(tiles - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    r = fold<T, kPass == 0 ? 1 : kRowsInFlight, kPass != 0>(pb, gb, rows, n,
                                                           fold_stage, red);
  }
  if (threadIdx.x == 0)
    gain[b] = __fadd_rn(__fmul_rn(neg_eps, r.y),
                        __fdiv_rn(__fmul_rn(eps2, r.x), (float)rows));
}

// The tiling comes from the wrapper (kernels/gain.py::matvec_geometry) and
// is refused unless tiles = ceil(rows / bt) (1 for rows = 0).  The vector
// pass needs whole 16-byte vectors in every row (n % V == 0) and
// 16-byte-aligned phi and g; it is refused otherwise.
template <typename T>
cudaError_t launch_matvec(const void* phi, const void* g, int agents,
                          int rows, int n, int vector, int bt, int tiles,
                          float neg_eps, float eps2, void* proj, void* gain,
                          void* scratch, cudaStream_t s) {
  if (bt < 1 || tiles != (rows > 0 ? (rows + bt - 1) / bt : 1))
    return cudaErrorInvalidValue;
  if (vector && (n % Vec16<T>::kN != 0 ||
                 reinterpret_cast<uintptr_t>(phi) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(g) % 16 != 0))
    return cudaErrorInvalidValue;
  const long long units = (long long)agents * tiles;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  unsigned* tickets = nullptr;
  if (gain != nullptr && tiles > 1) {
    if (sc == nullptr) return cudaErrorInvalidValue;
    tickets = reinterpret_cast<unsigned*>(
        proj != nullptr ? sc : sc + (size_t)agents * rows);
    const cudaError_t err =
        cudaMemsetAsync(tickets, 0, (size_t)agents * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
  }
  const size_t smem =
      tickets == nullptr ? 0
                         : (size_t)(rows < kFoldRows ? rows : kFoldRows) * 4;
#define MATVEC_KERNEL_ARGS                                                  \
  static_cast<const T*>(phi), static_cast<const T*>(g), rows, n, bt, tiles, \
      neg_eps, eps2, static_cast<float*>(proj), static_cast<float*>(gain),  \
      sc, tickets
  if (!vector)
    matvec_gain_kernel<T, 0><<<(unsigned)units, kThreads, smem, s>>>(
        MATVEC_KERNEL_ARGS);
  else if (tiles > 1 && n > 32 * Vec16<T>::kN * kHeldVecs)
    matvec_gain_kernel<T, 2><<<(unsigned)units, kThreads, smem, s>>>(
        MATVEC_KERNEL_ARGS);
  else
    matvec_gain_kernel<T, 1><<<(unsigned)units, kThreads, smem, s>>>(
        MATVEC_KERNEL_ARGS);
#undef MATVEC_KERNEL_ARGS
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gain_family_stats (and megastep's first half): one block per unit (run,
// agent block, T-tile), the units of an agent block consecutive.  grad_j
// and Phi are read at the run's offset (stride 0 when every run shares
// them).  part holds, per agent, its tiles' partial sums of squared
// projections, its quadratic-form chunks, ||g||^2 and g . grad J (width
// tiles + chunks + 2); tickets, past the agents' rows of part, holds one
// arrival counter per agent block, zeroed by launch_family.
// ---------------------------------------------------------------------------

// K block sums at once, each in block_sum's order (red: K * (kWarps + 1)).
template <int K>
__device__ void block_sums(float (&v)[K], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * (kWarps + 1) + warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float* r = red + threadIdx.x * (kWarps + 1);
    float s = r[0];
    for (int i = 1; i < kWarps; ++i) s = __fadd_rn(s, r[i]);
    r[kWarps] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[k * (kWarps + 1) + kWarps];
}

// The family kernel's row passes take a tile's rows in steps of a warp: a
// step adds its rows' squared projections to sq in row order.
//
// Vector step: rows t0 .. t0 + kFamilyRows - 1.  Columns go in chunks of
// 32 V kHeldVecs (256 float32, 512 bf16): lane l loads g's vectors
// l + 32 c of the chunk into registers, then every row's vectors of the
// chunk, so a chunk keeps kFamilyRows kHeldVecs 16-byte loads in flight
// however wide the row.  A row's sum runs over the columns in
// projection_sq_vec's order, then one butterfly.
template <typename T>
__device__ __forceinline__ float vec_step(const T* __restrict__ phi,
                                          const T* __restrict__ g, int rows,
                                          int n, int t0, float sq) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kChunk = 32 * V * kHeldVecs;
  const int lane = threadIdx.x & 31;
  float acc[kFamilyRows];
#pragma unroll
  for (int r = 0; r < kFamilyRows; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    float gr[kHeldVecs][V];
#pragma unroll
    for (int c = 0; c < kHeldVecs; ++c) {
      const int col = c0 + (lane + 32 * c) * V;
      if (col < n) {
        Vec16<T>::widen(load_cached(g + col), gr[c]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) gr[c][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kFamilyRows; ++r) {
      // a row past the end repeats the last row; its sum is dropped below
      const T* row = phi + (size_t)min(t0 + r, rows - 1) * n;
#pragma unroll
      for (int c = 0; c < kHeldVecs; ++c) {
        const int col = c0 + (lane + 32 * c) * V;
        if (col < n) {
          float x[V];
          Vec16<T>::widen(load_stream(row + col), x);
#pragma unroll
          for (int i = 0; i < V; ++i) acc[r] = fmaf(x[i], gr[c][i], acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kFamilyRows; ++r) {
    const float p = warp_sum(acc[r]);
    if (t0 + r < rows) sq = fmaf(p, p, sq);
  }
  return sq;
}

// Xor butterfly over aligned groups of L lanes: every lane of a group ends
// with the group's sum, in a fixed order.
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Lane-group step: a row takes L lanes, so a warp takes G = 32 / L
// neighbouring rows side by side, rows t0 + r G + group for r <
// kRowsInFlight, each lane loading g[j] once per column for all of them.
// A row's sum runs over a lane's columns in index order, then the group's
// butterfly; sq stays per group (group_rows combines the groups).
template <typename T, int L>
__device__ __forceinline__ float group_step(const T* __restrict__ phi,
                                            const T* __restrict__ g,
                                            int rows, int n, int t0,
                                            float sq) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int grp = lane / L, sub = lane % L;
  float acc[kGroupRowsInFlight];
#pragma unroll
  for (int r = 0; r < kGroupRowsInFlight; ++r) acc[r] = 0.f;
  for (int j = sub; j < n; j += L) {
    const float gj = to_f32(g[j]);
#pragma unroll
    for (int r = 0; r < kGroupRowsInFlight; ++r) {
      // a row past the end repeats the last row; its sum is dropped below
      const int t = min(t0 + r * G + grp, rows - 1);
      acc[r] = fmaf(to_f32(phi[(size_t)t * n + j]), gj, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kGroupRowsInFlight; ++r) {
    const float p = group_sum<L>(acc[r]);
    if (t0 + r * G + grp < rows) sq = fmaf(p, p, sq);
  }
  return sq;
}

// A warp's lane groups in group order (each group's sq is uniform in it).
template <int L>
__device__ __forceinline__ float group_rows(float sq) {
  float s = __shfl_sync(0xffffffffu, sq, 0);
#pragma unroll
  for (int k = 1; k < 32 / L; ++k)
    s = __fadd_rn(s, __shfl_sync(0xffffffffu, sq, k * L));
  return s;
}

// One quadratic-form chunk, Phi's rows [i0, i1), for the kQuadAgents
// agents at ga (a ragged group repeats its last agent): q[a] = sum_j
// g_a[j] sum_{i0 <= i < i1} g_a[i] Phi_ij, returned to every thread.
// Thread j walks column j's rows in order, with column j + kThreads beside
// it (8 rows of both in flight); each load of Phi_ij serves every agent.
// A thread's columns enter q in index order, then block_sum's order.
template <typename T>
__device__ void quad_chunk(const float* __restrict__ mat,
                           const T* (&ga)[kQuadAgents], int i0, int i1,
                           int n, float (&gs)[kQuadAgents][kQuadRows],
                           float* red, float (&q)[kQuadAgents]) {
  static_assert(kQuadAgents * kQuadRows <= kThreads, "one gs load a thread");
  __syncthreads();  // gs may still be read by the previous chunk
  if (threadIdx.x < kQuadAgents * kQuadRows) {
    const int i = threadIdx.x % kQuadRows;
    const T* gp = ga[0];
#pragma unroll
    for (int a = 1; a < kQuadAgents; ++a)
      if (threadIdx.x / kQuadRows == a) gp = ga[a];
    gs[threadIdx.x / kQuadRows][i] = i0 + i < i1 ? to_f32(gp[i0 + i]) : 0.f;
  }
  __syncthreads();
  const int rows = i1 - i0;
#pragma unroll
  for (int a = 0; a < kQuadAgents; ++a) q[a] = 0.f;
  for (int j = threadIdx.x; j < n; j += 2 * kThreads) {
    const int j2 = j + kThreads;
    const bool two = j2 < n;
    float acc[2][kQuadAgents];
#pragma unroll
    for (int a = 0; a < kQuadAgents; ++a) acc[0][a] = acc[1][a] = 0.f;
    const float* col = mat + (size_t)i0 * n + j;
#pragma unroll 8
    for (int ii = 0; ii < rows; ++ii) {
      const float p = col[(size_t)ii * n];
      const float p2 = two ? col[(size_t)ii * n + kThreads] : 0.f;
#pragma unroll
      for (int a = 0; a < kQuadAgents; ++a) {
        acc[0][a] = fmaf(gs[a][ii], p, acc[0][a]);
        acc[1][a] = fmaf(gs[a][ii], p2, acc[1][a]);
      }
    }
#pragma unroll
    for (int a = 0; a < kQuadAgents; ++a) {
      q[a] = fmaf(to_f32(ga[a][j]), acc[0][a], q[a]);
      if (two) q[a] = fmaf(to_f32(ga[a][j2]), acc[1][a], q[a]);
    }
  }
  block_sums(q, red);
}

// kPass: 0 for the vector pass, else the lane-group pass's L.
//
// A unit takes its agents kPassAgents at a time.  The tile's steps of
// those agents are items (a, s) spread over the warps, item (a, s) to warp
// (s + a) % kWarps, each warp taking its items in order with no barrier
// between agents: with one step an agent (T <= 32 rows on the vector
// pass) eight agents run on eight warps at once.  Warp w then holds, for
// agent a, the steps s = w - a (mod kWarps), and a thread an agent adds
// those classes in class order, s = 0, 1, ... (mod kWarps): the same
// order for an agent at any place in its block.  On tile 0, warp (a +
// kWarps / 2) % kWarps also sums ||g_a||^2 and g_a . grad J (lane-strided,
// one butterfly), beside the warp that takes the agent's first step.  The tile's chunks of the quadratic form follow,
// kQuadAgents agents at a time.  part's row for an agent: [tile partials |
// chunk partials | ||g||^2, g.gradJ].
template <typename T, int kPass>
__global__ void __launch_bounds__(kThreads, kPass == 0 ? kVecBlocks
                                                       : kGroupBlocks)
family_stats_kernel(const T* __restrict__ phi, const T* __restrict__ g,
                    const float* __restrict__ grad_j, long long gj_stride,
                    const float* __restrict__ pm, long long pm_stride,
                    int m, int rows, int n, int cols, int bm, int bt,
                    int tiles, int chunks, float* __restrict__ part,
                    unsigned* __restrict__ tickets,
                    float* __restrict__ out) {
  constexpr int kSpan = kPass == 0 ? kFamilyRows
                                   : (32 / (kPass == 0 ? 32 : kPass)) *
                                         kGroupRowsInFlight;   // rows a step
  __shared__ float red[kQuadAgents * (kWarps + 1)];
  __shared__ float wsum[kPassAgents][kWarps + 1];   // +1: no bank conflicts
  __shared__ float wstat[kPassAgents][2];
  __shared__ float gs[kQuadAgents][kQuadRows];
  __shared__ int last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (m + bm - 1) / bm;
  const size_t unit = blockIdx.x / tiles;   // (run, agent block)
  const int tile = blockIdx.x % tiles;
  const size_t run = unit / groups;
  const int a0 = (unit % groups) * bm;
  const int na = min(bm, m - a0);
  const size_t b0 = run * m + a0;
  const int width = tiles + chunks + 2;
  const int t0 = tile * bt, trows = max(0, min(bt, rows - t0));
  const int steps = (trows + kSpan - 1) / kSpan;
  const float* gj = grad_j + run * gj_stride;
  const float* mat = pm + run * pm_stride;

  for (int p0 = 0; p0 < na; p0 += kPassAgents) {
    const int np = min(kPassAgents, na - p0);
    for (int a = 0; a < np; ++a) {
      const size_t b = b0 + p0 + a;
      const T* gb = g + b * n;
      const T* tp = phi + (b * rows + t0) * n;
      float sq = 0.f;
      for (int s = (warp - a % kWarps + kWarps) % kWarps; s < steps;
           s += kWarps) {
        if constexpr (kPass == 0)
          sq = vec_step<T>(tp, gb, trows, n, s * kSpan, sq);
        else
          sq = group_step<T, kPass>(tp, gb, trows, n, s * kSpan, sq);
      }
      if constexpr (kPass != 0) sq = group_rows<kPass>(sq);
      if (lane == 0) wsum[a][warp] = sq;
      if (tile == 0 && warp == (a + kWarps / 2) % kWarps) {
        float x2 = 0.f, xj = 0.f;
        for (int j = lane; j < n; j += 32) {
          const float x = to_f32(gb[j]);
          x2 = fmaf(x, x, x2);
          if (cols == 4) xj = fmaf(x, gj[j], xj);
        }
        x2 = warp_sum(x2);
        xj = warp_sum(xj);
        if (lane == 0) {
          wstat[a][0] = x2;
          wstat[a][1] = xj;
        }
      }
    }
    __syncthreads();
    for (int a = threadIdx.x; a < np; a += kThreads) {
      const float* w = wsum[a];
      float s = w[a % kWarps];
      for (int c = 1; c < kWarps; ++c) s = __fadd_rn(s, w[(c + a) % kWarps]);
      const size_t b = b0 + p0 + a;
      // with one tile the sums are final and go straight to out
      if (tiles == 1) {
        float* o = out + b * cols;
        o[0] = wstat[a][0];
        o[1] = s;
        if (cols == 4) o[2] = wstat[a][1];
      } else {
        float* pb = part + b * width;
        pb[tile] = s;
        if (tile == 0) {
          pb[tiles + chunks] = wstat[a][0];
          pb[tiles + chunks + 1] = wstat[a][1];
        }
      }
    }
    __syncthreads();  // wsum and wstat are read before the next agents'
  }

  // the tile's chunks of the quadratic form (with one tile, folded here in
  // chunk order)
  if (cols == 4 && tile < chunks) {
    for (int q0 = 0; q0 < na; q0 += kQuadAgents) {
      const int nq = min(kQuadAgents, na - q0);
      const T* ga[kQuadAgents];
#pragma unroll
      for (int a = 0; a < kQuadAgents; ++a)
        ga[a] = g + (b0 + q0 + min(a, nq - 1)) * n;
      float quad[kQuadAgents];
      for (int c = tile; c < chunks; c += tiles) {
        float q[kQuadAgents];
        quad_chunk<T>(mat, ga, c * kQuadRows, min(n, (c + 1) * kQuadRows), n,
                      gs, red, q);
#pragma unroll
        for (int a = 0; a < kQuadAgents; ++a)
          quad[a] = c == tile ? q[a] : __fadd_rn(quad[a], q[a]);
        if (tiles > 1 && threadIdx.x == 0) {
#pragma unroll
          for (int a = 0; a < kQuadAgents; ++a)
            if (a < nq) part[(b0 + q0 + a) * width + tiles + c] = q[a];
        }
      }
      if (tiles == 1 && threadIdx.x == 0) {
#pragma unroll
        for (int a = 0; a < kQuadAgents; ++a)
          if (a < nq) out[(b0 + q0 + a) * cols + 3] = quad[a];
      }
    }
  } else if (cols == 4 && tiles == 1) {
    for (int a = threadIdx.x; a < na; a += kThreads)   // n = 0: no chunk
      out[(b0 + a) * cols + 3] = 0.f;
  }
  if (tiles == 1) return;

  // the agent block's last unit folds every unit's partials, a thread an
  // agent: tiles in tile order, chunks in chunk order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + unit, 1u) == (unsigned)(tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int a = threadIdx.x; a < na; a += kThreads) {
    const float* pb = part + (b0 + a) * width;
    float sp = __ldcg(pb);
    for (int k = 1; k < tiles; ++k) sp = __fadd_rn(sp, __ldcg(pb + k));
    float* o = out + (b0 + a) * cols;
    o[0] = __ldcg(pb + tiles + chunks);
    o[1] = sp;
    if (cols == 4) {
      float quad = chunks > 0 ? __ldcg(pb + tiles) : 0.f;
      for (int c = 1; c < chunks; ++c)
        quad = __fadd_rn(quad, __ldcg(pb + tiles + c));
      o[2] = __ldcg(pb + tiles + chunks + 1);
      o[3] = quad;
    }
  }
}

// ---------------------------------------------------------------------------
// megastep's second half: one block per run.  Every block covers exactly
// the run's m agents, so no padded agent exists to mask (the Pallas kernel
// pads m to its agent block and masks by iota).  The agents go through
// shared memory kGateAgents at a time, in order: thread 0 carries the
// transmitter count and the thread of column j its sum u_j from one chunk
// to the next (u_j in w_next until the last chunk), so every sum is the
// one fixed-order chain over i = 0 .. m - 1 whatever m.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_update_kernel(const float* __restrict__ stats, int cols,
                   const T* __restrict__ g, const float* __restrict__ w,
                   const float* __restrict__ ctl,
                   const float* __restrict__ arand,
                   const float* __restrict__ deliver, int m, int rows, int n,
                   float eps, float neg_eps, float eps2,
                   float* __restrict__ w_next, float* __restrict__ alphas,
                   float* __restrict__ gains) {
  __shared__ float eff[kGateAgents];
  __shared__ float total;   // max(transmitters, 1)
  const size_t r = blockIdx.x;
  const float thresh = ctl[2 * r];
  const float mode = ctl[2 * r + 1];
  const T* gr = g + r * m * n;
  float count = 0.f;        // thread 0's running transmitter count
  for (int a0 = 0; a0 < m; a0 += kGateAgents) {
    const int na = min(kGateAgents, m - a0);
    const bool last = a0 + na == m;
    __syncthreads();  // the previous chunk's eff is consumed
    for (int i = threadIdx.x; i < na; i += kThreads) {
      const size_t a = r * m + a0 + i;
      const float* s = stats + a * cols;
      const float norm = __fmul_rn(neg_eps, s[0]);
      const float prac =
          __fadd_rn(norm, __fdiv_rn(__fmul_rn(eps2, s[1]), (float)rows));
      const float theo = cols == 4
          ? __fadd_rn(__fmul_rn(neg_eps, s[2]), __fmul_rn(eps2, s[3]))
          : prac;
      const float gain = mode == kModeTheoretical ? theo
                         : mode == kModeNorm      ? norm
                                                  : prac;
      const float gate = gain <= -thresh ? 1.f : 0.f;
      const float alpha = mode == kModeAlways   ? 1.f
                          : mode == kModeNever  ? 0.f
                          : mode == kModeRandom ? arand[a]
                                                : gate;
      gains[a] = gain;
      alphas[a] = alpha;
      eff[i] = deliver == nullptr ? alpha : alpha * deliver[a];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < na; ++i) count = __fadd_rn(count, eff[i]);
      if (last) total = fmaxf(count, 1.f);
    }
    if (last) __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      float u = a0 == 0 ? 0.f : w_next[r * n + j];
      for (int i = 0; i < na; ++i)
        u = fmaf(eff[i], to_f32(gr[(size_t)(a0 + i) * n + j]), u);
      w_next[r * n + j] =
          last ? __fsub_rn(w[r * n + j], __fmul_rn(eps, __fdiv_rn(u, total)))
               : u;
    }
  }
}

// The geometry comes from the wrapper (kernels/gain.py::family_geometry)
// and is refused unless it is this kernel's: tiles = ceil(rows / bt) (1
// for rows = 0), chunks = ceil(n / kQuadRows) with a model, else 0.  With
// several tiles, part is agents * (tiles + chunks + 2) floats followed by
// one 4-byte counter per agent block (kernels/gain.py::_family_scratch).
template <typename T>
cudaError_t launch_family(const void* phi, const void* g, int vector,
                          const float* grad_j, long long gj_stride,
                          const float* pm, long long pm_stride, int agents,
                          int m, int rows, int n, int cols, int bm, int bt,
                          int tiles, int chunks, float* part, float* out,
                          cudaStream_t s) {
  if (bm < 1 || bt < 1 || tiles != (rows > 0 ? (rows + bt - 1) / bt : 1) ||
      chunks != (cols == 4 ? (n + kQuadRows - 1) / kQuadRows : 0) ||
      (tiles > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (vector && (n % Vec16<T>::kN != 0 ||
                 reinterpret_cast<uintptr_t>(phi) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(g) % 16 != 0))
    return cudaErrorInvalidValue;
  const long long groups = (long long)(agents / m) * ((m + bm - 1) / bm);
  const long long units = groups * tiles;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  unsigned* tickets = nullptr;
  if (tiles > 1) {
    tickets = reinterpret_cast<unsigned*>(
        part + (size_t)agents * (tiles + chunks + 2));
    const cudaError_t err =
        cudaMemsetAsync(tickets, 0, (size_t)groups * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
  }
  const T* ph = static_cast<const T*>(phi);
  const T* gg = static_cast<const T*>(g);
#define FAMILY_ARGS                                                          \
  ph, gg, grad_j, gj_stride, pm, pm_stride, m, rows, n, cols, bm, bt, tiles, \
      chunks, part, tickets, out
  if (vector)
    family_stats_kernel<T, 0><<<(unsigned)units, kThreads, 0, s>>>(FAMILY_ARGS);
  else if (n <= 8)
    family_stats_kernel<T, 8><<<(unsigned)units, kThreads, 0, s>>>(FAMILY_ARGS);
  else if (n <= 16)
    family_stats_kernel<T, 16><<<(unsigned)units, kThreads, 0, s>>>(FAMILY_ARGS);
  else
    family_stats_kernel<T, 32><<<(unsigned)units, kThreads, 0, s>>>(FAMILY_ARGS);
#undef FAMILY_ARGS
  return cudaGetLastError();
}

template <typename T>
cudaError_t megastep_t(const void* phi, const void* g, int vector,
                       const void* w, const void* ctl, const void* arand,
                       const void* deliver, const float* gj,
                       long long gj_stride, const float* mat,
                       long long pm_stride, int runs, int m, int rows, int n,
                       int cols, int bm, int bt, int tiles, int chunks,
                       float* part, double eps, float* stats, void* w_next,
                       void* alphas, void* gains, cudaStream_t s) {
  const cudaError_t err =
      launch_family<T>(phi, g, vector, gj, gj_stride, mat, pm_stride,
                       runs * m, m, rows, n, cols, bm, bt, tiles, chunks,
                       part, stats, s);
  if (err != cudaSuccess) return err;
  gate_update_kernel<T><<<runs, kThreads, 0, s>>>(
      stats, cols, static_cast<const T*>(g), static_cast<const float*>(w),
      static_cast<const float*>(ctl), static_cast<const float*>(arand),
      static_cast<const float*>(deliver), m, rows, n, (float)eps,
      (float)(-eps), (float)(eps * eps), static_cast<float*>(w_next),
      static_cast<float*>(alphas), static_cast<float*>(gains));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (phi and g share it).
// Every entry returns cudaGetLastError() after its launches (0 on success).
extern "C" {

// vector: 1 for the vector pass, 0 for the generic pass
// (kernels/gain.py::matvec_vector_pass decides); bt, tiles: rows per T-tile
// and T-tiles per agent (kernels/gain.py::matvec_geometry); proj, gain:
// either may be null; scratch: read only for a gain over several tiles
// (launch_matvec).
int gain_matvec_tiles_launch(const void* phi, const void* g, int dtype,
                             int agents, int rows, int n, double eps,
                             int vector, int bt, int tiles, void* proj,
                             void* gain, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float neg_eps = (float)(-eps), eps2 = (float)(eps * eps);
#define MATVEC_ARGS \
  phi, g, agents, rows, n, vector, bt, tiles, neg_eps, eps2, proj, gain, scratch, s
  switch (dtype) {
    case 0: return (int)launch_matvec<float>(MATVEC_ARGS);
    case 1: return (int)launch_matvec<__nv_bfloat16>(MATVEC_ARGS);
    case 2: return (int)launch_matvec<__half>(MATVEC_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MATVEC_ARGS
}

// vector: 1 for the vector pass, 0 for the lane-group pass; bm, bt: agents
// per block and rows per T-tile; tiles, chunks: the geometry they give;
// part: agents * (tiles + chunks + 2) floats of scratch and a counter per
// agent block (read only when tiles > 1; launch_family).
int gain_family_stats_launch(const void* phi, const void* g, int dtype,
                             int vector, const void* grad_j,
                             long long gj_stride, const void* pm,
                             long long pm_stride, int agents, int m, int rows,
                             int n, int cols, int bm, int bt, int tiles,
                             int chunks, void* part, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FAMILY_ENTRY_ARGS                                                     \
  phi, g, vector, static_cast<const float*>(grad_j), gj_stride,               \
      static_cast<const float*>(pm), pm_stride, agents, m, rows, n, cols, bm, \
      bt, tiles, chunks, static_cast<float*>(part), static_cast<float*>(out), s
  switch (dtype) {
    case 0: return (int)launch_family<float>(FAMILY_ENTRY_ARGS);
    case 1: return (int)launch_family<__nv_bfloat16>(FAMILY_ENTRY_ARGS);
    case 2: return (int)launch_family<__half>(FAMILY_ENTRY_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FAMILY_ENTRY_ARGS
}

// Any number of agents m (gate_update_kernel walks them in chunks).
int megastep_launch(const void* phi, const void* g, int dtype, int vector,
                    const void* w, const void* ctl, const void* arand,
                    const void* deliver, const void* grad_j,
                    long long gj_stride, const void* pm, long long pm_stride,
                    int runs, int m, int rows, int n, int cols, int bm, int bt,
                    int tiles, int chunks, void* part, double eps, void* stats,
                    void* w_next, void* alphas, void* gains, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MEGASTEP_ARGS                                                         \
  phi, g, vector, w, ctl, arand, deliver, static_cast<const float*>(grad_j),  \
      gj_stride, static_cast<const float*>(pm), pm_stride, runs, m, rows, n,  \
      cols, bm, bt, tiles, chunks, static_cast<float*>(part), eps,            \
      static_cast<float*>(stats), w_next, alphas, gains, s
  switch (dtype) {
    case 0: return (int)megastep_t<float>(MEGASTEP_ARGS);
    case 1: return (int)megastep_t<__nv_bfloat16>(MEGASTEP_ARGS);
    case 2: return (int)megastep_t<__half>(MEGASTEP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MEGASTEP_ARGS
}

}  // extern "C"
