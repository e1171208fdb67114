// Hopper (sm_90a) kernels for the gain hot spot of Algorithm 1 (paper eq. 13,
// eq. 15, eq. 9 and eq. 6), bound to Python through a plain C interface and
// ctypes (repro_torch/kernels/gain.py).  Each one replaces a Pallas TPU
// kernel of src/repro/kernels/gain.py:
//
//   matvec_gain_kernel   <- gain_matvec (_matvec_kernel) + practical_gain.
//       proj_t = phi_t . g and eq. 15, -eps ||g||^2 + eps^2 sum_t proj_t^2 / T,
//       for every agent of every run in one launch (the leading batch axis
//       replaces the per-agent vmap of gain_dispatch.mode_gains).  Its phi
//       pass has a design of its own (below).
//   family_stats_kernel  <- gain_family_stats (_family_kernel).
//       Per agent [||g||^2, sum_t proj_t^2, g.gradJ, g^T Phi g], or the
//       2-column prefix, which never reads Phi or grad J.
//   gate_update_kernel   <- megastep_call (_megastep_kernel), second half.
//       Per run: mode-selected gains, the eq. 9 gate with the random /
//       always / never baselines, the optional channel keep mask, and
//       w - eps * sum_i(alpha_i keep_i g_i) / max(sum_i alpha_i keep_i, 1).
//
// What bounds them on an H100.  Each kernel streams phi once: at the main
// path's shape (192 runs x 64 agents x T=128 x n=256, float32) that is
// 1.61 GB per step against ~2.4 GFLOP, so device memory (3.35 TB/s) bounds
// them by two orders of magnitude over the float32 rate.  phi is read
// exactly once, coalesced (a warp walks one row of n contiguous elements).
// The one other large operand is a run's n x n Phi (256 KB at n = 256) in
// the quadratic form g^T Phi g.  Read once per agent it costs 3.2 GB of L2
// traffic per launch, and a kernel laid out that way ran at half the speed
// of the plain torch version on an H100 SXM, whose matmul reads Phi once
// per run.  So family_stats_kernel takes kAgents = 4 agents of one run per
// block and reads Phi once for all of them (a column per thread, each load
// used for every agent of the group): 4x less Phi traffic, and
// 192 x 64 / 4 = 3,072 blocks, so the last wave of blocks is short.  On
// the H100 the kernel ran faster at 4 agents per block than at 8 or 16:
// the phi pass, not Phi, sets its time once Phi is shared at all.
//
// The TPU kernels lean on the grid running in order: the n-tile axis
// accumulates into VMEM scratch and megastep carries the gated sum across
// agent blocks.  A CUDA grid has no order, so here a sequential axis is a
// loop inside one block, and nothing crosses blocks inside a kernel.
// megastep is two launches from one C entry: family_stats_kernel over
// agent groups writes the statistics, then gate_update_kernel runs one
// block per run.  Two launches were chosen over one block per run because
// the statistics pass is the part that moves phi: a block per run would
// stream 8 MB per block through 192 blocks on 132 SMs (a 1.45-wave tail,
// one block per SM), while agent groups fill the card; the statistics
// round trip through device memory is 4 floats per agent.
//
// matvec_gain_kernel's phi pass.  The generic pass (projection_sq, kept by
// family_stats_kernel and the ragged shapes) makes 4-byte loads, reloads
// g[j] for every row and has one row per warp in flight, and sq_norm reads
// g a second time; at the main path's shape it ran at 76 % of the HBM
// bound.  The vector pass (projection_sq_vec) takes n % (16 / sizeof(T))
// == 0 and 16-byte-aligned phi and g; the wrapper's Python predicate
// (kernels/gain.py::matvec_vector_pass) picks the pass and the launcher
// refuses the vector pass where its loads would not be whole and aligned.
// A lane loads its slice of g once into registers (kHeldVecs = 2 16-byte
// vectors: 256 columns float32, 512 bf16 a warp; at n = 256 float32 that is
// 8 floats a lane), takes ||g||^2 from those same registers, and then
// streams kRowsInFlight = 8 consecutive rows per warp with every 16-byte
// load of the group issued before the group's sums (64 KB of phi in flight
// per 256-thread block at n = 256), then one fixed xor butterfly per row;
// lanes 0-7 store the group's eight projections together (32 contiguous
// bytes).  phi's loads skip L1 and ask L2 for 256-byte prefetches: it is
// read once (g, reused by every row, stays cached).  Timed on the H100 at
// the main path's shape, this beat 4 rows in flight, cached phi loads, an
// L2 prefetch that still fills L1, a persistent grid, 128 or 512 threads,
// and per-warp row tiles with one store each.  Columns past
// the held ones loop in chunks of 32 16-byte vectors whose g is read again
// with each row, from L1.  One instantiation per dtype.
//
// Determinism: no atomics.  Each lane sums its strided elements in index
// order with fmaf, warps reduce by a fixed xor butterfly (every lane ends
// with the same value), and a block combines its warps in warp order.  So
// two launches on the same inputs give bitwise-equal outputs, and every
// trigger decision is reproducible.  All arithmetic is float32 on CUDA
// cores (no tensor cores, so no TF32); bf16 inputs are widened on load.
// The gain formulas use __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc
// cannot contract them into FMAs: they round like the plain torch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAgents = 4;  // agents of one run per family_stats block

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

// Row dot products of one agent's (T, n) batch with its g: writes proj when
// asked and returns sum_t proj_t^2 (in row order per warp, then warp order).
template <typename T>
__device__ float projection_sq(const T* __restrict__ phi,
                               const T* __restrict__ g, int rows, int n,
                               float* __restrict__ proj, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sq = 0.f;
  for (int t = warp; t < rows; t += kWarps) {
    const T* row = phi + (size_t)t * n;
    float acc = 0.f;
    for (int j = lane; j < n; j += 32)
      acc = fmaf(to_f32(row[j]), to_f32(g[j]), acc);
    acc = warp_sum(acc);
    if (proj != nullptr && lane == 0) proj[t] = acc;
    sq = fmaf(acc, acc, sq);
  }
  return block_sum_of_warps(sq, red);
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
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void widen(uint4 v, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

constexpr int kRowsInFlight = 8;   // consecutive rows a warp streams at once
constexpr int kHeldVecs = 2;       // 16-byte vectors of g a lane holds

// The vector pass of one agent: returns {sum_t proj_t^2 (rows in order
// per warp, then warp order), ||g||^2} and writes proj when asked.  Lane
// l holds g's columns (l + 32 c) V .. + V - 1, c < kHeldVecs, in
// registers; columns past those, in chunks of 32 V, are read again with
// each row (from L1).
template <typename T>
__device__ float2 projection_sq_vec(const T* __restrict__ phi,
                                    const T* __restrict__ g, int rows, int n,
                                    float* __restrict__ proj, float* red) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kHeld = 32 * V * kHeldVecs;   // columns of g in registers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gr[kHeldVecs][V];
  float g2 = 0.f;
#pragma unroll
  for (int c = 0; c < kHeldVecs; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < n) {
      Vec16<T>::widen(load_cached(g + col), gr[c]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) gr[c][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) g2 = fmaf(gr[c][i], gr[c][i], g2);
  }
  for (int col = kHeld + lane * V; col < n; col += 32 * V) {
    float x[V];
    Vec16<T>::widen(load_cached(g + col), x);
#pragma unroll
    for (int i = 0; i < V; ++i) g2 = fmaf(x[i], x[i], g2);
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
      for (int col = kHeld + lane * V; col < n; col += 32 * V) {
        float x[V], y[V];
        Vec16<T>::widen(load_stream(row + col), x);
        Vec16<T>::widen(load_cached(g + col), y);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[r] = fmaf(x[i], y[i], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) acc[r] = warp_sum(acc[r]);
    // lanes 0..7 store the group's consecutive rows (32 contiguous bytes)
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
  return make_float2(block_sum_of_warps(sq, red), warp_sum(g2));
}

// ---------------------------------------------------------------------------
// gain_matvec / practical_gain: one block per agent, through the generic
// pass (ragged n) or the vector pass.
// ---------------------------------------------------------------------------
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
matvec_gain_kernel(const T* __restrict__ phi, const T* __restrict__ g,
                   int rows, int n, float neg_eps, float eps2,
                   float* __restrict__ proj, float* __restrict__ gain) {
  __shared__ float red[kWarps + 1];
  const size_t b = blockIdx.x;
  const T* gb = g + b * n;
  const T* phib = phi + b * rows * n;
  float* pb = proj == nullptr ? nullptr : proj + b * rows;
  float sp, gg;
  if constexpr (!kVector) {
    sp = projection_sq(phib, gb, rows, n, pb, red);
    gg = sq_norm(gb, n, red);
  } else {
    const float2 r = projection_sq_vec<T>(phib, gb, rows, n, pb, red);
    sp = r.x;
    gg = r.y;
  }
  if (gain != nullptr && threadIdx.x == 0)
    gain[b] = __fadd_rn(__fmul_rn(neg_eps, gg),
                        __fdiv_rn(__fmul_rn(eps2, sp), (float)rows));
}

// The vector pass needs whole 16-byte vectors in every row (n % V == 0)
// and 16-byte-aligned phi and g; it is refused otherwise.
template <typename T>
cudaError_t launch_matvec(const void* phi, const void* g, int agents,
                          int rows, int n, int vector, float neg_eps,
                          float eps2, void* proj, void* gain,
                          cudaStream_t s) {
  const T* ph = static_cast<const T*>(phi);
  const T* gg = static_cast<const T*>(g);
  float* pj = static_cast<float*>(proj);
  float* gn = static_cast<float*>(gain);
  if (!vector) {
    matvec_gain_kernel<T, false><<<agents, kThreads, 0, s>>>(
        ph, gg, rows, n, neg_eps, eps2, pj, gn);
  } else {
    if (n % Vec16<T>::kN != 0 || reinterpret_cast<uintptr_t>(phi) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(g) % 16 != 0)
      return cudaErrorInvalidValue;
    matvec_gain_kernel<T, true><<<agents, kThreads, 0, s>>>(
        ph, gg, rows, n, neg_eps, eps2, pj, gn);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gain_family_stats (and megastep's first half): one block per group of
// kAgents agents of one run.  grad_j and Phi are read at the run's offset
// (stride 0 when every run shares them).
//
// The phi pass takes the group's agents one after another.  The quadratic
// form g^T Phi g = sum_j g_j (sum_i g_i Phi_ij) gives thread j column j of
// Phi: it walks the rows in order, one coalesced load of Phi_ij per row,
// used for every agent of the group (their g_i broadcast from shared
// memory), so a block reads the run's Phi once for kAgents agents.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
family_stats_kernel(const T* __restrict__ phi, const T* __restrict__ g,
                    const float* __restrict__ grad_j, long long gj_stride,
                    const float* __restrict__ pm, long long pm_stride,
                    int m, int rows, int n, int cols,
                    float* __restrict__ out) {
  __shared__ float red[kWarps + 1];
  __shared__ float gs[kAgents][kThreads];
  const int groups = (m + kAgents - 1) / kAgents;
  const size_t run = blockIdx.x / groups;
  const int a0 = (blockIdx.x % groups) * kAgents;
  const int na = min(kAgents, m - a0);
  const size_t b0 = run * m + a0;
  const float* gj = grad_j + run * gj_stride;
  for (int a = 0; a < na; ++a) {
    const size_t b = b0 + a;
    const T* gb = g + b * n;
    const float sp = projection_sq(phi + b * rows * n, gb, rows, n, nullptr,
                                   red);
    const float gg = sq_norm(gb, n, red);
    float gdotj = 0.f;
    if (cols == 4) {
      float s = 0.f;
      for (int j = threadIdx.x; j < n; j += kThreads)
        s = fmaf(to_f32(gb[j]), gj[j], s);
      gdotj = block_sum(s, red);
    }
    if (threadIdx.x == 0) {
      float* o = out + b * cols;
      o[0] = gg;
      o[1] = sp;
      if (cols == 4) o[2] = gdotj;
    }
  }
  if (cols != 4) return;
  // A ragged last group repeats its last agent in the spare slots, so the
  // inner loop has no branch; only the group's real agents are written.
  const T* ga[kAgents];
#pragma unroll
  for (int a = 0; a < kAgents; ++a) ga[a] = g + (b0 + min(a, na - 1)) * n;
  const float* mat = pm + run * pm_stride;
  float part[kAgents];
#pragma unroll
  for (int a = 0; a < kAgents; ++a) part[a] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    float acc[kAgents];
#pragma unroll
    for (int a = 0; a < kAgents; ++a) acc[a] = 0.f;
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      __syncthreads();  // gs may still be read by the previous tile
      const int i = i0 + threadIdx.x;
#pragma unroll
      for (int a = 0; a < kAgents; ++a)
        gs[a][threadIdx.x] = i < n ? to_f32(ga[a][i]) : 0.f;
      __syncthreads();
      if (j < n) {
        const int tile = min(kThreads, n - i0);
        const float* col = mat + (size_t)i0 * n + j;
#pragma unroll 4
        for (int ii = 0; ii < tile; ++ii) {
          const float p = col[(size_t)ii * n];
#pragma unroll
          for (int a = 0; a < kAgents; ++a) acc[a] = fmaf(gs[a][ii], p, acc[a]);
        }
      }
    }
    if (j < n) {
#pragma unroll
      for (int a = 0; a < kAgents; ++a)
        part[a] = fmaf(to_f32(ga[a][j]), acc[a], part[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < kAgents; ++a) {
    const float quad = block_sum(part[a], red);
    if (a < na && threadIdx.x == 0) out[(b0 + a) * cols + 3] = quad;
  }
}

// ---------------------------------------------------------------------------
// megastep's second half: one block per run.  Every block covers exactly
// the run's m agents, so no padded agent exists to mask (the Pallas kernel
// pads m to its agent block and masks by iota).
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
  extern __shared__ float eff[];  // m floats, then the transmitter count
  const size_t r = blockIdx.x;
  const float thresh = ctl[2 * r];
  const float mode = ctl[2 * r + 1];
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const size_t a = r * m + i;
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
    float c = 0.f;
    for (int i = 0; i < m; ++i) c = __fadd_rn(c, eff[i]);
    eff[m] = fmaxf(c, 1.f);
  }
  __syncthreads();
  const float cnt = eff[m];
  const T* gr = g + r * m * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    float u = 0.f;
    for (int i = 0; i < m; ++i) u = fmaf(eff[i], to_f32(gr[(size_t)i * n + j]), u);
    w_next[r * n + j] =
        __fsub_rn(w[r * n + j], __fmul_rn(eps, __fdiv_rn(u, cnt)));
  }
}

template <typename T>
void launch_family(const void* phi, const void* g, const float* grad_j,
                   long long gj_stride, const float* pm, long long pm_stride,
                   int agents, int m, int rows, int n, int cols, float* out,
                   cudaStream_t stream) {
  const int blocks = agents / m * ((m + kAgents - 1) / kAgents);
  family_stats_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(phi), static_cast<const T*>(g), grad_j, gj_stride,
      pm, pm_stride, m, rows, n, cols, out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (phi and g share it).  Every entry
// returns cudaGetLastError() after its launches (0 on success).
extern "C" {

// vector: 1 for the vector pass, 0 for the generic pass
// (kernels/gain.py::matvec_vector_pass decides).
int gain_matvec_launch(const void* phi, const void* g, int dtype, int agents,
                       int rows, int n, double eps, int vector, void* proj,
                       void* gain, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float neg_eps = (float)(-eps), eps2 = (float)(eps * eps);
  const cudaError_t err =
      dtype == 0 ? launch_matvec<float>(phi, g, agents, rows, n, vector,
                                        neg_eps, eps2, proj, gain, s)
                 : launch_matvec<__nv_bfloat16>(phi, g, agents, rows, n,
                                                vector, neg_eps, eps2,
                                                proj, gain, s);
  return (int)err;
}

int gain_family_stats_launch(const void* phi, const void* g, int dtype,
                             const void* grad_j, long long gj_stride,
                             const void* pm, long long pm_stride, int agents,
                             int m, int rows, int n, int cols, void* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gj = static_cast<const float*>(grad_j);
  const float* mat = static_cast<const float*>(pm);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    launch_family<float>(phi, g, gj, gj_stride, mat, pm_stride, agents, m,
                         rows, n, cols, o, s);
  else
    launch_family<__nv_bfloat16>(phi, g, gj, gj_stride, mat, pm_stride, agents,
                                 m, rows, n, cols, o, s);
  return (int)cudaGetLastError();
}

int megastep_launch(const void* phi, const void* g, int dtype, const void* w,
                    const void* ctl, const void* arand, const void* deliver,
                    const void* grad_j, long long gj_stride, const void* pm,
                    long long pm_stride, int runs, int m, int rows, int n,
                    int cols, double eps, void* stats, void* w_next,
                    void* alphas, void* gains, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gj = static_cast<const float*>(grad_j);
  const float* mat = static_cast<const float*>(pm);
  float* st = static_cast<float*>(stats);
  const size_t smem = (size_t)(m + 1) * sizeof(float);
  const float eps_f = (float)eps, neg_eps = (float)(-eps),
              eps2 = (float)(eps * eps);
  if (dtype == 0) {
    launch_family<float>(phi, g, gj, gj_stride, mat, pm_stride, runs * m, m,
                         rows, n, cols, st, s);
    gate_update_kernel<float><<<runs, kThreads, smem, s>>>(
        st, cols, static_cast<const float*>(g), static_cast<const float*>(w),
        static_cast<const float*>(ctl), static_cast<const float*>(arand),
        static_cast<const float*>(deliver), m, rows, n, eps_f, neg_eps, eps2,
        static_cast<float*>(w_next), static_cast<float*>(alphas),
        static_cast<float*>(gains));
  } else {
    launch_family<__nv_bfloat16>(phi, g, gj, gj_stride, mat, pm_stride,
                                 runs * m, m, rows, n, cols, st, s);
    gate_update_kernel<__nv_bfloat16><<<runs, kThreads, smem, s>>>(
        st, cols, static_cast<const __nv_bfloat16*>(g),
        static_cast<const float*>(w), static_cast<const float*>(ctl),
        static_cast<const float*>(arand), static_cast<const float*>(deliver),
        m, rows, n, eps_f, neg_eps, eps2, static_cast<float*>(w_next),
        static_cast<float*>(alphas), static_cast<float*>(gains));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
