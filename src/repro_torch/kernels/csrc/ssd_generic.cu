// Hopper (sm_90a) CUDA-core kernels for the Mamba2 SSD at every shape the
// Pallas tile takes (src/repro/kernels/ssd_scan.py::ssd_chunk_tiles,
// _ssd_chunk_kernel, has no width limit) and for the inter-chunk pass that
// replaces the XLA code around it (ssd_chunked_pallas,
// src/repro/kernels/ssd_scan.py:133-145), bound to Python through a plain C
// interface and ctypes (repro_torch/kernels/ssd_scan.py).  The formulas are
// ssd_scan.cu's; the wrapper routes here what its fixed-shape kernels
// refuse: Q, N or P above 128 and float16 B and C (the tile), and wider
// chunks or states, P not a multiple of 4, rows of C that are not 16-byte
// multiples, float16 C or output and inputs off 16-byte boundaries (the
// pass).  A source of its own, so that nvcc builds it beside ssd_scan.cu.
//
// What bounds them on an H100.  At mamba2-370m's widths with a chunk of
// 256 (32 heads of P 64, N 128, 1 x 8192 tokens, bf16 B and C) the tile's
// function is 8.9e9 float32 operations (C B^T once a chunk and y a head on
// the pairs j <= i, the state a head) against 0.17 GB: 0.13 ms on CUDA
// cores (67 TFLOP/s), so the operations bound it.  The pass is 4.4e9
// operations against 0.14 GB: 0.065 ms, bound by its operations too.
//
// ssd_chunk_generic_kernel (every tile shape; what the others refuse).  The
// Pallas tile has no width limit, so this one holds no whole operand.  A
// block takes one (batch x chunk, tile of 128 output rows) and a group of
// kHeadsG = 8 heads: 256 threads in ssd_chunk_kernel's 16 x 16 grid, each
// with 8 rows of 4 or 8 columns (column tiles of 64 where P fits one, else
// of 128, walked inside the block).  B and C have no head axis, so a y
// block makes G = C B^T for its 128 rows once for all its heads and column
// tiles, over a window of up to 256 positions j held in shared memory (128
// x 257 floats: a chunk of 256 in one window; past it G is made again a
// window at a time, and each head's partial y is stored and read back,
// which keeps every chain): N in pieces of 32 columns, C's and B's pieces
// staged by cp.async one piece ahead (16-byte copies where B's and C's
// rows allow, else plain loads).  Then for each head and column tile, in
// steps of 64 positions j (up to the tile's last row: later j add exact
// zeros, and the steps a row tile cannot see are skipped), G * decay goes
// into shared memory (masked before the exponential, the head's cum of the
// rows and of the window beside it) and the y product reads it against
// dtx's step, staged by cp.async one step ahead.  A state block (rows n of
// the state) walks all j for each head and column tile with B's raw step,
// its cum and dtx's step staged by cp.async one step ahead, B_j w_j formed
// in shared memory.  Every output is the same ascending fmaf chain as
// ssd_chunk_kernel's (G over n, y and the state over j, the decay and w
// products rounded alike), so where both run the bits are equal
// (chip_smoke.py's fixed_vs_generic checks it).  Up to 231,936 bytes of
// shared memory (G's window at a chunk of 256 with 128-column tiles),
// one block an SM.

// ssd_state_pass_generic_kernel (every pass shape, dtype and alignment).
// ssd_state_pass_kernel's blocks and arithmetic with nothing held whole:
// h lives in the block's own slice of the final-state output (zeroed
// first, updated in place after a barrier once every row has read
// h_{c-1}), C and h are staged 128 rows by 64 state columns at a time, and
// every load is scalar, so any P, N, row size and address works; float16
// C widens on load and y is stored as float32, bf16 or float16.  The same
// fmaf chains, so where both run the bits equal ssd_state_pass_kernel's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

namespace generic {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_u32;

constexpr int kThreadsG = 256;
constexpr int kSideG = 16;              // threads per side of the 16 x 16 grid
constexpr int kTileG = 8;               // rows per thread
constexpr int kOut = kSideG * kTileG;   // 128: rows of an output tile
constexpr int kJ = 64;                  // chunk positions j of a step
constexpr int kNG = 32;                 // state columns n staged at once (G)
constexpr int kJC = kJ / kSideG;        // G columns per thread in a step
constexpr int kWindow = 256;            // positions j of G held at once
constexpr int kHeadsG = 8;              // heads of a block

// 16-byte-aligned float offsets of a tile block's shared memory (floats):
// A = G over the window (kOut x (jw + 1)), or a state block's ring of two
// raw B steps (kJ x kOut of T) and their cum; M = G * decay (kOut x (kJ +
// 1)) or a state block's B w (kJ x (kOut + 1)), then two steps of dtx (kJ x
// cols each), the two staged pieces of C and B while G is made (kOut + kJ
// rows of kNG + pad T each, twice) aliasing M; the rows' cum and the
// window's.
__host__ __device__ constexpr int larger(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int up4(int x) { return (x + 3) / 4 * 4; }
struct TileSmem {
  int ms, xs, ci, cj, floats;
  __host__ __device__ TileSmem(int jw, int cols, int t_size) {
    const int a = up4(larger(kOut * (jw + 1), 2 * kJ * kOut * t_size / 4 + 2 * kJ));
    const int stage = 2 * (kOut + kJ) * (kNG + 16 / t_size) * t_size / 4;
    const int m = up4(larger(kOut * (kJ + 1), kJ * (kOut + 1)));
    ms = a;
    xs = ms + m;
    ci = xs + larger(2 * kJ * cols, stage - m);
    cj = ci + kOut;
    floats = cj + kWindow;
  }
};

template <typename T>
__device__ __forceinline__ void zero16(T* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// dtx (BC, Q, H, P) f32; cum (BC, Q, H) f32; bm, cm (BC, Q, N);
// y (BC, Q, H, P) f32; states (BC, H, N, P) f32.  Block (bc x tile, head
// group of kHeadsG): tiles [0, qt) are the rows i0 = 128 t of y, the rest
// the rows n0 of the state; each walks its heads and column tiles of
// 16 TC columns.  jw: G's window (a multiple of kJ, at most kWindow);
// vec_bc: B and C rows are 16-byte multiples on 16-byte boundaries; vec_x:
// likewise dtx's rows.
template <typename T, int TC>
__global__ void __launch_bounds__(kThreadsG)
ssd_chunk_generic_kernel(const float* __restrict__ dtx,
                         const float* __restrict__ cum,
                         const T* __restrict__ bm, const T* __restrict__ cm,
                         int Q, int H, int N, int P, int jw, int vec_bc,
                         int vec_x, float* __restrict__ y,
                         float* __restrict__ states) {
  constexpr int kCols = kSideG * TC;       // columns p of an output tile
  constexpr int kCG = TC / 4;              // a thread's groups of 4 columns
  constexpr int kEl = 16 / (int)sizeof(T); // elements of T in 16 bytes
  constexpr int kSt = kNG + kEl;           // staged C and B row, in T
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const TileSmem L(jw, kCols, (int)sizeof(T));
  float* const Ms = smem + L.ms;
  float* const ci = smem + L.ci;
  float* const cj = smem + L.cj;
  auto xs = [&](int buf) { return smem + L.xs + buf * kJ * kCols; };

  const int qt = (Q + kOut - 1) / kOut;
  const int tiles = qt + (N + kOut - 1) / kOut;
  const int64_t bc = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int h0 = blockIdx.y * kHeadsG, h1 = min(h0 + kHeadsG, H);
  const int tid = threadIdx.x, tx = tid % kSideG, ty = tid / kSideG;
  const T* bsrc = bm + bc * Q * N;
  const T* csrc = cm + bc * Q * N;
  const int pt = (P + kCols - 1) / kCols;
  auto cum_at = [&](int j, int h) { return cum[(bc * Q + j) * H + h]; };

  // dtx rows j0 .. j0 + kJ - 1 of head h, columns p0 .. p0 + kCols - 1,
  // zeros past Q and P, into a step buffer by cp.async
  auto stage_x = [&](float* dst, int h, int j0, int p0) {
    if (vec_x) {
      for (int e = tid; e < kJ * kCols / 4; e += kThreadsG) {
        const int j = j0 + e / (kCols / 4), p = p0 + 4 * (e % (kCols / 4));
        float* d = dst + 4 * e;
        if (j < Q && p < P)
          cp_async16(smem_u32(d), dtx + ((bc * Q + j) * H + h) * P + p);
        else
          zero16(d);
      }
    } else {
      for (int e = tid; e < kJ * kCols; e += kThreadsG) {
        const int j = j0 + e / kCols, p = p0 + e % kCols;
        if (j < Q && p < P)
          cp_async4(smem_u32(dst + e), dtx + ((bc * Q + j) * H + h) * P + p);
        else
          dst[e] = 0.f;
      }
    }
  };
  // rows r0 .. r0 + rows - 1 of B or C (any below Q), columns n0 .. n0 +
  // cols - 1 (zeros past N and Q), into dst at kSt-element rows (G) or
  // cols-element rows (a state step); by cp.async where the rows allow
  auto stage_rows = [&](T* dst, int stride, const T* src, int r0, int rows,
                        int n0, int cols) {
    if (vec_bc) {
      for (int e = tid; e < rows * cols / kEl; e += kThreadsG) {
        const int r = e / (cols / kEl), c = kEl * (e % (cols / kEl));
        T* d = dst + r * stride + c;
        if (r0 + r < Q && n0 + c < N)
          cp_async16(smem_u32(d), src + (int64_t)(r0 + r) * N + n0 + c);
        else
          zero16(d);
      }
    } else {
      for (int e = tid; e < rows * cols; e += kThreadsG) {
        const int r = e / cols, c = e % cols;
        dst[r * stride + c] = r0 + r < Q && n0 + c < N
            ? src[(int64_t)(r0 + r) * N + n0 + c] : T(0.f);
      }
    }
  };

  float acc[kTileG][TC];

  if (t < qt) {
    // y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dtx_j over rows
    // i0 .. i0 + 127: G made once for every head and column tile of the
    // block, a window of jw positions at a time; j ascending, as
    // ssd_chunk_kernel's chain (later j add exact zeros)
    const int i0 = t * kOut;
    const int j_end = min(Q, i0 + kOut);
    float* const Gs = smem;   // kOut x (jw + 1)
    const int gs = jw + 1;
    for (int jw0 = 0; jw0 < j_end; jw0 += jw) {
      const int jw_end = min(j_end, jw0 + jw);
      const int nsub = (jw_end - jw0 + kJ - 1) / kJ;
      const int nn = (N + kNG - 1) / kNG;
      // G = C B^T over the window, n ascending in pieces of kNG staged by
      // cp.async one piece ahead
      T* const stage = reinterpret_cast<T*>(Ms);
      auto stage_g = [&](int g) {
        T* buf = stage + (g % 2) * (kOut + kJ) * kSt;
        const int n0 = (g % nn) * kNG, j0 = jw0 + (g / nn) * kJ;
        stage_rows(buf, kSt, csrc, i0, kOut, n0, kNG);
        stage_rows(buf + kOut * kSt, kSt, bsrc, j0, kJ, n0, kNG);
        cp_async_commit();
      };
      __syncthreads();   // the previous window's steps are consumed
      stage_g(0);
      float g[kTileG][kJC];
      for (int step = 0; step < nsub * nn; ++step) {
        if (step % nn == 0) {
#pragma unroll
          for (int r = 0; r < kTileG; ++r)
#pragma unroll
            for (int c = 0; c < kJC; ++c) g[r][c] = 0.f;
        }
        if (step + 1 < nsub * nn) {
          stage_g(step + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const T* Cs = stage + (step % 2) * (kOut + kJ) * kSt;
        const T* Bs = Cs + kOut * kSt;
        for (int n = 0; n < kNG; ++n) {
          float a[kTileG], b[kJC];
#pragma unroll
          for (int r = 0; r < kTileG; ++r) a[r] = to_f32(Cs[(ty + kSideG * r) * kSt + n]);
#pragma unroll
          for (int c = 0; c < kJC; ++c) b[c] = to_f32(Bs[(tx + kSideG * c) * kSt + n]);
#pragma unroll
          for (int r = 0; r < kTileG; ++r)
#pragma unroll
            for (int c = 0; c < kJC; ++c) g[r][c] = fmaf(a[r], b[c], g[r][c]);
        }
        if (step % nn == nn - 1) {
          const int jc0 = (step / nn) * kJ;
#pragma unroll
          for (int r = 0; r < kTileG; ++r)
#pragma unroll
            for (int c = 0; c < kJC; ++c)
              Gs[(ty + kSideG * r) * gs + jc0 + tx + kSideG * c] = g[r][c];
        }
        __syncthreads();   // this piece is consumed
      }

      // every head and column tile: G * decay, then the y product over
      // the window's steps, dtx staged by cp.async one step ahead
      const int n_steps = (h1 - h0) * pt * nsub;
      auto step_at = [&](int s, int& h, int& p0, int& j0) {
        h = h0 + s / (pt * nsub);
        p0 = (s / nsub) % pt * kCols;
        j0 = jw0 + (s % nsub) * kJ;
      };
      {
        int h, p0, j0;
        step_at(0, h, p0, j0);
        stage_x(xs(0), h, j0, p0);
        cp_async_commit();
      }
      for (int s = 0; s < n_steps; ++s) {
        int h, p0, j0;
        step_at(s, h, p0, j0);
        if (s % (pt * nsub) == 0) {   // a new head: its cum
          for (int r = tid; r < kOut; r += kThreadsG)
            ci[r] = i0 + r < Q ? cum_at(i0 + r, h) : 0.f;
          for (int r = tid; r < jw; r += kThreadsG)
            cj[r] = jw0 + r < Q ? cum_at(jw0 + r, h) : 0.f;
          __syncthreads();
        }
        if (s % nsub == 0) {   // a new (head, column tile): acc
#pragma unroll
          for (int r = 0; r < kTileG; ++r) {
            const int i = i0 + ty + kSideG * r;
#pragma unroll
            for (int c = 0; c < TC; ++c) {
              const int p = p0 + 64 * (c / 4) + 4 * tx + c % 4;
              acc[r][c] = jw0 > 0 && i < Q && p < P
                  ? y[((bc * Q + i) * H + h) * P + p] : 0.f;
            }
          }
        }
        if (s + 1 < n_steps) {
          int hn, pn, jn;
          step_at(s + 1, hn, pn, jn);
          stage_x(xs((s + 1) % 2), hn, jn, pn);
          cp_async_commit();
        }
        // the 1-semiseparable decay, masked before the exponential
#pragma unroll
        for (int r = 0; r < kTileG; ++r) {
          const int ir = ty + kSideG * r, i = i0 + ir;
#pragma unroll
          for (int c = 0; c < kJC; ++c) {
            const int jc = tx + kSideG * c, j = j0 + jc;
            Ms[ir * (kJ + 1) + jc] = i < Q && j < Q && j <= i
                ? Gs[ir * gs + j - jw0] * expf(ci[ir] - cj[j - jw0]) : 0.f;
          }
        }
        if (s + 1 < n_steps) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncthreads();
        const float* X = xs(s % 2);
        for (int j = 0; j < kJ; ++j) {
          float a[kTileG];
          float4 x[kCG];
#pragma unroll
          for (int r = 0; r < kTileG; ++r) a[r] = Ms[(ty + kSideG * r) * (kJ + 1) + j];
#pragma unroll
          for (int q4 = 0; q4 < kCG; ++q4)
            x[q4] = *reinterpret_cast<const float4*>(X + j * kCols + 64 * q4 + 4 * tx);
#pragma unroll
          for (int r = 0; r < kTileG; ++r)
#pragma unroll
            for (int q4 = 0; q4 < kCG; ++q4) {
              acc[r][4 * q4] = fmaf(a[r], x[q4].x, acc[r][4 * q4]);
              acc[r][4 * q4 + 1] = fmaf(a[r], x[q4].y, acc[r][4 * q4 + 1]);
              acc[r][4 * q4 + 2] = fmaf(a[r], x[q4].z, acc[r][4 * q4 + 2]);
              acc[r][4 * q4 + 3] = fmaf(a[r], x[q4].w, acc[r][4 * q4 + 3]);
            }
        }
        if (s % nsub == nsub - 1) {   // the (head, column tile)'s window
#pragma unroll
          for (int r = 0; r < kTileG; ++r) {
            const int i = i0 + ty + kSideG * r;
#pragma unroll
            for (int c = 0; c < TC; ++c) {
              const int p = p0 + 64 * (c / 4) + 4 * tx + c % 4;
              if (i < Q && p < P) y[((bc * Q + i) * H + h) * P + p] = acc[r][c];
            }
          }
        }
        __syncthreads();   // Ms, the dtx step and the cum are consumed
      }
    }
  } else {
    // state = sum_j exp(cum_Q - cum_j) B_j (x) dtx_j over rows n0 .. n0 +
    // 127, for every head and column tile of the block: j ascending; B's
    // raw step and the step's cum staged by cp.async one step ahead with
    // dtx's, B w formed in shared memory
    const int n0 = (t - qt) * kOut;
    const int nsub = (Q + kJ - 1) / kJ;
    const int n_steps = (h1 - h0) * pt * nsub;
    T* const braw = reinterpret_cast<T*>(smem);                 // 2 x kJ x kOut
    float* const cjs = smem + 2 * kJ * kOut * (int)sizeof(T) / 4;   // 2 x kJ
    auto step_at = [&](int s, int& h, int& p0, int& j0) {
      h = h0 + s / (pt * nsub);
      p0 = (s / nsub) % pt * kCols;
      j0 = (s % nsub) * kJ;
    };
    auto stage = [&](int s) {
      int h, p0, j0;
      step_at(s, h, p0, j0);
      stage_rows(braw + (s % 2) * kJ * kOut, kOut, bsrc, j0, kJ, n0, kOut);
      float* cum_j = cjs + (s % 2) * kJ;
      for (int r = tid; r < kJ; r += kThreadsG) {
        if (j0 + r < Q) cp_async4(smem_u32(cum_j + r), cum + (bc * Q + j0 + r) * H + h);
        else cum_j[r] = 0.f;
      }
      stage_x(xs(s % 2), h, j0, p0);
      cp_async_commit();
    };
    stage(0);
    float last = 0.f;
    for (int s = 0; s < n_steps; ++s) {
      int h, p0, j0;
      step_at(s, h, p0, j0);
      if (s % nsub == 0) {
        last = cum_at(Q - 1, h);
#pragma unroll
        for (int r = 0; r < kTileG; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
      }
      if (s + 1 < n_steps) {
        stage(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // B_j w_j, w_j = exp(cum_Q - cum_j), as ssd_chunk_kernel rounds it
      const T* Bt = braw + (s % 2) * kJ * kOut;
      const float* cum_j = cjs + (s % 2) * kJ;
      for (int e = tid; e < kJ * kOut; e += kThreadsG) {
        const int j = e / kOut, n = e % kOut;
        Ms[j * (kOut + 1) + n] = j0 + j < Q && n0 + n < N
            ? to_f32(Bt[e]) * expf(last - cum_j[j]) : 0.f;
      }
      __syncthreads();
      const float* X = xs(s % 2);
      for (int j = 0; j < kJ; ++j) {
        float a[kTileG];
        float4 x[kCG];
#pragma unroll
        for (int r = 0; r < kTileG; ++r) a[r] = Ms[j * (kOut + 1) + ty + kSideG * r];
#pragma unroll
        for (int q4 = 0; q4 < kCG; ++q4)
          x[q4] = *reinterpret_cast<const float4*>(X + j * kCols + 64 * q4 + 4 * tx);
#pragma unroll
        for (int r = 0; r < kTileG; ++r)
#pragma unroll
          for (int q4 = 0; q4 < kCG; ++q4) {
            acc[r][4 * q4] = fmaf(a[r], x[q4].x, acc[r][4 * q4]);
            acc[r][4 * q4 + 1] = fmaf(a[r], x[q4].y, acc[r][4 * q4 + 1]);
            acc[r][4 * q4 + 2] = fmaf(a[r], x[q4].z, acc[r][4 * q4 + 2]);
            acc[r][4 * q4 + 3] = fmaf(a[r], x[q4].w, acc[r][4 * q4 + 3]);
          }
      }
      if (s % nsub == nsub - 1) {
        float* st = states + (bc * H + h) * N * P;
#pragma unroll
        for (int r = 0; r < kTileG; ++r) {
          const int n = n0 + ty + kSideG * r;
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            const int p = p0 + 64 * (c / 4) + 4 * tx + c % 4;
            if (n < N && p < P) st[(int64_t)n * P + p] = acc[r][c];
          }
        }
      }
      __syncthreads();   // B w and the step's buffers are consumed
    }
  }
}

template <typename T, int TC>
cudaError_t launch_tile_cols(const float* dtx, const float* cum,
                             const void* bm, const void* cm, int bc, int Q,
                             int H, int N, int P, float* y, float* states,
                             cudaStream_t s) {
  const int q_steps = (Q + kJ - 1) / kJ * kJ;   // Q in whole steps
  const int jw = q_steps < kWindow ? q_steps : kWindow;
  const int bytes = TileSmem(jw, kSideG * TC, (int)sizeof(T)).floats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_generic_kernel<T, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (Q + kOut - 1) / kOut + (N + kOut - 1) / kOut;
  if ((long long)bc * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_bc = (N * (int)sizeof(T)) % 16 == 0 && aligned(bm) && aligned(cm);
  const int vec_x = P % 4 == 0 && aligned(dtx);
  dim3 grid((unsigned)(bc * tiles), (H + kHeadsG - 1) / kHeadsG);
  ssd_chunk_generic_kernel<T, TC><<<grid, kThreadsG, bytes, s>>>(
      dtx, cum, static_cast<const T*>(bm), static_cast<const T*>(cm), Q, H, N,
      P, jw, vec_bc, vec_x, y, states);
  return cudaGetLastError();
}

// Column tiles of 64 where P fits one, else of 128.
template <typename T>
cudaError_t launch_tile(const float* dtx, const float* cum, const void* bm,
                        const void* cm, int bc, int Q, int H, int N, int P,
                        float* y, float* states, cudaStream_t s) {
  if (P <= 4 * kSideG)
    return launch_tile_cols<T, 4>(dtx, cum, bm, cm, bc, Q, H, N, P, y, states, s);
  return launch_tile_cols<T, 8>(dtx, cum, bm, cm, bc, Q, H, N, P, y, states, s);
}

constexpr int kSliceG = 32;   // P columns of one pass block
constexpr int kRowsG = 128;   // rows of C . h a block makes at once
constexpr int kNP = 64;       // state rows n staged at once

__device__ __forceinline__ void store_y(void* y, int y_dtype, int64_t i,
                                        float v) {
  if (y_dtype == 0)
    static_cast<float*>(y)[i] = v;
  else if (y_dtype == 1)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(y)[i] = __float2half_rn(v);
}

// y_intra (B, nc, Q, H, P) f32; states (B, nc, H, N, P) f32; cum (B, nc,
// Q, H) f32; cm (B, nc, Q, N); y (B, L, H, P) in y_dtype (0 float32, 1
// bf16, 2 float16); final_state (B, H, N, P) f32, which holds h as the
// block walks the chunks (the block owns its P slice of it).  Block (P
// slice, head, batch row); thread (ty, tx) of 32 x 8 makes rows ty + 32 r
// and columns 4 tx .. 4 tx + 3 of each 128-row step.
template <typename T>
__global__ void __launch_bounds__(kThreadsG)
ssd_state_pass_generic_kernel(const float* __restrict__ y_intra,
                              const float* __restrict__ states,
                              const float* __restrict__ cum,
                              const T* __restrict__ cm, int nc, int Q, int H,
                              int N, int P, int L, void* __restrict__ y,
                              int y_dtype, float* final_state) {
  __shared__ float Cs[kRowsG][kNP + 1];
  __shared__ float Hs[kNP][kSliceG];
  const int p0 = blockIdx.x * kSliceG, hd = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int pw = min(kSliceG, P - p0);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  float* hg = final_state + (b * H + hd) * N * P + p0;   // h[n][p] at n P + p

  for (int e = tid; e < N * pw; e += kThreadsG) hg[(int64_t)(e / pw) * P + e % pw] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int64_t row0 = (b * nc + c) * Q;
    for (int i0 = 0; i0 < Q; i0 += kRowsG) {
      // acc = C_c . h_{c-1} over this thread's rows and columns, n ascending
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kNP) {
        __syncthreads();   // h is complete; the previous pieces are consumed
        for (int e = tid; e < kRowsG * kNP; e += kThreadsG) {
          const int r = e / kNP, n = n0 + e % kNP, i = i0 + r;
          Cs[r][e % kNP] =
              i < Q && n < N ? to_f32(cm[(row0 + i) * N + n]) : 0.f;
        }
        for (int e = tid; e < kNP * kSliceG; e += kThreadsG) {
          const int r = e / kSliceG, pc = e % kSliceG, n = n0 + r;
          Hs[r][pc] = n < N && pc < pw ? __ldcg(hg + (int64_t)n * P + pc) : 0.f;
        }
        __syncthreads();
        for (int n = 0; n < kNP; ++n) {
          float hv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) hv[k] = Hs[n][4 * tx + k];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cv = Cs[ty + 32 * r][n];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(cv, hv[k], acc[r][k]);
          }
        }
      }
      // y_c = y_intra_c + exp(cum_c) acc, pad rows dropped
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 32 * r;
        const int64_t t = (int64_t)c * Q + i;
        if (i >= Q || t >= L) continue;
        const float e = expf(cum[(row0 + i) * H + hd]);
        const float* yi = y_intra + ((row0 + i) * H + hd) * P + p0;
        const int64_t out = ((b * L + t) * H + hd) * P + p0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int pc = 4 * tx + k;
          if (pc < pw) store_y(y, y_dtype, out + pc, fmaf(e, acc[r][k], yi[pc]));
        }
      }
    }
    __syncthreads();   // every read of h_{c-1} is done
    // h_c = exp(cum_c,Q) h_{c-1} + state_c, each element by one thread
    const float dec = expf(cum[(row0 + Q - 1) * H + hd]);
    const float* sc = states + (((b * nc + c) * H + hd) * N) * (int64_t)P + p0;
    for (int e = tid; e < N * pw; e += kThreadsG) {
      const int64_t at = (int64_t)(e / pw) * P + e % pw;
      hg[at] = fmaf(dec, __ldcg(hg + at), sc[at]);
    }
  }
}

template <typename T>
cudaError_t launch_pass(const float* y_intra, const float* states,
                        const float* cum, const void* cm, int B, int nc,
                        int Q, int H, int N, int P, int L, void* y,
                        int y_dtype, float* final_state, cudaStream_t s) {
  if (H > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((P + kSliceG - 1) / kSliceG, H, B);
  ssd_state_pass_generic_kernel<T><<<grid, kThreadsG, 0, s>>>(
      y_intra, states, cum, static_cast<const T*>(cm), nc, Q, H, N, P, L, y,
      y_dtype, final_state);
  return cudaGetLastError();
}

}  // namespace generic
}  // namespace

extern "C" {

// The generic tile: any Q, N, P >= 1; dtype of B and C: 0 float32, 1
// bfloat16, 2 float16.  No alignment rule.
int ssd_chunk_generic_launch(const void* dtx, const void* cum, const void* bm,
                             const void* cm, int dtype, int bc, int Q, int H,
                             int N, int P, void* y, void* states,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || N < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const float* d = static_cast<const float*>(dtx);
  const float* c = static_cast<const float*>(cum);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(states);
  switch (dtype) {
    case 0: return (int)generic::launch_tile<float>(d, c, bm, cm, bc, Q, H, N, P, yo, so, s);
    case 1: return (int)generic::launch_tile<__nv_bfloat16>(d, c, bm, cm, bc, Q, H, N, P, yo, so, s);
    case 2: return (int)generic::launch_tile<__half>(d, c, bm, cm, bc, Q, H, N, P, yo, so, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The generic pass: any Q, N, P >= 1; c_dtype and y_dtype 0 float32, 1
// bfloat16, 2 float16.  No alignment rule.
int ssd_state_pass_generic_launch(const void* y_intra, const void* states,
                                  const void* cum, const void* cm,
                                  int c_dtype, int y_dtype, int B, int nc,
                                  int Q, int H, int N, int P, int L, void* y,
                                  void* final_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || N < 1 || P < 1 || L < 1 || L > nc * Q || y_dtype < 0 ||
      y_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const float* yi = static_cast<const float*>(y_intra);
  const float* st = static_cast<const float*>(states);
  const float* cu = static_cast<const float*>(cum);
  float* fs = static_cast<float*>(final_state);
  switch (c_dtype) {
    case 0: return (int)generic::launch_pass<float>(yi, st, cu, cm, B, nc, Q, H, N, P, L, y, y_dtype, fs, s);
    case 1: return (int)generic::launch_pass<__nv_bfloat16>(yi, st, cu, cm, B, nc, Q, H, N, P, L, y, y_dtype, fs, s);
    case 2: return (int)generic::launch_pass<__half>(yi, st, cu, cm, B, nc, Q, H, N, P, L, y, y_dtype, fs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
