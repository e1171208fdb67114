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
// cores (67 TFLOP/s), so the operations bound it, and this kernel does
// several times more (G made again for every head and column tile, and
// whole 64-wide j steps).  The pass is 4.4e9 operations
// against 0.14 GB: 0.065 ms, bound by its operations too.
//
// ssd_chunk_generic_kernel (every tile shape; what the others refuse).  The
// Pallas tile has no width limit, so this one holds no whole operand: a
// block makes one 128 x 128 tile of y (rows i, columns p) or of the state
// (rows n, columns p) for one (batch x chunk, head), 256 threads in
// ssd_chunk_kernel's 16 x 16 grid of 8 x 8 outputs.  A y block walks j in
// steps of 64 up to its last row (later j add exact zeros): G = C B^T for
// its rows and those j, N streamed through shared memory 32 columns at a
// time, then G * decay and the y product with dtx's rows j; a state block
// walks all j with B_j w_j and dtx_j staged.  Every output is the same
// ascending fmaf chain as ssd_chunk_kernel's (G over n, y and the state
// over j, the decay and w products rounded alike), so where both run the
// bits are equal (chip_smoke.py checks it).  G is made again for every
// head and column tile: the price of no width limit, on a route no config
// takes.  92,160 bytes of shared memory, two blocks an SM.
//
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

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

namespace generic {

constexpr int kThreadsG = 256;
constexpr int kSideG = 16;              // threads per side of the 16 x 16 grid
constexpr int kTileG = 8;               // outputs per thread per side
constexpr int kOut = kSideG * kTileG;   // 128: rows and columns of an output tile
constexpr int kJ = 64;                  // chunk positions j staged at once
constexpr int kNG = 32;                 // state columns n staged at once (G)
constexpr int kJC = kJ / kSideG;        // G columns per thread

// Shared floats of one tile block: C (kOut x kNG) and B (kJ x kNG) pieces
// for G, G * decay (kOut x kJ), dtx (kJ x kOut), and the cum of the rows
// and of the staged j; a state block reuses the front for B w (kJ x kOut).
constexpr int kCs = kOut * (kNG + 1), kBs = kJ * (kNG + 1);
constexpr int kMs = kOut * (kJ + 1), kXs = kJ * kOut;
constexpr int kTileSmem = kCs + kBs + kMs + kXs + kOut + kJ;
static_assert(kJ * (kOut + 1) <= kCs + kBs + kMs, "B w fits the front");

// dtx (BC, Q, H, P) f32; cum (BC, Q, H) f32; bm, cm (BC, Q, N);
// y (BC, Q, H, P) f32; states (BC, H, N, P) f32.  Block (bc x tile, head):
// tiles [0, qt * pt) are 128 x 128 tiles of y, the rest of the state.
template <typename T>
__global__ void __launch_bounds__(kThreadsG)
ssd_chunk_generic_kernel(const float* __restrict__ dtx,
                         const float* __restrict__ cum,
                         const T* __restrict__ bm, const T* __restrict__ cm,
                         int Q, int H, int N, int P, float* __restrict__ y,
                         float* __restrict__ states) {
  extern __shared__ float smem[];
  const int pt = (P + kOut - 1) / kOut;
  const int yt = (Q + kOut - 1) / kOut * pt;
  const int tiles = yt + (N + kOut - 1) / kOut * pt;
  const int64_t bc = blockIdx.x / tiles;
  int t = blockIdx.x % tiles;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % kSideG, ty = tid / kSideG;
  const T* bsrc = bm + bc * Q * N;
  const T* csrc = cm + bc * Q * N;
  auto cum_at = [&](int j) { return cum[(bc * Q + j) * H + h]; };

  float acc[kTileG][kTileG];
#pragma unroll
  for (int r = 0; r < kTileG; ++r)
#pragma unroll
    for (int c = 0; c < kTileG; ++c) acc[r][c] = 0.f;

  float* Xs = smem + kCs + kBs + kMs;   // kJ x kOut: dtx of the staged j
  auto load_x = [&](int j0, int p0) {
    for (int e = tid; e < kJ * kOut; e += kThreadsG) {
      const int j = j0 + e / kOut, p = p0 + e % kOut;
      Xs[e] = j < Q && p < P ? dtx[((bc * Q + j) * H + h) * P + p] : 0.f;
    }
  };

  if (t < yt) {
    // y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dtx_j over rows i0..,
    // columns p0..: j ascending, as ssd_chunk_kernel's chain
    const int i0 = t / pt * kOut, p0 = t % pt * kOut;
    float* Cs = smem;                 // kOut x (kNG + 1)
    float* Bs = Cs + kCs;             // kJ x (kNG + 1)
    float* Ms = Bs + kBs;             // kOut x (kJ + 1): G * decay
    float* ci = Xs + kXs;             // kOut: cum of the rows
    float* cj = ci + kOut;            // kJ: cum of the staged j
    for (int r = tid; r < kOut; r += kThreadsG)
      ci[r] = i0 + r < Q ? cum_at(i0 + r) : 0.f;
    const int j_end = min(Q, i0 + kOut);   // later j add exact zeros
    for (int j0 = 0; j0 < j_end; j0 += kJ) {
      float g[kTileG][kJC];
#pragma unroll
      for (int r = 0; r < kTileG; ++r)
#pragma unroll
        for (int c = 0; c < kJC; ++c) g[r][c] = 0.f;
      for (int n0 = 0; n0 < N; n0 += kNG) {
        __syncthreads();  // the previous pieces (and j step) are consumed
        for (int e = tid; e < kOut * kNG; e += kThreadsG) {
          const int r = e / kNG, n = n0 + e % kNG, i = i0 + r;
          Cs[r * (kNG + 1) + e % kNG] =
              i < Q && n < N ? to_f32(csrc[(int64_t)i * N + n]) : 0.f;
        }
        for (int e = tid; e < kJ * kNG; e += kThreadsG) {
          const int r = e / kNG, n = n0 + e % kNG, j = j0 + r;
          Bs[r * (kNG + 1) + e % kNG] =
              j < Q && n < N ? to_f32(bsrc[(int64_t)j * N + n]) : 0.f;
        }
        if (n0 == 0) {
          load_x(j0, p0);
          for (int r = tid; r < kJ; r += kThreadsG)
            cj[r] = j0 + r < Q ? cum_at(j0 + r) : 0.f;
        }
        __syncthreads();
        for (int n = 0; n < kNG; ++n) {
          float a[kTileG], b[kJC];
#pragma unroll
          for (int r = 0; r < kTileG; ++r)
            a[r] = Cs[(ty + kSideG * r) * (kNG + 1) + n];
#pragma unroll
          for (int c = 0; c < kJC; ++c)
            b[c] = Bs[(tx + kSideG * c) * (kNG + 1) + n];
#pragma unroll
          for (int r = 0; r < kTileG; ++r)
#pragma unroll
            for (int c = 0; c < kJC; ++c) g[r][c] = fmaf(a[r], b[c], g[r][c]);
        }
      }
      // the 1-semiseparable decay, masked before the exponential
#pragma unroll
      for (int r = 0; r < kTileG; ++r) {
        const int ir = ty + kSideG * r, i = i0 + ir;
#pragma unroll
        for (int c = 0; c < kJC; ++c) {
          const int jc = tx + kSideG * c, j = j0 + jc;
          Ms[ir * (kJ + 1) + jc] = i < Q && j < Q && j <= i
              ? g[r][c] * expf(ci[ir] - cj[jc]) : 0.f;
        }
      }
      __syncthreads();
      for (int j = 0; j < kJ; ++j) {
        float a[kTileG], x[kTileG];
#pragma unroll
        for (int r = 0; r < kTileG; ++r) a[r] = Ms[(ty + kSideG * r) * (kJ + 1) + j];
#pragma unroll
        for (int c = 0; c < kTileG; ++c) x[c] = Xs[j * kOut + tx + kSideG * c];
#pragma unroll
        for (int r = 0; r < kTileG; ++r)
#pragma unroll
          for (int c = 0; c < kTileG; ++c) acc[r][c] = fmaf(a[r], x[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTileG; ++r) {
      const int i = i0 + ty + kSideG * r;
#pragma unroll
      for (int c = 0; c < kTileG; ++c) {
        const int p = p0 + tx + kSideG * c;
        if (i < Q && p < P) y[((bc * Q + i) * H + h) * P + p] = acc[r][c];
      }
    }
  } else {
    // state = sum_j exp(cum_Q - cum_j) B_j (x) dtx_j over rows n0..,
    // columns p0..: j ascending
    t -= yt;
    const int n0 = t / pt * kOut, p0 = t % pt * kOut;
    float* Ws = smem;                 // kJ x (kOut + 1): B_j w_j
    const float last = cum_at(Q - 1);
    for (int j0 = 0; j0 < Q; j0 += kJ) {
      __syncthreads();  // the previous j step is consumed
      for (int e = tid; e < kJ * kOut; e += kThreadsG) {
        const int r = e / kOut, n = n0 + e % kOut, j = j0 + r;
        Ws[r * (kOut + 1) + e % kOut] =
            j < Q && n < N
                ? to_f32(bsrc[(int64_t)j * N + n]) * expf(last - cum_at(j))
                : 0.f;
      }
      load_x(j0, p0);
      __syncthreads();
      for (int j = 0; j < kJ; ++j) {
        float a[kTileG], x[kTileG];
#pragma unroll
        for (int r = 0; r < kTileG; ++r) a[r] = Ws[j * (kOut + 1) + ty + kSideG * r];
#pragma unroll
        for (int c = 0; c < kTileG; ++c) x[c] = Xs[j * kOut + tx + kSideG * c];
#pragma unroll
        for (int r = 0; r < kTileG; ++r)
#pragma unroll
          for (int c = 0; c < kTileG; ++c) acc[r][c] = fmaf(a[r], x[c], acc[r][c]);
      }
    }
    float* st = states + (bc * H + h) * N * P;
#pragma unroll
    for (int r = 0; r < kTileG; ++r) {
      const int n = n0 + ty + kSideG * r;
#pragma unroll
      for (int c = 0; c < kTileG; ++c) {
        const int p = p0 + tx + kSideG * c;
        if (n < N && p < P) st[(int64_t)n * P + p] = acc[r][c];
      }
    }
  }
}

template <typename T>
cudaError_t launch_tile(const float* dtx, const float* cum, const void* bm,
                        const void* cm, int bc, int Q, int H, int N, int P,
                        float* y, float* states, cudaStream_t s) {
  const int bytes = kTileSmem * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_generic_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const long long pt = (P + kOut - 1) / kOut;
  const long long tiles = ((Q + kOut - 1) / kOut + (N + kOut - 1) / kOut) * pt;
  if ((long long)bc * tiles > 0x7fffffffLL || H > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)(bc * tiles), H);
  ssd_chunk_generic_kernel<T><<<grid, kThreadsG, bytes, s>>>(
      dtx, cum, static_cast<const T*>(bm), static_cast<const T*>(cm), Q, H, N,
      P, y, states);
  return cudaGetLastError();
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
