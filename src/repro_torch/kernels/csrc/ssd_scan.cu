// Hopper (sm_90a) kernel for the Mamba2 SSD intra-chunk tile
// (arXiv:2405.21060 §6), bound to Python through a plain C interface and
// ctypes (repro_torch/kernels/ssd_scan.py).  It replaces the Pallas TPU
// kernel src/repro/kernels/ssd_scan.py::ssd_chunk_tiles (_ssd_chunk_kernel).
// For every (batch x chunk, head) it computes
//
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dtx_j      (Q x P)
//   state = sum_j exp(cum_Q - cum_j) B_j (x) dtx_j                (N x P)
//
// with the decay masked before the exponential, all in float32 (B and C
// arrive in the model's dtype and are widened on load).
//
// What bounds it on an H100.  At mamba2-370m's prefill (B = 4, L = 8192:
// 256 chunks x 32 heads, Q = 128, N = 128, P = 64) the tile moves about
// 0.82 GB (dtx, y and the states at 268 MB each) against 3.5e10 float32
// operations once C B^T is shared by the heads, so the float32 rate
// (67 TFLOP/s outside the tensor cores; the reference computes in float32,
// so TF32 tensor cores are not an option) bounds it, not device memory.
//
// Design.  B and C are shared by all heads (ngroups = 1), so the Q x Q
// Gram matrix G = C B^T depends only on the chunk.  The Pallas grid
// (B*nc, H) recomputes it for every head, which is half of its operations.
// Here one block takes kHeads = 8 heads of one chunk: it computes G once
// into registers, then for each head forms G * decay in shared memory and
// runs the two products.  One block per chunk and all 32 heads would make
// G once per chunk, but gives only 256 blocks for 132 SMs (two waves, the
// second half empty); 8 heads per block gives 1,024 blocks and computes G
// 4 times per chunk instead of 32.  Q = 128 and N = 128 in float32 make B
// and C 64 KB each, above the 48 KB static limit, so the block uses
// dynamic shared memory (B, then C aliased with G * decay, dtx of one head
// and cum: 165 KB at the full shape, set with cudaFuncSetAttribute).
//
// Every product is a 256-thread register tile: thread (ty, tx) of a 16 x 16
// grid owns rows ty + 16 r and columns tx + 16 c (r, c < 8), so one block
// covers up to 128 x 128 outputs and neighbouring threads read
// neighbouring shared-memory words.  Rows of B, C and G * decay are padded
// by one float so that a column walk does not hit one bank.  Each output
// is a fixed-order fmaf chain, so two launches give bitwise-equal results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
