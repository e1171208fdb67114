// Hopper (sm_90a) kernel for blockwise online-softmax attention with GQA,
// causal and sliding-window masks, bound to Python through a plain C
// interface and ctypes (repro_torch/kernels/flash_attention.py).  It
// replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_flash_kernel).
//
//   o[b, i, h] = sum_j softmax_j(q_i . k_j d^-1/2 | mask) v_j,
//   kv head of query head h = h / (H / KVH),
//   visible iff j < Lk, (causal) j <= i, (window w) j > i - w,
//
// masked scores take -1e30, the running max, normalizer and accumulator
// are float32, and the output is in q's dtype.  Positions are arange(L) on
// both sides, so the kernel takes Lq == Lk (the wrapper checks).
//
// What bounds it on an H100.  At yi-6b's prefill (B = 1, L = 8192, 32
// query heads, 4 kv heads, d = 128) causal attention is about 5.5e11
// operations against 151 MB of q, k, v and o, so the arithmetic bounds it:
// 0.56 ms on bf16 tensor cores (989 TFLOP/s), 8.2 ms on float32 CUDA cores
// (67 TFLOP/s).  This first kernel is the simple correct one: every
// product runs in float32 on CUDA cores (bf16 inputs are widened on load;
// float32 inputs get true float32, never TF32), so it cannot beat the
// 8.2 ms floor; wgmma and TMA are a later kernel's work.
//
// Design.  One block per (q tile of 64 rows, query head, batch row), 256
// threads in a 16 x 16 grid; thread (ty, tx) owns score rows ty + 16 r and
// columns tx + 16 c (r, c < 4) and output columns tx + 16 c (c < d / 16),
// so neighbouring threads read neighbouring shared-memory words and the
// 16 threads of one row are one half-warp, which reduces the row's max
// and sum with a fixed xor butterfly.  The sequential kv axis of the
// Pallas grid is the loop inside the block: a 64-row K and V tile is
// staged in shared memory, the 64 x 64 scores stay in registers, the
// probabilities go through shared memory into P V.  Causal and window
// masks let the loop skip kv tiles that no row of the q tile can see
// (exact: every row sees its own position, so a skipped tile would only
// have added terms that the online rescale multiplies by exp(-1e30) = 0),
// which halves the causal work; q tiles are scheduled longest first.  GQA
// reads the shared kv head in place, never expanded.  No atomics: two
// launches give bitwise-equal outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kRows = kBlockQ / kSide;   // score rows per thread
constexpr int kCols = kBlockK / kSide;   // score columns per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Fixed xor butterfly over the 16 lanes of one half-warp (one score row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// q, o (B, L, H, D); k, v (B, L, KVH, D); all contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int L, int H, int KVH, int causal,
             int window, float scale, T* __restrict__ o) {
  constexpr int DS = D + 1;               // padded row of Q and K
  constexpr int PS = kBlockK + 1;         // padded row of P
  constexpr int DC = D / kSide;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // kBlockQ x DS, pre-scaled
  float* Ks = Qs + kBlockQ * DS;          // kBlockK x DS
  float* Vs = Ks + kBlockK * DS;          // kBlockK x D
  float* Ps = Vs + kBlockK * D;           // kBlockQ x PS

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D, i = q0 + r;
    Qs[r * DS + d] =
        i < L ? to_f32(q[(((int64_t)b * L + i) * H + h) * D + d]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  // kv tiles that some row of this q tile can see
  const int q_last = min(q0 + kBlockQ, L) - 1;
  const int k_end = causal ? q_last + 1 : L;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e - r * D, j = k0 + r;
      const int64_t src = (((int64_t)b * L + j) * KVH + kvh) * D + d;
      Ks[r * DS + d] = j < L ? to_f32(k[src]) : 0.f;
      Vs[r * D + d] = j < L ? to_f32(v[src]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] = Qs[(ty + kSide * r) * DS + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) bk[c] = Ks[(tx + kSide * c) * DS + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = q0 + ty + kSide * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = k0 + tx + kSide * c;
        bool vis = j < L;
        if (causal) vis = vis && j <= i;
        if (window > 0) vis = vis && j > i - window;
        if (!vis) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float corr = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty + kSide * r) * PS + tx + kSide * c] = p;
        sum += p;
      }
      l[r] = l[r] * corr + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float p[kRows], x[DC];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = Ps[(ty + kSide * r) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) x[c] = Vs[j * D + tx + kSide * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + ty + kSide * r;
    if (i >= L) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = o + (((int64_t)b * L + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(dst + tx + kSide * c, acc[r][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, int B, int L,
                   int H, int KVH, int causal, int window, void* o,
                   cudaStream_t s) {
  constexpr int DS = D + 1;
  const size_t bytes =
      sizeof(float) * ((size_t)kBlockQ * DS + (size_t)kBlockK * DS +
                       (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockQ - 1) / kBlockQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), L, H, KVH, causal, window,
      1.f / sqrtf((float)D), static_cast<T*>(o));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, int B,
                     int L, int H, int KVH, int D, int causal, int window,
                     void* o, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, B, L, H, KVH, causal, window, o, s);
    case 32: return launch<T, 32>(q, k, v, B, L, H, KVH, causal, window, o, s);
    case 64: return launch<T, 64>(q, k, v, B, L, H, KVH, causal, window, o, s);
    case 128: return launch<T, 128>(q, k, v, B, L, H, KVH, causal, window, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           int dtype, int B, int L, int H, int KVH, int D,
                           int causal, int window, void* o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(q, k, v, B, L, H, KVH, D, causal, window, o, s)
          : dispatch<__nv_bfloat16>(q, k, v, B, L, H, KVH, D, causal, window,
                                    o, s);
  return (int)err;
}

}  // extern "C"
