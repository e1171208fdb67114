// flash_kernel and flash_wide_kernel, the CUDA-core routes of the port's
// flash attention: their notes are flash_attention.cu's.  Included by
// flash_attention.cu (float32 and bf16 at head dims 16-128, the checked
// float32 route) and flash_contract.cu (float16, the widths past those and
// flash_wide_kernel), so that nvcc builds the two beside each other; each
// source instantiates what it launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
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

// The kv tiles that some row of the q tile starting at q0 can see: keys
// [begin, end), begin a multiple of kBlockK.
__device__ __forceinline__ int2 visible_keys(int q0, int Lq, int Lk,
                                             int causal, int window) {
  const int q_last = min(q0 + kBlockQ, Lq) - 1;
  const int k_end = causal ? min(q_last + 1, Lk) : Lk;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;
  return make_int2(k_begin, k_end);
}

// One kv tile's online-softmax step on the scores s (thread (ty, tx): rows
// ty + 16 r, keys k0 + tx + 16 c): mask, update the running max m and
// normalizer l, rescale the accumulator, write the probabilities to Ps.
template <int DC>
__device__ __forceinline__ void softmax_tile(float (&s)[kRows][kCols],
                                             float (&m)[kRows],
                                             float (&l)[kRows],
                                             float (&acc)[kRows][DC], int q0,
                                             int k0, int Lk, int causal,
                                             int window, int ty, int tx,
                                             float* Ps) {
  constexpr int PS = kBlockK + 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + ty + kSide * r;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = k0 + tx + kSide * c;
      bool vis = j < Lk;
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
}

// acc += P V over one kv tile: Vs holds the tile's columns of this block,
// ldv floats a row; thread tx owns columns tx + 16 c.
template <int DC>
__device__ __forceinline__ void pv_tile(float (&acc)[kRows][DC],
                                        const float* Ps, const float* Vs,
                                        int ldv, int ty, int tx) {
  constexpr int PS = kBlockK + 1;
#pragma unroll 4
  for (int j = 0; j < kBlockK; ++j) {
    float p[kRows], x[DC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) p[r] = Ps[(ty + kSide * r) * PS + j];
#pragma unroll
    for (int c = 0; c < DC; ++c) x[c] = Vs[j * ldv + tx + kSide * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
  }
}

// Rows of the finished q tile, columns c0 + tx + 16 c below dim.
template <typename T, int DC>
__device__ __forceinline__ void store_rows(const float (&acc)[kRows][DC],
                                           const float (&l)[kRows], T* o,
                                           int b, int h, int q0, int Lq,
                                           int H, int dim, int c0, int ty,
                                           int tx) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + ty + kSide * r;
    if (i >= Lq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = o + (((int64_t)b * Lq + i) * H + h) * dim;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = c0 + tx + kSide * c;
      if (col < dim) store(dst + col, acc[r][c] * inv);
    }
  }
}

// q, o (B, Lq, H, dim); k, v (B, Lk, KVH, dim); all contiguous.  D is the
// instantiated width, dim <= D the true head dim: columns past dim load as
// zeros (adding exactly 0 to every score) and are not stored.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, int Lq, int Lk, int H, int KVH,
             int dim, int causal, int window, float scale,
             T* __restrict__ o) {
  constexpr int DS = D + 1;               // padded row of Q and K
  constexpr int DC = D / kSide;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // kBlockQ x DS, pre-scaled
  float* Ks = Qs + kBlockQ * DS;          // kBlockK x DS
  float* Vs = Ks + kBlockK * DS;          // kBlockK x D
  float* Ps = Vs + kBlockK * D;           // kBlockQ x (kBlockK + 1)

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D, i = q0 + r;
    Qs[r * DS + d] = i < Lq && d < dim
        ? to_f32(q[(((int64_t)b * Lq + i) * H + h) * dim + d]) * scale
        : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int2 keys = visible_keys(q0, Lq, Lk, causal, window);
  for (int k0 = keys.x; k0 < keys.y; k0 += kBlockK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, d = e - r * D, j = k0 + r;
      const bool in = j < Lk && d < dim;
      const int64_t src = (((int64_t)b * Lk + j) * KVH + kvh) * dim + d;
      Ks[r * DS + d] = in ? to_f32(k[src]) : 0.f;
      Vs[r * D + d] = in ? to_f32(v[src]) : 0.f;
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

    softmax_tile<DC>(s, m, l, acc, q0, k0, Lk, causal, window, ty, tx, Ps);
    __syncthreads();
    pv_tile<DC>(acc, Ps, Vs, D, ty, tx);
  }
  store_rows<T, DC>(acc, l, o, b, h, q0, Lq, H, dim, 0, ty, tx);
}

// flash_wide_kernel: head dims past the widest flash_kernel (kMaxWidth).
// Block (q tile, head x column slice, batch row) writes kWideCols output
// columns; it computes the scores over d in chunks of kWideChunk columns
// of Q and K staged in shared memory (each score the same ascending fmaf
// chain as flash_kernel's, zeros past dim), so every slice of a row
// recomputes the same scores and softmax.  Fixed order, no atomics.
constexpr int kMaxWidth = 256;
constexpr int kWideChunk = 64;
constexpr int kWideCols = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, int Lq, int Lk, int H, int KVH,
                  int dim, int causal, int window, float scale,
                  T* __restrict__ o) {
  constexpr int CS = kWideChunk + 1;
  constexpr int DC = kWideCols / kSide;
  extern __shared__ float smem[];
  float* Qs = smem;                       // kBlockQ x CS, pre-scaled
  float* Ks = Qs + kBlockQ * CS;          // kBlockK x CS
  float* Vs = Ks + kBlockK * CS;          // kBlockK x kWideCols
  float* Ps = Vs + kBlockK * kWideCols;   // kBlockQ x (kBlockK + 1)

  const int slices = (dim + kWideCols - 1) / kWideCols;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y / slices, c0 = blockIdx.y % slices * kWideCols;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  const int2 keys = visible_keys(q0, Lq, Lk, causal, window);
  for (int k0 = keys.x; k0 < keys.y; k0 += kBlockK) {
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
    for (int d0 = 0; d0 < dim; d0 += kWideChunk) {
      __syncthreads();  // the previous chunk (and tile) is consumed
      for (int e = tid; e < kBlockQ * kWideChunk; e += kThreads) {
        const int r = e / kWideChunk, d = e - r * kWideChunk;
        const int i = q0 + r, j = k0 + r, dd = d0 + d;
        Qs[r * CS + d] = i < Lq && dd < dim
            ? to_f32(q[(((int64_t)b * Lq + i) * H + h) * dim + dd]) * scale
            : 0.f;
        Ks[r * CS + d] = j < Lk && dd < dim
            ? to_f32(k[(((int64_t)b * Lk + j) * KVH + kvh) * dim + dd])
            : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < kWideChunk; ++d) {
        float a[kRows], bk[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[r] = Qs[(ty + kSide * r) * CS + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) bk[c] = Ks[(tx + kSide * c) * CS + d];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
      }
    }
    for (int e = tid; e < kBlockK * kWideCols; e += kThreads) {
      const int r = e / kWideCols, d = e - r * kWideCols;
      const int j = k0 + r, dd = c0 + d;
      Vs[e] = j < Lk && dd < dim
          ? to_f32(v[(((int64_t)b * Lk + j) * KVH + kvh) * dim + dd])
          : 0.f;
    }
    softmax_tile<DC>(s, m, l, acc, q0, k0, Lk, causal, window, ty, tx, Ps);
    __syncthreads();
    pv_tile<DC>(acc, Ps, Vs, kWideCols, ty, tx);
  }
  store_rows<T, DC>(acc, l, o, b, h, q0, Lq, H, dim, c0, ty, tx);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, int B, int Lq,
                   int Lk, int H, int KVH, int dim, int causal, int window,
                   void* o, cudaStream_t s) {
  constexpr int DS = D + 1;
  const size_t bytes =
      sizeof(float) * ((size_t)kBlockQ * DS + (size_t)kBlockK * DS +
                       (size_t)kBlockK * D + (size_t)kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBlockQ - 1) / kBlockQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Lq, Lk, H, KVH, dim, causal, window,
      1.f / sqrtf((float)dim), static_cast<T*>(o));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, int B,
                        int Lq, int Lk, int H, int KVH, int dim, int causal,
                        int window, void* o, cudaStream_t s) {
  const size_t bytes =
      sizeof(float) * ((size_t)kBlockQ * (kWideChunk + 1) +
                       (size_t)kBlockK * (kWideChunk + 1) +
                       (size_t)kBlockK * kWideCols +
                       (size_t)kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long slices = (dim + kWideCols - 1) / kWideCols;
  if (H * slices > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((Lq + kBlockQ - 1) / kBlockQ, (unsigned)(H * slices), B);
  flash_wide_kernel<T><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Lq, Lk, H, KVH, dim, causal, window,
      1.f / sqrtf((float)dim), static_cast<T*>(o));
  return cudaGetLastError();
}

}  // namespace
