// flash_kernel and flash_wide_kernel, the CUDA-core routes of the port's
// flash attention: their notes are flash_attention.cu's.  flash_kernel
// takes float32 alone (every 16-bit input up to head dim 256 runs on the
// tensor cores, TMA-fed or, off TMA's 16-byte alignment, fed by
// flash_wgmma.cuh's own loader); flash_wide_kernel takes every dtype past
// 256 and reads any alignment itself: cp.async where the base and row
// stride allow it (16 bytes, or 4 for float32), flash_load.cuh's
// byte-permute loads for 16-bit rows that start off a 4-byte boundary,
// which no cp.async can copy.  Included by flash_attention.cu (float32 at
// head dims 16-128, the checked float32 route) and flash_contract.cu
// (float32 at width 256 and flash_wide_kernel), so that nvcc builds the
// two beside each other; each source instantiates what it launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_load.cuh"
#include "hopper.cuh"

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

// The kv tiles that some row of the q tile of `rows` rows starting at q0
// can see: keys [begin, end), begin a multiple of kBlockK.
__device__ __forceinline__ int2 visible_keys(int q0, int Lq, int Lk,
                                             int causal, int window,
                                             int rows = kBlockQ) {
  const int q_last = min(q0 + rows, Lq) - 1;
  const int k_end = causal ? min(q_last + 1, Lk) : Lk;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBlockK * kBlockK;
  return make_int2(k_begin, k_end);
}

// One kv tile's online-softmax step on the scores s (thread (ty, tx): rows
// ty + 16 r, keys k0 + tx + 16 c): mask, update the running max m and
// normalizer l, rescale the accumulator, write the probabilities to Ps.
template <int DC, int RT = kRows>
__device__ __forceinline__ void softmax_tile(float (&s)[RT][kCols],
                                             float (&m)[RT], float (&l)[RT],
                                             float (&acc)[RT][DC], int q0,
                                             int k0, int Lk, int causal,
                                             int window, int ty, int tx,
                                             float* Ps) {
  constexpr int PS = kBlockK + 1;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
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

// flash_wide_kernel: head dims past the widest flash_kernel (kMaxWidth),
// each score computed once per (q tile, head); its notes are
// flash_attention.cu's.
constexpr int kMaxWidth = 256;
constexpr int kWideChunk = 64;   // columns of d in one staged K chunk

// A block of 16 RT q rows (RT score rows a thread: 4, 2 or 1) keeps
// kOutCols output columns (512, 1024, 2048) in registers, 128 floats a
// thread, and stages V over all of them kVKeys keys at a time.
template <int RT>
struct Wide {
  static constexpr int kRowsQ = kSide * RT;
  static constexpr int kOutCols = 2048 / RT;
  static constexpr int kDC = kOutCols / kSide;   // output columns a thread
  static constexpr int kVKeys = 4 * RT;
  static constexpr int kQS = kOutCols + 4;       // floats a resident Q row
  static constexpr int kPS = kBlockK + 1;        // floats a P row
};

// The two staging buffers of element type T: a K chunk (kBlockK keys x
// kWideChunk columns) or a V chunk (kVKeys keys x kOutCols columns), each
// row padded by 16 bytes (rows stay 16-byte aligned for cp.async, and a
// quarter-warp's 16-byte reads of eight K rows fall in distinct banks).
template <typename T, int RT>
struct WideStage {
  static constexpr int kPad = 16 / (int)sizeof(T);
  static constexpr int kKS = kWideChunk + kPad;
  static constexpr int kVS = Wide<RT>::kOutCols + kPad;
  static constexpr int kKBytes = kBlockK * kKS * (int)sizeof(T);
  static constexpr int kVBytes = Wide<RT>::kVKeys * kVS * (int)sizeof(T);
  static constexpr int kBytes = kKBytes > kVBytes ? kKBytes : kVBytes;
};

// How a block stages k or v: cp.async of 16 bytes (a 16-byte-aligned base
// and row stride), of 4 bytes (float32 at any offset), or the byte-permute
// loads of flash_load.cuh (16-bit at any 2-byte boundary; synchronous).
enum WideMode { kWideCp16 = 0, kWideCp4 = 1, kWideBytes = 2 };

template <typename T>
int wide_mode(const void* p, int dim) {
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && (dim * sizeof(T)) % 16 == 0)
    return kWideCp16;
  return sizeof(T) == 4 ? kWideCp4 : kWideBytes;
}

// Rows [r0, r0 + rows) x columns [col0, col0 + cols) of one head of a
// contiguous (B, L, heads, dim) tensor into `buf` (ld elements a row),
// zeros past L and past dim; cols a multiple of 8.
template <typename T>
__device__ __forceinline__ void wide_stage(uint8_t* buf, int ld,
                                           const T* src, int b, int L,
                                           int heads, int head, int dim,
                                           int r0, int rows, int col0,
                                           int cols, int mode, int tid) {
  constexpr int ES = (int)sizeof(T);
  auto row_of = [&](int j) {
    return src + (((int64_t)b * L + j) * heads + head) * dim;
  };
  if constexpr (ES == 2) {
    if (mode == kWideBytes) {
      const int units = cols / 8;
      for (int e = tid; e < rows * units; e += kThreads) {
        const int r = e / units, u = e - r * units, j = r0 + r;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (j < L) x = flash_load::row_chunk(row_of(j) + col0, u, dim - col0);
        *reinterpret_cast<uint4*>(buf + ((size_t)r * ld + 8 * u) * ES) = x;
      }
      return;
    }
  }
  if (mode == kWideCp16) {
    constexpr int U = 16 / ES;
    const int units = cols / U;
    for (int e = tid; e < rows * units; e += kThreads) {
      const int r = e / units, u = e - r * units, j = r0 + r;
      const int col = col0 + U * u;
      uint8_t* dst = buf + ((size_t)r * ld + U * u) * ES;
      if (j < L && col < dim)
        hopper::cp_async16(hopper::smem_u32(dst), row_of(j) + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {   // kWideCp4: float32
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols, j = r0 + r;
      const int col = col0 + c;
      uint8_t* dst = buf + ((size_t)r * ld + c) * ES;
      if (j < L && col < dim)
        hopper::cp_async4(hopper::smem_u32(dst), row_of(j) + col);
      else
        *reinterpret_cast<float*>(dst) = 0.f;
    }
  }
}

__device__ __forceinline__ float2 pair_f32(uint32_t w, const __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}
__device__ __forceinline__ float2 pair_f32(uint32_t w, const __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

// s[r][c] += Q K^T over the first ncols columns of a staged K chunk (ncols
// a multiple of 8; columns past dim are zeros in Q and K): thread (ty, tx)
// takes rows ty + 16 r and keys tx + 16 c, each score one ascending fmaf
// chain over d, as flash_kernel's.  qb: the chunk's first column of Q (qs
// floats a row, pre-scaled).
template <typename T, int RT>
__device__ __forceinline__ void wide_scores(float (&s)[RT][kCols],
                                            const float* qb, int qs,
                                            const uint8_t* kbuf, int ncols,
                                            int ty, int tx) {
  constexpr int KS = WideStage<T, RT>::kKS;
  if constexpr (sizeof(T) == 4) {
    const float* kb = reinterpret_cast<const float*>(kbuf);
#pragma unroll 2
    for (int d = 0; d < ncols; d += 4) {
      float4 a[RT], bk[kCols];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        a[r] = *reinterpret_cast<const float4*>(qb + (ty + kSide * r) * qs + d);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        bk[c] = *reinterpret_cast<const float4*>(kb + (tx + kSide * c) * KS + d);
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[r][c] = fmaf(a[r].x, bk[c].x, s[r][c]);
          s[r][c] = fmaf(a[r].y, bk[c].y, s[r][c]);
          s[r][c] = fmaf(a[r].z, bk[c].z, s[r][c]);
          s[r][c] = fmaf(a[r].w, bk[c].w, s[r][c]);
        }
    }
  } else {
    const T* kb = reinterpret_cast<const T*>(kbuf);
    for (int d = 0; d < ncols; d += 8) {
      uint4 raw[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        raw[c] = *reinterpret_cast<const uint4*>(kb + (tx + kSide * c) * KS + d);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
          a[r] = *reinterpret_cast<const float4*>(qb + (ty + kSide * r) * qs +
                                                  d + 4 * half);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float2 k01 = pair_f32(half ? raw[c].z : raw[c].x, kb);
          const float2 k23 = pair_f32(half ? raw[c].w : raw[c].y, kb);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            s[r][c] = fmaf(a[r].x, k01.x, s[r][c]);
            s[r][c] = fmaf(a[r].y, k01.y, s[r][c]);
            s[r][c] = fmaf(a[r].z, k23.x, s[r][c]);
            s[r][c] = fmaf(a[r].w, k23.y, s[r][c]);
          }
        }
      }
    }
  }
}

// acc += P V over the kVKeys keys of a staged V chunk, keys jbase.. of the
// tile's P.  Thread tx owns four neighbouring columns of each group of 64,
// 64 g + 4 tx + e (acc[r][4 g + e]), read with one vector load a group;
// groups past the first ngroups lie past dim and are skipped.
template <typename T, int RT>
__device__ __forceinline__ void pv_wide(float (&acc)[RT][Wide<RT>::kDC],
                                        const float* Ps, const uint8_t* vbuf,
                                        int jbase, int ngroups, int ty,
                                        int tx) {
  using G = Wide<RT>;
  constexpr int VS = WideStage<T, RT>::kVS;
  const T* vb = reinterpret_cast<const T*>(vbuf);
#pragma unroll 2
  for (int j = 0; j < G::kVKeys; ++j) {
    float p[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) p[r] = Ps[(ty + kSide * r) * G::kPS + jbase + j];
#pragma unroll
    for (int g = 0; g < G::kDC / 4; ++g) {
      if (g < ngroups) {
        const T* src = vb + j * VS + 64 * g + 4 * tx;
        float x[4];
        if constexpr (sizeof(T) == 4) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          const float2 a = pair_f32(w.x, vb), b = pair_f32(w.y, vb);
          x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < RT; ++r)
            acc[r][4 * g + e] = fmaf(p[r], x[e], acc[r][4 * g + e]);
      }
    }
  }
}

// q, o (B, Lq, H, dim); k, v (B, Lk, KVH, dim); all contiguous, dim >
// kMaxWidth.  Block (q tile of 16 RT rows, head x column slice, batch
// row); one slice while dim <= kOutCols.  Each kv tile is a stream of
// K chunks (S over all of d) and V chunks (P V over the block's columns),
// double-buffered through `stage`: chunk i + 1 loads while chunk i runs.
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, int Lq, int Lk, int H, int KVH,
                  int dim, int causal, int window, float scale, int kmode,
                  int vmode, T* __restrict__ o) {
  using G = Wide<RT>;
  using S = WideStage<T, RT>;
  constexpr int DC = G::kDC;
  extern __shared__ __align__(16) uint8_t wide_smem[];
  float* Qs = reinterpret_cast<float*>(wide_smem);   // kRowsQ x kQS
  float* Ps = Qs + G::kRowsQ * G::kQS;               // kRowsQ x kPS
  uint8_t* stage = reinterpret_cast<uint8_t*>(Ps + G::kRowsQ * G::kPS);

  const int slices = (dim + G::kOutCols - 1) / G::kOutCols;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest rows first
  const int h = blockIdx.y / slices, c0 = blockIdx.y % slices * G::kOutCols;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * G::kRowsQ;
  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  // Q stays resident, pre-scaled, while it fits; past kOutCols (a second
  // slice) each K chunk's columns of Q are staged beside it
  const bool resident = dim <= G::kOutCols;
  const int nkc = (dim + kWideChunk - 1) / kWideChunk;   // K chunks a tile
  constexpr int kNvc = kBlockK / G::kVKeys;             // V chunks a tile
  const int n_per = nkc + kNvc;
  const int vcols = min(G::kOutCols, (dim - c0 + 63) / 64 * 64);
  const int ngroups = vcols / 64;
  auto q_at = [&](int i, int c) {
    return i < Lq && c < dim
        ? to_f32(q[(((int64_t)b * Lq + i) * H + h) * dim + c]) * scale
        : 0.f;
  };

  if (resident) {
    const int qcols = min(G::kOutCols, (dim + 7) / 8 * 8);
    for (int e = tid; e < G::kRowsQ * qcols; e += kThreads) {
      const int r = e / qcols, c = e - r * qcols;
      Qs[r * G::kQS + c] = q_at(q0 + r, c);
    }
  }

  float m[RT], l[RT], acc[RT][DC], s[RT][kCols];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
  }

  const int2 keys = visible_keys(q0, Lq, Lk, causal, window, G::kRowsQ);
  const int k_begin = keys.x;
  const int n_tiles = max(0, (keys.y - keys.x + kBlockK - 1) / kBlockK);
  const int n_total = n_tiles * n_per;

  auto issue = [&](int i) {
    const int t = i / n_per, part = i - t * n_per;
    const int k0 = k_begin + t * kBlockK;
    uint8_t* buf = stage + (i & 1) * S::kBytes;
    if (part < nkc)
      wide_stage<T>(buf, S::kKS, k, b, Lk, KVH, kvh, dim, k0, kBlockK,
                    part * kWideChunk, kWideChunk, kmode, tid);
    else
      wide_stage<T>(buf, S::kVS, v, b, Lk, KVH, kvh, dim,
                    k0 + (part - nkc) * G::kVKeys, G::kVKeys, c0, vcols,
                    vmode, tid);
  };

  if (n_total > 0) issue(0);
  hopper::cp_async_commit();
  for (int i = 0; i < n_total; ++i) {
    if (i + 1 < n_total) issue(i + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();   // chunk i has landed (this thread's part)
    const int t = i / n_per, part = i - t * n_per;
    const int k0 = k_begin + t * kBlockK;
    if (!resident && part < nkc) {
      for (int e = tid; e < G::kRowsQ * kWideChunk; e += kThreads) {
        const int r = e / kWideChunk, c = e - r * kWideChunk;
        Qs[r * (kWideChunk + 4) + c] = q_at(q0 + r, part * kWideChunk + c);
      }
    }
    __syncthreads();   // every thread's part of chunk i (and P) is in place
    const uint8_t* buf = stage + (i & 1) * S::kBytes;
    if (part < nkc) {
      if (part == 0) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) s[r][c] = 0.f;
      }
      const int ncols = min(kWideChunk, (dim - part * kWideChunk + 7) / 8 * 8);
      wide_scores<T, RT>(s, resident ? Qs + part * kWideChunk : Qs,
                         resident ? G::kQS : kWideChunk + 4, buf, ncols, ty,
                         tx);
      if (part == nkc - 1)
        softmax_tile<DC, RT>(s, m, l, acc, q0, k0, Lk, causal, window, ty, tx,
                             Ps);
    } else {
      pv_wide<T, RT>(acc, Ps, buf, (part - nkc) * G::kVKeys, ngroups, ty, tx);
    }
    __syncthreads();   // chunk i's buffer is free for chunk i + 2
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = q0 + ty + kSide * r;
    if (i >= Lq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = o + (((int64_t)b * Lq + i) * H + h) * dim;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = c0 + 64 * (c / 4) + 4 * tx + c % 4;
      if (col < dim) store(dst + col, acc[r][c] * inv);
    }
  }
}

template <typename T, int RT>
cudaError_t launch_wide_rows(const void* q, const void* k, const void* v,
                             int B, int Lq, int Lk, int H, int KVH, int dim,
                             int causal, int window, void* o,
                             cudaStream_t s) {
  using G = Wide<RT>;
  const size_t bytes =
      sizeof(float) * ((size_t)G::kRowsQ * G::kQS + (size_t)G::kRowsQ * G::kPS) +
      2 * (size_t)WideStage<T, RT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  const long long slices = (dim + G::kOutCols - 1) / G::kOutCols;
  if (H * slices > 65535 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((Lq + G::kRowsQ - 1) / G::kRowsQ, (unsigned)(H * slices), B);
  flash_wide_kernel<T, RT><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Lq, Lk, H, KVH, dim, causal, window,
      1.f / sqrtf((float)dim), wide_mode<T>(k, dim), wide_mode<T>(v, dim),
      static_cast<T*>(o));
  return cudaGetLastError();
}

// Head dims past kMaxWidth: 64 q rows a block up to 512, 32 up to 1024,
// 16 beyond (column slices of 2048 past that).
template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, int B,
                        int Lq, int Lk, int H, int KVH, int dim, int causal,
                        int window, void* o, cudaStream_t s) {
#define WIDE_ARGS q, k, v, B, Lq, Lk, H, KVH, dim, causal, window, o, s
  if (dim <= kMaxWidth || KVH < 1 || H % KVH || Lk < 1)
    return cudaErrorInvalidValue;
  if (dim <= Wide<4>::kOutCols) return launch_wide_rows<T, 4>(WIDE_ARGS);
  if (dim <= Wide<2>::kOutCols) return launch_wide_rows<T, 2>(WIDE_ARGS);
  return launch_wide_rows<T, 1>(WIDE_ARGS);
#undef WIDE_ARGS
}

}  // namespace
