// The flash-attention launches flash_attention.cu leaves (flash_simt.cuh
// and flash_wgmma.cuh have the kernels, flash_attention.cu their notes):
// TMA's flash_wgmma_kernel on float16 at widths 64, 128 and 256 and on bf16
// at width 256 (head dims 136-256), flash_kernel at width 256 for float32
// head dims 129-256, and flash_wide_kernel past 256 in every dtype.  16-bit
// inputs TMA cannot read (off a 16-byte boundary, or a head dim that is not
// a multiple of 8) take flash_loaded.cu's route: the same tensor-core
// kernel with a producer warpgroup of its own in place of TMA, since a
// tensor map needs a 16-byte base and 16-byte row strides.  They replace
// the Pallas TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// on the inputs it takes that no config of this repository gives it.  A
// source of its own, so that nvcc builds it beside flash_attention.cu.

#include <type_traits>

#include "flash_simt.cuh"
#include "flash_wgmma.cuh"

namespace {

// float32 past 128 (flash_attention.cu launches every float32 head dim up
// to 128 itself): flash_kernel at width 256 up to kMaxWidth; every dtype
// past kMaxWidth: flash_wide_kernel.  16-bit inputs up to kMaxWidth run on
// the tensor cores (flash_wgmma.cuh), never here.
template <typename T>
cudaError_t dispatch_wide(const void* q, const void* k, const void* v, int B,
                          int Lq, int Lk, int H, int KVH, int D, int causal,
                          int window, void* o, cudaStream_t s) {
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (D > kMaxWidth) return launch_wide<T>(FLASH_ARGS);
  if constexpr (std::is_same<T, float>::value) {
    if (D > 128) return launch<T, kMaxWidth>(FLASH_ARGS);
  }
  return cudaErrorInvalidValue;
#undef FLASH_ARGS
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16; flash_attention_launch sends
// here every call it does not launch itself.
int flash_contract_launch(const void* q, const void* k, const void* v,
                          int dtype, int B, int Lq, int Lk, int H, int KVH,
                          int D, int causal, int window, void* o,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KVH < 1 || H % KVH || Lk < 1) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  switch (dtype) {
    case 0: return (int)dispatch_wide<float>(FLASH_ARGS);
    case 1: return (int)dispatch_wide<__nv_bfloat16>(FLASH_ARGS);
    case 2: return (int)dispatch_wide<__half>(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

// The tensor-core kernel on what flash_attention.cu does not instantiate:
// dtype 1 (bf16) at width 256, dtype 2 (float16) at every width.  D a
// multiple of 8 up to 256, q, k, v and o 16-byte aligned (wg::launch).
int flash_wgmma_contract_launch(int dtype, const void* q, const void* k,
                                const void* v, int B, int Lq, int Lk, int H,
                                int KVH, int D, int causal, int window,
                                void* o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 4 * wg::kAtom) return (int)cudaErrorInvalidValue;
  const int w = wg::width_of(D);
#define WG_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (dtype == 1 && w == 256)
    return (int)wg::launch<__nv_bfloat16, 256>(WG_ARGS);
  if (dtype == 2) {
    if (w == 64) return (int)wg::launch<__half, 64>(WG_ARGS);
    if (w == 128) return (int)wg::launch<__half, 128>(WG_ARGS);
    return (int)wg::launch<__half, 256>(WG_ARGS);
  }
#undef WG_ARGS
  return (int)cudaErrorInvalidValue;
}

// float16 q, k, v and o (16-byte aligned) with D a multiple of 8 up to 256,
// on the tensor cores.
int flash_attention_wgmma_f16_launch(const void* q, const void* k,
                                     const void* v, int B, int Lq, int Lk,
                                     int H, int KVH, int D, int causal,
                                     int window, void* o, void* stream) {
  return flash_wgmma_contract_launch(2, q, k, v, B, Lq, Lk, H, KVH, D, causal,
                                     window, o, stream);
}

// Blocks of flash_wgmma_contract_launch's kernel an SM holds at once at
// head dim D; -1 if the query failed or no such kernel is here.
int flash_wgmma_contract_blocks_per_sm(int dtype, int D) {
  if (D < 1 || D > 4 * wg::kAtom) return -1;
  const int w = wg::width_of(D);
  if (dtype == 1) return w == 256 ? wg::blocks_per_sm<__nv_bfloat16, 256>() : -1;
  if (dtype != 2) return -1;
  if (w == 64) return wg::blocks_per_sm<__half, 64>();
  if (w == 128) return wg::blocks_per_sm<__half, 128>();
  return wg::blocks_per_sm<__half, 256>();
}

}  // extern "C"
