// The flash-attention launches flash_attention.cu leaves (flash_simt.cuh
// has the kernels, flash_attention.cu their notes): flash_kernel on float16
// at every head dim up to 256 (the next of the widths 16, 32, 64, 96, 128
// and 256, the true head dim a run-time argument), flash_kernel at width
// 256 for float32 and bf16 head dims 129-256, and flash_wide_kernel past
// 256.  They replace the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention on the inputs it
// takes that no config of this repository gives it.  A source of its own,
// so that nvcc builds it beside flash_attention.cu.

#include "flash_simt.cuh"

namespace {

// Past 128: width 256 up to kMaxWidth, flash_wide_kernel beyond.
// (float32 and bf16 come here only past 128: flash_attention.cu launches
// every head dim up to 128 itself.)
template <typename T>
cudaError_t dispatch_wide(const void* q, const void* k, const void* v, int B,
                          int Lq, int Lk, int H, int KVH, int D, int causal,
                          int window, void* o, cudaStream_t s) {
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (D <= 128) return cudaErrorInvalidValue;
  if (D <= kMaxWidth) return launch<T, kMaxWidth>(FLASH_ARGS);
  return launch_wide<T>(FLASH_ARGS);
#undef FLASH_ARGS
}

// float16 at every head dim: its own width of 16, 32, 64, 96, 128, or the
// next of them, then as dispatch_wide.
cudaError_t dispatch_f16(const void* q, const void* k, const void* v, int B,
                         int Lq, int Lk, int H, int KVH, int D, int causal,
                         int window, void* o, cudaStream_t s) {
#define FLASH_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (D < 1) return cudaErrorInvalidValue;
  if (D <= 16) return launch<__half, 16>(FLASH_ARGS);
  if (D <= 32) return launch<__half, 32>(FLASH_ARGS);
  if (D <= 64) return launch<__half, 64>(FLASH_ARGS);
  if (D <= 96) return launch<__half, 96>(FLASH_ARGS);
  if (D <= 128) return launch<__half, 128>(FLASH_ARGS);
  return dispatch_wide<__half>(FLASH_ARGS);
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
    case 2: return (int)dispatch_f16(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // extern "C"
