// The loaded route of flash_wgmma_kernel (flash_wgmma.cuh; its notes are
// flash_attention.cu's): bf16 and float16 q, k and v that TMA cannot read,
// because one of them starts off a 16-byte boundary or the head dim is not
// a multiple of 8, on the tensor cores all the same.  A producer warpgroup
// loads every Q, K and V tile from any 2-byte-aligned address into the
// swizzled layout TMA would have written; the consumers' arithmetic is the
// TMA route's.  It replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention on those inputs.
// A source of its own, so that nvcc builds its six instantiations beside
// the other sources.

#include "flash_wgmma.cuh"

extern "C" {

// dtype 1 (bf16) or 2 (float16) q, k, v and o, contiguous, each at any
// 2-byte boundary; head dim D from 1 to 256 at the width of wg::width_of.
int flash_attention_wgmma_loaded_launch(int dtype, const void* q,
                                        const void* k, const void* v, int B,
                                        int Lq, int Lk, int H, int KVH, int D,
                                        int causal, int window, void* o,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 4 * wg::kAtom) return (int)cudaErrorInvalidValue;
  const int w = wg::width_of(D);
#define WG_ARGS q, k, v, B, Lq, Lk, H, KVH, D, causal, window, o, s
  if (dtype == 1) {
    if (w == 64) return (int)wg::launch_loaded<__nv_bfloat16, 64>(WG_ARGS);
    if (w == 128) return (int)wg::launch_loaded<__nv_bfloat16, 128>(WG_ARGS);
    return (int)wg::launch_loaded<__nv_bfloat16, 256>(WG_ARGS);
  }
  if (dtype == 2) {
    if (w == 64) return (int)wg::launch_loaded<__half, 64>(WG_ARGS);
    if (w == 128) return (int)wg::launch_loaded<__half, 128>(WG_ARGS);
    return (int)wg::launch_loaded<__half, 256>(WG_ARGS);
  }
#undef WG_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
