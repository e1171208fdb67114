"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attention.cu``),
ported from the Pallas kernel of ``repro/kernels/flash_attention.py``.

Blockwise online-softmax attention with GQA (query head h reads kv head
h // (H / KVH), never expanded), causal and sliding-window masks, float32
running statistics and the output in q's dtype.  The masks are the Pallas
kernel's: query row i and key j both count from 0, and key j is visible
to row i iff j < Lk, (causal) j <= i and (window w) j > i - w, so Lk may
differ from Lq (the encoder-decoder's cross-attention: Lq decoder tokens
over Lk frames).  A row that sees no key (only possible with a window and
Lk < Lq) is outside the contract: the Pallas kernel and
``ref.flash_attention_ref`` already disagree there.  For CPU tensors
``flash_attention`` returns the plain version (``ref.flash_attention_ref``);
for CUDA tensors it checks them, launches one of its kernels on the current
stream and raises if the launch failed — it never falls back.  The kernels
are forward-only (a CUDA input that requires grad raises).

Routing (``route``), by dtype, head dim and alignment, never by a failed
build or launch:

- bf16 or float16 with a head dim that is a multiple of 8 up to 256, q,
  k and v each on a 16-byte boundary -> ``flash_wgmma_kernel`` fed by
  TMA: both products on the tensor cores (wgmma's bf16 or f16 kind), P
  entering P V as a hi/lo pair of the input's type, at a tile width of 64,
  128 or 256 columns (a head dim between runs the next width, the tensor
  maps' true d zero-filling the columns past it; the kernel's notes say
  how).  Counted in ``LAUNCHES["flash_attention_wgmma"]`` for bf16 at head
  dims 64, 96 and 128 (the main paths'), ``["flash_attention_wgmma_f16"]``
  for float16 and ``["flash_attention_wgmma_padded"]`` for bf16 at any
  other head dim.
- every other bf16 or float16 input up to 256 (any of q, k and v off a
  16-byte boundary, or a head dim that is not a multiple of 8) -> the same
  kernel fed by a producer warpgroup of its own
  (``LAUNCHES["flash_attention_wgmma_loaded"]``): it reads each row from
  any 2-byte boundary as aligned 16-byte words shifted into place, and
  writes the swizzled tiles TMA would have written, zeros past d and past
  L.  A tensor map needs a 16-byte base and 16-byte row strides, and
  cp.async a source aligned to its copy size, so neither can read these
  inputs.  At a head dim that is a multiple of 8 the output equals, bit for
  bit, TMA's on the same values.
- float32 with a head dim that is a multiple of 4 up to 128, q, k and v
  each on a 16-byte boundary -> ``flash_wgmma_kernel``'s float32 kind
  (``csrc/flash_f32.cu``): every float32 operand as three bf16 pieces, each
  product the six piece products with a + b < 3 on the tensor cores (never
  TF32), fed by a producer warpgroup that splits the rows it loads,
  ``LAUNCHES["flash_attention_wgmma_f32"]``.
- any other float32 input at head dims 16, 32, 64, 96, 128 ->
  ``flash_kernel``: float32 on CUDA cores, never TF32,
  ``LAUNCHES["flash_attention_simt"]``; a call can ask for it on any
  float32 input up to 256 (``force=SIMT``), to hold and time it beside the
  tensor cores.
- float32 at any other head dim up to 256 -> ``flash_kernel`` at the next
  of those widths or 256, the true head dim a run-time argument (loads past
  it zero-filled, stores skipped), ``LAUNCHES["flash_attention_padded"]``.
- head dims above 256, any dtype -> ``flash_wide_kernel``: one block per
  (q tile, head) computes each score once, Q resident, K and V streamed in
  chunks, ``LAUNCHES["flash_attention_wide"]``.

q, k and v of different dtypes (the Pallas kernel casts each to float32)
are cast to float32 here, exactly: a 16-bit one into a fresh (aligned)
tensor, a float32 one passed on as it is.  The three take the float32
route of their head dim and the float32 inputs' offsets; the output is
cast once to q's dtype.

The reference's ``block_q`` / ``block_k`` are TPU tile sizes; the CUDA
kernels' tiles are fixed and the results do not depend on them, so the
port's signature leaves them out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import check, forward_only, need, on_cuda, ptr, stream


class Route(NamedTuple):
    kernel: str     # the CUDA kernel's name (as a profiler trace shows it)
    counter: str    # its key in LAUNCHES


WGMMA = Route("flash_wgmma_kernel", "flash_attention_wgmma")
WGMMA_F16 = Route("flash_wgmma_kernel", "flash_attention_wgmma_f16")
WGMMA_PADDED = Route("flash_wgmma_kernel", "flash_attention_wgmma_padded")
WGMMA_LOADED = Route("flash_wgmma_kernel", "flash_attention_wgmma_loaded")
WGMMA_F32 = Route("flash_wgmma_kernel", "flash_attention_wgmma_f32")
SIMT = Route("flash_kernel", "flash_attention_simt")
PADDED = Route("flash_kernel", "flash_attention_padded")
WIDE = Route("flash_wide_kernel", "flash_attention_wide")
ROUTES = (WGMMA, WGMMA_F16, WGMMA_PADDED, WGMMA_LOADED, WGMMA_F32, SIMT,
          PADDED, WIDE)
TENSOR_CORE_ROUTES = (WGMMA, WGMMA_F16, WGMMA_PADDED, WGMMA_LOADED, WGMMA_F32)
LAUNCHES = {r.counter: 0 for r in ROUTES}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HALF_DTYPES = (torch.bfloat16, torch.float16)
HEAD_DIMS = (16, 32, 64, 96, 128)   # flash_kernel's own widths
WGMMA_HEAD_DIMS = (64, 96, 128)     # the main paths' tensor-core head dims
MAX_PADDED = 256                    # widest flash_kernel and flash_wgmma_kernel
WGMMA_DIM_STEP = 8                  # a TMA row stride: 16 bytes of 16-bit
F32_DIM_STEP = 4                    # a float32 row of 16-byte words
MAX_F32 = 128                       # widest float32 kind of flash_wgmma_kernel


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def route(dtype: torch.dtype, head_dim: int, aligned: bool = True) -> Route:
    """The kernel a CUDA call with q, k and v of this dtype and head dim
    launches (``aligned``: each of the three starts on a 16-byte
    boundary)."""
    if head_dim > MAX_PADDED:
        return WIDE
    if dtype in HALF_DTYPES:
        if not aligned or head_dim % WGMMA_DIM_STEP:
            return WGMMA_LOADED
        if dtype == torch.float16:
            return WGMMA_F16
        return WGMMA if head_dim in WGMMA_HEAD_DIMS else WGMMA_PADDED
    if aligned and head_dim % F32_DIM_STEP == 0 and head_dim <= MAX_F32:
        return WGMMA_F32
    return flash_kernel_route(head_dim)


def flash_kernel_route(head_dim: int) -> Route:
    """``flash_kernel``'s route for a float32 call of this head dim (up to
    ``MAX_PADDED``)."""
    return SIMT if head_dim in HEAD_DIMS else PADDED


def element_offsets(*tensors: torch.Tensor) -> tuple:
    """Each tensor's start, in its own elements, past a 16-byte boundary."""
    return tuple(t.data_ptr() % 16 // t.element_size() for t in tensors)


def compute_dtype(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.dtype:
    """The dtype a CUDA call runs in: q's when k and v share it, else
    float32 (the wrapper casts all three, exactly)."""
    return q.dtype if q.dtype == k.dtype == v.dtype else torch.float32


def cuda_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Route:
    """Check q, k and v against what the kernels take and return the route
    a CUDA call takes; raise on anything else.  Reads only shapes, dtypes,
    strides and addresses, so it runs on tensors of any device."""
    forward_only("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, L, H, d), got {tuple(q.shape)}")
    B, Lq, H, D = q.shape
    Lk, KVH = (k.shape[1], k.shape[2]) if k.dim() == 4 else (0, 0)
    if D < 1:
        raise ValueError(f"flash_attention takes head dims >= 1, got {D}")
    if KVH < 1 or H % KVH:
        raise ValueError(f"kv heads {KVH} must divide query heads {H}")
    if Lk < 1:
        raise ValueError(f"k must hold at least one key, got {tuple(k.shape)}")
    need(q, "q", (B, Lq, H, D), tuple(_DTYPES))
    need(k, "k", (B, Lk, KVH, D), tuple(_DTYPES))
    need(v, "v", (B, Lk, KVH, D), tuple(_DTYPES))
    dt = compute_dtype(q, k, v)
    # a cast copy (mixed dtypes) is fresh, so aligned; a tensor that is
    # not cast keeps its own offset
    kept = [t for t in (q, k, v) if t.dtype == dt]
    return route(dt, D, not any(element_offsets(*kept)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    force: Route | None = None) -> torch.Tensor:
    """q: (B, Lq, H, d); k/v: (B, Lk, KVH, d), KVH | H.  Returns (B, Lq, H, d).

    ``force=SIMT`` runs a float32 CUDA call on ``flash_kernel`` (counted in
    its own route's counter, SIMT or PADDED by head dim) wherever its route
    would be another; no other route can be forced."""
    if not on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    r = cuda_route(q, k, v)
    dt = compute_dtype(q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        out = flash_attention(q.float(), k.float(), v.float(), causal=causal,
                              window=window, force=force)
        return out.to(q.dtype)
    if force is not None:
        if force is not SIMT or dt != torch.float32 or r is WIDE:
            raise ValueError(f"flash_attention: cannot force {force} on "
                             f"{dt} at head dim {q.shape[-1]}")
        r = flash_kernel_route(q.shape[-1])
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if not out.numel():
        return out
    LAUNCHES[r.counter] += 1
    if r is WGMMA_F32:
        check(_build.load().flash_attention_wgmma_f32_launch(
            ptr(q), ptr(k), ptr(v), B, Lq, Lk, H, KVH, D, int(causal),
            int(window), ptr(out), stream(q)),
            f"flash_attention (wgmma, {r.counter})")
    elif r is WGMMA_LOADED:
        check(_build.load().flash_attention_wgmma_loaded_launch(
            _DTYPES[q.dtype], ptr(q), ptr(k), ptr(v), B, Lq, Lk, H, KVH, D,
            int(causal), int(window), ptr(out), stream(q)),
            f"flash_attention (wgmma, {r.counter})")
    elif r in TENSOR_CORE_ROUTES:
        lib = _build.load()
        launch = (lib.flash_attention_wgmma_f16_launch if r is WGMMA_F16
                  else lib.flash_attention_wgmma_launch)
        check(launch(ptr(q), ptr(k), ptr(v), B, Lq, Lk, H, KVH, D,
                     int(causal), int(window), ptr(out), stream(q)),
              f"flash_attention (wgmma, {r.counter})")
    else:
        check(_build.load().flash_attention_launch(
            ptr(q), ptr(k), ptr(v), _DTYPES[q.dtype], B, Lq, Lk, H, KVH, D,
            int(causal), int(window), ptr(out), stream(q)),
            f"flash_attention ({r.kernel})")
    return out
