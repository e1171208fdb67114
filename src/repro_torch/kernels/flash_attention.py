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
for CUDA tensors it checks them, launches one of two kernels on the current
stream and raises if the launch failed — it never falls back.  The kernels
are forward-only (a CUDA input that requires grad raises).

Routing (``route``), by dtype and head dim:

- bf16 with head dim 64, 96 or 128 -> ``flash_wgmma_kernel``: both
  products on the tensor cores (wgmma), K/V tiles by TMA, P entering P V
  as a hi/lo pair of bf16 (head dim 96 in tiles padded to 128 columns, the
  kernel's notes say how).  Counted in ``LAUNCHES["flash_attention_wgmma"]``.
  Its inputs must start on 16-byte boundaries (TMA).
- everything else it takes (float32 at head dims 16, 32, 64, 96, 128;
  bf16 at 16 and 32) -> ``flash_kernel``: float32 on CUDA cores, never TF32, the
  checked float32 route.  Counted in ``LAUNCHES["flash_attention_simt"]``.

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
SIMT = Route("flash_kernel", "flash_attention_simt")
LAUNCHES = {WGMMA.counter: 0, SIMT.counter: 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128)
WGMMA_HEAD_DIMS = (64, 96, 128)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def route(dtype: torch.dtype, head_dim: int) -> Route:
    """The kernel a CUDA call with this dtype and head dim launches."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return WGMMA
    return SIMT


def cuda_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Route:
    """Check q, k and v against what the kernels take and return the route
    a CUDA call takes; raise on anything else.  Reads only shapes, dtypes,
    strides and addresses, so it runs on tensors of any device."""
    forward_only("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, L, H, d), got {tuple(q.shape)}")
    B, Lq, H, D = q.shape
    Lk, KVH = (k.shape[1], k.shape[2]) if k.dim() == 4 else (0, 0)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {D}")
    if KVH < 1 or H % KVH:
        raise ValueError(f"kv heads {KVH} must divide query heads {H}")
    if Lk < 1:
        raise ValueError(f"k must hold at least one key, got {tuple(k.shape)}")
    need(q, "q", (B, Lq, H, D), tuple(_DTYPES))
    need(k, "k", (B, Lk, KVH, D), (q.dtype,))
    need(v, "v", (B, Lk, KVH, D), (q.dtype,))
    r = route(q.dtype, D)
    if r is WGMMA and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 q, k and v must start on "
                         "16-byte boundaries (TMA)")
    return r


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Lq, H, d); k/v: (B, Lk, KVH, d), KVH | H.  Returns (B, Lq, H, d)."""
    if not on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    r = cuda_route(q, k, v)
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if not out.numel():
        return out
    LAUNCHES[r.counter] += 1
    if r is WGMMA:
        check(_build.load().flash_attention_wgmma_launch(
            ptr(q), ptr(k), ptr(v), B, Lq, Lk, H, KVH, D, int(causal),
            int(window), ptr(out), stream(q)), "flash_attention (wgmma)")
    else:
        check(_build.load().flash_attention_launch(
            ptr(q), ptr(k), ptr(v), _DTYPES[q.dtype], B, Lq, Lk, H, KVH, D,
            int(causal), int(window), ptr(out), stream(q)), "flash_attention")
    return out
