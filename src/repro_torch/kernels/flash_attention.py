"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
ported from the Pallas kernel of ``repro/kernels/flash_attention.py``.

Blockwise online-softmax attention with GQA (query head h reads kv head
h // (H / KVH), never expanded), causal and sliding-window masks from the
absolute positions arange(L), float32 running statistics and the output in
q's dtype.  For CPU tensors ``flash_attention`` returns the plain version
(``ref.flash_attention_ref``); for CUDA tensors it checks them, launches
the kernel on the current stream and raises if the launch failed — it
never falls back.  ``LAUNCHES`` counts launches.  The kernel is
forward-only (a CUDA input that requires grad raises) and takes Lq == Lk,
head dims 16, 32, 64 and 128, and float32 or bf16.

The reference's ``block_q`` / ``block_k`` are TPU tile sizes; the CUDA
kernel's tiles are fixed (64 x 64) and the results do not depend on them,
so the port's signature leaves them out.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import check, forward_only, need, on_cuda, ptr, stream

LAUNCHES = {"flash_attention": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Lq, H, d); k/v: (B, Lk, KVH, d), KVH | H.  Returns (B, Lq, H, d)."""
    if not on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    forward_only("flash_attention", q, k, v)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, L, H, d), got {tuple(q.shape)}")
    B, L, H, D = q.shape
    KVH = k.shape[2] if k.dim() == 4 else 0
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head dims {HEAD_DIMS}, got {D}")
    if KVH < 1 or H % KVH:
        raise ValueError(f"kv heads {KVH} must divide query heads {H}")
    need(q, "q", (B, L, H, D), tuple(_DTYPES))
    need(k, "k", (B, L, KVH, D), (q.dtype,))    # Lk == Lq
    need(v, "v", (B, L, KVH, D), (q.dtype,))
    out = torch.empty_like(q)
    if out.numel():
        LAUNCHES["flash_attention"] += 1
        check(_build.load().flash_attention_launch(
            ptr(q), ptr(k), ptr(v), _DTYPES[q.dtype], B, L, H, KVH, D,
            int(causal), int(window), ptr(out), stream(q)), "flash_attention")
    return out
