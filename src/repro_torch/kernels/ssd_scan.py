"""Wrapper of the CUDA SSD intra-chunk kernel (``csrc/ssd_scan.cu``), ported
from the Pallas kernel of ``repro/kernels/ssd_scan.py``.

``ssd_chunk_tiles`` computes, for every (batch, chunk, head), the
intra-chunk output and the chunk's state (the kernel's docstring has the
formulas).  For CPU tensors it returns the plain version
(``ref.ssd_chunk_ref``); for CUDA tensors it checks them, launches the
kernel on the current stream and raises if the launch failed — it never
falls back.  ``LAUNCHES`` counts launches.  The kernel is forward-only:
a CUDA input that requires grad raises.

``ssd_chunked`` is the port of ``ssd_chunked_pallas``, a drop-in for
``repro_torch.models.ssm.ssd_chunked``: padding to the chunk, the cumsum,
the inter-chunk state recurrence and the inter-chunk output term stay
plain torch, as they stay XLA in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import check, forward_only, need, on_cuda, ptr, stream

LAUNCHES = {"ssd_chunk_tiles": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128   # largest chunk, state and head width one block covers (kMaxDim)


def reset_launches() -> None:
    LAUNCHES["ssd_chunk_tiles"] = 0


def ssd_chunk_tiles(dtx: torch.Tensor, cum: torch.Tensor, b_mat: torch.Tensor,
                    c_mat: torch.Tensor):
    """All intra-chunk outputs + per-chunk states.

    dtx (B, nc, Q, H, P) and cum (B, nc, Q, H) float32; b_mat, c_mat
    (B, nc, Q, N) float32 or bf16 (computed in float32).  Returns
    (y_intra (B, nc, Q, H, P) float32, states (B, nc, H, N, P) float32).
    """
    if not on_cuda(dtx, cum, b_mat, c_mat):
        return ref.ssd_chunk_ref(dtx, cum, b_mat, c_mat)
    forward_only("ssd_chunk_tiles", dtx, cum, b_mat, c_mat)
    if dtx.dim() != 5:
        raise ValueError(f"dtx must be (B, nc, Q, H, P), got {tuple(dtx.shape)}")
    B, nc, Q, H, P = dtx.shape
    N = b_mat.shape[-1]
    if max(Q, N, P) > MAX_DIM:
        raise ValueError(f"ssd_chunk_tiles takes Q, N, P <= {MAX_DIM}, got "
                         f"Q={Q} N={N} P={P}")
    need(dtx, "dtx", (B, nc, Q, H, P))
    need(cum, "cum", (B, nc, Q, H))
    need(b_mat, "b_mat", (B, nc, Q, N), tuple(_DTYPES))
    need(c_mat, "c_mat", (B, nc, Q, N), (b_mat.dtype,))
    y = torch.empty_like(dtx)
    states = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                         device=dtx.device)
    if y.numel():
        LAUNCHES["ssd_chunk_tiles"] += 1
        check(_build.load().ssd_chunk_launch(
            ptr(dtx), ptr(cum), ptr(b_mat), ptr(c_mat), _DTYPES[b_mat.dtype],
            B * nc, Q, H, N, P, ptr(y), ptr(states), stream(dtx)),
            "ssd_chunk_tiles")
    return y, states


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int = 128):
    """Chunked SSD through the tile kernel.

    xh (B, L, H, P); dt (B, L, H) positive steps; a (H,) negative rates;
    b_mat, c_mat (B, L, N).  Returns (y (B, L, H, P) in xh's dtype,
    final_state (B, H, N, P) float32).
    """
    B, L, H, P = xh.shape
    N = b_mat.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = xh.shape[1] // Q

    xh_c = xh.reshape(B, nc, Q, H, P)
    dt_c = dt.reshape(B, nc, Q, H).float()
    b_c = b_mat.reshape(B, nc, Q, N).contiguous()
    c_c = c_mat.reshape(B, nc, Q, N).contiguous()
    cum = torch.cumsum(dt_c * a.float(), dim=2)             # (B, nc, Q, H)
    total = cum[:, :, -1, :]                                 # (B, nc, H)
    dtx = (dt_c[..., None] * xh_c.float()).contiguous()

    y_intra, s_chunk = ssd_chunk_tiles(dtx, cum.contiguous(), b_c, c_c)

    # inter-chunk recurrence h_c = exp(total_c) h_{c-1} + s_c, emitting the
    # state before each chunk (the reference's lax.scan)
    decay = torch.exp(total)[..., None, None]                # (B, nc, H, 1, 1)
    h_before = torch.empty_like(s_chunk)
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
    for ci in range(nc):
        h_before[:, ci] = h
        h = torch.addcmul(s_chunk[:, ci], decay[:, ci], h)

    # y_inter[i] = exp(cum_i) C_i . h_before
    ch = torch.einsum("bcin,bchnp->bcihp", c_c.float(), h_before)
    y = y_intra + torch.exp(cum)[..., None] * ch
    y = y.reshape(B, nc * Q, H, P)[:, :L]
    return y.to(xh.dtype), h
