"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block, ported from
``repro/models/ssm.py``.

Per head h with state (N x P):   h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t,
y_t = C_t . h_t + D * x_t,   a_t = exp(dt_t * A_h),  A_h < 0 learned.
B_t, C_t are shared across heads (ngroups = 1), x_t is the (P,) head input.

``ssd_chunked`` here is the plain chunked algorithm (intra-chunk terms as
(Q x Q) products, a short loop over chunk states), the reference's
production path.  ``apply_mamba2`` runs the tile kernel's version
(``repro_torch.kernels.ssd_scan.ssd_chunked``: the CUDA kernel for CUDA
tensors, its plain version on the CPU) unless the caller asks for this
plain path with ``use_kernel=False``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan
from repro_torch.models.layers import rms_norm, truncated_normal


def init_mamba2(gen: torch.Generator, d_model: int, ssm_state: int,
                head_dim: int, expand: int, conv_width: int, dtype) -> dict:
    d_inner = expand * d_model
    num_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * ssm_state
    s_in = d_model**-0.5
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        # in_proj emits [z (d_inner), xBC (conv_ch), dt (H)]
        "w_in": truncated_normal(gen, (d_model, d_inner + conv_ch + num_heads), s_in, dtype),
        "conv_w": truncated_normal(gen, (conv_width, conv_ch), conv_width**-0.5, dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=gen.device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, num_heads, **f32)),  # A = -exp(a_log)
        "dt_bias": torch.log(torch.expm1(torch.full((num_heads,), 1e-2, **f32))),
        "d_skip": torch.ones((num_heads,), **f32),
        "norm_w": torch.ones((d_inner,), **f32),
        "w_out": truncated_normal(gen, (d_inner, d_model), d_inner**-0.5, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, L, C); w: (W, C)."""
    W, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):  # W is tiny (4)
        out = out + xp[:, i:i + L, :] * w[i]
    return out + b


def ssd_chunked(
    xh: torch.Tensor,        # (B, L, H, P) head inputs
    dt: torch.Tensor,        # (B, L, H)    positive step sizes
    a: torch.Tensor,         # (H,)         negative decay rates A_h
    b_mat: torch.Tensor,     # (B, L, N)
    c_mat: torch.Tensor,     # (B, L, N)
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,   # (B, H, N, P)
):
    """Chunked SSD.  Returns (y (B, L, H, P), final_state (B, H, N, P))."""
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
    b_c = b_mat.reshape(B, nc, Q, N).float()
    c_c = c_mat.reshape(B, nc, Q, N).float()

    log_a = dt_c * a.float()                          # (B, nc, Q, H), negative
    cum = torch.cumsum(log_a, dim=2)                  # inclusive cumsum within chunk
    total = cum[:, :, -1, :]                          # (B, nc, H)
    dtx = dt_c[..., None] * xh_c.float()              # (B, nc, Q, H, P)

    # ---- intra-chunk (quadratic, attention-like) ---------------------------
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,Q,Q,H)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    # mask BEFORE exp: upper-triangle exponents are positive
    seg = torch.where(tril[None, None, :, :, None], seg,
                      torch.full_like(seg, -float("inf")))
    decay = torch.exp(seg)
    gbc = torch.einsum("bcin,bcjn->bcij", c_c, b_c)              # (B,nc,Q,Q)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", gbc[..., None] * decay, dtx)

    # ---- chunk states + inter-chunk recurrence -----------------------------
    w_state = torch.exp(total[:, :, None, :] - cum)              # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjn,bcjhp->bchnp", b_c, w_state[..., None] * dtx)

    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=xh.device)
         if initial_state is None else initial_state.float())
    h_before = torch.empty_like(s_chunk)                         # state before each chunk
    for ci in range(nc):
        h_before[:, ci] = h
        h = torch.exp(total[:, ci])[..., None, None] * h + s_chunk[:, ci]

    # ---- inter-chunk output: C_i . (exp(cum_i) * H_before) ------------------
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcin,bchnp->bcihp", c_c, h_before)

    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)[:, :L]
    return y.to(xh.dtype), h


def ssd_step(state, x1, dt1, a, b1, c1):
    """One recurrent decode step.  state (B, H, N, P); x1 (B, H, P); dt1
    (B, H); a (H,); b1, c1 (B, N).  Returns (y (B, H, P), new_state)."""
    dt1 = dt1.float()
    decay = torch.exp(dt1 * a.float()[None, :])                  # (B, H)
    upd = torch.einsum("bn,bhp->bhnp", b1.float(), dt1[..., None] * x1.float())
    new_state = decay[..., None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", c1.float(), new_state)
    return y.to(x1.dtype), new_state


def _split_in_proj(x, params, d_inner, N):
    zxbcdt = x @ params["w_in"]
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * N], dim=-1)


def apply_mamba2(params, x: torch.Tensor, ssm_state: int, head_dim: int,
                 chunk: int = 128, norm_eps: float = 1e-5,
                 use_kernel: bool = True) -> torch.Tensor:
    """Full Mamba2 mixer over a sequence (prefill).  x: (B, L, d)."""
    B, L, d = x.shape
    d_inner = params["w_out"].shape[0]
    H = d_inner // head_dim
    N = ssm_state

    z, xbc, dt = _split_in_proj(x, params, d_inner, N)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, b_mat, c_mat = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])              # (B, L, H)
    a = -torch.exp(params["a_log"])                              # (H,)

    xh = xs.reshape(B, L, H, head_dim)
    ssd = ssd_scan.ssd_chunked if use_kernel else ssd_chunked
    y, _ = ssd(xh, dt, a, b_mat, c_mat, chunk=chunk)
    y = y + params["d_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, L, d_inner)
    y = rms_norm(y * F.silu(z), params["norm_w"], norm_eps)      # gated norm
    return y @ params["w_out"]


def init_mamba_cache(batch: int, d_model: int, ssm_state: int, head_dim: int,
                     expand: int, conv_width: int, dtype, device=None) -> dict:
    d_inner = expand * d_model
    H = d_inner // head_dim
    conv_ch = d_inner + 2 * ssm_state
    return {
        "ssm": torch.zeros((batch, H, ssm_state, head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def decode_mamba2(params, x: torch.Tensor, cache: dict, ssm_state: int,
                  head_dim: int, norm_eps: float = 1e-5):
    """One-token recurrent step (O(1) in context length).  x: (B, 1, d);
    cache {"ssm": (B, H, N, P), "conv": (B, W-1, C)}.  Returns (out, new
    cache); the cache passed in is not modified."""
    B = x.shape[0]
    d_inner = params["w_out"].shape[0]
    H = d_inner // head_dim
    N = ssm_state

    z, xbc, dt = _split_in_proj(x[:, 0], params, d_inner, N)

    # rolling conv buffer: [prev taps | new] then depthwise dot with conv_w
    conv_in = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)        # (B, W, C)
    xbc = F.silu(torch.einsum("bwc,wc->bc", conv_in, params["conv_w"])
                 + params["conv_b"])
    new_conv = conv_in[:, 1:, :]

    xs, b1, c1 = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt1 = F.softplus(dt.float() + params["dt_bias"])                    # (B, H)
    a = -torch.exp(params["a_log"])

    xh = xs.reshape(B, H, head_dim)
    y, new_ssm = ssd_step(cache["ssm"], xh, dt1, a, b1, c1)
    y = y + params["d_skip"][None, :, None].to(y.dtype) * xh
    y = y.reshape(B, 1, d_inner)
    y = rms_norm(y * F.silu(z[:, None, :]), params["norm_w"], norm_eps)
    return y @ params["w_out"], {"ssm": new_ssm, "conv": new_conv}
