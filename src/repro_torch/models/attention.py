"""Attention: GQA with RoPE, sliding windows, KV caches, ported from
``repro/models/attention.py``.

Three inner implementations with identical semantics:

* ``reference_attention`` — einsum + softmax, materializes (Lq, Lk) scores.
* ``chunked_attention``   — plain online-softmax loop over KV chunks.
* ``repro_torch.kernels.flash_attention`` — the hand-written CUDA kernel
  (its plain version on the CPU), the port of the Pallas kernel the
  reference documents as the hardware version of ``chunked_attention``.
  ``attention_block`` runs it for self-attention over positions arange(L)
  and for cross-attention over a memory at positions arange(Lk) unless the
  caller asks for the plain path (``use_kernel=False``).

All plain entry points take explicit query/key positions so prefill
(q_pos = k_pos = arange) and decode (q at position ``t``, cache positions
0..S-1) share one masking rule:  visible iff  k_pos <= q_pos  and  (no
window or k_pos > q_pos - window)  and  k_pos < valid_len.  Decode is not
the kernel's function and stays plain torch, as it stays jnp outside
Pallas in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as flash
from repro_torch.models.layers import apply_rope, truncated_normal

NEG_INF = -1e30
POS_SENTINEL = 2**31 - 1   # padded / unwritten KV slots (the reference's INT32_MAX)


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, dtype) -> dict:
    s_in = d_model**-0.5
    s_out = (num_heads * head_dim) ** -0.5
    return {
        "wq": truncated_normal(gen, (d_model, num_heads, head_dim), s_in, dtype),
        "wk": truncated_normal(gen, (d_model, num_kv_heads, head_dim), s_in, dtype),
        "wv": truncated_normal(gen, (d_model, num_kv_heads, head_dim), s_in, dtype),
        "wo": truncated_normal(gen, (num_heads, head_dim, d_model), s_out, dtype),
    }


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match query heads. (B, L, KV, hd) -> (B, L, H, hd)."""
    kv = k.shape[2]
    return k if kv == num_heads else k.repeat_interleave(num_heads // kv, dim=2)


def _mask(q_pos, k_pos, causal: bool, window: int, valid_len=None):
    """(..., Lq, Lk) boolean visibility."""
    m = torch.ones(q_pos.shape[-1:] + k_pos.shape[-1:], dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    if valid_len is not None:
        m = m[None] & (k_pos[None, None, :] < valid_len[:, None, None])
    return m


def reference_attention(q, k, v, q_pos, k_pos, causal: bool = True,
                        window: int = 0, valid_len=None) -> torch.Tensor:
    """q: (B, Lq, H, hd); k/v: (B, Lk, KV, hd) -> (B, Lq, H, hd)."""
    H, hd = q.shape[2], q.shape[3]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd**-0.5
    mask = _mask(q_pos, k_pos, causal, window, valid_len)
    mask = mask[:, None] if mask.dim() == 3 else mask[None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def chunked_attention(q, k, v, q_pos, k_pos, causal: bool = True,
                      window: int = 0, valid_len=None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax loop over KV chunks; same semantics as reference."""
    B, Lq, H, hd = q.shape
    Lk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    chunk = min(chunk, Lk)
    pad = (-Lk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=POS_SENTINEL)
    qf = q.float() * hd**-0.5
    m = torch.full((B, H, Lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, Lk + pad, chunk):
        k_c, v_c = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp_c = k_pos[c0:c0 + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_c.float())
        vis = _mask(q_pos, kp_c, causal, window, valid_len)
        # padded KV slots carry the sentinel; the causal mask hides them
        # implicitly but non-causal attention must exclude them too
        vis = vis & (kp_c < POS_SENTINEL)
        vis = vis[:, None] if vis.dim() == 3 else vis[None, None]
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                   v_c.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                # (B, Lq, H, hd)


def _project(x, w):
    """x (B, L, d) @ w (d, heads, hd) -> (B, L, heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).reshape(*x.shape[:-1], heads, hd)


def _out_project(o, wo):
    """o (B, L, H, hd) @ wo (H, hd, d) -> (B, L, d)."""
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def attention_block(params, x: torch.Tensor, positions: torch.Tensor,
                    rope_theta: float, causal: bool = True, window: int = 0,
                    chunk: int = 1024,
                    kv_override: Optional[tuple] = None,
                    use_chunked: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
    """Full projection -> RoPE -> attention -> output projection.

    x (B, L, d); positions (L,).  With ``use_kernel`` the flash kernel runs
    on the unexpanded k and v: over x itself, or over the memory of a
    cross-attention ``kv_override = (memory, memory_positions)`` (no RoPE,
    Lk = the memory's length).  Its masks use query positions arange(L) and
    key positions arange(Lk), which is what every caller passes.  Otherwise
    the plain ``chunked_attention`` / ``reference_attention`` by
    ``use_chunked``.
    """
    q = _project(x, params["wq"])
    if kv_override is None:
        k = _project(x, params["wk"])
        v = _project(x, params["wv"])
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        k_pos = positions
    else:
        mem, k_pos = kv_override
        k = _project(mem, params["wk"])
        v = _project(mem, params["wv"])

    if use_kernel:
        out = flash.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal,
                                    window=window)
    elif use_chunked:
        out = chunked_attention(q, k, v, positions, k_pos, causal=causal,
                                window=window, chunk=chunk)
    else:
        out = reference_attention(q, k, v, positions, k_pos, causal=causal,
                                  window=window)
    return _out_project(out, params["wo"])


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  dtype, device=None) -> dict:
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention_block(params, x: torch.Tensor, cache: dict, t: int,
                           rope_theta: float, window: int = 0,
                           chunk: int = 1024, use_chunked: bool = True):
    """One decode step: write K/V at slot t (t mod S for a sliding-window
    ring), attend to the cache.  x (B, 1, d); cache {"k", "v"}: (B, S, KV,
    hd), **updated in place** (the reference returns a new cache; here the
    returned dict is the same tensors).  The reference's sequence-sharded
    cache branch has no counterpart on one device."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    dev = x.device
    q = _project(x, params["wq"])
    k_new = _project(x, params["wk"])
    v_new = _project(x, params["wv"])
    pos = torch.full((1,), t, dtype=torch.long, device=dev)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)

    slot = (t % S) if window > 0 else min(t, S - 1)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    # Absolute positions of cache slots: ring layout for SWA, linear otherwise.
    slots = torch.arange(S, dtype=torch.long, device=dev)
    if window > 0:
        cycle = (t // S) * S
        k_pos = torch.where(slots <= slot, cycle + slots, cycle - S + slots)
        k_pos = torch.where(k_pos < 0, torch.full_like(k_pos, POS_SENTINEL),
                            k_pos)                                   # unwritten
    else:
        k_pos = slots
    valid = torch.full((B,), min(t + 1, S), dtype=torch.long, device=dev)
    fn = chunked_attention if use_chunked else reference_attention
    kwargs = dict(chunk=chunk) if use_chunked else {}
    out = fn(q, cache["k"], cache["v"], pos, k_pos, causal=True, window=window,
             valid_len=None if window > 0 else valid, **kwargs)
    return _out_project(out, params["wo"]), cache
