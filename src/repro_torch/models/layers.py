"""Shared neural building blocks, ported from ``repro/models/layers.py``.

Parameters live in ``nn.Module``s (see ``ssm_model`` / ``transformer``);
these functions take them explicitly, as the reference's do.  Weights are
drawn from an explicit ``torch.Generator`` at the reference's scales: the
numbers differ from ``jax.random``'s, so parity tests carry the
reference's parameters across with ``repro_torch.convert.model_from_jax``.
``chunked_xent_loss`` is the training loss (``loss_fn`` of each model);
``run_block`` applies a block, under per-block activation checkpointing
when the config asks for remat and autograd is recording.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn


def model_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight, made with ``requires_grad=False`` so that serving never
    records a graph; the train step turns it on (``requires_grad_``)."""
    return nn.Parameter(t, requires_grad=False)


def param_dict(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: param(v) for k, v in tree.items()})


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     dtype=torch.float32) -> torch.Tensor:
    """``scale`` times a normal truncated to [-2, 2], drawn in float32 on
    ``gen``'s device and cast to ``dtype`` (the reference's recipe)."""
    out = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (out * scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs.  x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., :, None].float() * freqs                 # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                            # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype) -> dict:
    scale_in = d_model**-0.5
    scale_out = d_ff**-0.5
    params = {
        "w_up": truncated_normal(gen, (d_model, d_ff), scale_in, dtype),
        "w_down": truncated_normal(gen, (d_ff, d_model), scale_out, dtype),
    }
    if activation == "swiglu":
        params["w_gate"] = truncated_normal(gen, (d_model, d_ff), scale_in, dtype)
    return params


def apply_mlp(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if activation == "swiglu":
        up = F.silu(x @ params["w_gate"]) * up
    elif activation == "relu2":          # nemotron-4 squared ReLU
        up = torch.square(F.relu(up))
    elif activation == "gelu":
        up = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return up @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype) -> torch.Tensor:
    # 1/sqrt(d) keeps tied-head logits O(1) at init; RMSNorm rescales inputs.
    return truncated_normal(gen, (vocab, d_model), d_model**-0.5, dtype)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


# ---------------------------------------------------------------------------
# Blocks under remat + sequence-chunked cross-entropy
# ---------------------------------------------------------------------------

def run_block(fn, h: torch.Tensor, remat: bool, *args):
    """``fn(h, *args)`` (a tensor, or a tuple such as an MoE block's
    hidden and aux loss); with ``remat`` and autograd recording, under
    non-reentrant activation checkpointing (the reference's
    ``jax.checkpoint`` of each block).  The non-reentrant form also
    recomputes under double backward, so the curvature term's
    reverse-over-reverse passes through it.  The blocks draw no random
    numbers, so no RNG state is stashed (which also keeps the recompute
    capturable in a CUDA graph)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, h, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(h, *args)


def chunked_xent_loss(hidden: torch.Tensor, lm_head: torch.Tensor,
                      targets: torch.Tensor, mask: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """Masked mean next-token cross-entropy without full (B, L, V) logits.

    hidden (B, L, d) final hidden states; lm_head (d, V); targets (B, L)
    int; mask (B, L) float32.  Loops over sequence chunks of ``chunk``
    (padding the last with masked positions when L % chunk != 0), each
    with (B, chunk, V) float32 logits, and sums in chunk order as the
    reference's scan does.
    """
    B, L, d = hidden.shape
    if L % chunk:
        pad = chunk - L % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
        L += pad
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    denom = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, L, chunk):
        logits = (hidden[:, c:c + chunk] @ lm_head).float()      # (B, chunk, V)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              targets[:, c:c + chunk, None].long())[..., 0]
        m_c = mask[:, c:c + chunk]
        total = total + torch.sum((lse - picked) * m_c)
        denom = denom + torch.sum(m_c)
    return total / torch.clamp(denom, min=1.0)
