"""Modality frontend stubs, ported from ``repro/models/frontends.py``.

The [vlm] and [audio] configs specify the transformer backbone only: the
ViT / conv-codec that would produce patch or frame embeddings is not
implemented, and callers supply precomputed embeddings of the right shape.
The one learned part is the projector from the frontend's embedding width
to d_model (InternVL2's MLP projector, SeamlessM4T's length adaptor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal


def init_projector(gen: torch.Generator, frontend_dim: int, d_model: int,
                   dtype) -> dict:
    return {
        "w1": truncated_normal(gen, (frontend_dim, d_model), frontend_dim**-0.5,
                               dtype),
        "w2": truncated_normal(gen, (d_model, d_model), d_model**-0.5, dtype),
    }


def apply_projector(params, emb: torch.Tensor) -> torch.Tensor:
    """(B, P, frontend_dim) -> (B, P, d_model): ``gelu(emb @ w1) @ w2``
    (tanh gelu, ``jax.nn.gelu``'s default).  The reference multiplies
    float32 embeddings by weights of the model's dtype and JAX promotes the
    product to float32; so here the weights are widened to the wider of
    the two dtypes (the embeddings are never rounded to bf16), and the
    result keeps that dtype: the callers cast it to the model's."""
    dt = torch.promote_types(emb.dtype, params["w1"].dtype)
    h = F.gelu(emb.to(dt) @ params["w1"].to(dt), approximate="tanh")
    return h @ params["w2"].to(dt)
