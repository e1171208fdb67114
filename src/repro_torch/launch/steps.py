"""The serving steps, ported from ``repro/launch/steps.py``.

One device, no mesh and no sharding: the reference's ``jax.jit`` with
shardings becomes a closure that runs the model under
``torch.inference_mode`` on the resolved device.  The train step waits for
the training slice (ROADMAP.md queue 1 item 13); ``launch/mesh.py``,
``hlo_analysis.py`` and ``dryrun.py`` inspect XLA on a TPU mesh and have
no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


def build_prefill_step(model, cfg: ModelConfig, device=None):
    """``prefill(tokens, prefix_emb=None) -> (last-position logits f32, aux)``
    for a (B, L) token batch, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    model.to(dev)

    def prefill(tokens: torch.Tensor, prefix_emb=None):
        with torch.inference_mode():
            return model.prefill(tokens.to(dev), prefix_emb)

    return prefill


def build_serve_step(model, cfg: ModelConfig, shape: ShapeConfig, device=None):
    """One-token decode step against a ``shape.seq_len``-deep cache.

    Returns ``(step, init_cache)``: ``step(cache, token (B,), t) -> (logits
    (B, V) f32, cache)`` updates the cache in place; ``init_cache()`` makes
    an empty cache for ``shape.global_batch`` rows on the device.
    """
    dev = resolve_device(device)
    model.to(dev)

    def step(cache, token: torch.Tensor, t: int):
        with torch.inference_mode():
            return model.decode_step(cache, token.to(dev), int(t))

    def init_cache():
        with torch.inference_mode():
            return model.init_cache(shape.global_batch, shape.seq_len)

    return step, init_cache
