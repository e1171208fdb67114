"""Model factory, ported from ``repro/models/api.py``: ModelConfig -> module.

Every model exposes the reference's surface as methods of an
``nn.Module`` that holds its weights:
  loss_fn(batch) -> (loss, metrics)          # training, on the plain path
  prefill(tokens, prefix_emb) -> (logits, aux)
  init_cache(batch, seq_len) / decode_step(cache, token, t)
  cache_len(seq_len)
The port trains and serves every family of the reference: ssm, dense,
MoE, hybrid, the encoder-decoder (audio frames) and the decoder-only
vision / audio prefix models.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm_model import MambaLM
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """The model of ``cfg`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default cuda;
    raises without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.is_encdec:
        return EncDec(cfg, gen)
    # dense / moe / vlm (decoder-only with optional prefix embeddings)
    cls = {"ssm": MambaLM, "hybrid": HybridLM}.get(cfg.arch_type, Transformer)
    return cls(cfg, gen)
