"""Model factory, ported from ``repro/models/api.py``: ModelConfig -> module.

Every model exposes the reference's surface as methods of an
``nn.Module`` that holds its weights:
  loss_fn(batch) -> (loss, metrics)          # training, on the plain path
  prefill(tokens, prefix_emb) -> (logits, aux)
  init_cache(batch, seq_len) / decode_step(cache, token, t)
  cache_len(seq_len)
The port trains and serves the ssm, dense, MoE and hybrid families; the
encoder-decoder and frontend (vision / audio prefix) families raise.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs import NOT_PORTED_ITEM
from repro_torch.configs.base import ModelConfig
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm_model import MambaLM
from repro_torch.models.transformer import Transformer


def build_model(cfg: ModelConfig, device=None, seed: int = 0):
    """The model of ``cfg`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default cuda;
    raises without a GPU unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if (cfg.is_encdec or cfg.frontend != "none"
            or cfg.arch_type not in ("ssm", "dense", "moe", "hybrid")):
        raise NotImplementedError(
            f"the {cfg.arch_type!r} family ({cfg.name}) is not ported to "
            f"repro_torch yet ({NOT_PORTED_ITEM})")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cls = {"ssm": MambaLM, "hybrid": HybridLM}.get(cfg.arch_type, Transformer)
    return cls(cfg, gen)
