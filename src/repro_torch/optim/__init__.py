"""Functional optimizers over dicts of tensors, ported from ``repro/optim``."""

from repro_torch.optim.optimizers import (  # noqa: F401
    AdamWState,
    Optimizer,
    SgdState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    sgd,
)
