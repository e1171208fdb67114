"""Checkpoints of tensor trees (``repro_torch.checkpoint.store``)."""

from repro_torch.checkpoint.store import load_metadata, restore, save  # noqa: F401
