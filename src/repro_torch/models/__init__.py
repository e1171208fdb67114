"""The LM substrate's model families, ported from ``repro/models``."""

from repro_torch.models.api import build_model  # noqa: F401
