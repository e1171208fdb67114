"""Data pipelines of the port: synthetic LM token streams
(``repro_torch.data.synthetic_lm``, ported from ``repro/data``)."""

from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch  # noqa: F401
