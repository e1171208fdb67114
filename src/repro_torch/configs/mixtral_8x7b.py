"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention (W=4096) — the SWA is what lets long_500k decode run for this arch.

The port's copy of ``repro/configs/mixtral_8x7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    num_experts=8, experts_per_token=2, sliding_window=4096,
    mlp_activation="swiglu", source="arXiv:2401.04088",
)
