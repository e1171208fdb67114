"""OLMoE-1B-7B [arXiv:2409.02060]: 64-expert top-8 MoE, MHA.

The port's copy of ``repro/configs/olmoe_1b_7b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", arch_type="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    num_experts=64, experts_per_token=8,
    mlp_activation="swiglu", source="arXiv:2409.02060",
)
