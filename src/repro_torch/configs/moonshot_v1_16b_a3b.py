"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 64-expert top-6 MoE.

The port's copy of ``repro/configs/moonshot_v1_16b_a3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", arch_type="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    num_experts=64, experts_per_token=6,
    mlp_activation="swiglu", source="hf:moonshotai/Moonlight-16B-A3B",
)
