"""Jamba-v0.1-52B [arXiv:2403.19887]: Mamba+attention 1:7 interleave
(attn_period=8), MoE every other layer (16 experts, top-2).

The port's copy of ``repro/configs/jamba_v0_1_52b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, experts_per_token=2,
    attn_period=8, moe_period=2,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    mlp_activation="swiglu", source="arXiv:2403.19887",
)
