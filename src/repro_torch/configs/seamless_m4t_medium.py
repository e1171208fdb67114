"""SeamlessM4T-medium [arXiv:2308.11596]: enc-dec; speech frontend stubbed
(frame embeddings via input_specs per the assignment carve-out).

The port's copy of ``repro/configs/seamless_m4t_medium.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", arch_type="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    encoder_layers=12, frontend="audio", frontend_dim=512, num_prefix=1024,
    mlp_activation="gelu", source="arXiv:2308.11596",
)
