"""Mamba2-370m [arXiv:2405.21060]: attention-free SSD (state-space duality).

The port's copy of ``repro/configs/mamba2_370m.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True, source="arXiv:2405.21060",
)
