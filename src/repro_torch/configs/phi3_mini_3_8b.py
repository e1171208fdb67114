"""Phi-3-mini-3.8B [arXiv:2404.14219]: dense, RoPE + SwiGLU, MHA-as-GQA.

The port's copy of ``repro/configs/phi3_mini_3_8b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", arch_type="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    mlp_activation="swiglu", source="arXiv:2404.14219",
)
