"""Nemotron-4-15B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP, 256k vocab.

The port's copy of ``repro/configs/nemotron_4_15b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", arch_type="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000,
    mlp_activation="relu2", source="arXiv:2402.16819",
)
