"""Yi-6B [arXiv:2403.04652]: llama-arch dense with aggressive GQA (kv=4).

The port's copy of ``repro/configs/yi_6b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    mlp_activation="swiglu", source="arXiv:2403.04652",
)
