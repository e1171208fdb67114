"""InternVL2-2B [arXiv:2404.16821]: InternLM2-chat-1.8B backbone (GQA kv=8);
InternViT vision encoder stubbed (patch embeddings via input_specs).

The port's copy of ``repro/configs/internvl2_2b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", arch_type="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    frontend="vision", frontend_dim=1024, num_prefix=256,
    mlp_activation="swiglu", source="arXiv:2404.16821",
)
