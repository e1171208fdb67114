"""Config schema for the architecture zoo and input shapes: the port's own
copy of ``repro/configs/base.py`` (the port imports nothing of ``repro``).

Every ported architecture is a ``ModelConfig`` instance in its own module
(``repro_torch/configs/<id>.py``) citing its source; input shapes are the
four ``ShapeConfig``s of the reference.  ``reduced()`` produces the
CPU-smoke variant (2 layers, d_model <= 512, <= 4 experts) of the same
family, exactly as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads; 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3

    # attention flavour
    sliding_window: int = 0         # 0 => full attention
    mlp_activation: str = "swiglu"  # swiglu | relu2 | gelu
    rope_theta: float = 1e4

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    attn_period: int = 0            # hybrid: one attn layer per `attn_period` layers
    moe_period: int = 0             # hybrid/moe-interleave: MoE MLP every k-th layer

    # encoder-decoder
    encoder_layers: int = 0         # > 0 => enc-dec (decoder layers = num_layers)

    # modality frontend (stubbed per assignment carve-out)
    frontend: str = "none"          # none | vision | audio
    frontend_dim: int = 0           # raw embedding dim emitted by the stub
    num_prefix: int = 0             # patches/frames consumed as a prefix

    # numerics / misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 1024          # sequence-chunked cross-entropy block
    attn_chunk: int = 1024          # KV-chunked attention block (pure-JAX flash)
    # serving perf knobs (§Perf):
    decode_dense_attn: bool = False # decode: einsum attention (plays well with
                                    # a sequence-sharded cache) vs chunked scan
    kv_cache_layout: str = "auto"   # auto | heads | hd | seq
    source: str = ""                # citation per assignment

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/lm_head can
        be sharded 16-way (standard practice; e.g. OLMoE's 50304 is already
        the padded size of GPT-NeoX's 50280)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def supports_long_context(self) -> bool:
        """True iff decode over 500k+ tokens is sub-quadratic for this config."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window > 0

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family (spec: 2 layers, d<=512, <=4 experts)."""
        changes: dict = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            loss_chunk=64,
            attn_chunk=64,
            dtype="float32",
            remat=False,
        )
        if self.num_heads > 0:
            heads = min(self.num_heads, 4)
            kv = max(1, min(self.num_kv_heads, heads))
            while heads % kv:
                kv -= 1
            changes.update(num_heads=heads, num_kv_heads=kv, head_dim=64)
        if self.is_moe:
            changes.update(
                num_experts=min(self.num_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
            )
        if self.encoder_layers:
            changes.update(encoder_layers=2)
        if self.ssm_state:
            changes.update(ssm_state=min(self.ssm_state, 32), ssm_head_dim=32)
        if self.num_prefix:
            changes.update(num_prefix=8, frontend_dim=min(self.frontend_dim or 64, 64))
        if self.sliding_window:
            changes.update(sliding_window=64)
        if self.attn_period:
            changes.update(attn_period=2, moe_period=max(self.moe_period, 0) and 2)
        if self.moe_period:
            changes.update(moe_period=2)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
