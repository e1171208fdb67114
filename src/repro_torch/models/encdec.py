"""Encoder-decoder backbone (SeamlessM4T-medium family, arXiv:2308.11596),
ported from ``repro/models/encdec.py`` as an ``nn.Module``.

As in the reference, the speech frontend (mel-spectrogram + conv feature
extractor) is stubbed: the encoder consumes precomputed frame embeddings
through the learned projector (``models/frontends.py``).  Downstream is
real: a bidirectional self-attention encoder over the frames and a causal
decoder with cross-attention over the encoder's memory, trained with
teacher forcing.

Layers are ``nn.ModuleList``s (``enc_blocks``, ``dec_blocks``; the
reference stacks them for ``lax.scan``).  Prefill runs the flash-attention
kernel in every attention unless ``use_kernels`` is False: the encoder's
(non-causal, frames over frames), the decoder's self-attention (causal)
and its cross-attention (non-causal, Lq tokens over Lk frames).
``loss_fn`` trains through the plain attention, as the reference trains
through its jnp attention.  Decode keeps a per-layer self-attention KV
cache, updated in place, and recomputes the cross-attention K/V from the
(static) memory each step on the plain path, as the reference does: the
memory rides in the cache (``{"self": ..., "memory": ...}``) so that
``decode_step`` has every model's signature, and ``init_cache`` leaves it
zero until a caller puts ``encode(frames)`` there.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import frontends
from repro_torch.models.layers import (apply_mlp, chunked_xent_loss,
                                       embed_tokens, init_embedding, init_mlp,
                                       model_dtype, param, param_dict,
                                       rms_norm, run_block, truncated_normal)


def _attention(cfg: ModelConfig, gen: torch.Generator) -> nn.ParameterDict:
    return param_dict(attn_lib.init_attention(
        gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
        cfg.resolved_head_dim, model_dtype(cfg)))


def _norm(cfg: ModelConfig, gen: torch.Generator) -> nn.Parameter:
    return param(torch.ones((cfg.d_model,), device=gen.device))


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.attn = _attention(cfg, gen)
        self.mlp = param_dict(init_mlp(gen, cfg.d_model, cfg.d_ff,
                                       cfg.mlp_activation, model_dtype(cfg)))


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = _norm(cfg, gen)
        self.lnx = _norm(cfg, gen)
        self.ln2 = _norm(cfg, gen)
        self.self_attn = _attention(cfg, gen)
        self.cross_attn = _attention(cfg, gen)
        self.mlp = param_dict(init_mlp(gen, cfg.d_model, cfg.d_ff,
                                       cfg.mlp_activation, model_dtype(cfg)))


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = True
        dt = model_dtype(cfg)
        # drawn in the reference's order: encoder, decoder, projector,
        # embedding, head
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, gen) for _ in range(cfg.encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, gen) for _ in range(cfg.num_layers))
        self.projector = param_dict(frontends.init_projector(
            gen, cfg.frontend_dim, cfg.d_model, dt))
        self.embed = param(init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt))
        self.enc_norm = _norm(cfg, gen)
        self.final_norm = _norm(cfg, gen)
        self.lm_head = param(truncated_normal(
            gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dt))

    def head(self) -> torch.Tensor:
        return self.lm_head

    def _kernels(self, use_kernels) -> bool:
        return self.use_kernels if use_kernels is None else use_kernels

    # -- encoder ----------------------------------------------------------------

    def _enc_block(self, h, block: EncBlock, positions, use_kernels: bool):
        cfg = self.cfg
        a_in = rms_norm(h, block.ln1, cfg.norm_eps)
        h = h + attn_lib.attention_block(
            block.attn, a_in, positions, cfg.rope_theta, causal=False,
            chunk=cfg.attn_chunk, use_chunked=h.shape[1] > 512,
            use_kernel=use_kernels)
        m_in = rms_norm(h, block.ln2, cfg.norm_eps)
        return h + apply_mlp(block.mlp, m_in, cfg.mlp_activation)

    def encode(self, frames: torch.Tensor, use_kernels=None) -> torch.Tensor:
        """frames (B, F, frontend_dim) -> memory (B, F, d) in the model's
        dtype."""
        cfg = self.cfg
        use_kernels = self._kernels(use_kernels)
        h = frontends.apply_projector(self.projector, frames).to(
            model_dtype(cfg))
        positions = torch.arange(h.shape[1], device=h.device)
        for block in self.enc_blocks:
            h = run_block(self._enc_block, h, cfg.remat, block, positions,
                          use_kernels)
        return rms_norm(h, self.enc_norm, cfg.norm_eps)

    # -- decoder ----------------------------------------------------------------

    def _dec_block(self, h, block: DecBlock, positions, memory, mem_pos,
                   use_kernels: bool):
        cfg = self.cfg
        a_in = rms_norm(h, block.ln1, cfg.norm_eps)
        h = h + attn_lib.attention_block(
            block.self_attn, a_in, positions, cfg.rope_theta, causal=True,
            chunk=cfg.attn_chunk, use_chunked=h.shape[1] > 512,
            use_kernel=use_kernels)
        x_in = rms_norm(h, block.lnx, cfg.norm_eps)
        h = h + attn_lib.attention_block(
            block.cross_attn, x_in, positions, cfg.rope_theta, causal=False,
            chunk=cfg.attn_chunk, kv_override=(memory, mem_pos),
            use_chunked=memory.shape[1] > 512, use_kernel=use_kernels)
        m_in = rms_norm(h, block.ln2, cfg.norm_eps)
        return h + apply_mlp(block.mlp, m_in, cfg.mlp_activation)

    def dec_hidden(self, tokens: torch.Tensor, memory: torch.Tensor,
                   use_kernels=None) -> torch.Tensor:
        """The decoder's final-normed hidden states (B, L, d) of ``tokens``
        over ``memory`` (the reference's ``_dec_hidden``)."""
        cfg = self.cfg
        use_kernels = self._kernels(use_kernels)
        h = embed_tokens(self.embed, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        mem_pos = torch.arange(memory.shape[1], device=h.device)
        for block in self.dec_blocks:
            h = run_block(self._dec_block, h, cfg.remat, block, positions,
                          memory, mem_pos, use_kernels)
        return rms_norm(h, self.final_norm, cfg.norm_eps)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.embed.device)

    def hidden_states(self, tokens: torch.Tensor, prefix_emb: torch.Tensor,
                      use_kernels=None):
        """Encode the frames ``prefix_emb`` and run the decoder over them:
        (final-normed hidden of every token position, aux 0), the surface
        ``Transformer.hidden_states`` has."""
        memory = self.encode(prefix_emb, use_kernels)
        return self.dec_hidden(tokens, memory, use_kernels), self._zero()

    def loss_fn(self, batch: dict):
        """Teacher-forced next-token cross-entropy of ``batch`` (prefix_emb:
        the frames; tokens / targets / mask).  Returns (loss, {"xent",
        "aux"}), aux 0.  Runs the plain path whatever ``use_kernels`` says:
        the kernels are forward-only."""
        hidden, aux = self.hidden_states(batch["tokens"], batch["prefix_emb"],
                                         use_kernels=False)
        xent = chunked_xent_loss(hidden, self.lm_head, batch["targets"],
                                 batch["mask"], self.cfg.loss_chunk)
        return xent, {"xent": xent, "aux": aux}

    # -- serving -------------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        return seq_len

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"self": {"k", "v"}: (layers, B, S, KV, hd), "memory": zeros (B,
        num_prefix, d)}, in the model's dtype."""
        cfg = self.cfg
        dt = model_dtype(cfg)
        one = attn_lib.init_kv_cache(batch, seq_len, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, dt,
                                     self.embed.device)
        return {"self": {k: v.expand((cfg.num_layers,) + v.shape).clone()
                         for k, v in one.items()},
                "memory": torch.zeros((batch, cfg.num_prefix, cfg.d_model),
                                      dtype=dt, device=self.embed.device)}

    def decode_step(self, cache: dict, token: torch.Tensor, t: int):
        """One token for the whole batch over ``cache["memory"]``.  token:
        (B,) int; t: position.  Returns (logits (B, V) f32, cache); the
        self-attention cache is updated in place."""
        cfg = self.cfg
        h = embed_tokens(self.embed, token)[:, None, :]          # (B, 1, d)
        memory = cache["memory"]
        mem_pos = torch.arange(memory.shape[1], device=h.device)
        pos = torch.full((1,), t, dtype=torch.long, device=h.device)
        for i, block in enumerate(self.dec_blocks):
            a_in = rms_norm(h, block.ln1, cfg.norm_eps)
            a_out, _ = attn_lib.decode_attention_block(
                block.self_attn, a_in,
                {k: v[i] for k, v in cache["self"].items()}, t,
                cfg.rope_theta, chunk=cfg.attn_chunk,
                use_chunked=not cfg.decode_dense_attn)
            h = h + a_out
            x_in = rms_norm(h, block.lnx, cfg.norm_eps)
            h = h + attn_lib.attention_block(
                block.cross_attn, x_in, pos, cfg.rope_theta, causal=False,
                kv_override=(memory, mem_pos), use_chunked=False,
                use_kernel=False)
            m_in = rms_norm(h, block.ln2, cfg.norm_eps)
            h = h + apply_mlp(block.mlp, m_in, cfg.mlp_activation)
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return (h[:, 0, :] @ self.lm_head).float(), cache

    def prefill(self, tokens: torch.Tensor, prefix_emb: torch.Tensor):
        """Encode the frames ``prefix_emb`` and run the decoder over the
        prompt ``tokens``; returns (last-position logits f32, aux 0)."""
        hidden, aux = self.hidden_states(tokens, prefix_emb)
        return (hidden[:, -1, :] @ self.lm_head).float(), aux
