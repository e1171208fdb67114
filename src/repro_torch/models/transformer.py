"""Decoder-only transformer (dense, MoE and vision-prefix: yi-6b,
phi3-mini, nemotron-4, olmoe, mixtral, moonshot, internvl2), ported from
``repro/models/transformer.py`` as an ``nn.Module``.

Supported: GQA + RoPE, sliding window, swiglu/relu2/gelu MLPs, MoE MLPs in
every block when the config has experts (``models/moe.py``; their aux
losses summed over the layers), tied embeddings, and vision / audio
prefix embeddings through the frontend projector (``models/frontends.py``:
the projected prefix goes in front of the token embeddings, every position
causal, and the loss skips it).  Layers are an
``nn.ModuleList`` (the reference stacks them on a leading axis for
``lax.scan``); prefill runs the flash-attention kernel per layer unless
``use_kernels`` is False, and decode threads a per-layer KV cache that is
updated in place (its MoE with aux coefficients 0, as the reference's).
``loss_fn`` trains through the plain attention, as the reference trains
through its jnp attention: the flash kernel is forward-only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import frontends
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_mlp, chunked_xent_loss,
                                       embed_tokens, init_embedding, init_mlp,
                                       model_dtype, param, param_dict,
                                       rms_norm, run_block, truncated_normal)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = model_dtype(cfg)
        self.ln1 = param(torch.ones((cfg.d_model,), device=gen.device))
        self.ln2 = param(torch.ones((cfg.d_model,), device=gen.device))
        self.attn = param_dict(attn_lib.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, dt))
        if cfg.is_moe:
            self.moe = param_dict(moe_lib.init_moe(
                gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                cfg.mlp_activation, dt))
        else:
            self.mlp = param_dict(init_mlp(gen, cfg.d_model, cfg.d_ff,
                                           cfg.mlp_activation, dt))


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = True
        dt = model_dtype(cfg)
        self.embed = param(init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt))
        self.blocks = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.num_layers))
        self.final_norm = param(torch.ones((cfg.d_model,), device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = param(truncated_normal(
                gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dt))
        if cfg.frontend != "none":
            self.projector = param_dict(frontends.init_projector(
                gen, cfg.frontend_dim, cfg.d_model, dt))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _mlp(self, block: Block, m_in: torch.Tensor, aux_coef: float,
             z_coef: float):
        """The block's MLP: (output, aux loss or None for a dense MLP)."""
        cfg = self.cfg
        if cfg.is_moe:
            return moe_lib.apply_moe(
                block.moe, m_in, cfg.experts_per_token, cfg.capacity_factor,
                cfg.mlp_activation, aux_coef, z_coef)
        return apply_mlp(block.mlp, m_in, cfg.mlp_activation), None

    def _block(self, h: torch.Tensor, block: Block, positions: torch.Tensor,
               use_kernels: bool):
        cfg = self.cfg
        a_in = rms_norm(h, block.ln1, cfg.norm_eps)
        h = h + attn_lib.attention_block(
            block.attn, a_in, positions, cfg.rope_theta, causal=True,
            window=cfg.sliding_window, chunk=cfg.attn_chunk,
            use_chunked=h.shape[1] > 512, use_kernel=use_kernels)
        m_in = rms_norm(h, block.ln2, cfg.norm_eps)
        m_out, aux = self._mlp(block, m_in, cfg.router_aux_coef,
                               cfg.router_z_coef)
        return h + m_out, aux

    def hidden_states(self, tokens: torch.Tensor,
                      prefix_emb: Optional[torch.Tensor] = None,
                      use_kernels=None):
        """Embed (the projected ``prefix_emb`` (B, P, frontend_dim) in front
        of the tokens, when given) and run all blocks.  Returns
        (final-normed hidden over every position, prefix included; aux: the
        MoE losses summed over the layers, 0 without MoE).  ``use_kernels``
        defaults to the module's switch."""
        cfg = self.cfg
        use_kernels = self.use_kernels if use_kernels is None else use_kernels
        h = embed_tokens(self.embed, tokens)
        if prefix_emb is not None:
            proj = frontends.apply_projector(self.projector, prefix_emb)
            h = torch.cat([proj.to(h.dtype), h], dim=1)
        positions = torch.arange(h.shape[1], device=h.device)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for block in self.blocks:
            h, a = run_block(self._block, h, cfg.remat, block, positions,
                             use_kernels)
            if a is not None:
                aux = aux + a
        return rms_norm(h, self.final_norm, cfg.norm_eps), aux

    def loss_fn(self, batch: dict):
        """Next-token cross-entropy (+ aux, 0 without MoE) of ``batch``
        (tokens / targets / mask, + ``prefix_emb`` for the vision / audio
        decoders: the loss is on the text positions only).  Returns (loss,
        {"xent", "aux"}).  Runs the plain path whatever ``use_kernels``
        says: the kernels are forward-only and raise under autograd
        (``forward_only``)."""
        prefix = batch.get("prefix_emb")
        hidden, aux = self.hidden_states(batch["tokens"], prefix,
                                         use_kernels=False)
        if prefix is not None:
            hidden = hidden[:, prefix.shape[1]:]
        xent = chunked_xent_loss(hidden, self.head(), batch["targets"],
                                 batch["mask"], self.cfg.loss_chunk)
        return xent + aux, {"xent": xent, "aux": aux}

    # -- serving ---------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        if self.cfg.sliding_window > 0:
            return min(seq_len, self.cfg.sliding_window)
        return seq_len

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"k", "v"}: (layers, B, S, KV, hd) in the model's dtype."""
        cfg = self.cfg
        one = attn_lib.init_kv_cache(batch, self.cache_len(seq_len),
                                     cfg.num_kv_heads, cfg.resolved_head_dim,
                                     model_dtype(cfg), self.embed.device)
        return {k: v.expand((cfg.num_layers,) + v.shape).clone()
                for k, v in one.items()}

    def decode_step(self, cache: dict, token: torch.Tensor, t: int):
        """One token for the whole batch.  token: (B,) int; t: position.
        Returns (logits (B, V) f32, cache); the cache is updated in place.
        Decode takes no prefix, as the reference's does."""
        cfg = self.cfg
        h = embed_tokens(self.embed, token)[:, None, :]          # (B, 1, d)
        for i, block in enumerate(self.blocks):
            a_in = rms_norm(h, block.ln1, cfg.norm_eps)
            a_out, _ = attn_lib.decode_attention_block(
                block.attn, a_in, {k: v[i] for k, v in cache.items()}, t,
                cfg.rope_theta, window=cfg.sliding_window,
                chunk=cfg.attn_chunk, use_chunked=not cfg.decode_dense_attn)
            h = h + a_out
            m_in = rms_norm(h, block.ln2, cfg.norm_eps)
            h = h + self._mlp(block, m_in, 0.0, 0.0)[0]
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return (h[:, 0, :] @ self.head()).float(), cache

    def prefill(self, tokens: torch.Tensor,
                prefix_emb: Optional[torch.Tensor] = None):
        """Process a full prompt (behind ``prefix_emb``, when given);
        returns (last-position logits f32, aux)."""
        hidden, aux = self.hidden_states(tokens, prefix_emb)
        return (hidden[:, -1, :] @ self.head()).float(), aux
