"""Attention-free Mamba2 language model (mamba2-370m family), ported from
``repro/models/ssm_model.py`` as an ``nn.Module``.

Blocks are {norm, mamba2-mixer} only (the SSD architecture folds the MLP
into the expanded mixer, hence d_ff = 0).  Decode is O(1) in context
length.  The reference's stacked ``blocks`` tree is an ``nn.ModuleList``
here (``repro_torch.convert.model_from_jax`` splits it), and the model
methods take no params argument: the module holds them.  ``loss_fn``
trains on the plain chunked SSD, as the reference trains through its jnp
SSD: the SSD kernels are forward-only.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import random as trandom
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (chunked_xent_loss, embed_tokens,
                                       init_embedding, model_dtype, param,
                                       param_dict, rms_norm, run_block,
                                       truncated_normal)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = param(torch.ones((cfg.d_model,), device=gen.device))
        self.mamba = param_dict(ssm_lib.init_mamba2(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
            cfg.ssm_conv_width, model_dtype(cfg)))


class MambaLM(nn.Module):
    """``use_kernels`` picks the SSD tile kernel's path (the default) or the
    plain chunked SSD of ``models/ssm.py`` for prefill."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = True
        dt = model_dtype(cfg)
        self.embed = param(init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt))
        self.blocks = nn.ModuleList(MambaBlock(cfg, gen)
                                    for _ in range(cfg.num_layers))
        self.final_norm = param(torch.ones((cfg.d_model,), device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = param(truncated_normal(
                gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dt))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _block(self, h: torch.Tensor, block: MambaBlock,
               use_kernels: bool) -> torch.Tensor:
        cfg = self.cfg
        m_in = rms_norm(h, block.ln1, cfg.norm_eps)
        return h + ssm_lib.apply_mamba2(
            block.mamba, m_in, cfg.ssm_state, cfg.ssm_head_dim,
            norm_eps=cfg.norm_eps, use_kernel=use_kernels)

    def hidden_states(self, tokens: torch.Tensor, prefix_emb=None,
                      use_kernels=None):
        """Embed and run all blocks.  Returns (final-normed hidden, aux 0).
        ``use_kernels`` defaults to the module's switch."""
        cfg = self.cfg
        use_kernels = self.use_kernels if use_kernels is None else use_kernels
        h = embed_tokens(self.embed, tokens)
        for block in self.blocks:
            h = run_block(self._block, h, cfg.remat, block, use_kernels)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return rms_norm(h, self.final_norm, cfg.norm_eps), aux

    def loss_fn(self, batch: dict):
        """Next-token cross-entropy of ``batch`` (tokens / targets / mask).
        Returns (loss, {"xent", "aux"}).  Runs the plain path whatever
        ``use_kernels`` says: the kernels are forward-only and raise under
        autograd (``forward_only``)."""
        hidden, aux = self.hidden_states(batch["tokens"], use_kernels=False)
        xent = chunked_xent_loss(hidden, self.head(), batch["targets"],
                                 batch["mask"], self.cfg.loss_chunk)
        return xent, {"xent": xent, "aux": aux}

    def cache_len(self, seq_len: int) -> int:
        return 1   # O(1) recurrent state; seq_len only sets position bookkeeping

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"ssm": (layers, B, H, N, P) f32, "conv": (layers, B, W-1, C)}."""
        cfg = self.cfg
        one = ssm_lib.init_mamba_cache(batch, cfg.d_model, cfg.ssm_state,
                                       cfg.ssm_head_dim, cfg.ssm_expand,
                                       cfg.ssm_conv_width, model_dtype(cfg),
                                       self.embed.device)
        return {k: v.expand((cfg.num_layers,) + v.shape).clone()
                for k, v in one.items()}

    def decode_step(self, cache: dict, token: torch.Tensor, t):
        """One token for the whole batch.  token: (B,) int; the recurrent
        state is position-free, so ``t`` is unused.  Returns (logits (B, V)
        f32, cache); the cache is updated in place, layer by layer."""
        cfg = self.cfg
        h = embed_tokens(self.embed, token)[:, None, :]
        for i, block in enumerate(self.blocks):
            m_in = rms_norm(h, block.ln1, cfg.norm_eps)
            out, new = ssm_lib.decode_mamba2(
                block.mamba, m_in, {k: v[i] for k, v in cache.items()},
                cfg.ssm_state, cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
            for k, v in new.items():
                cache[k][i] = v
            h = h + out
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return (h[:, 0, :] @ self.head()).float(), cache

    def prefill(self, tokens: torch.Tensor, prefix_emb=None):
        """Process a full prompt; returns (last-position logits f32, aux)."""
        hidden, aux = self.hidden_states(tokens)
        return (hidden[:, -1, :] @ self.head()).float(), aux


@torch.no_grad()
def reference_weights(model: MambaLM, seed: int = 0) -> MambaLM:
    """Overwrite ``model``'s random leaves with the draws of the
    reference's ``MambaLM.init(jax.random.key(seed))``: the same key splits
    (embed, one key a block split six ways, lm_head), each leaf ``scale *
    truncated_normal`` on the port's threefry, bit for bit JAX's.  The
    constant leaves stay the port's own: equal to the reference's but for
    ``a_log``, within one ulp (``jnp.linspace`` rounds its interpolation
    its own way).  Returns ``model``."""
    cfg = model.cfg
    dev = model.embed.device
    keys = trandom.split(trandom.key(seed, dev), cfg.num_layers + 2)

    def draw(leaf, key, scale):
        leaf.copy_(scale * trandom.truncated_normal(
            key, tuple(leaf.shape)).to(leaf.dtype))

    d_inner = cfg.ssm_expand * cfg.d_model
    draw(model.embed, keys[0], cfg.d_model**-0.5)
    for key, block in zip(keys[1:-1], model.blocks):
        ks = trandom.split(key, 6)
        draw(block.mamba["w_in"], ks[0], cfg.d_model**-0.5)
        draw(block.mamba["conv_w"], ks[1], cfg.ssm_conv_width**-0.5)
        draw(block.mamba["w_out"], ks[2], d_inner**-0.5)
    if not cfg.tie_embeddings:
        draw(model.lm_head, keys[-1], cfg.d_model**-0.5)
    return model
