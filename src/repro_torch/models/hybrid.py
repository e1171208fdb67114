"""Jamba-style hybrid: Mamba + attention interleaved 1:7, MoE every other
layer (arXiv:2403.19887), ported from ``repro/models/hybrid.py`` as an
``nn.Module``.

The depth is ``num_layers // attn_period`` identical super-blocks (an
``nn.ModuleList``; the reference stacks them for ``lax.scan``); inside a
super-block the ``attn_period`` layers have a static structure:

    position p:  mixer = attention if p == attn_period // 2 else mamba2
                 mlp   = MoE if p % moe_period == moe_period - 1 else dense

A super-block holds its mamba2 mixers, MoE MLPs and dense MLPs as lists in
position order (``superblocks.<i>.mamba.<j>`` and so on;
``repro_torch.convert`` splits the reference's two-level stacks into
them) beside one attention layer and the (period, d) norm weights.
Prefill runs the SSD and flash-attention kernels unless ``use_kernels`` is
False; ``loss_fn`` trains on the plain path, as the other families do.
The cache has the same two levels: an attention ring per super-block and
a recurrent state per mamba2 layer, updated in place by ``decode_step``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_mlp, chunked_xent_loss,
                                       embed_tokens, init_embedding, init_mlp,
                                       model_dtype, param, param_dict,
                                       rms_norm, run_block, truncated_normal)


class SuperBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, n_mamba: int,
                 n_moe: int, n_mlp: int):
        super().__init__()
        dt = model_dtype(cfg)
        dev = gen.device
        # the reference's order of initialisation: mixers, attention, MLPs
        self.mamba = nn.ModuleList(param_dict(ssm_lib.init_mamba2(
            gen, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_expand,
            cfg.ssm_conv_width, dt)) for _ in range(n_mamba))
        self.attn = param_dict(attn_lib.init_attention(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, dt))
        self.moe = nn.ModuleList(param_dict(moe_lib.init_moe(
            gen, cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.mlp_activation,
            dt)) for _ in range(n_moe))
        self.mlp = nn.ModuleList(param_dict(init_mlp(
            gen, cfg.d_model, cfg.d_ff, cfg.mlp_activation, dt))
            for _ in range(n_mlp))
        self.ln1 = param(torch.ones((cfg.attn_period, cfg.d_model), device=dev))
        self.ln2 = param(torch.ones((cfg.attn_period, cfg.d_model), device=dev))


class HybridLM(nn.Module):
    """``use_kernels`` picks the kernels' path (the default) or the plain
    chunked SSD and attention for prefill."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        if cfg.num_layers % cfg.attn_period:
            raise ValueError("num_layers must be a multiple of attn_period")
        self.cfg = cfg
        self.use_kernels = True
        self.period = cfg.attn_period
        self.attn_pos = cfg.attn_period // 2
        self.n_super = cfg.num_layers // cfg.attn_period
        self.moe_positions = [
            p for p in range(self.period)
            if cfg.moe_period and p % cfg.moe_period == cfg.moe_period - 1]
        self.mamba_positions = [p for p in range(self.period)
                                if p != self.attn_pos]
        dt = model_dtype(cfg)
        self.embed = param(init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt))
        n_moe = len(self.moe_positions)
        self.superblocks = nn.ModuleList(
            SuperBlock(cfg, gen, len(self.mamba_positions), n_moe,
                       self.period - n_moe) for _ in range(self.n_super))
        self.final_norm = param(torch.ones((cfg.d_model,), device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = param(truncated_normal(
                gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dt))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _mlp(self, sb: SuperBlock, p: int, f_in: torch.Tensor,
             counters: dict, aux_coef: float, z_coef: float):
        """Position p's MLP: (output, aux loss or None for a dense MLP)."""
        cfg = self.cfg
        if p in self.moe_positions:
            i = counters["moe"]
            counters["moe"] += 1
            return moe_lib.apply_moe(
                sb.moe[i], f_in, cfg.experts_per_token, cfg.capacity_factor,
                cfg.mlp_activation, aux_coef, z_coef)
        i = counters["mlp"]
        counters["mlp"] += 1
        return apply_mlp(sb.mlp[i], f_in, cfg.mlp_activation), None

    def _super(self, h: torch.Tensor, sb: SuperBlock, positions: torch.Tensor,
               window: int, use_kernels: bool):
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        counters = {"mamba": 0, "moe": 0, "mlp": 0}
        for p in range(self.period):
            m_in = rms_norm(h, sb.ln1[p], cfg.norm_eps)
            if p == self.attn_pos:
                h = h + attn_lib.attention_block(
                    sb.attn, m_in, positions, cfg.rope_theta, causal=True,
                    window=window, chunk=cfg.attn_chunk,
                    use_chunked=h.shape[1] > 512, use_kernel=use_kernels)
            else:
                h = h + ssm_lib.apply_mamba2(
                    sb.mamba[counters["mamba"]], m_in, cfg.ssm_state,
                    cfg.ssm_head_dim, norm_eps=cfg.norm_eps,
                    use_kernel=use_kernels)
                counters["mamba"] += 1
            f_in = rms_norm(h, sb.ln2[p], cfg.norm_eps)
            out, a = self._mlp(sb, p, f_in, counters, cfg.router_aux_coef,
                               cfg.router_z_coef)
            if a is not None:
                aux = aux + a
            h = h + out
        return h, aux

    def hidden_states(self, tokens: torch.Tensor, prefix_emb=None,
                      window=None, use_kernels=None):
        """Embed and run every super-block.  Returns (final-normed hidden,
        aux: the MoE losses summed over the layers).  ``prefix_emb`` is
        accepted and unused, as in the reference; ``use_kernels`` defaults
        to the module's switch."""
        cfg = self.cfg
        use_kernels = self.use_kernels if use_kernels is None else use_kernels
        h = embed_tokens(self.embed, tokens)
        positions = torch.arange(h.shape[1], device=h.device)
        window = cfg.sliding_window if window is None else window
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for sb in self.superblocks:
            h, a = run_block(self._super, h, cfg.remat, sb, positions, window,
                             use_kernels)
            aux = aux + a
        return rms_norm(h, self.final_norm, cfg.norm_eps), aux

    def loss_fn(self, batch: dict):
        """Next-token cross-entropy + MoE aux of ``batch`` (tokens / targets
        / mask).  Returns (loss, {"xent", "aux"}).  Runs the plain path
        whatever ``use_kernels`` says: the kernels are forward-only."""
        hidden, aux = self.hidden_states(batch["tokens"], use_kernels=False)
        xent = chunked_xent_loss(hidden, self.head(), batch["targets"],
                                 batch["mask"], self.cfg.loss_chunk)
        return xent + aux, {"xent": xent, "aux": aux}

    # -- serving ---------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        """Attention cache length; long-context decode uses the reference's
        sliding-window variant (window 4096) above 131072 tokens."""
        if seq_len > 131_072:
            return 4_096
        if self.cfg.sliding_window > 0:
            return min(seq_len, self.cfg.sliding_window)
        return seq_len

    def init_cache(self, batch: int, seq_len: int) -> dict:
        """{"attn": {"k", "v"}: (super-blocks, B, S, KV, hd) in the model's
        dtype, "mamba": {"ssm": (super-blocks, mamba layers, B, H, N, P)
        f32, "conv": (super-blocks, mamba layers, B, W-1, C)}}."""
        cfg = self.cfg
        dev = self.embed.device
        attn = attn_lib.init_kv_cache(batch, self.cache_len(seq_len),
                                      cfg.num_kv_heads, cfg.resolved_head_dim,
                                      model_dtype(cfg), dev)
        mamba = ssm_lib.init_mamba_cache(batch, cfg.d_model, cfg.ssm_state,
                                         cfg.ssm_head_dim, cfg.ssm_expand,
                                         cfg.ssm_conv_width, model_dtype(cfg),
                                         dev)
        lead = (self.n_super,)
        return {
            "attn": {k: v.expand(lead + v.shape).clone() for k, v in attn.items()},
            "mamba": {k: v.expand(lead + (len(self.mamba_positions),)
                                  + v.shape).clone() for k, v in mamba.items()},
        }

    def decode_step(self, cache: dict, token: torch.Tensor, t: int):
        """One token for the whole batch.  token: (B,) int; t: position.
        Returns (logits (B, V) f32, cache); the cache is updated in place.
        The attention ring's size is its window, as in the reference."""
        cfg = self.cfg
        h = embed_tokens(self.embed, token)[:, None, :]
        window = cache["attn"]["k"].shape[2]
        for i, sb in enumerate(self.superblocks):
            counters = {"mamba": 0, "moe": 0, "mlp": 0}
            for p in range(self.period):
                m_in = rms_norm(h, sb.ln1[p], cfg.norm_eps)
                if p == self.attn_pos:
                    out, _ = attn_lib.decode_attention_block(
                        sb.attn, m_in, {k: v[i] for k, v in cache["attn"].items()},
                        t, cfg.rope_theta, window=window, chunk=cfg.attn_chunk,
                        use_chunked=not cfg.decode_dense_attn)
                else:
                    j = counters["mamba"]
                    out, new = ssm_lib.decode_mamba2(
                        sb.mamba[j], m_in,
                        {k: v[i, j] for k, v in cache["mamba"].items()},
                        cfg.ssm_state, cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
                    for k, v in new.items():
                        cache["mamba"][k][i, j] = v
                    counters["mamba"] += 1
                h = h + out
                f_in = rms_norm(h, sb.ln2[p], cfg.norm_eps)
                h = h + self._mlp(sb, p, f_in, counters, 0.0, 0.0)[0]
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        return (h[:, 0, :] @ self.head()).float(), cache

    def prefill(self, tokens: torch.Tensor, prefix_emb=None):
        """Process a full prompt; returns (last-position logits f32, aux)."""
        hidden, aux = self.hidden_states(tokens)
        return (hidden[:, -1, :] @ self.head()).float(), aux
