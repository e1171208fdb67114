"""Mixture-of-Experts MLP with top-k routing and capacity dispatch, ported
from ``repro/models/moe.py``.

Routing is batch-row local, as in the reference: each sequence routes its
own L tokens with capacity ``C = capacity(L, E, k, factor)`` per expert.
A token's k experts come from the float32 router's softmax (``top_k_ids``:
descending, the lower expert first on a tie, as ``jax.lax.top_k``), their
gates are renormalised over the k, and its position in an expert is the
count of earlier (token, choice) pairs in token-major ``L·k`` order that
chose that expert; pairs at position ``C`` or beyond are dropped (gate 0,
slot ``C``, the scratch row).  ``route`` does all of this in one
module-level function, and the choice in the module-level ``top_k_ids``,
which ``route`` looks up at call time: a check can wrap it to record the
plain path's choices and replay them elsewhere.

Dispatch fills a (E, B, C) table of token indices (each kept slot written
by exactly one (token, choice) pair, integer writes, no float atomics;
only the scratch row C collects several), then gathers the tokens' rows
into the (E, B·C, d) expert input, empty slots reading a zero row.  The
result is the reference's ``(B, E, C, d)`` scatter-add buffer laid out
expert-major for the batched products, and a repeated call gives the same
bits.  The expert FFN is three batched products (``torch.bmm``; the
reference computes them outside any Pallas kernel), and the combine
gathers each token's k outputs and sums them weighted by the gates.
The reference's ``constrain_batch_dim`` sharding hints have no
counterpart on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import truncated_normal


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, num_experts: int,
             activation: str, dtype) -> dict:
    s_in = d_model**-0.5
    s_out = d_ff**-0.5
    params = {
        "router": truncated_normal(gen, (d_model, num_experts), s_in),
        "w_up": truncated_normal(gen, (num_experts, d_model, d_ff), s_in, dtype),
        "w_down": truncated_normal(gen, (num_experts, d_ff, d_model), s_out, dtype),
    }
    if activation == "swiglu":
        params["w_gate"] = truncated_normal(gen, (num_experts, d_model, d_ff),
                                            s_in, dtype)
    return params


def capacity(num_tokens: int, num_experts: int, k: int, factor: float) -> int:
    c = int(num_tokens * k * factor / num_experts) + 1
    return max(8, -(-c // 8) * 8)   # round up to a multiple of 8


class Routing(NamedTuple):
    logits: torch.Tensor       # (B, L, E) float32
    probs: torch.Tensor        # (B, L, E) float32
    expert_ids: torch.Tensor   # (B, L, k) int64, descending probability
    flat_ids: torch.Tensor     # (B, L·k) token-major
    safe_pos: torch.Tensor     # (B, L·k) slot in the expert; C if dropped
    gates_flat: torch.Tensor   # (B, L·k) float32; 0 if dropped


def top_k_ids(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest along the last axis, descending, the lower index first
    among equals (``jax.lax.top_k``'s order, which the position cumsum
    reads)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, k: int, C: int) -> Routing:
    """Per-row routing of x (B, L, d) to ``k`` of the router's (d, E)
    experts with capacity ``C``; the gates are the probabilities at the
    experts that ``top_k_ids`` chose."""
    B, L, _ = x.shape
    E = router.shape[-1]
    logits = x.float() @ router                                  # (B, L, E)
    probs = torch.softmax(logits, dim=-1)
    expert_ids = top_k_ids(probs, k)
    gate_vals = torch.gather(probs, -1, expert_ids)              # (B, L, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_ids = expert_ids.reshape(B, L * k)
    # expert-major, so that the count runs along the inner axis (a scan
    # along the outer L·k axis is far slower on the card)
    onehot = F.one_hot(flat_ids, E).to(torch.int32).transpose(1, 2).contiguous()
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot  # (B, E, L·k)
    pos_in_expert = torch.gather(pos, 1, flat_ids[:, None, :])[:, 0].long()
    keep = pos_in_expert < C
    gates_flat = gate_vals.reshape(B, L * k) * keep.to(gate_vals.dtype)
    safe_pos = torch.where(keep, pos_in_expert, torch.full_like(pos_in_expert, C))
    return Routing(logits, probs, expert_ids, flat_ids, safe_pos, gates_flat)


def dispatch(x: torch.Tensor, r: Routing, E: int, C: int) -> torch.Tensor:
    """Kept tokens into their slots: (E, B·C, d) in x's dtype, an empty
    slot all zeros.  Each kept slot is written by one (token, choice) pair,
    so the table holds no race; the scratch row C is cut off."""
    B, L, d = x.shape
    k = r.flat_ids.shape[1] // L
    dev = x.device
    slot_tok = torch.full((E, B, C + 1), L, dtype=torch.long, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None]
    tok = (torch.arange(L * k, device=dev) // k).expand(B, L * k)
    slot_tok[r.flat_ids, b_idx, r.safe_pos] = tok
    xpad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)         # row L: zeros
    rows = xpad[torch.arange(B, device=dev)[None, :, None], slot_tok[:, :, :C]]
    return rows.reshape(E, B * C, d)


def expert_ffn(params, expert_in: torch.Tensor, activation: str) -> torch.Tensor:
    """(E, B·C, d) -> (E, B·C, d): each expert's MLP on its slots."""
    up = torch.bmm(expert_in, params["w_up"])
    if activation == "swiglu":
        up = F.silu(torch.bmm(expert_in, params["w_gate"])) * up
    elif activation == "relu2":
        up = torch.square(F.relu(up))
    elif activation == "gelu":
        up = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return torch.bmm(up, params["w_down"])


def combine(expert_out: torch.Tensor, r: Routing, B: int, C: int) -> torch.Tensor:
    """Each token's k expert outputs, weighted by its gates and summed:
    (B, L, d).  A dropped choice reads slot C - 1 at gate 0."""
    E, _, d = expert_out.shape
    Lk = r.flat_ids.shape[1]
    k = r.expert_ids.shape[-1]
    b_idx = torch.arange(B, device=expert_out.device)[:, None]
    vals = expert_out.reshape(E, B, C, d)[
        r.flat_ids, b_idx, torch.clamp(r.safe_pos, max=C - 1)]   # (B, L·k, d)
    vals = vals * r.gates_flat[..., None].to(vals.dtype)
    return vals.reshape(B, Lk // k, k, d).sum(dim=2)


def apply_moe(params, x: torch.Tensor, k: int, capacity_factor: float,
              activation: str, aux_coef: float, z_coef: float):
    """x (B, L, d) -> (output (B, L, d), aux loss float32 scalar): the
    Switch balance loss plus the router z-loss, over all B·L tokens."""
    B, L, _ = x.shape
    E = params["router"].shape[-1]
    C = capacity(L, E, k, capacity_factor)
    r = route(x, params["router"], k, C)

    me = r.probs.mean(dim=(0, 1))                                # (E,)
    ce = F.one_hot(r.expert_ids, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = aux_coef * E * torch.sum(me * ce)
    zloss = z_coef * torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)

    expert_out = expert_ffn(params, dispatch(x, r, E, C), activation)
    return combine(expert_out, r, B, C), aux + zloss
