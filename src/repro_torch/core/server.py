"""Server-side aggregation (paper eq. 6), ported from ``repro/core/server.py``:

    w_{k+1} = w_k - eps * (sum_i alpha_i g_i) / max(sum_i alpha_i, 1).
"""

from __future__ import annotations

import torch


def gated_sum(grads: torch.Tensor, alphas: torch.Tensor):
    """``sum_i alpha_i g_i`` (..., n) and ``sum_i alpha_i`` (...,) over the
    agents of (..., m, n) gradients and (..., m) decisions."""
    return torch.einsum("...m,...mn->...n", alphas, grads), alphas.sum(-1)


def masked_mean(summed: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The eq. 6 mean: a gated sum over max(count, 1)."""
    return summed / torch.clamp(count, min=1.0).unsqueeze(-1)


def aggregate(grads: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """Masked mean over transmitting agents: (..., m, n), (..., m) -> (..., n)."""
    return masked_mean(*gated_sum(grads, alphas))


def server_update(w: torch.Tensor, grads: torch.Tensor, alphas: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Eq. 6: one server step given all agents' gradients and decisions."""
    return w - eps * aggregate(grads, alphas)
