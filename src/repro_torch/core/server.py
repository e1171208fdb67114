"""Server-side aggregation (paper eq. 6), ported from ``repro/core/server.py``:

    w_{k+1} = w_k - eps * (sum_i alpha_i g_i) / max(sum_i alpha_i, 1).
"""

from __future__ import annotations

import torch


def aggregate(grads: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """Masked mean over transmitting agents: (..., m, n), (..., m) -> (..., n)."""
    num_tx = alphas.sum(-1, keepdim=True)
    summed = torch.einsum("...m,...mn->...n", alphas, grads)
    return summed / torch.clamp(num_tx, min=1.0)


def server_update(w: torch.Tensor, grads: torch.Tensor, alphas: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Eq. 6: one server step given all agents' gradients and decisions."""
    return w - eps * aggregate(grads, alphas)
