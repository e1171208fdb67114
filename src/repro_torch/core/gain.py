"""Performance-gain computation (paper eq. 13 and eq. 15), ported from
``repro/core/gain.py``.

gain = J(w - eps g) - J(w) = -eps g^T grad J + eps^2 g^T Phi g; transmit
iff gain <= -threshold (eq. 9).  Every function takes leading batch dims
on ``g`` (runs, agents); matrices broadcast against them.
"""

from __future__ import annotations

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _quad(g: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """g^T M g over the last axis: g (..., n); M (n, n), or (R, n, n) with
    g (R, m, n) — one product per run, never M copied per agent."""
    return _dot(g @ mat, g)


def theoretical_gain(g: torch.Tensor, grad_j: torch.Tensor,
                     phi: torch.Tensor, eps: float) -> torch.Tensor:
    """Exact gain via eq. 13 (needs the true grad J and Phi)."""
    return -eps * _dot(g, grad_j) + eps**2 * _quad(g, phi)


def practical_gain(g: torch.Tensor, phi_hat: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Eq. 15 with a materialized Phi_hat: -eps ||g||^2 + eps^2 g^T Phi_hat g."""
    return -eps * _dot(g, g) + eps**2 * _quad(g, phi_hat)


def practical_gain_streaming(g: torch.Tensor, phi_t: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """Eq. 15 in the O(T n) streaming form: g^T Phi_hat g = mean_t proj_t^2.

    ``phi_t`` is (..., T, n) and ``g`` (..., n); ``repro_torch.kernels.gain``
    has the CUDA version.
    """
    proj = (phi_t @ g.unsqueeze(-1)).squeeze(-1)
    return -eps * _dot(g, g) + eps**2 * torch.sum(proj**2, -1) / phi_t.shape[-2]


def gain_norm_only(g: torch.Tensor, eps: float) -> torch.Tensor:
    """Remark 4 ablation: -eps ||g||^2 (curvature-blind)."""
    return -eps * _dot(g, g)
