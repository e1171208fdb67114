"""Plain-torch oracles of the three gain kernels, ported from
``repro/kernels/ref.py``.

These are the semantics; ``repro_torch.kernels.gain`` runs them for CPU
tensors and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.  All take leading batch dims where the reference vmaps, compute in
float32 and never use TF32.
"""

from __future__ import annotations

from typing import Optional

import torch

# Trigger modes and their ids: the port's one definition (gain_dispatch
# re-exports them, csrc/gain.cu mirrors the ids; pinned by a test).
MODES = ("theoretical", "practical", "norm", "random", "always", "never")
(MODE_THEORETICAL, MODE_PRACTICAL, MODE_NORM, MODE_RANDOM, MODE_ALWAYS,
 MODE_NEVER) = range(len(MODES))


def _full_f32():
    # the oracle is the float32 contract: no TF32 in any matmul on the card
    torch.backends.cuda.matmul.allow_tf32 = False


def gain_matvec_ref(phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """proj_t = phi_t . g: phi (..., T, n), g (..., n) -> (..., T) f32."""
    _full_f32()
    return (phi.float() @ g.float().unsqueeze(-1)).squeeze(-1)


def practical_gain_ref(phi: torch.Tensor, g: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """Eq. 15: -eps ||g||^2 + eps^2 mean_t proj_t^2, per leading index."""
    proj = gain_matvec_ref(phi, g)
    gf = g.float()
    return (-eps * (gf * gf).sum(-1)
            + eps**2 * (proj * proj).sum(-1) / phi.shape[-2])


def gain_family_stats_ref(phi: torch.Tensor, g: torch.Tensor,
                          grad_j: Optional[torch.Tensor] = None,
                          phi_matrix: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-agent gain-family statistics.

    phi (*B, m, T, n); g (*B, m, n); grad_j (n,) shared or (*B, n) per run;
    phi_matrix (n, n) shared or (*B, n, n) per run.  With a model returns
    (*B, m, 4) f32 ``[||g||^2, sum_t (phi_t.g)^2, g.grad_J, g^T Phi g]``;
    without one, the (*B, m, 2) prefix.
    """
    _full_f32()
    gf = g.float()
    proj = (phi.float() @ gf.unsqueeze(-1)).squeeze(-1)
    cols = [(gf * gf).sum(-1), (proj * proj).sum(-1)]
    if grad_j is not None and phi_matrix is not None:
        gj = grad_j.float()
        if gj.dim() > 1:                      # per run: broadcast over agents
            gj = gj.unsqueeze(-2)
        cols += [(gf * gj).sum(-1),
                 ((gf @ phi_matrix.float()) * gf).sum(-1)]
    return torch.stack(cols, dim=-1)


def gains_from_stats_ref(stats: torch.Tensor, mode: torch.Tensor, eps: float,
                         num_samples: int) -> torch.Tensor:
    """Mode-selected gains (eq. 13 / 15 / Remark 4) from (..., m, 2|4) stats;
    ``mode`` broadcasts against (..., m)."""
    prac = -eps * stats[..., 0] + eps**2 * stats[..., 1] / num_samples
    norm = -eps * stats[..., 0]
    theo = (-eps * stats[..., 2] + eps**2 * stats[..., 3]
            if stats.shape[-1] == 4 else prac)
    return select_gain(mode, theo, norm, prac)


def select_gain(mode: torch.Tensor, theo: torch.Tensor, norm: torch.Tensor,
                prac: torch.Tensor) -> torch.Tensor:
    """eq. 13 for "theoretical", Remark 4 for "norm", eq. 15 otherwise."""
    return torch.where(mode == MODE_THEORETICAL, theo,
                       torch.where(mode == MODE_NORM, norm, prac))


def select_alphas(mode: torch.Tensor, gate: torch.Tensor,
                  alpha_rand: torch.Tensor) -> torch.Tensor:
    """The eq. 9 gate or the random / always / never baselines, by mode."""
    one = torch.ones_like(gate)
    return torch.where(mode == MODE_ALWAYS, one,
                       torch.where(mode == MODE_NEVER, torch.zeros_like(gate),
                                   torch.where(mode == MODE_RANDOM,
                                               alpha_rand.to(gate.dtype),
                                               gate)))


def megastep_ref(phi: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                 ctl: torch.Tensor, alpha_rand: torch.Tensor,
                 grad_j: Optional[torch.Tensor] = None,
                 phi_matrix: Optional[torch.Tensor] = None,
                 deliver: Optional[torch.Tensor] = None, *,
                 eps: float):
    """Whole-inner-step oracle for R runs.

    phi (R, m, T, n); g (R, m, n); w (R, n); ctl (R, 2) f32 ``[threshold,
    mode_id]``; alpha_rand (R, m); grad_j (R, n); phi_matrix (n, n) or
    (R, n, n); deliver (R, m) optional channel keep mask.  Returns
    ``(w_next (R, n), alphas (R, m), gains (R, m))``: mode-selected gains,
    the eq. 9 trigger with its baselines, and the eq. 6 gated update over
    ``alphas * deliver``.
    """
    stats = gain_family_stats_ref(phi, g, grad_j, phi_matrix)
    thresh, mode = ctl[..., 0:1], ctl[..., 1:2]
    gains = gains_from_stats_ref(stats, mode, eps, phi.shape[-2])
    gate = (gains <= -thresh).float()
    alphas = select_alphas(mode, gate, alpha_rand.float())
    eff = alphas if deliver is None else alphas * deliver.float()
    gf = g.float()
    upd = (torch.einsum("...m,...mn->...n", eff, gf)
           / torch.clamp(eff.sum(-1, keepdim=True), min=1.0))
    return w.float() - eps * upd, alphas, gains
