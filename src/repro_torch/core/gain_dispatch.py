"""Single dispatch point for every gain computation, ported from
``repro/core/gain_dispatch.py``.

Two orthogonal axes, both plain strings:

* ``backend`` ("reference" | "kernel") picks the implementation of the
  O(T n) projection work: plain torch (``repro_torch.core.gain``) or the
  hand-written CUDA kernels (``repro_torch.kernels.gain``, whose wrappers
  run their plain versions for CPU tensors).  Default from
  ``REPRO_TORCH_GAIN_BACKEND``, else "kernel".
* ``step_backend`` ("reference" | "fused" | "megastep") picks the structure
  of the per-step work: three independent gain passes; one shared
  ``family_stats`` pass; or the whole post-gradient step (gains, eq. 9
  trigger, eq. 6 update) as one ``megastep``.  Default from
  ``REPRO_TORCH_STEP_BACKEND``, else "megastep".

Tensors carry the sweep's run axis in front where the reference is vmapped:
``grads`` (R, m, n), ``phi_t`` (R, m, T, n), ``grad_j`` (R, n), ``phi_matrix``
(n, n) shared or (R, n, n) per run, ``mode_id`` an int or an (R,) tensor.
``tree_gain`` is the tree gain of LM training (``core/fed_sgd.py``).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import gain as _ref
from repro_torch.kernels import gain as _kernels
from repro_torch.kernels import ref as _kref
from repro_torch.kernels.ref import (MODE_ALWAYS, MODE_NEVER, MODE_NORM,  # noqa: F401
                                     MODE_PRACTICAL, MODE_RANDOM,
                                     MODE_THEORETICAL, MODES)

BACKENDS = ("reference", "kernel")
STEP_BACKENDS = ("reference", "fused", "megastep")

ModeId = Union[int, torch.Tensor]


def default_backend() -> str:
    return os.environ.get("REPRO_TORCH_GAIN_BACKEND", "kernel")


def default_step_backend() -> str:
    return os.environ.get("REPRO_TORCH_STEP_BACKEND", "megastep")


def _resolve(backend: Optional[str]) -> str:
    backend = backend or default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend


def _resolve_step(step_backend: Optional[str]) -> str:
    step_backend = step_backend or default_step_backend()
    if step_backend not in STEP_BACKENDS:
        raise ValueError(
            f"step_backend must be one of {STEP_BACKENDS}, got {step_backend!r}")
    return step_backend


def _agent_mode(mode_id: ModeId, like: torch.Tensor) -> torch.Tensor:
    """The mode id as a tensor that broadcasts against (..., m)."""
    mode = torch.as_tensor(mode_id, device=like.device)
    return mode.unsqueeze(-1) if mode.dim() else mode


def _per_run(x: Optional[torch.Tensor], base_dim: int):
    """Give a per-run model vector an agent axis (shared ones pass as is)."""
    if x is None or x.dim() == base_dim:
        return x
    return x.unsqueeze(-base_dim - 1)


def practical_gain(g: torch.Tensor, phi_t: torch.Tensor, eps: float, *,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Eq. 15 streaming gain per leading index (one launch with "kernel")."""
    if _resolve(backend) == "kernel":
        return _kernels.practical_gain(phi_t, g, eps=eps)
    return _ref.practical_gain_streaming(g, phi_t, eps)


def theoretical_gain(g, grad_j, phi_matrix, eps: float) -> torch.Tensor:
    """Eq. 13 exact gain; a per-run grad_j broadcasts over agents."""
    return _ref.theoretical_gain(g, _per_run(grad_j, 1), phi_matrix, eps)


def norm_gain(g: torch.Tensor, eps: float) -> torch.Tensor:
    """Remark 4 ablation: -eps ||g||^2."""
    return _ref.gain_norm_only(g, eps)


class FamilyStats(NamedTuple):
    """Shared per-agent sufficient statistics of the whole gain family."""

    gnorm2: torch.Tensor              # (..., m) ||g_i||^2
    sumproj2: torch.Tensor            # (..., m) sum_t (phi_it . g_i)^2
    gdotj: Optional[torch.Tensor]     # (..., m) g_i . grad J(w)
    quad: Optional[torch.Tensor]      # (..., m) g_i^T Phi g_i


def family_stats(grads: torch.Tensor, phi_t: torch.Tensor,
                 grad_j: Optional[torch.Tensor],
                 phi_matrix: Optional[torch.Tensor], *,
                 backend: Optional[str] = None) -> FamilyStats:
    """The gain family's statistics in one pass (one launch with "kernel");
    without an exact model the theoretical columns are None."""
    have_model = grad_j is not None and phi_matrix is not None
    fn = (_kernels.gain_family_stats if _resolve(backend) == "kernel"
          else _kref.gain_family_stats_ref)
    stats = fn(phi_t, grads, grad_j if have_model else None,
               phi_matrix if have_model else None)
    return FamilyStats(gnorm2=stats[..., 0], sumproj2=stats[..., 1],
                       gdotj=stats[..., 2] if have_model else None,
                       quad=stats[..., 3] if have_model else None)


def gains_from_stats(mode_id: ModeId, stats: FamilyStats, eps: float,
                     num_samples: int) -> torch.Tensor:
    """Mode-selected gains from shared family statistics."""
    cols = [stats.gnorm2, stats.sumproj2]
    if stats.gdotj is not None and stats.quad is not None:
        cols += [stats.gdotj, stats.quad]
    # without a model, spec validation guarantees mode_id != theoretical
    return _kref.gains_from_stats_ref(torch.stack(cols, dim=-1),
                                      _agent_mode(mode_id, stats.gnorm2),
                                      eps, num_samples)


def mode_gains(mode_id: ModeId, grads: torch.Tensor, phi_t: torch.Tensor,
               eps: float, grad_j: Optional[torch.Tensor],
               phi_matrix: Optional[torch.Tensor], *,
               backend: Optional[str] = None,
               step_backend: Optional[str] = None) -> torch.Tensor:
    """Per-agent gains (..., m) for each run's trigger mode.

    eq. 13 for "theoretical", the norm ablation for "norm", eq. 15 for the
    rest.  "fused" and "megastep" derive all three from one
    ``family_stats`` pass; "reference" keeps three independent passes.
    """
    if _resolve_step(step_backend) in ("fused", "megastep"):
        stats = family_stats(grads, phi_t, grad_j, phi_matrix,
                             backend=backend)
        return gains_from_stats(mode_id, stats, eps, phi_t.shape[-2])
    prac = practical_gain(grads, phi_t, eps, backend=backend)
    norm = norm_gain(grads, eps)
    if grad_j is None or phi_matrix is None:
        theo = prac  # spec validation guarantees mode_id != theoretical
    else:
        theo = theoretical_gain(grads, grad_j, phi_matrix, eps)
    return _kref.select_gain(_agent_mode(mode_id, prac), theo, norm, prac)


def select_alphas(mode_id: ModeId, gate: torch.Tensor,
                  alpha_rand: torch.Tensor) -> torch.Tensor:
    """Transmit decisions: the eq. 9 gate, or the random / always / never
    baseline, by each run's mode."""
    return _kref.select_alphas(_agent_mode(mode_id, gate), gate, alpha_rand)


def megastep(mode_id: ModeId, w: torch.Tensor, grads: torch.Tensor,
             phi_t: torch.Tensor, eps: float, threshold,
             alpha_rand: torch.Tensor, grad_j: Optional[torch.Tensor],
             phi_matrix: Optional[torch.Tensor], *,
             backend: Optional[str] = None,
             deliver: Optional[torch.Tensor] = None):
    """One whole gated-SGD inner step for R runs: gains + trigger + eq. 6.

    Args:
      mode_id:    int or (R,) mode ids.
      w:          (R, n) server weights.
      grads:      (R, m, n); phi_t: (R, m, T, n).
      threshold:  float or (R,) lambda_k.
      alpha_rand: (R, m) pre-drawn f32 bernoulli decisions (random mode).
      grad_j:     (R, n) exact grad J(w), or None.
      phi_matrix: (n, n) or (R, n, n) exact Phi, or None.
      deliver:    optional (R, m) 0/1 channel keep mask.

    Returns ``(w_next (R, n), alphas (R, m), gains (R, m))``; with
    ``backend="kernel"`` the step is one ``megastep_call`` (two launches).
    """
    have_model = grad_j is not None and phi_matrix is not None
    R, dev = w.shape[0], w.device
    ctl = torch.stack([
        torch.as_tensor(threshold, dtype=torch.float32, device=dev).expand(R),
        torch.as_tensor(mode_id, device=dev).to(torch.float32).expand(R),
    ], dim=-1).contiguous()
    fn = (_kernels.megastep_call if _resolve(backend) == "kernel"
          else _kref.megastep_ref)
    return fn(phi_t, grads, w, ctl, alpha_rand.contiguous(),
              grad_j if have_model else None,
              phi_matrix if have_model else None, deliver=deliver, eps=eps)


def tree_gain(g, cfg, grad_fn=None, params=None) -> torch.Tensor:
    """Tree gain for deep-net training (HVP eq. 13 / gnorm ablation).

    Thin re-export of ``repro_torch.core.fed_sgd.local_gain`` so the train
    step and the sweep stack share one entry point.  Imported lazily, as
    the reference does, to keep ``core`` free of an import cycle.
    """
    from repro_torch.core import fed_sgd
    return fed_sgd.local_gain(g, cfg, grad_fn=grad_fn, params=params)
