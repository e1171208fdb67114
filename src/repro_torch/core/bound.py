"""Theorem 1's bound (eq. 12) in plain Python, ported from
``repro/core/trigger.py``.  Torch-free, so the report renders it without
importing torch; ``core.trigger`` exports the same function."""

from __future__ import annotations


def theorem1_bound(lam: float, rho: float, eps: float, num_iterations: int,
                   j_w0: float, j_wstar: float, trace_phi_g: float) -> float:
    """Right-hand side of Theorem 1 (eq. 12)."""
    geo = (1.0 - rho**num_iterations) / (1.0 - rho)
    return (lam + j_wstar + rho**num_iterations * (j_w0 - j_wstar)
            + geo * eps**2 * trace_phi_g)
