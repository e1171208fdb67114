"""Linear value-function approximation (paper §II), ported from
``repro/core/vfa.py``.

J(w) = E_d[(target(x) - w^T phi(x))^2] with the factor-2 gradient
convention, so ``E[g_hat] = grad J`` and ``hess J = 2 Phi``.  Functions take
any leading batch dims (runs, agents) where the reference vmaps.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VFAProblem:
    """A fixed instance of problem (3): features + visit weights + targets."""

    phi_matrix: torch.Tensor   # (num_states, n) feature matrix under d
    d_weights: torch.Tensor    # (num_states,) probability weights of d
    targets: torch.Tensor      # (num_states,) Bellman targets
    gamma: float

    @property
    def n(self) -> int:
        return int(self.phi_matrix.shape[-1])

    def second_moment(self) -> torch.Tensor:
        """Phi = E_d phi phi^T  (Assumption 1 requires this PD)."""
        return torch.einsum("s,si,sj->ij", self.d_weights, self.phi_matrix,
                            self.phi_matrix)

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        """Exact J(w) under the population distribution d."""
        resid = self.phi_matrix @ w - self.targets
        return torch.sum(self.d_weights * resid**2)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        """Exact grad J(w) = 2 E_d[phi (w^T phi - target)]."""
        resid = self.phi_matrix @ w - self.targets
        return 2.0 * torch.einsum("s,si->i", self.d_weights * resid,
                                  self.phi_matrix)

    def optimum(self) -> torch.Tensor:
        """w* solving (3): Phi w = E_d[phi * target]."""
        b = torch.einsum("s,si->i", self.d_weights * self.targets,
                         self.phi_matrix)
        return torch.linalg.solve(self.second_moment(), b)

    def check_assumption_1(self, tol: float = 1e-9) -> bool:
        return bool(torch.linalg.eigvalsh(self.second_moment()).min() > tol)

    def max_stable_stepsize(self) -> float:
        """Assumption 2's sufficient condition: eps < 1 / lambda_max(Phi)."""
        return float(1.0 / torch.linalg.eigvalsh(self.second_moment()).max())

    def min_rho(self, eps: float) -> float:
        """Assumption 3 lower bound: rho >= max_i (1 - 2 eps lambda_i)^2."""
        eigs = torch.linalg.eigvalsh(self.second_moment())
        return float(torch.max((1.0 - 2.0 * eps * eigs) ** 2))


def stochastic_gradient(w: torch.Tensor, phi_t: torch.Tensor,
                        targets_t: torch.Tensor) -> torch.Tensor:
    """Eq. (5): g = (2/T) sum_t phi_t (w.phi_t - y_t), batched.

    Args:
      w:         (..., n) weights, broadcast over the batch's leading dims.
      phi_t:     (..., T, n) features of the T local samples.
      targets_t: (..., T) sampled Bellman targets.
    Returns (..., n).
    """
    resid = (phi_t @ w.unsqueeze(-1)).squeeze(-1) - targets_t
    T = phi_t.shape[-2]
    return (2.0 / T) * (phi_t.transpose(-1, -2)
                        @ resid.unsqueeze(-1)).squeeze(-1)


def empirical_second_moment(phi_t: torch.Tensor) -> torch.Tensor:
    """Phi_hat = (1/T) sum_t phi_t phi_t^T  (eq. 14): (..., n, n)."""
    return (phi_t.transpose(-1, -2) @ phi_t) / phi_t.shape[-2]


def bellman_targets(costs: torch.Tensor, v_next: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    """target_t = c_t + gamma * V_current(x_plus_t)   (sampled eq. 1 RHS)."""
    return costs + gamma * v_next
