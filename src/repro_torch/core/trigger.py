"""Communication triggers and threshold schedules (paper eq. 9, 16), ported
from ``repro/core/trigger.py``.

alpha_k = 1 iff gain_k <= -lambda_k with lambda_k = lambda / (N rho^(N-1-k)).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.bound import theorem1_bound  # noqa: F401


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    lam: float                      # communication price lambda > 0
    rho: float                      # decay parameter in (0, 1)
    num_iterations: int             # horizon N
    include_horizon_norm: bool = True  # divide by N (proof form) or not

    def threshold(self, k) -> torch.Tensor:
        """lambda_k (float32) for iteration(s) k (0-based).

        Evaluated in float32 like the reference, with a correctly rounded
        ``rho**e``; XLA's float32 ``pow`` may round the other way in the
        last ulp, so schedules agree to 1 ulp rather than bitwise.
        """
        norm = self.num_iterations if self.include_horizon_norm else 1.0
        expo = self.num_iterations - 1 - np.asarray(k, np.float64)
        pw = (np.float64(np.float32(self.rho)) ** expo).astype(np.float32)
        with np.errstate(divide="ignore", over="ignore"):
            out = np.float32(self.lam) / (np.float32(norm) * pw)
        return torch.from_numpy(np.asarray(out, np.float32))

    def schedule(self) -> torch.Tensor:
        """(N,) float32 vector of thresholds lambda_0..lambda_{N-1}."""
        return self.threshold(np.arange(self.num_iterations))


def should_transmit(gain: torch.Tensor, threshold) -> torch.Tensor:
    """Eq. 9: alpha = 1 iff the (negative-is-good) gain clears -threshold."""
    return (gain <= -threshold).to(torch.float32)


def check_assumption_2(eps: float, phi_eigs: torch.Tensor) -> bool:
    """|1 - 2 eps lambda_i(Phi)| < 1 for all eigenvalues (eq. 10)."""
    return bool(torch.all(torch.abs(1.0 - 2.0 * eps * phi_eigs) < 1.0))


def check_assumption_3(rho: float, eps: float, phi_eigs: torch.Tensor) -> bool:
    """rho >= max_i (1 - 2 eps lambda_i(Phi))^2 (eq. 11)."""
    return bool(rho >= float(torch.max((1.0 - 2.0 * eps * phi_eigs) ** 2))
                - 1e-12)
