"""Continuous-state example (paper §V, Fig. 3), ported from
``repro/envs/linear_system.py``.

x_+ = A x + w with w ~ N(0, sigma2 I), cost c(x) = ||x||^2, gamma = 0.9,
degree-2 polynomial features phi(x) = [x1^2, x2^2, x1 x2, x1, x2, 1] and
d = Uniform([0, 1]^2).  The class is closed under the Bellman operator, so
the exact target coefficients, Phi, w* and J are available in closed form
(host numpy, as the reference).

The samplers are batched over any leading key axes (runs, agents, steps):
``split(rng) -> r_x, r_w``, then ``uniform(r_x, (T, 2))`` and ``normal(r_w,
(T, 2))`` per key, the reference's streams.  The two small products
(``x @ A.T`` and ``gamma phi(x_+) @ v``) are written out term by term, so a
sample does not depend on the batch it is drawn in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import vfa as vfa_lib

N_FEATURES = 6  # [x1^2, x2^2, x1*x2, x1, x2, 1]


def poly_features(x: torch.Tensor) -> torch.Tensor:
    """phi(x) for x of shape (..., 2) -> (..., 6)."""
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([x1**2, x2**2, x1 * x2, x1, x2, torch.ones_like(x1)],
                       dim=-1)


def _quad_from_weights(w: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Weights -> (Q, b, c0) with V(x) = x^T Q x + b^T x + c0."""
    Q = np.array([[w[0], w[2] / 2.0], [w[2] / 2.0, w[1]]])
    b = np.array([w[3], w[4]])
    return Q, b, float(w[5])


def _weights_from_quad(Q: np.ndarray, b: np.ndarray, c0: float) -> np.ndarray:
    return np.array([Q[0, 0], Q[1, 1], 2.0 * Q[0, 1], b[0], b[1], c0])


def _dot(feats: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_i feats[..., i] * v[..., i], left to right."""
    out = feats[..., 0] * v[..., 0]
    for i in range(1, feats.shape[-1]):
        out = out + feats[..., i] * v[..., i]
    return out


@dataclasses.dataclass(frozen=True)
class LinearSystem:
    a_matrix: tuple = ((0.8, -0.2), (0.1, 1.0))
    noise_var: float = 0.1
    gamma: float = 0.9

    @property
    def A(self) -> np.ndarray:
        return np.asarray(self.a_matrix)

    # -- exact quantities ----------------------------------------------------

    @staticmethod
    def second_moment() -> np.ndarray:
        """Phi = E_d phi phi^T for d = Uniform([0,1]^2), in closed form
        (E[u^k] = 1/(k+1) for independent U(0,1) coordinates)."""
        exps = [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)]
        phi = np.empty((N_FEATURES, N_FEATURES))
        for i, (p1, q1) in enumerate(exps):
            for j, (p2, q2) in enumerate(exps):
                phi[i, j] = (1.0 / (p1 + p2 + 1)) * (1.0 / (q1 + q2 + 1))
        return phi

    def bellman_target_weights(self, v_weights: np.ndarray) -> np.ndarray:
        """Exact coefficients of c(x) + gamma E[V_cur(Ax + w)] (eq. 1 RHS):
        x^T (gamma A^T Q A + I) x + gamma b^T A x + gamma (c0 + sigma2 tr Q)."""
        Q, b, c0 = _quad_from_weights(np.asarray(v_weights))
        A = self.A
        Qn = self.gamma * A.T @ Q @ A + np.eye(2)
        bn = self.gamma * A.T @ b
        cn = self.gamma * (c0 + self.noise_var * np.trace(Q))
        return _weights_from_quad(Qn, bn, cn)

    def vfa_problem(self, v_weights, grid: int = 64) -> vfa_lib.VFAProblem:
        """Population problem (3) on a midpoint quadrature grid over
        [0,1]^2, the targets from the exact Bellman-target polynomial; the
        features are float32, as the reference's."""
        t = (np.arange(grid) + 0.5) / grid
        xx, yy = np.meshgrid(t, t, indexing="ij")
        pts = np.stack([xx.ravel(), yy.ravel()], axis=-1)          # (G^2, 2)
        phi_m = poly_features(torch.as_tensor(pts, dtype=torch.float32))
        targets = phi_m.numpy() @ self.bellman_target_weights(
            np.asarray(v_weights))
        return vfa_lib.VFAProblem(
            phi_matrix=phi_m,
            d_weights=torch.full((pts.shape[0],), 1.0 / pts.shape[0]),
            targets=torch.as_tensor(targets, dtype=torch.float32),
            gamma=self.gamma)

    # -- sampling --------------------------------------------------------------

    def _draw(self, rngs, num_samples, noise_scale, v):
        """(phi(x), c(x) + gamma phi(A x + w) . v) for keys (..., 2)."""
        A = self.A.astype(np.float32)
        sig = torch.tensor(math.sqrt(self.noise_var), dtype=torch.float32,
                           device=rngs.device)
        r_x, r_w = trandom.split(rngs, 2).unbind(-2)
        x = trandom.uniform(r_x, (num_samples, 2))
        noise = sig * noise_scale * trandom.normal(r_w, (num_samples, 2))
        x1, x2 = x[..., 0], x[..., 1]
        x_next = torch.stack([x1 * float(A[0, 0]) + x2 * float(A[0, 1]),
                              x1 * float(A[1, 0]) + x2 * float(A[1, 1])],
                             dim=-1) + noise
        cost = x1 * x1 + x2 * x2
        # the reference's (gamma * phi(x_+)) @ v, in its order
        targets = cost + _dot(self.gamma * poly_features(x_next), v)
        return poly_features(x), targets

    def sampler_fn(self, num_samples: int):
        """``fn(params, rngs (R, m, 2)) -> (phi (R, m, T, 6), targets (R, m,
        T))``; per-agent params ``v`` (6,) V_current and ``noise_scale``
        (a multiplier of the process-noise std), leaves (R, m, ...)."""

        def fn(params, rngs):
            return self._draw(rngs, num_samples,
                              params["noise_scale"][..., None, None],
                              params["v"].unsqueeze(-2))

        return fn

    def agent_param_row(self, v_weights, noise_scale: float = 1.0) -> dict:
        return {"v": torch.as_tensor(v_weights, dtype=torch.float32),
                "noise_scale": torch.tensor(noise_scale, dtype=torch.float32)}

    def agent_params(self, v_weights, num_agents: int,
                     noise_scale: float = 1.0) -> dict:
        row = self.agent_param_row(v_weights, noise_scale)
        return {k: v.expand((num_agents,) + v.shape).clone()
                for k, v in row.items()}

    def make_sampler(self, v_weights, num_samples: int):
        """``sampler(rngs (..., 2)) -> (phi (..., T, 6), targets (..., T))``:
        x ~ Uniform([0,1]^2), x_+ = A x + w, target c(x) + gamma V_cur(x_+)."""
        v = torch.as_tensor(v_weights, dtype=torch.float32)

        def sampler(rngs):
            return self._draw(rngs, num_samples, 1.0, v.to(rngs.device))

        return sampler
