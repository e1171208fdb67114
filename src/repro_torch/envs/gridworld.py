"""Grid exploration MDP (paper §V, Fig. 2), ported from
``repro/envs/gridworld.py``.

An H x W grid, four clamped moves, an absorbing zero-cost goal, unit cost
elsewhere, and a 50% push to the right along the top row.  Tabular
features, so the weight vector is the value table.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import vfa as vfa_lib
from repro_torch.envs.base import TabularSamplerMixin

ACTIONS = np.array([(-1, 0), (1, 0), (0, -1), (0, 1)])  # up, down, left, right


@dataclasses.dataclass(frozen=True)
class GridWorld(TabularSamplerMixin):
    height: int = 5
    width: int = 5
    goal: tuple[int, int] = (4, 4)
    wind_prob: float = 0.5   # top-row disturbance probability
    gamma: float = 1.0

    @property
    def num_states(self) -> int:
        return self.height * self.width

    @property
    def num_actions(self) -> int:
        return 4

    def _idx(self, r: int, c: int) -> int:
        return r * self.width + c

    def transition_matrix(self) -> np.ndarray:
        """P[s, a, s'] with boundary clamping, absorbing goal, top-row wind."""
        S, A = self.num_states, self.num_actions
        P = np.zeros((S, A, S))
        goal = self._idx(*self.goal)
        for r in range(self.height):
            for c in range(self.width):
                s = self._idx(r, c)
                if s == goal:
                    P[s, :, s] = 1.0
                    continue
                for a, (dr, dc) in enumerate(ACTIONS):
                    nr = min(max(r + dr, 0), self.height - 1)
                    nc = min(max(c + dc, 0), self.width - 1)
                    intended = self._idx(nr, nc)
                    if r == 0:
                        wc = min(nc + 1, self.width - 1)
                        windy = self._idx(nr, wc)
                        P[s, a, intended] += 1.0 - self.wind_prob
                        P[s, a, windy] += self.wind_prob
                    else:
                        P[s, a, intended] = 1.0
        return P

    def cost_vector(self) -> np.ndarray:
        """c(s) = 1 everywhere except the absorbing goal."""
        c = np.ones(self.num_states)
        c[self._idx(*self.goal)] = 0.0
        return c

    def uniform_policy(self) -> np.ndarray:
        return np.full((self.num_states, self.num_actions), 1.0 / self.num_actions)

    def policy_transition(self, policy: np.ndarray | None = None) -> np.ndarray:
        policy = self.uniform_policy() if policy is None else policy
        return np.einsum("sa,sat->st", policy, self.transition_matrix())

    def exact_value(self, policy: np.ndarray | None = None) -> np.ndarray:
        """V_pi: expected time to goal, by a linear solve over non-goal states."""
        P = self.policy_transition(policy)
        c = self.cost_vector()
        goal = self._idx(*self.goal)
        keep = np.arange(self.num_states) != goal
        A = np.eye(keep.sum()) - self.gamma * P[np.ix_(keep, keep)]
        v = np.zeros(self.num_states)
        v[keep] = np.linalg.solve(A, c[keep])
        return v

    def bellman_update(self, v_current: np.ndarray,
                       policy: np.ndarray | None = None) -> np.ndarray:
        """Exact eq. (1): V_upd(s) = c_pi(s) + gamma * (P_pi V_cur)(s)."""
        P = self.policy_transition(policy)
        return self.cost_vector() + self.gamma * P @ v_current

    def vfa_problem(self, v_current) -> vfa_lib.VFAProblem:
        """Population problem (3) for one Bellman update, uniform d."""
        S = self.num_states
        return vfa_lib.VFAProblem(
            phi_matrix=torch.eye(S),
            d_weights=torch.full((S,), 1.0 / S),
            targets=torch.as_tensor(self.bellman_update(np.asarray(v_current)),
                                    dtype=torch.float32),
            gamma=self.gamma)

    def make_sampler(self, v_current, num_samples: int):
        """Batched ``sampler(rngs (R, m, 2)) -> (phi (R, m, T, S), targets)``:
        x ~ Uniform(X), a ~ Uniform(A), x' ~ P(.|x, a), target c(x) + gamma
        V(x'), on each key's stream as the reference's per-agent closure."""
        P = torch.as_tensor(self.transition_matrix(), dtype=torch.float32)
        c = torch.as_tensor(self.cost_vector(), dtype=torch.float32)
        v = torch.as_tensor(v_current, dtype=torch.float32)
        S, A = self.num_states, self.num_actions

        def sampler(rngs):
            Pd, cd, vd = (t.to(rngs.device) for t in (P, c, v))
            r_x, r_a, r_n = trandom.split(rngs, 3).unbind(-2)
            x = trandom.randint(r_x, (num_samples,), 0, S)
            a = trandom.randint(r_a, (num_samples,), 0, A)
            x_next = trandom.categorical(r_n, torch.log(Pd[x, a] + 1e-30))
            targets = cd[x] + self.gamma * vd[x_next]
            return torch.nn.functional.one_hot(x, S).to(torch.float32), targets

        return sampler
