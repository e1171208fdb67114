"""Garnet MDPs: a randomized family for heterogeneity studies, ported from
``repro/envs/garnet.py``.

The numpy construction is the reference's, draw for draw, so transition
tensors and costs are bitwise equal for the same (seed, S, A, b).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import vfa as vfa_lib
from repro_torch.envs.base import (TabularSamplerMixin, stack_agent_params,
                                   stack_env_family, stack_env_fleets)


@dataclasses.dataclass(frozen=True)
class GarnetMDP(TabularSamplerMixin):
    num_states: int = 20
    num_actions: int = 4
    branching: int = 3        # next-state support size per (s, a)
    seed: int = 0             # instance id within the family
    gamma: float = 0.95

    def _rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, self.num_states, self.num_actions, self.branching, stream))

    def transition_matrix(self) -> np.ndarray:
        """P[s, a, s']: ``branching`` random successors with random weights."""
        rng = self._rng(0)
        S, A, b = self.num_states, self.num_actions, self.branching
        P = np.zeros((S, A, S))
        for s in range(S):
            for a in range(A):
                succ = rng.choice(S, size=b, replace=False)
                cuts = np.sort(np.concatenate([[0.0], rng.random(b - 1), [1.0]]))
                P[s, a, succ] = np.diff(cuts)
        return P

    def cost_vector(self) -> np.ndarray:
        """c(s) ~ U(0, 1) i.i.d. per state."""
        return self._rng(1).random(self.num_states)

    def uniform_policy(self) -> np.ndarray:
        return np.full((self.num_states, self.num_actions),
                       1.0 / self.num_actions)

    def policy_transition(self, policy: np.ndarray | None = None) -> np.ndarray:
        policy = self.uniform_policy() if policy is None else policy
        return np.einsum("sa,sat->st", policy, self.transition_matrix())

    def exact_value(self, policy: np.ndarray | None = None) -> np.ndarray:
        """V_pi = (I - gamma P_pi)^{-1} c."""
        P = self.policy_transition(policy)
        A = np.eye(self.num_states) - self.gamma * P
        return np.linalg.solve(A, self.cost_vector())

    def bellman_update(self, v_current: np.ndarray,
                       policy: np.ndarray | None = None) -> np.ndarray:
        """Exact eq. (1): V_upd = c + gamma P_pi V_cur."""
        return (self.cost_vector()
                + self.gamma * self.policy_transition(policy) @ v_current)

    def vfa_problem(self, v_current) -> vfa_lib.VFAProblem:
        """Population problem (3) for one Bellman update, uniform d."""
        S = self.num_states
        return vfa_lib.VFAProblem(
            phi_matrix=torch.eye(S),
            d_weights=torch.full((S,), 1.0 / S),
            targets=torch.as_tensor(self.bellman_update(np.asarray(v_current)),
                                    dtype=torch.float32),
            gamma=self.gamma)


def garnet_family(num_instances: int, **kwargs) -> tuple[GarnetMDP, ...]:
    """``num_instances`` i.i.d. instances sharing (S, A, b) — one per seed."""
    return tuple(GarnetMDP(seed=s, **kwargs) for s in range(num_instances))


def garnet_fleet_sets(envs, v_current, num_agents: int, num_junk: int = 0,
                      skew: float = 30.0, noise_scale: float = 5.0,
                      seed: int = 0) -> dict:
    """One agent fleet per garnet instance — ``run_sweep(fleet_sets=...)``.

    Instance e's fleet has ``num_junk`` junk agents whose visits collapse
    onto an instance-specific state (logit ``skew``) with target noise drawn
    in ``[0.5, 1.5] * noise_scale``; the rest are clean uniform-visit
    agents.  Draws are seeded per (seed, instance) exactly as the reference.
    """
    if not 0 <= num_junk <= num_agents:
        raise ValueError(f"num_junk must be in [0, {num_agents}], "
                         f"got {num_junk}")
    fleets = []
    for e, env in enumerate(envs):
        rng = np.random.default_rng((seed, e))
        rows = [env.agent_param_row(v_current)
                for _ in range(num_agents - num_junk)]
        for _ in range(num_junk):
            logits = np.zeros(env.num_states, np.float32)
            logits[int(rng.integers(env.num_states))] = skew
            rows.append(env.agent_param_row(
                v_current, visit_logits=logits,
                noise_scale=float(noise_scale * (0.5 + rng.random()))))
        fleets.append(stack_agent_params(*rows))
    return stack_env_fleets(fleets)


def garnet_env_family(num_instances: int, v_current=None,
                      with_terms: bool = True, device=None, **kwargs):
    """The family as a sweep env grid axis: ``(envs, EnvFamily)`` with exact
    terms at ``v_current`` (default w = 0)."""
    envs = garnet_family(num_instances, **kwargs)
    if v_current is None:
        v_current = np.zeros(envs[0].num_states, np.float32)
    return envs, stack_env_family(envs, v_current, with_terms=with_terms,
                                  device=device)
