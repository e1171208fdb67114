"""Q-function extension (paper Remark 1), ported from
``repro/core/qlearning.py``.

Linear Q-function approximation over tabular state-action features
``phi(x, a) = e_{(x, a)}`` with the expected-SARSA target for a fixed
policy pi, ``c(x) + gamma E_{x+|x,a} E_{a+ ~ pi(.|x+)} Q(x+, a+)`` (zero at
the absorbing goal).  The agents' samplers emit (phi, target) tuples, so
``run_gated_sgd`` and ``run_value_iteration`` fit it unchanged: the
extension is the problem construction, not a new algorithm.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import vfa as vfa_lib
from repro_torch.envs.gridworld import GridWorld


def q_dimension(gw: GridWorld) -> int:
    return gw.num_states * gw.num_actions


def exact_q(gw: GridWorld, policy: np.ndarray | None = None) -> np.ndarray:
    """Exact Q_pi via the exact V_pi: Q(s,a) = c(s) + gamma sum P(s'|s,a) V(s')."""
    v = gw.exact_value(policy)
    P = gw.transition_matrix()
    c = gw.cost_vector()
    q = c[:, None] + gw.gamma * np.einsum("sat,t->sa", P, v)
    goal = gw._idx(*gw.goal)
    q[goal, :] = 0.0
    return q.reshape(-1)


def bellman_q_update(gw: GridWorld, q_current: np.ndarray,
                     policy: np.ndarray | None = None) -> np.ndarray:
    """Exact expected-SARSA operator on a Q table (flattened (S*A,))."""
    policy = gw.uniform_policy() if policy is None else policy
    P = gw.transition_matrix()
    c = gw.cost_vector()
    q = q_current.reshape(gw.num_states, gw.num_actions)
    v_next = np.einsum("ta,ta->t", policy, q)          # E_{a+}[Q(x+, a+)]
    upd = c[:, None] + gw.gamma * np.einsum("sat,t->sa", P, v_next)
    goal = gw._idx(*gw.goal)
    upd[goal, :] = 0.0
    return upd.reshape(-1)


def q_problem(gw: GridWorld, q_current: np.ndarray) -> vfa_lib.VFAProblem:
    """Population problem (3) for one expected-SARSA update: uniform d over
    state-action pairs, tabular phi."""
    n = q_dimension(gw)
    return vfa_lib.VFAProblem(
        phi_matrix=torch.eye(n),
        d_weights=torch.full((n,), 1.0 / n),
        targets=torch.as_tensor(bellman_q_update(gw, np.asarray(q_current)),
                                dtype=torch.float32),
        gamma=gw.gamma)


def make_q_sampler(gw: GridWorld, q_current,
                   num_samples: int) -> Callable[[torch.Tensor], tuple]:
    """``sampler(rngs (..., 2)) -> (phi (..., T, S*A), targets (..., T))``,
    batched over any leading key axes (runs, agents, steps).

    Per key, as the reference: ``split(rng, 4)``; (x, a) ~ Uniform by two
    ``randint``s, x+ ~ P(.|x, a) and a+ ~ pi(.|x+) by two ``categorical``s;
    the target is c(x) + gamma Q_cur(x+, a+), zero at the absorbing goal.
    """
    P = torch.as_tensor(gw.transition_matrix(), dtype=torch.float32)
    c = torch.as_tensor(gw.cost_vector(), dtype=torch.float32)
    policy = torch.as_tensor(gw.uniform_policy(), dtype=torch.float32)
    q = torch.as_tensor(q_current, dtype=torch.float32)
    S, A = gw.num_states, gw.num_actions
    goal = gw._idx(*gw.goal)

    def sampler(rngs):
        Pd, cd, pol, qd = (t.to(rngs.device) for t in (P, c, policy, q))
        r_s, r_a, r_n, r_an = trandom.split(rngs, 4).unbind(-2)
        s = trandom.randint(r_s, (num_samples,), 0, S)
        a = trandom.randint(r_a, (num_samples,), 0, A)
        s_next = trandom.categorical(r_n, torch.log(Pd[s, a] + 1e-30))
        a_next = trandom.categorical(r_an, torch.log(pol[s_next] + 1e-30))
        targets = cd[s] + gw.gamma * qd[s_next * A + a_next]
        targets = torch.where(s == goal, 0.0, targets)
        phi = torch.nn.functional.one_hot(s * A + a, S * A)
        return phi.to(torch.float32), targets

    return sampler
