"""Federated TD(0) under Markovian sampling, ported from ``repro/core/td.py``.

Each agent walks its own chain and bootstraps its targets from the weights
it holds; the TD(0) semi-gradient is ``vfa.stochastic_gradient`` on that
bootstrapped batch (tabular phi = e_s, targets c(s) + gamma w[s'] + noise),
so the trigger, transmit and aggregate machinery of ``gated_sgd_core``
runs it unchanged through its ``sampler_state=`` hook.

The walk never reads the weights: its start (``td_init_states``), its
uniform actions and Gumbel draws and the target noise are functions of the
keys, the env and the fleet alone.  So the sampler comes in two parts: a
``walk`` that runs on each distinct sample stream (the sweep hands one walk
to every run that shares the stream), and ``Walk.batch(w)``, the one-hot
features and targets each run forms from its own weights.  The threefry
draws of a walk (``draw``) do not depend on the chain state either, so they
are made for many steps at once, and the walk itself is T gathers and
argmaxes a step.

Exact quantities (host numpy, float64): the TD fixed point ``w* = (I -
gamma P_pi)^{-1} c`` under the uniform policy, the stationary distribution
``d`` of ``P_pi``, and ``J(w) = (w - w*)^T D (w - w*)`` as ``ProblemTerms``
(``phi_matrix = D``, ``bvec = D w*``, ``c0 = w*^T D w*``), so ``j_final`` is
the squared stationary-weighted error.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.core.algorithm1 import (MODE_IDS, SAMPLER_STATE_FOLD,
                                         BlockSampler, GatedSGDConfig,
                                         InnerTrace, ProblemTerms,
                                         SummaryTrace, TraceSpec,
                                         gated_sgd_core)


class Walk(NamedTuple):
    """One step's chain walk of every (stream, agent): (U, m, T) leaves."""

    xs: torch.Tensor        # visited states
    xs_next: torch.Tensor   # their successors
    cost: torch.Tensor      # c[xs]
    gamma: torch.Tensor     # (U, 1, 1) discount of each stream's env
    noise: torch.Tensor     # noise_scale * N(0, 1)

    def to_runs(self, gather) -> "Walk":
        """Every leaf through ``gather`` (a stream -> run index)."""
        return Walk(*(gather(x) for x in self))

    def batch(self, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(phi (R, m, T, S), targets (R, m, T)) under weights w (R, S):
        ``c[x] + gamma * w[x'] + noise``, the reference's order."""
        R, m, T = self.xs_next.shape
        w_next = w.unsqueeze(1).expand(R, m, w.shape[-1]).gather(
            -1, self.xs_next)
        targets = self.cost + self.gamma * w_next + self.noise
        phi = torch.nn.functional.one_hot(self.xs, w.shape[-1])
        return phi.to(torch.float32), targets


def _per_run(x: torch.Tensor, R: int, base_dim: int) -> torch.Tensor:
    return x.expand((R,) + x.shape) if x.dim() == base_dim else x


class TDFamilySampler:
    """``td_family_sampler_fn(T)``: one T-step walk per agent per step with
    TD(0)-bootstrapped targets, the env as data.

    Batched over runs (or streams) and agents: ``env_params`` leaves per run
    ((R, S, A, S), (R, S), (R,)) or shared ((S, A, S), (S,), ()), agent
    ``params`` (R, m, ...) or (m, ...) (``noise_scale`` read, ``"v"``
    ignored), chain ``state`` (R, m).  Chain convention as the reference:
    uniform actions, ``s' ~ categorical(log(P[s, a] + 1e-30))``, the walk
    continuing where the last batch ended.

    * ``draw(env_params, rngs (R, b, m, 2))`` -> ``(a, g, z)``: b steps'
      actions (R, b, m, T), Gumbel noise (R, b, m, T, S) and target normals
      (R, b, m, T) — the reference's ``split(rng) -> r_walk, r_t``,
      ``split(r_walk, T)``, ``split(., 2) -> r_a, r_n``, each per key;
    * ``walk(env_params, params, state, (a, g, z) at one step)`` ->
      ``(state', Walk)``: T steps of gather + argmax (first index on ties);
    * called as ``fn(env_params, params, w, state, rngs (R, m, 2))`` it is
      the reference's stateful family form: ``(state', phi, targets)``.
    """

    def __init__(self, num_samples: int):
        self.num_samples = num_samples

    def draw(self, env_params, rngs: torch.Tensor) -> tuple:
        P = env_params["P"]
        S, A, T = P.shape[-3], P.shape[-2], self.num_samples
        r_walk, r_t = trandom.split(rngs, 2).unbind(-2)
        r_a, r_n = trandom.split(trandom.split(r_walk, T), 2).unbind(-2)
        return (trandom.randint(r_a, (), 0, A), trandom.gumbel(r_n, (S,)),
                trandom.normal(r_t, (T,)))

    def walk(self, env_params, params, state: torch.Tensor, draws):
        a, g, z = draws
        R = state.shape[0]
        P = _per_run(env_params["P"], R, 3)
        c = _per_run(env_params["c"], R, 1)
        gamma = _per_run(torch.as_tensor(env_params["gamma"],
                                         dtype=torch.float32,
                                         device=state.device), R, 0)
        log_p = torch.log(P + 1e-30)
        run = torch.arange(R, device=state.device).view(R, 1)
        s, xs = state.to(torch.int64), []
        for t in range(self.num_samples):
            xs.append(s)
            s = torch.argmax(g[..., t, :] + log_p[run, s, a[..., t]], dim=-1)
        xs = torch.stack(xs, dim=-1)                         # (R, m, T)
        xs_next = torch.cat([xs[..., 1:], s.unsqueeze(-1)], dim=-1)
        noise = params["noise_scale"].unsqueeze(-1) * z
        return s, Walk(xs=xs, xs_next=xs_next, cost=c[run.unsqueeze(-1), xs],
                       gamma=gamma.view(R, 1, 1), noise=noise)

    def __call__(self, env_params, params, w, state, rngs):
        draws = self.draw(env_params, rngs.unsqueeze(1))
        state, walk = self.walk(env_params, params, state,
                                tuple(x[:, 0] for x in draws))
        return (state,) + walk.batch(w)


def td_family_sampler_fn(num_samples: int) -> TDFamilySampler:
    """The stateful family sampler the sweep runs for ``sampling="markov"``."""
    return TDFamilySampler(num_samples)


def td_sample_all(env_params, params, num_samples: int) -> BlockSampler:
    """The whole fleet's stateful sampler for the core: one env and one
    fleet shared by every run (``run_td``), each run its own walk; called
    as ``sample_all(state (R, m), w (R, S), rngs (R, m, 2))`` it draws one
    step."""
    fam = TDFamilySampler(num_samples)

    def take(state, w, draws):
        state, walk = fam.walk(env_params, params, state, draws)
        return (state,) + walk.batch(w)

    return BlockSampler(draw=lambda rngs: fam.draw(env_params, rngs),
                        take=take)


def td_init_states(params, rng: torch.Tensor) -> torch.Tensor:
    """(..., m) initial chain states: ``split(rng, m)`` and one
    ``categorical(visit_logits)`` per agent (zeros: uniform), for keys
    (..., 2) and ``visit_logits`` (..., m, S) — the sweep's
    ``state_init_fn``, called with ``fold_in(run_key, SAMPLER_STATE_FOLD)``."""
    logits = params["visit_logits"]
    return trandom.categorical(trandom.split(rng, logits.shape[-2]), logits)


# ---------------------------------------------------------------------------
# Exact TD quantities (host numpy)
# ---------------------------------------------------------------------------


def stationary_distribution(P_pi: np.ndarray) -> np.ndarray:
    """d = d P_pi, solved as ``(P_pi^T - I) d = 0`` with the last row
    replaced by ``sum d = 1``."""
    P_pi = np.asarray(P_pi, np.float64)
    S = P_pi.shape[0]
    A = P_pi.T - np.eye(S)
    A[-1, :] = 1.0
    b = np.zeros(S)
    b[-1] = 1.0
    return np.linalg.solve(A, b)


def td_fixed_point(env) -> np.ndarray:
    """w* = (I - gamma P_pi)^{-1} c under the uniform policy."""
    P_pi = np.asarray(env.transition_matrix(), np.float64).mean(axis=1)
    S = P_pi.shape[0]
    c = np.asarray(env.cost_vector(), np.float64)
    return np.linalg.solve(np.eye(S) - env.gamma * P_pi, c)


def td_problem_terms(env, device=None) -> ProblemTerms:
    """``J(w) = (w - w*)^T D (w - w*)`` as float32 ``ProblemTerms``:
    ``objective(w*) == 0`` and ``grad(w) = 2 D (w - w*)``."""
    P_pi = np.asarray(env.transition_matrix(), np.float64).mean(axis=1)
    d = stationary_distribution(P_pi)
    wstar = td_fixed_point(env)
    D = np.diag(d)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return ProblemTerms(phi_matrix=f32(D), bvec=f32(D @ wstar),
                        c0=f32(wstar @ D @ wstar))


def td_env_family(num_instances: int, device=None, **kwargs):
    """Garnet chains stacked as a sweep env axis with exact TD terms:
    ``(envs, EnvFamily)``, the family terms each instance's own
    ``td_problem_terms`` (``j_final`` reads as squared distance to w*)."""
    from repro_torch.envs.base import EnvFamily, stack_env_family
    from repro_torch.envs.garnet import garnet_family

    envs = garnet_family(num_instances, **kwargs)
    fam = stack_env_family(envs, np.zeros(envs[0].num_states, np.float32),
                           with_terms=False, device=device)
    terms = [td_problem_terms(e, device) for e in envs]
    return envs, EnvFamily(params=fam.params, terms=ProblemTerms(
        *(torch.stack(leaves) for leaves in zip(*terms))))


def run_td(
    rng: torch.Tensor,
    w0,
    env,
    cfg: GatedSGDConfig,
    num_samples: int,
    agent_params=None,
    trace: Union[str, TraceSpec] = "full",
    channel=None,
    channel_caps: Optional[tuple[int, int]] = None,
    device=None,
) -> Union[InnerTrace, SummaryTrace]:
    """One federated TD(0) inner run on a single tabular env.

    The chains start from ``fold_in(rng, SAMPLER_STATE_FOLD)``, the sweep's
    derivation, so a ``run_td`` call equals its ``sampling="markov"`` sweep
    cell.  ``agent_params`` defaults to the env's homogeneous fleet; the
    exact TD terms are always attached.
    """
    dev = resolve_device(device)
    rng = torch.as_tensor(rng).to(dev)
    params = (env.agent_params(w0, cfg.num_agents)
              if agent_params is None else agent_params)
    params = {k: torch.as_tensor(v).to(dev) for k, v in params.items()}
    states = td_init_states(params, trandom.fold_in(rng, SAMPLER_STATE_FOLD))
    return gated_sgd_core(
        rng, w0,
        mode_id=MODE_IDS[cfg.mode],
        thresholds=cfg.trigger.schedule(),
        tx_prob=cfg.random_tx_prob,
        sample_all=td_sample_all(env.env_params(dev), params, num_samples),
        eps=cfg.eps,
        num_agents=cfg.num_agents,
        terms=td_problem_terms(env, dev),
        gain_backend=cfg.gain_backend,
        trace=trace,
        step_backend=cfg.step_backend,
        channel=channel,
        channel_caps=channel_caps,
        sampler_state=states,
        device=dev,
    )
