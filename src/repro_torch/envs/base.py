"""Common environment protocol for the sweep engine, ported from
``repro/envs/base.py``.

Tabular envs expose the exact problem (``vfa_problem``), per-agent sampler
parameters (``agent_params``: a dict of stacked tensors, heterogeneity as
data) and one *batched* sampling function: it draws every agent's T samples
for every run in one call, with keys of shape (R, m, 2) and the same
threefry streams as the reference's vmapped per-agent sampler.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, runtime_checkable

import torch

from repro_torch import random as trandom
from repro_torch.core import vfa as vfa_lib
from repro_torch.core.algorithm1 import ParamSampler, ProblemTerms


class EnvFamily(NamedTuple):
    """A stacked env family: ``params`` leaves (E, ...) — ``{"P": (E, S, A,
    S), "c": (E, S), "gamma": (E,)}`` — and optional stacked exact terms."""

    params: dict
    terms: Optional[ProblemTerms] = None

    @property
    def num_instances(self) -> int:
        return int(next(iter(self.params.values())).shape[0])


@runtime_checkable
class Env(Protocol):
    """Structural protocol — GridWorld and GarnetMDP satisfy it."""

    def vfa_problem(self, v_current) -> vfa_lib.VFAProblem: ...

    def sampler_fn(self, num_samples: int): ...

    def agent_params(self, v_current, num_agents: int): ...


def stack_agent_params(*rows) -> dict:
    """Stack per-agent parameter dicts (each tensor gains a leading m axis)."""
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def stack_env_fleets(fleets) -> dict:
    """Stack one agent fleet per env instance: leaves (E, m, ...), the
    ``fleet_sets=`` input of ``run_sweep`` (zipped with the env axis)."""
    fleets = list(fleets)
    if not fleets:
        raise ValueError("need at least one per-env fleet to stack")
    return {k: torch.stack([f[k] for f in fleets]) for k in fleets[0]}


def as_param_sampler(env: Env, v_current, num_agents: int,
                     num_samples: int, **agent_kwargs) -> ParamSampler:
    """The env's default homogeneous fleet as a ParamSampler."""
    return ParamSampler(
        fn=env.sampler_fn(num_samples),
        params=env.agent_params(v_current, num_agents, **agent_kwargs))


def _per_run(x: torch.Tensor, R: int, base_dim: int) -> torch.Tensor:
    """An env leaf shared by every run (``base_dim`` dims) as an (R, ...)
    view; per-run leaves pass as they are."""
    return x.expand((R,) + x.shape) if x.dim() == base_dim else x


def family_sampler_fn(num_samples: int):
    """Tabular sampling with the ENV as data, batched over runs and agents.

    ``fn(env_params, params, rngs) -> (phi (R, m, T, S), targets (R, m, T))``
    with ``env_params`` leaves per run ((R, S, A, S), (R, S), (R,)) or shared
    by all runs ((S, A, S), (S,), ()), agent ``params`` leaves (R, m, ...)
    and ``rngs`` (R, m, 2).  Step for step it is the reference's per-agent
    sampler: ``split(rng, 4)``, x ~ categorical(visit_logits), a ~
    randint(A), x' ~ categorical(log(P[x, a] + 1e-30)), targets c(x) +
    gamma V(x') + noise_scale * normal.
    """

    def fn(env_params, params, rngs):
        R = rngs.shape[0]
        P = _per_run(env_params["P"], R, 3)
        c = _per_run(env_params["c"], R, 1)
        gamma = _per_run(torch.as_tensor(env_params["gamma"],
                                         dtype=torch.float32,
                                         device=rngs.device), R, 0)
        S, A = P.shape[-3], P.shape[-2]
        r_x, r_a, r_n, r_t = trandom.split(rngs, 4).unbind(-2)
        x = trandom.categorical(r_x, params["visit_logits"],
                                shape=(num_samples,))            # (R, m, T)
        a = trandom.randint(r_a, (num_samples,), 0, A)
        run = torch.arange(R, device=rngs.device).view(R, 1, 1)
        x_next = trandom.categorical(r_n, torch.log(P[run, x, a] + 1e-30))
        v_next = params["v"].gather(-1, x_next)
        targets = (c[run, x] + gamma.view(R, 1, 1) * v_next
                   + params["noise_scale"].unsqueeze(-1)
                   * trandom.normal(r_t, (num_samples,)))
        return torch.nn.functional.one_hot(x, S).to(torch.float32), targets

    return fn


def family_problem_terms(env_params, v_current) -> ProblemTerms:
    """Exact ``ProblemTerms`` at ``V_current`` of one env-params row, or of
    every row of a stacked family (leading E axis): uniform policy, uniform
    d, tabular phi, so Phi = I/S and b = targets/S."""
    P, c = env_params["P"], env_params["c"]
    v = torch.as_tensor(v_current, dtype=torch.float32, device=P.device)
    gamma = torch.as_tensor(env_params["gamma"], dtype=torch.float32,
                            device=P.device)
    P_pi = P.mean(dim=-2)                        # uniform policy
    targets = c + gamma.unsqueeze(-1) * (P_pi @ v)
    S = c.shape[-1]
    eye = torch.eye(S, device=P.device) / S
    return ProblemTerms(
        phi_matrix=eye.expand(c.shape[:-1] + (S, S)).contiguous(),
        bvec=targets / S,
        c0=torch.sum(targets**2, -1) / S)


def stack_env_family(envs, v_current, with_terms: bool = True,
                     device=None) -> EnvFamily:
    """Stack tabular env instances (sharing (S, A)) into the env grid axis."""
    rows = [e.env_params(device) for e in envs]
    params = {
        "P": torch.stack([r["P"] for r in rows]),
        "c": torch.stack([r["c"] for r in rows]),
        "gamma": torch.stack([r["gamma"] for r in rows]),
    }
    terms = family_problem_terms(params, v_current) if with_terms else None
    return EnvFamily(params=params, terms=terms)


class TabularSamplerMixin:
    """Shared parameterized sampling for finite-state envs (tabular phi).

    Hosts provide ``transition_matrix()``, ``cost_vector()``,
    ``num_states``, ``num_actions`` and ``gamma``.  Per-agent parameters:
    ``v`` (S,) V_current, ``visit_logits`` (S,) local visit log-weights,
    ``noise_scale`` additive N(0, scale^2) target noise.
    """

    def env_params(self, device=None) -> dict:
        """This instance as the data dict ``family_sampler_fn`` consumes."""
        return {
            "P": torch.as_tensor(self.transition_matrix(),
                                 dtype=torch.float32).to(device),
            "c": torch.as_tensor(self.cost_vector(),
                                 dtype=torch.float32).to(device),
            "gamma": torch.tensor(self.gamma, dtype=torch.float32,
                                  device=device),
        }

    def sampler_fn(self, num_samples: int):
        """``fn(params, rngs)``: ``family_sampler_fn`` with this instance's
        env params (copied once to each device the keys come on)."""
        fam = family_sampler_fn(num_samples)
        envs = {}

        def fn(params, rngs):
            if rngs.device not in envs:
                envs[rngs.device] = self.env_params(rngs.device)
            return fam(envs[rngs.device], params, rngs)

        return fn

    def agent_param_row(self, v_current, visit_logits=None,
                        noise_scale: float = 0.0) -> dict:
        """One agent's sampler parameters (un-stacked)."""
        S = self.num_states
        return {
            "v": torch.as_tensor(v_current, dtype=torch.float32),
            "visit_logits": (torch.zeros((S,), dtype=torch.float32)
                             if visit_logits is None else
                             torch.as_tensor(visit_logits,
                                             dtype=torch.float32)),
            "noise_scale": torch.tensor(noise_scale, dtype=torch.float32),
        }

    def agent_params(self, v_current, num_agents: int, visit_logits=None,
                     noise_scale: float = 0.0) -> dict:
        """Homogeneous fleet: the same row stacked m times."""
        row = self.agent_param_row(v_current, visit_logits, noise_scale)
        return {k: v.expand((num_agents,) + v.shape).clone()
                for k, v in row.items()}

    def problem_terms(self, v_current) -> ProblemTerms:
        """Exact ``ProblemTerms`` for V_current (``family_problem_terms``)."""
        return family_problem_terms(self.env_params(), v_current)
