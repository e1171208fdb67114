"""Tabular environments of the sweep engine: garnet families and the
paper's §V gridworld, with batched threefry samplers."""

from repro_torch.envs.base import (EnvFamily, as_param_sampler,
                                   family_problem_terms, family_sampler_fn,
                                   stack_agent_params, stack_env_family,
                                   stack_env_fleets)
from repro_torch.envs.garnet import (GarnetMDP, garnet_env_family,
                                     garnet_family, garnet_fleet_sets)
from repro_torch.envs.gridworld import GridWorld

__all__ = ["EnvFamily", "GarnetMDP", "GridWorld", "as_param_sampler",
           "family_problem_terms", "family_sampler_fn", "garnet_env_family",
           "garnet_family", "garnet_fleet_sets", "stack_agent_params",
           "stack_env_family", "stack_env_fleets"]
