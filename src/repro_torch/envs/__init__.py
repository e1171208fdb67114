"""Environments of the sweep engine: garnet families, the paper's §V
gridworld and its continuous-state linear system, with batched threefry
samplers."""

from repro_torch.envs.base import (EnvFamily, as_param_sampler,
                                   family_problem_terms, family_sampler_fn,
                                   stack_agent_params, stack_env_family,
                                   stack_env_fleets)
from repro_torch.envs.garnet import (GarnetMDP, garnet_env_family,
                                     garnet_family, garnet_fleet_sets)
from repro_torch.envs.gridworld import GridWorld
from repro_torch.envs.linear_system import LinearSystem, poly_features

__all__ = ["EnvFamily", "GarnetMDP", "GridWorld", "LinearSystem",
           "as_param_sampler", "family_problem_terms", "family_sampler_fn",
           "garnet_env_family", "garnet_family", "garnet_fleet_sets",
           "poly_features", "stack_agent_params", "stack_env_family",
           "stack_env_fleets"]
