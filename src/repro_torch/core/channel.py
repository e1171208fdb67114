"""Lossy-edge channel model, ported from ``repro/core/channel.py``.

The uplink is sweep data like the trigger mode or lambda:

* ``ChannelSpec`` — one uplink configuration (torch-free and hashable, so
  it canonicalizes through the port's store): a per-agent (or shared) drop
  probability, a delay of ``d`` server steps, and a staleness of ``s``
  steps (each agent's whole local computation reads ``w_{k-s}``).
* ``ChannelInputs`` — the per-run tensors the core consumes
  (``repro_torch.core.algorithm1.gated_sgd_core(channel=...)``); a stack of
  specs is one ``ChannelInputs`` with a leading channel axis, which the
  sweep gathers per run.
* ``channel_caps`` — the ring capacities (max delay + 1, max staleness + 1)
  that size the pending-delivery and stale-weights rings of a whole
  ``channel_sets`` axis.

Delivered-vs-attempted contract: the trigger's ``alpha`` is the attempted
transmission (eq. 7 charges it); the channel keeps each with probability
``1 - drop_prob`` and only ``delivered = alpha * keep`` reaches the server.
The default everywhere is ``channel=None``, the perfect channel without
rings or extra draws; a clean ``ChannelSpec()`` reproduces it bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch


class ChannelSpec(NamedTuple):
    """One uplink channel configuration (store-canonical).

    ``drop_prob`` is one float shared by all agents or a per-agent tuple;
    ``delay`` holds every delivered update back ``d`` server steps (the
    last d deliveries of a run never land); ``staleness`` makes each agent
    compute against ``w_{k-s}`` (``w_0`` while k < s) while the server
    applies deliveries to its current weights.
    """

    drop_prob: Union[float, tuple] = 0.0
    delay: int = 0
    staleness: int = 0


PERFECT = ChannelSpec()


class ChannelInputs(NamedTuple):
    """Per-run channel tensors for the core; with a leading axis, the
    stacked (C, ...) form."""

    drop_prob: torch.Tensor   # (m,) float32 per-agent drop probability
    delay: torch.Tensor       # () int64 transmission delay in steps
    staleness: torch.Tensor   # () int64 staleness in steps


def as_spec(channel: Union[ChannelSpec, dict, Sequence]) -> ChannelSpec:
    """Coerce a ``ChannelSpec``, its dict form (store round trip), or a
    plain ``(drop_prob, delay, staleness)`` sequence."""
    if isinstance(channel, ChannelSpec):
        spec = channel
    elif isinstance(channel, dict):
        spec = ChannelSpec(**channel)
    else:
        spec = ChannelSpec(*channel)
    if isinstance(spec.drop_prob, list):
        spec = spec._replace(drop_prob=tuple(spec.drop_prob))
    return spec


def validate_channel(channel, num_agents: Optional[int] = None) -> ChannelSpec:
    """Validate one channel configuration; returns the coerced spec."""
    spec = as_spec(channel)
    probs = (spec.drop_prob if isinstance(spec.drop_prob, tuple)
             else (spec.drop_prob,))
    for p in probs:
        if not isinstance(p, (int, float)) or not 0.0 <= float(p) <= 1.0:
            raise ValueError(
                f"channel drop_prob entries must lie in [0, 1], got {p!r}")
    if (num_agents is not None and isinstance(spec.drop_prob, tuple)
            and len(spec.drop_prob) != num_agents):
        raise ValueError(
            f"per-agent drop_prob has {len(spec.drop_prob)} entries for "
            f"{num_agents} agents")
    for name in ("delay", "staleness"):
        v = getattr(spec, name)
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(
                f"channel {name} must be a non-negative int, got {v!r}")
    return spec


def channel_caps(channels: Sequence) -> tuple[int, int]:
    """Ring capacities covering every channel in the set:
    ``(delay_cap, stale_cap) = (max delay + 1, max staleness + 1)``."""
    specs = [as_spec(c) for c in channels]
    return (max(s.delay for s in specs) + 1,
            max(s.staleness for s in specs) + 1)


def _prob_row(spec: ChannelSpec, num_agents: int, device) -> torch.Tensor:
    return torch.as_tensor(spec.drop_prob, dtype=torch.float32,
                           device=device).expand(num_agents)


def stack_channels(channels: Sequence, num_agents: int,
                   device=None) -> ChannelInputs:
    """Stack validated specs into the (C, ...) form for the sweep."""
    specs = [validate_channel(c, num_agents) for c in channels]
    return ChannelInputs(
        drop_prob=torch.stack([_prob_row(s, num_agents, device)
                               for s in specs]),
        delay=torch.tensor([s.delay for s in specs], dtype=torch.int64,
                           device=device),
        staleness=torch.tensor([s.staleness for s in specs],
                               dtype=torch.int64, device=device),
    )


def channel_inputs(channel, num_agents: int, device=None
                   ) -> tuple[ChannelInputs, tuple[int, int]]:
    """Per-run convenience: one spec -> (its tensors, its ring caps)."""
    spec = validate_channel(channel, num_agents)
    inputs = ChannelInputs(
        drop_prob=_prob_row(spec, num_agents, device),
        delay=torch.tensor(spec.delay, dtype=torch.int64, device=device),
        staleness=torch.tensor(spec.staleness, dtype=torch.int64,
                               device=device),
    )
    return inputs, channel_caps([spec])
