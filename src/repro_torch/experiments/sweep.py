"""The batched sweep engine, ported from ``repro/experiments/sweep.py``.

``run_sweep`` flattens the grid (optional env-family axis x optional
agent-param-set axis x optional channel axis x modes x lambdas x rhos x
seeds) into one run axis
and runs Algorithm 1 over it as a leading tensor dimension — the counterpart
of the reference's ``jax.vmap`` over runs.  ``chunk_size`` runs the axis in
chunks of that many runs (bounding device memory) and ``batching="map"``
runs one run at a time; all three give the same per-run results.

Seeds map to keys as ``repro_torch.random.key(seed)``, exactly the
reference's ``jax.random.key``, so runs that share a seed share their
sample stream across modes and lambdas (common random numbers).  Runs that
also share their env and fleet therefore draw identical batches, and the
engine draws each distinct batch once and hands it to every run that
shares it; the results are the same as drawing per run.  The draws of many
steps are made in one pass (``algorithm1.BlockSampler``).

``sampling="markov"`` runs a stateful family sampler (``repro_torch.core.
td.td_family_sampler_fn``) whose chain walk is drawn once per distinct
stream, with each stream's chain state threaded through the steps; only
the bootstrapped targets read a run's weights.

``plan_sweep`` / ``exec_plan_segment`` / ``finalize_sweep`` are the
chunk-boundary surface the resumable runtime
(``repro_torch.experiments.runtime``) checkpoints between: a segment is
``chunk_size`` runs, exactly the block ``run_sweep`` runs with the same
``chunk_size``.

One card: ``mesh`` must be None.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import gain_dispatch
from repro_torch.core import vfa as vfa_lib
from repro_torch.core.algorithm1 import (MODE_IDS, MODES,
                                         SAMPLER_STATE_FOLD, BlockSampler,
                                         InnerTrace, ParamSampler,
                                         ProblemTerms, SummaryTrace,
                                         TraceSpec, gated_sgd_core,
                                         resolve_trace, steps_at_once)
from repro_torch.core.trigger import TriggerConfig

BASE_AXES = ("mode", "lam", "rho", "seed")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One experiment grid: modes x lambdas x rhos x seeds (all run data).

    ``batching="vmap"`` runs the whole run axis (or ``chunk_size`` runs at
    a time) as one batch; ``"map"`` runs one run at a time.
    ``channel_sets`` (a tuple of ``ChannelSpec`` rows) adds a ``"channel"``
    grid axis right before the base four; None is the perfect channel.
    ``tag`` labels sweeps whose inputs differ where the spec cannot see
    (it is part of the store's hash).
    """

    modes: tuple[str, ...]
    lambdas: tuple[float, ...]
    seeds: tuple[int, ...]
    rhos: tuple[float, ...]
    eps: float
    num_iterations: int
    num_agents: int
    include_horizon_norm: bool = True
    random_tx_prob: Union[float, np.ndarray] = 0.5
    # 'reference' | 'kernel'; None resolves REPRO_TORCH_GAIN_BACKEND
    gain_backend: Optional[str] = None
    # 'reference' | 'fused' | 'megastep'; None resolves REPRO_TORCH_STEP_BACKEND
    step_backend: Optional[str] = None
    batching: str = "vmap"          # 'vmap' | 'map'
    trace: Union[str, TraceSpec] = "full"
    chunk_size: Optional[int] = None
    channel_sets: Optional[tuple] = None
    sampling: str = "iid"
    tag: Optional[str] = None

    def __post_init__(self):
        for m in self.modes:
            if m not in MODES:
                raise ValueError(f"unknown mode {m!r}, must be one of {MODES}")
        if self.batching not in ("vmap", "map"):
            raise ValueError(
                f"batching must be 'vmap' or 'map', got {self.batching!r}")
        if (self.gain_backend is not None
                and self.gain_backend not in gain_dispatch.BACKENDS):
            raise ValueError(
                f"gain_backend must be one of {gain_dispatch.BACKENDS}, "
                f"got {self.gain_backend!r}")
        if (self.step_backend is not None
                and self.step_backend not in gain_dispatch.STEP_BACKENDS):
            raise ValueError(
                f"step_backend must be one of {gain_dispatch.STEP_BACKENDS}, "
                f"got {self.step_backend!r}")
        resolve_trace(self.trace)
        if self.channel_sets is not None:
            if not self.channel_sets:
                raise ValueError(
                    "channel_sets must be a non-empty tuple of ChannelSpec "
                    "rows (or None for the perfect channel)")
            coerced = tuple(channel_lib.validate_channel(c, self.num_agents)
                            for c in self.channel_sets)
            object.__setattr__(self, "channel_sets", coerced)
            if (self.step_backend == "megastep"
                    and max(c.delay for c in coerced) > 0):
                raise ValueError(
                    "step_backend='megastep' fuses the server update into "
                    "the per-step kernel and cannot express a channel delay "
                    "> 0; use the reference or fused step backend")
        if self.sampling not in ("iid", "markov"):
            raise ValueError(
                f"sampling must be 'iid' or 'markov', got {self.sampling!r}")
        if self.chunk_size is not None:
            if self.batching != "vmap":
                raise ValueError("chunk_size only applies to batching='vmap'")
            if self.chunk_size < 1:
                raise ValueError(
                    f"chunk_size must be >= 1, got {self.chunk_size}")

    @property
    def grid_shape(self) -> tuple[int, int, int, int]:
        return (len(self.modes), len(self.lambdas), len(self.rhos),
                len(self.seeds))

    def thresholds(self) -> np.ndarray:
        """(L, R, N) float32 threshold schedules."""
        out = np.empty(
            (len(self.lambdas), len(self.rhos), self.num_iterations),
            np.float32)
        for i, lam in enumerate(self.lambdas):
            for j, rho in enumerate(self.rhos):
                out[i, j] = TriggerConfig(
                    lam=lam, rho=rho, num_iterations=self.num_iterations,
                    include_horizon_norm=self.include_horizon_norm
                ).schedule().numpy()
        return out


class SweepResult(NamedTuple):
    """Stacked traces + summaries; ``axes`` names the leading grid axes."""

    trace: Union[InnerTrace, SummaryTrace]
    comm_rate: torch.Tensor
    j_final: Optional[torch.Tensor]
    axes: tuple[str, ...] = BASE_AXES

    @property
    def final_weights(self) -> torch.Tensor:
        if isinstance(self.trace, SummaryTrace):
            return self.trace.final_weights
        return self.trace.weights[..., -1, :]


class _RunInputs(NamedTuple):
    """Per-run data of the flattened grid (leading axis = padded runs)."""

    keys: torch.Tensor                   # (G, 2)
    mode_ids: torch.Tensor               # (G,)
    thresholds: torch.Tensor             # (G, N)
    tx_probs: torch.Tensor               # (G,)
    set_idx: Optional[torch.Tensor]      # (G,) into the param-set stack
    env_idx: Optional[torch.Tensor]      # (G,) into the env-family stack
    chan_idx: Optional[torch.Tensor] = None   # (G,) into the channel stack


class SweepPlan(NamedTuple):
    """The flattened grid, ready to run (see ``plan_sweep``)."""

    spec: SweepSpec
    per_run: _RunInputs          # padded to ``padded_runs`` rows
    w0: torch.Tensor
    shared_params: object        # agent params when no param-set axis
    param_stack: object          # stacked param sets / per-env fleets
    env_stack: object            # env-family params (E, ...), or None
    env_terms: object            # stacked per-env ProblemTerms, or None
    shared_terms: object         # grid-shared ProblemTerms, or None
    sampler_fn: object
    gs: tuple[int, ...]          # grid shape ([E,] [P,] M, L, R, S)
    axes: tuple[str, ...]
    num_runs: int                # G: real grid cells
    padded_runs: int             # multiple of chunk_size
    env_indices: Optional[np.ndarray]   # (G,) env index per run, unpadded
    streams: np.ndarray          # (Gp,) id of each run's sample stream
    fleet_by_env: bool = False
    device: object = None
    channel_stack: object = None  # stacked ChannelInputs (C, ...), or None
    channel_caps: object = None   # (delay_cap, stale_cap), or None
    # sampling="markov": (agent_params (U, m, ...), rngs (U, 2)) -> chain
    # state (U, m), e.g. repro_torch.core.td.td_init_states
    state_init_fn: object = None

    @property
    def segment_runs(self) -> int:
        """Runs per checkpointable segment: ``chunk_size`` (the whole padded
        axis when the spec does not chunk)."""
        return self.spec.chunk_size or self.padded_runs

    def segments(self) -> list[tuple[int, int]]:
        """Half-open ``[start, stop)`` run ranges; the padding makes the
        padded axis divide evenly into segments."""
        s = self.segment_runs
        return [(a, a + s) for a in range(0, self.padded_runs, s)]


def plan_sweep(
    spec: SweepSpec,
    sampler: ParamSampler,
    w0,
    problem: Optional[Union[vfa_lib.VFAProblem, ProblemTerms]] = None,
    *,
    param_sets: Optional[dict] = None,
    env_sets=None,
    fleet_sets: Optional[dict] = None,
    mesh=None,
    state_init_fn=None,
    device=None,
) -> SweepPlan:
    """Flatten the requested grid into a ``SweepPlan`` (see ``run_sweep``)."""
    if mesh is not None:
        raise NotImplementedError(
            "repro_torch sweeps run on one card: mesh must be None")
    if spec.sampling == "markov":
        if state_init_fn is None:
            raise ValueError(
                "sampling='markov' threads per-agent sampler state through "
                "the step loop and needs state_init_fn=(agent_params, rng) "
                "-> state (e.g. repro_torch.core.td.td_init_states)")
        if not all(hasattr(sampler.fn, a) for a in ("draw", "walk")):
            raise TypeError(
                "sampling='markov' needs a family sampler with draw and "
                "walk (repro_torch.core.td.td_family_sampler_fn)")
    elif state_init_fn is not None:
        raise ValueError(
            "state_init_fn was given but spec.sampling is 'iid' — the "
            "stateless sampler contract has no state to initialize; set "
            "SweepSpec(sampling='markov') for stateful (Markovian) sweeps")
    dev = resolve_device(device)
    terms = (problem if isinstance(problem, ProblemTerms)
             else ProblemTerms.from_problem(problem) if problem is not None
             else None)
    env_terms = env_sets.terms if env_sets is not None else None
    if "theoretical" in spec.modes and terms is None and env_terms is None:
        raise ValueError("theoretical mode needs the exact problem "
                         "(problem= or env_sets with terms)")
    if fleet_sets is not None:
        if env_sets is None:
            raise ValueError("fleet_sets zips one agent fleet per env "
                             "instance — it requires env_sets")
        if param_sets is not None:
            raise ValueError("fleet_sets and param_sets cannot combine")

    M, L, R, S = spec.grid_shape
    share_params = param_sets is None
    gs: tuple[int, ...] = ()
    axes: tuple[str, ...] = ()
    if env_sets is not None:
        E = env_sets.num_instances
        gs += (E,)
        axes += ("env_set",)
        if fleet_sets is not None:
            for leaf in fleet_sets.values():
                if leaf.shape[0] != E:
                    raise ValueError(
                        f"fleet_sets leaves must stack one fleet per env "
                        f"instance: leading axis {leaf.shape[0]} != {E} envs")
                if leaf.shape[1] != spec.num_agents:
                    raise ValueError(
                        f"fleet_sets fleets carry {leaf.shape[1]} agents, "
                        f"spec.num_agents is {spec.num_agents}")
    if not share_params:
        gs += (int(next(iter(param_sets.values())).shape[0]),)
        axes += ("param_set",)
    if spec.channel_sets is not None:
        gs += (len(spec.channel_sets),)
        axes += ("channel",)
    gs += (M, L, R, S)
    axes += BASE_AXES
    G = math.prod(gs)

    grid = np.indices(gs).reshape(len(gs), G)
    mi, li, ri, si = grid[-4], grid[-3], grid[-2], grid[-1]
    ei = grid[0] if env_sets is not None else None
    pi = grid[1 if env_sets is not None else 0] if not share_params else None
    # the channel is the innermost leading axis (right before the base 4)
    ci = grid[len(gs) - 5] if spec.channel_sets is not None else None

    C = spec.chunk_size or 1
    Gp = C * math.ceil(G / C)
    pad = np.arange(Gp) % G

    def col(x):
        return np.zeros(Gp, np.int64) if x is None else x[pad]

    # a run's sample stream depends on its seed, env row and agent fleet,
    # not on its channel: the i.i.d. sampler never reads the weights, and
    # the keep mask draws from fold_in(rng_k, 1), not from the agents' keys.
    # Under Markovian sampling the chain walk (its start from the seed's
    # key, its randint and Gumbel draws, the target noise) never reads the
    # weights either; only the targets c[x] + gamma w[x'] + noise read a
    # run's w (w_stale on a channel), and they are formed per run after the
    # walk is handed out.  So the stream id leaves the channel out there too.
    _, streams = np.unique(np.stack([col(si), col(ei), col(pi)], -1),
                           axis=0, return_inverse=True)

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    per_run = _RunInputs(
        keys=trandom.keys(spec.seeds).to(dev)[on(si[pad])],
        mode_ids=on([MODE_IDS[m] for m in spec.modes], torch.int64)[on(mi[pad])],
        thresholds=on(spec.thresholds())[on(li[pad]), on(ri[pad])],
        tx_probs=on(np.broadcast_to(
            np.asarray(spec.random_tx_prob, np.float32), gs).reshape(G)[pad]),
        set_idx=None if share_params else on(pi[pad]),
        env_idx=on(ei[pad]) if env_sets is not None else None,
        chan_idx=on(ci[pad]) if ci is not None else None)

    def params_on(p):
        return {k: on(v) for k, v in p.items()}

    shared_params = param_stack = None
    if fleet_sets is not None:
        param_stack = params_on(fleet_sets)
    elif share_params:
        shared_params = params_on(sampler.params)
    else:
        param_stack = params_on(param_sets)
    return SweepPlan(
        spec=spec, per_run=per_run, w0=on(w0, torch.float32),
        shared_params=shared_params, param_stack=param_stack,
        env_stack=(params_on(env_sets.params) if env_sets is not None
                   else None),
        env_terms=env_terms.to(dev) if env_terms is not None else None,
        shared_terms=(None if env_terms is not None or terms is None
                      else terms.to(dev)),
        sampler_fn=sampler.fn, gs=gs, axes=axes, num_runs=G, padded_runs=Gp,
        env_indices=ei, streams=np.asarray(streams).reshape(-1),
        fleet_by_env=fleet_sets is not None, device=dev,
        channel_stack=(None if spec.channel_sets is None else
                       channel_lib.stack_channels(
                           spec.channel_sets, spec.num_agents, dev)),
        channel_caps=(None if spec.channel_sets is None else
                      channel_lib.channel_caps(spec.channel_sets)),
        state_init_fn=state_init_fn)


def _gather(tree: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in tree.items()}


def _exec_block(plan: SweepPlan, rows: np.ndarray):
    """Run the padded runs ``rows`` as one batch through the core."""
    spec, dev = plan.spec, plan.device
    sel = torch.as_tensor(rows, device=dev)
    run = _RunInputs(*(None if x is None else x[sel] for x in plan.per_run))
    # one draw per distinct sample stream, handed to every run that shares it
    _, first, inverse = np.unique(plan.streams[rows], return_index=True,
                                  return_inverse=True)
    every_run = len(first) == len(rows)
    if every_run:                            # each run draws its own batch
        first = inverse = np.arange(len(rows))
    rep = sel[torch.as_tensor(first, device=dev)]
    inv = torch.as_tensor(np.asarray(inverse).reshape(-1), device=dev)
    if plan.param_stack is None:
        params = {k: v.expand((len(first),) + v.shape)
                  for k, v in plan.shared_params.items()}
    else:
        pidx = (plan.per_run.env_idx if plan.fleet_by_env
                else plan.per_run.set_idx)[rep]
        params = _gather(plan.param_stack, pidx)
    env = (_gather(plan.env_stack, plan.per_run.env_idx[rep])
           if plan.env_stack is not None else None)
    local_rep = torch.as_tensor(first, device=dev)
    fn = plan.sampler_fn

    def streams(rngs):
        """The distinct streams' keys of b steps: (U, b, m, 2)."""
        return rngs if every_run else rngs[local_rep]

    def to_runs(x):
        return x if every_run else x[inv]

    state = None
    if spec.sampling == "markov":
        # each stream's chain starts from its first run's key, folded
        # inside the block, so a resumed segment rebuilds the same state
        state = plan.state_init_fn(params, trandom.fold_in(
            run.keys[local_rep], SAMPLER_STATE_FOLD))

        def take(st, w, draws):
            st, walk = fn.walk(env, params, st, draws)
            return (st,) + walk.to_runs(to_runs).batch(w)

        sampler = BlockSampler(draw=lambda rngs: fn.draw(env, streams(rngs)),
                               take=take)
    else:
        def draw(rngs):
            rngs = streams(rngs)
            U, b = rngs.shape[:2]

            def per_step(t):      # a stream's leaf, once for each step
                return t.unsqueeze(1).expand((U, b) + t.shape[1:]).reshape(
                    (U * b,) + t.shape[1:])
            pb = {k: per_step(v) for k, v in params.items()}
            eb = (None if env is None else
                  {k: per_step(v) for k, v in env.items()})
            return steps_at_once(
                lambda r: fn(eb, pb, r) if eb is not None else fn(pb, r),
                rngs)

        sampler = BlockSampler(
            draw=draw, take=lambda draws: tuple(to_runs(x) for x in draws))

    terms = plan.shared_terms
    if plan.env_terms is not None:
        terms = ProblemTerms(*(t[run.env_idx] for t in plan.env_terms))
    chan = (None if plan.channel_stack is None else
            channel_lib.ChannelInputs(*(t[run.chan_idx]
                                        for t in plan.channel_stack)))
    return gated_sgd_core(
        run.keys, plan.w0, run.mode_ids, run.thresholds, run.tx_probs,
        sampler, spec.eps, spec.num_agents, terms=terms,
        gain_backend=spec.gain_backend, trace=spec.trace,
        step_backend=spec.step_backend, channel=chan,
        channel_caps=plan.channel_caps, sampler_state=state, device=dev)


def _concat(parts):
    return type(parts[0])(*(
        None if xs[0] is None else torch.cat(xs, dim=0)
        for xs in zip(*parts)))


def exec_plan(plan: SweepPlan):
    """Run the whole padded run axis: one batch, chunks, or one run at a time."""
    if plan.spec.batching == "map":
        return _concat([_exec_block(plan, np.arange(a, a + 1))
                        for a in range(plan.padded_runs)])
    return _concat([exec_plan_segment(plan, a, b)
                    for a, b in plan.segments()])


def exec_plan_segment(plan: SweepPlan, start: int, stop: int):
    """One checkpointable segment ``[start, stop)`` of the padded run axis,
    run as one batch: the same block, and so the same bytes, as the rows
    ``[start, stop)`` of ``exec_plan`` at this ``chunk_size``."""
    if not (0 <= start < stop <= plan.padded_runs):
        raise ValueError(f"segment [{start}, {stop}) outside "
                         f"[0, {plan.padded_runs})")
    return _exec_block(plan, np.arange(start, stop))


class ShapeDtype(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def segment_shapes(plan: SweepPlan):
    """Shape and dtype of each leaf of one segment's output, from the trace
    type and the plan (the port has no ``eval_shape``): a trace NamedTuple
    of ``ShapeDtype`` (None where the run leaves a field out)."""
    spec, rs = plan.spec, plan.segment_runs
    N, m, n = spec.num_iterations, spec.num_agents, plan.w0.shape[-1]
    trace = resolve_trace(spec.trace)
    has_terms = plan.env_terms is not None or plan.shared_terms is not None
    lossy = plan.channel_stack is not None

    def sd(*shape, keep=True):
        return ShapeDtype((rs,) + shape, torch.float32) if keep else None

    if trace == "full":
        return InnerTrace(weights=sd(N + 1, n), alphas=sd(N, m),
                          gains=sd(N, m), comm_rate=sd(),
                          delivered=sd(N, m, keep=lossy))
    return SummaryTrace(
        final_weights=sd(n), comm_rate=sd(), tx_counts=sd(m),
        gain_mean=sd(m), gain_min=sd(m), gain_max=sd(m),
        j_final=sd(keep=has_terms),
        j_trajectory=sd(N, keep=trace.j_trajectory and has_terms),
        alphas=sd(N, m, keep=trace.alphas), gains=sd(N, m, keep=trace.gains),
        delivered_counts=sd(m, keep=lossy), delivered_rate=sd(keep=lossy))


def finalize_sweep(plan: SweepPlan, flat) -> SweepResult:
    """Trim padding, restore the grid shape, attach exact-J summaries."""
    gs, G = plan.gs, plan.num_runs
    flat = type(flat)(*(None if x is None else x[:G] for x in flat))
    result = type(flat)(*(None if x is None else x.reshape(gs + x.shape[1:])
                          for x in flat))
    if isinstance(flat, SummaryTrace):
        j_final = result.j_final
    elif plan.env_terms is not None:
        idx = torch.as_tensor(plan.env_indices, device=plan.device)
        terms = ProblemTerms(*(t[idx] for t in plan.env_terms))
        j_final = terms.objective(flat.weights[:, -1, :]).reshape(gs)
    elif plan.shared_terms is not None:
        j_final = plan.shared_terms.objective(
            flat.weights[:, -1, :]).reshape(gs)
    else:
        j_final = None
    return SweepResult(trace=result, comm_rate=result.comm_rate,
                       j_final=j_final, axes=plan.axes)


def run_sweep(
    spec: SweepSpec,
    sampler: ParamSampler,
    w0,
    problem: Optional[Union[vfa_lib.VFAProblem, ProblemTerms]] = None,
    *,
    param_sets: Optional[dict] = None,
    env_sets=None,
    fleet_sets: Optional[dict] = None,
    mesh=None,
    state_init_fn=None,
    device=None,
) -> SweepResult:
    """Execute the whole grid on one device (default cuda).

    Args:
      sampler:    the fleet: a batched sampling fn plus stacked agent params.
                  With ``env_sets`` the fn takes ``(env_params, agent_params,
                  rngs)`` — see ``repro_torch.envs.base.family_sampler_fn``.
      problem:    exact problem for the theoretical trigger / J summaries.
      param_sets: dict of stacked agent-param sets, leaves (P, m, ...):
                  adds a leading ``"param_set"`` axis.
      env_sets:   an ``EnvFamily`` (leaves (E, ...) + stacked terms): adds
                  the outermost ``"env_set"`` axis.
      fleet_sets: per-env fleets, leaves (E, m, ...), zipped with the env
                  axis (requires ``env_sets``; exclusive with param_sets).
      mesh:       must be None (one card).
      device:     where to run; without a GPU pass ``device="cpu"``.

    Returns a SweepResult whose leaves carry the grid shape
    ``([E,] [P,] M, L, R, S)`` and whose ``axes`` names those axes.
    """
    plan = plan_sweep(spec, sampler, w0, problem, param_sets=param_sets,
                      env_sets=env_sets, fleet_sets=fleet_sets, mesh=mesh,
                      state_init_fn=state_init_fn, device=device)
    return finalize_sweep(plan, exec_plan(plan))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def tradeoff_rows(result: SweepResult, spec: SweepSpec, **extra) -> list[dict]:
    """Fig-2-style tradeoff summary: mean over seeds per grid cell, with the
    paper's metric (8) ``lam * comm_rate + J`` when J is available."""
    if result.axes[-4:] != BASE_AXES:
        raise ValueError(f"unexpected trailing axes {result.axes!r}")
    lead = result.axes[:-4]
    comm = _np(result.comm_rate).mean(axis=-1)
    jf = (_np(result.j_final).mean(axis=-1)
          if result.j_final is not None else None)
    rows = []
    for idx in np.ndindex(*comm.shape):
        m, l, r = idx[-3], idx[-2], idx[-1]
        row = dict(mode=spec.modes[m], lam=spec.lambdas[l], rho=spec.rhos[r],
                   comm_rate=float(comm[idx]), **extra)
        for name, i in zip(lead, idx):
            row[name] = int(i)
        if jf is not None:
            row["J_final"] = float(jf[idx])
            row["metric8"] = float(spec.lambdas[l] * comm[idx] + jf[idx])
        rows.append(row)
    return rows


def matched_random_probs(result: SweepResult, spec: SweepSpec,
                         mode: str = "theoretical") -> np.ndarray:
    """Per-cell transmit probabilities for the rate-matched random baseline
    (``mode``'s measured comm rates, averaged over seeds)."""
    if result.axes[-4:] != BASE_AXES:
        raise ValueError(f"unexpected trailing axes {result.axes!r}")
    comm = _np(result.comm_rate)
    m = spec.modes.index(mode)
    rates = comm[..., m, :, :, :].mean(axis=-1, keepdims=True)
    return rates[..., None, :, :, :]
