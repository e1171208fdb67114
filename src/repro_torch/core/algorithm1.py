"""Algorithm 1's inner loop (paper §II-B, §III-IV), ported from
``repro/core/algorithm1.py``.

``gated_sgd_core`` runs N gated-SGD iterations for a batch of runs at once:
the run axis is a leading tensor dimension (the reference vmaps a per-run
core over it), the scan over iterations is a Python loop, and the trigger
mode, thresholds and random-transmit probability are per-run data, so one
code path serves every cell of a sweep grid.  A single run is the same
core with R = 1 (pass an unbatched key).

``channel=`` (with its ring capacities ``channel_caps``) runs the lossy
edge of ``repro.core.channel``: drop, delay and staleness per run.
``sampler_state=`` threads a stateful (Markovian) sampler's per-run chain
state through the step loop (``repro_torch.core.td``).  The reference's
``jax.lax.optimization_barrier`` has no counterpart: torch runs eagerly and
folds nothing.

Every key of a run is known before its first step, so the loop draws the
randomness of many steps in one pass: the per-step key split, the
random-mode and keep-mask draws and the agents' samples (``BlockSampler``).
Each draw is a function of its key alone, so a run's result does not
depend on how many steps a pass draws.

``run_value_iteration`` / ``run_value_iteration_scan`` are the outer loop
(lines 10-12): repeated inner fits, each starting from and bootstrapping
off the last one's weights.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch import random as trandom
from repro_torch import resolve_device
from repro_torch.core import channel as channel_lib
from repro_torch.core import gain_dispatch
from repro_torch.core import server as server_lib
from repro_torch.core import vfa as vfa_lib
from repro_torch.core.trigger import TriggerConfig, should_transmit

MODES = gain_dispatch.MODES
MODE_IDS = {name: i for i, name in enumerate(MODES)}

# fold_in tag deriving a run's sampler-state init key from its run key ("TD"
# in ASCII), the reference's: run_td and the sweep's markov path share it,
# so per-run and in-sweep chains are the same
SAMPLER_STATE_FOLD = 0x5444

# sample_all(rngs (R, m, 2)) -> (phi (R, m, T, n), targets (R, m, T))
SampleAll = Callable[[torch.Tensor], tuple]

# bytes of randomness (and of a BlockSampler's samples) one pass may draw:
# the loop sizes its passes from the first step's draws
DRAW_BYTES = 1 << 28


class BlockSampler(NamedTuple):
    """A sampler that draws the samples of many steps in one pass.

    ``draw(rngs (R, b, m, 2))`` returns a tuple of tensors whose axis 1 is
    the step (axis 0 the run, or whatever ``take`` maps to runs);
    ``take(draws)`` turns one step's slice of them into ``(phi, targets)``,
    or, for a stateful sampler, ``take(state, w, draws)`` into ``(state',
    phi, targets)``.  Called like a plain sampler it draws one step.
    """

    draw: Callable
    take: Callable

    def __call__(self, *args):
        *lead, rngs = args
        draws = self.draw(rngs.unsqueeze(1))
        return self.take(*lead, tuple(x[:, 0] for x in draws))


class ParamSampler(NamedTuple):
    """One batched sampling function plus stacked per-agent parameters.

    ``fn(params, rngs) -> (phi (R, m, T, n), targets (R, m, T))`` draws
    every agent's local batch of every run; ``params`` is a dict whose
    tensors carry the agent axis (m, ...) — or (R, m, ...) when the runs'
    fleets differ — and ``rngs`` is (R, m, 2).
    """

    fn: Callable
    params: object

    @property
    def num_agents(self) -> int:
        if not self.params:
            raise ValueError(
                "ParamSampler.params is empty (e.g. None): such samplers "
                "only carry the fn for run_sweep(param_sets=...) and cannot "
                "be used where a concrete fleet is required")
        return int(next(iter(self.params.values())).shape[0])


class InnerTrace(NamedTuple):
    """Per-iteration trace (leading run axis when batched, then N).

    ``alphas`` / ``comm_rate`` are the attempted transmissions (eq. 7),
    channel or not; ``delivered`` is the subset the channel let through,
    present only on a lossy-channel run.
    """

    weights: torch.Tensor      # (..., N+1, n) w_0..w_N
    alphas: torch.Tensor       # (..., N, m) transmit decisions
    gains: torch.Tensor        # (..., N, m) evaluated gains
    comm_rate: torch.Tensor    # (...,) (1/N) sum_k mean_i alpha_k^i (eq. 7)
    delivered: Optional[torch.Tensor] = None   # (..., N, m) alpha * keep


class TraceSpec(NamedTuple):
    """What the streaming loop keeps besides the O(1) running summaries."""

    j_trajectory: bool = False
    alphas: bool = False
    gains: bool = False


class SummaryTrace(NamedTuple):
    """Streaming counterpart of ``InnerTrace``: running summaries only."""

    final_weights: torch.Tensor          # (..., n) w_N
    comm_rate: torch.Tensor              # (...,) eq. 7
    tx_counts: torch.Tensor              # (..., m)
    gain_mean: torch.Tensor              # (..., m)
    gain_min: torch.Tensor               # (..., m)
    gain_max: torch.Tensor               # (..., m)
    j_final: Optional[torch.Tensor]      # (...,) exact J(w_N), with terms
    j_trajectory: Optional[torch.Tensor]  # (..., N)
    alphas: Optional[torch.Tensor]       # (..., N, m)
    gains: Optional[torch.Tensor]        # (..., N, m)
    # the delivered subset on a lossy channel (None on the perfect one)
    delivered_counts: Optional[torch.Tensor] = None   # (..., m)
    delivered_rate: Optional[torch.Tensor] = None     # (...,)


SUMMARY_TRACE = TraceSpec()


def resolve_trace(trace) -> Union[str, TraceSpec]:
    """Normalize the trace policy: 'full' | 'summary' | TraceSpec."""
    if trace == "full":
        return "full"
    if trace == "summary":
        return SUMMARY_TRACE
    if isinstance(trace, TraceSpec):
        return trace
    raise ValueError(
        f"trace must be 'full', 'summary' or a TraceSpec, got {trace!r}")


class ProblemTerms(NamedTuple):
    """The exact problem as sufficient statistics.

    J(w) = w^T Phi w - 2 b^T w + c0, grad J = 2 (Phi w - b).  Leaves are
    shared ((n, n), (n,), ()) or per run ((R, n, n), (R, n), (R,)); ``grad``
    and ``objective`` take weights (..., n).
    """

    phi_matrix: torch.Tensor
    bvec: torch.Tensor
    c0: torch.Tensor

    @classmethod
    def from_problem(cls, problem: vfa_lib.VFAProblem) -> "ProblemTerms":
        b = torch.einsum("s,si->i", problem.d_weights * problem.targets,
                         problem.phi_matrix)
        c0 = torch.sum(problem.d_weights * problem.targets**2)
        return cls(phi_matrix=problem.second_moment(), bvec=b, c0=c0)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        return 2.0 * ((self.phi_matrix @ w.unsqueeze(-1)).squeeze(-1)
                      - self.bvec)

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        pw = (self.phi_matrix @ w.unsqueeze(-1)).squeeze(-1)
        return (w * pw).sum(-1) - 2.0 * (self.bvec * w).sum(-1) + self.c0

    def to(self, device) -> "ProblemTerms":
        return ProblemTerms(*(t.to(device) for t in self))


@dataclasses.dataclass(frozen=True)
class GatedSGDConfig:
    trigger: TriggerConfig
    eps: float
    num_agents: int
    mode: str = "practical"
    random_tx_prob: float = 0.5
    # 'reference' | 'kernel'; None reads REPRO_TORCH_GAIN_BACKEND
    gain_backend: Optional[str] = None
    # 'reference' | 'fused' | 'megastep'; None reads REPRO_TORCH_STEP_BACKEND
    step_backend: Optional[str] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
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


def _runs(x, R: int, device, dtype) -> torch.Tensor:
    """A per-run scalar as an (R,) tensor (a shared value is broadcast)."""
    return torch.as_tensor(x, device=device).to(dtype).expand(R)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def gated_sgd_core(
    rng: torch.Tensor,
    w0: torch.Tensor,
    mode_id,
    thresholds: torch.Tensor,
    tx_prob,
    sample_all: SampleAll,
    eps: float,
    num_agents: int,
    terms: Optional[ProblemTerms] = None,
    gain_backend: Optional[str] = None,
    trace: Union[str, TraceSpec] = "full",
    step_backend: Optional[str] = None,
    channel: Optional[channel_lib.ChannelInputs] = None,
    channel_caps: Optional[tuple[int, int]] = None,
    sampler_state=None,
    device=None,
) -> Union[InnerTrace, SummaryTrace]:
    """Branchless inner loop of Algorithm 1 (lines 5-9) for R runs at once.

    Args:
      rng:        (R, 2) run keys, or one (2,) key for a single run (then
                  every output drops its run axis).
      w0:         (n,) shared or (R, n) initial weights.
      mode_id:    int or (R,) trigger-mode ids (``MODES``).
      thresholds: (N,) shared or (R, N) per-iteration lambda_k.
      tx_prob:    float or (R,) random-mode transmit probability.
      sample_all: a ``BlockSampler``, or a batched callable ``rngs (R', m,
                  2) -> (phi (R', m, T, n), targets (R', m, T))`` whose
                  fleet is shared by every run: it is called on the keys
                  of R' = R x b steps at once.
      terms:      exact ``ProblemTerms`` (shared or per-run leaves), needed
                  by the theoretical mode and for J summaries.
      channel:    optional ``ChannelInputs``: drop_prob (m,) or (R, m),
                  delay and staleness () or (R,); needs ``channel_caps``
                  ``(delay_cap, stale_cap)`` covering every run's values.
      sampler_state: switches ``sample_all`` (then a ``BlockSampler``) to
                  the stateful form ``take(state, w, draws) -> (state',
                  phi, targets)``; the state is threaded untouched from
                  step to step, except that a single run's gains the run
                  axis.  The sampler sees the weights the agents see:
                  ``w``, or ``w_{k-s}`` on a channel.
      device:     where to run (default cuda; raises without a GPU unless
                  the caller passes "cpu").

    Per step: one ``split`` per run into m agent keys and the random-mode
    key (``rngs[-1]``, as the reference), the agents' batches and
    stochastic gradients, then the gain family, the eq. 9 trigger and the
    eq. 6 update through ``gain_dispatch`` ("megastep" does all three in
    one dispatch).  Both trace policies run the same step body.  The keys
    and key-only draws of up to ``DRAW_BYTES`` worth of steps are made in
    one pass ahead of those steps.

    With a channel (the reference's ``_channel_core``): the keep mask is
    ``bernoulli(fold_in(rng_k, 1), 1 - drop_prob)``, so the agents' and the
    trigger's keys are the perfect channel's and a clean channel gives
    the ``channel=None`` result bit for bit; the agents compute gradients,
    gains and grad J at ``w_{k-s}`` from a (R, stale_cap, n) ring that
    starts as w0, while the update applies to the current w; the delivered
    sum and count enter a (R, delay_cap) ring and land d steps later.
    Each run reads its own ring slot by a gather.  "megastep" applies the
    keep mask inside the kernel and takes no delay.
    """
    dev = resolve_device(device)
    step_backend_r = gain_dispatch._resolve_step(step_backend)
    if channel is not None:
        if channel_caps is None:
            raise ValueError(
                "channel= needs the ring capacities channel_caps="
                "(delay_cap, stale_cap); build both via "
                "repro_torch.core.channel.channel_inputs(spec, num_agents)")
        if step_backend_r == "megastep" and channel_caps[0] > 1:
            raise NotImplementedError(
                "step_backend='megastep' fuses the server update into the "
                "per-step kernel, which cannot express a transmission delay "
                "(delivered updates must land d steps later); use the "
                "reference or fused step backend for channels with delay > 0")
    trace = resolve_trace(trace)
    rng = torch.as_tensor(rng).to(dev)
    single = rng.dim() == 1
    if single:
        rng = rng.unsqueeze(0)
    stateful = sampler_state is not None
    st = sampler_state
    if stateful and single:
        st = st.unsqueeze(0)
    if not isinstance(sample_all, BlockSampler):
        if stateful:
            raise TypeError("a stateful sampler (sampler_state=) must be a "
                            "BlockSampler, e.g. repro_torch.core.td."
                            "td_sample_all")
        sample_all = BlockSampler(
            draw=functools.partial(steps_at_once, sample_all),
            take=lambda draws: draws)
    R, m = rng.shape[0], num_agents
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32).to(dev)
    if thresholds.dim() == 1:
        thresholds = thresholds.expand(R, -1)
    N = thresholds.shape[-1]
    w = torch.as_tensor(w0, dtype=torch.float32).to(dev).expand(R, -1)
    w = w.contiguous()         # steps return new weights, never write w
    modes = _runs(mode_id, R, dev, torch.int64)
    tx_p = _runs(tx_prob, R, dev, torch.float32)
    if terms is not None:
        terms = terms.to(dev)
    phi_matrix = terms.phi_matrix if terms is not None else None

    lossy = channel is not None
    if lossy:
        delay_cap, stale_cap = channel_caps
        keep_p = 1.0 - torch.as_tensor(channel.drop_prob, dtype=torch.float32
                                       ).to(dev).expand(R, m)
        delay = _runs(channel.delay, R, dev, torch.int64)
        staleness = _runs(channel.staleness, R, dev, torch.int64)
        runs = torch.arange(R, device=dev)
        stale_ring = w.unsqueeze(1).repeat(1, stale_cap, 1)      # w0 in every slot
        pend_sum = torch.zeros((R, delay_cap, w.shape[-1]), device=dev)
        pend_cnt = torch.zeros((R, delay_cap), device=dev)

    step_keys = trandom.split(rng, N)                      # (R, N, 2)

    def draw(k0, b):
        """Steps [k0, k0 + b) of every key-only draw: the random-mode mask
        (from ``rngs[-1]`` of each step's split), the keep mask and the
        sampler's draws from the agents' keys."""
        keys = step_keys[:, k0:k0 + b]                     # (R, b, 2)
        rngs = trandom.split(keys, m + 1)                  # (R, b, m+1, 2)
        alpha_rand = trandom.bernoulli(
            rngs[:, :, m], tx_p.view(R, 1, 1), (m,)).float()
        keep = (trandom.bernoulli(trandom.fold_in(keys, 1),
                                  keep_p.unsqueeze(1), (m,)).float()
                if lossy else None)
        return alpha_rand, keep, sample_all.draw(rngs[:, :, :m])

    def step_body(w, st, k, alpha_rand, keep, draws):
        w_agent = w
        if lossy:
            w_agent = stale_ring[runs, (k - staleness) % stale_cap]
        got = sample_all.take(*((st, w_agent) if stateful else ()), draws)
        if stateful:
            st, phi_b, targets_b = got
        else:
            phi_b, targets_b = got
        grads = vfa_lib.stochastic_gradient(w_agent.unsqueeze(1), phi_b,
                                            targets_b)
        grad_j = terms.grad(w_agent) if terms is not None else None
        if step_backend_r == "megastep":
            # with a channel, delay_cap == 1 (checked above): the kernel's
            # update is the immediate arrival of the kept transmissions
            w_next, alphas, gains = gain_dispatch.megastep(
                modes, w, grads, phi_b, eps, thresholds[:, k], alpha_rand,
                grad_j, phi_matrix, backend=gain_backend,
                deliver=keep if lossy else None)
        else:
            gains = gain_dispatch.mode_gains(
                modes, grads, phi_b, eps, grad_j, phi_matrix,
                backend=gain_backend, step_backend=step_backend)
            gate = should_transmit(gains, thresholds[:, k].unsqueeze(-1))
            alphas = gain_dispatch.select_alphas(modes, gate, alpha_rand)
            if lossy:
                # write this step's slot before reading: with delay 0 the
                # slot read is the slot just written
                slot = k % delay_cap
                pend_sum[:, slot], pend_cnt[:, slot] = server_lib.gated_sum(
                    grads, alphas * keep)
                back = (k - delay) % delay_cap
                w_next = w - eps * server_lib.masked_mean(
                    pend_sum[runs, back], pend_cnt[runs, back])
            else:
                w_next = server_lib.server_update(w, grads, alphas, eps)
        if not lossy:
            return w_next, st, alphas, gains, None
        stale_ring[:, (k + 1) % stale_cap] = w_next
        return w_next, st, alphas, gains, alphas * keep

    full = trace == "full"
    if full:
        ws, alist, glist, dlist = [w], [], [], []
    else:
        tx_counts = torch.zeros((R, m), device=dev)
        dl_counts = torch.zeros((R, m), device=dev) if lossy else None
        gain_sum = torch.zeros((R, m), device=dev)
        gain_min = torch.full((R, m), float("inf"), device=dev)
        gain_max = torch.full((R, m), float("-inf"), device=dev)
        j_traj, alist, glist = [], [], []
    k0, per_pass = 0, 1        # the first pass draws one step and sizes the rest
    while k0 < N:
        b = min(per_pass, N - k0)
        alpha_rand, keep, draws = draw(k0, b)
        if k0 == 0:
            per_step = _nbytes(alpha_rand, keep, *draws)
            per_pass = max(1, DRAW_BYTES // max(per_step, 1))
        for j in range(b):
            k = k0 + j
            # one step's slices, contiguous as the kernels take them
            w, st, alphas, gains, delivered = step_body(
                w, st, k, alpha_rand[:, j].contiguous(),
                keep[:, j].contiguous() if lossy else None,
                tuple(x[:, j].contiguous() for x in draws))
            if full:
                ws.append(w)
                alist.append(alphas)
                glist.append(gains)
                if lossy:
                    dlist.append(delivered)
                continue
            tx_counts = tx_counts + alphas
            if lossy:
                dl_counts = dl_counts + delivered
            gain_sum = gain_sum + gains
            gain_min = torch.minimum(gain_min, gains)
            gain_max = torch.maximum(gain_max, gains)
            if trace.j_trajectory and terms is not None:
                j_traj.append(terms.objective(w))
            if trace.alphas:
                alist.append(alphas)
            if trace.gains:
                glist.append(gains)
        k0 += b

    def stack(xs):
        return torch.stack(xs, dim=1) if xs else None

    if full:
        alphas_s = stack(alist)
        out = InnerTrace(weights=stack(ws), alphas=alphas_s,
                         gains=stack(glist),
                         comm_rate=alphas_s.mean(dim=(1, 2)),
                         delivered=stack(dlist))
    else:
        out = SummaryTrace(
            final_weights=w,
            comm_rate=tx_counts.sum(-1) / (N * m),
            tx_counts=tx_counts,
            gain_mean=gain_sum / N,
            gain_min=gain_min,
            gain_max=gain_max,
            j_final=terms.objective(w) if terms is not None else None,
            j_trajectory=stack(j_traj),
            alphas=stack(alist),
            gains=stack(glist),
            delivered_counts=dl_counts,
            delivered_rate=(dl_counts.sum(-1) / (N * m) if lossy else None))
    if single:
        out = type(out)(*(None if x is None else x[0] for x in out))
    return out


def steps_at_once(sample, rngs: torch.Tensor) -> tuple:
    """A batched i.i.d. sampler over b steps' keys ``(R, b, m, 2)`` in one
    call: the step axis joins the run axis and splits off again."""
    R, b = rngs.shape[:2]
    out = sample(rngs.reshape((R * b,) + rngs.shape[2:]))
    return tuple(x.reshape((R, b) + x.shape[1:]) for x in out)


def make_sample_all(sampler, num_agents: int, device=None) -> SampleAll:
    """Adapt a ``ParamSampler`` (or a batched ``rngs -> batch`` callable)
    to the core's interface; the fleet's params move to ``device`` once."""
    if isinstance(sampler, ParamSampler):
        if sampler.num_agents != num_agents:
            raise ValueError(
                f"ParamSampler carries {sampler.num_agents} agents, "
                f"config says {num_agents}")
        params = {k: torch.as_tensor(v).to(device)
                  for k, v in sampler.params.items()}

        def sample_all(rngs):
            return sampler.fn({k: v.expand((rngs.shape[0],) + v.shape)
                               for k, v in params.items()}, rngs)
        return sample_all
    if callable(sampler):
        return sampler
    raise TypeError("sampler must be a ParamSampler or a batched callable "
                    "rngs (R, m, 2) -> (phi, targets)")


def run_gated_sgd(
    rng: torch.Tensor,
    w0: torch.Tensor,
    sampler,
    cfg: GatedSGDConfig,
    problem: Optional[vfa_lib.VFAProblem] = None,
    trace: Union[str, TraceSpec] = "full",
    device=None,
) -> Union[InnerTrace, SummaryTrace]:
    """One inner run of Algorithm 1 (lines 5-9) for N iterations, m agents.

    ``rng`` is one (2,) key (``repro_torch.random.key(seed)``); the result
    carries no run axis.  ``problem`` is needed by the theoretical mode.
    """
    if cfg.mode == "theoretical" and problem is None:
        raise ValueError("theoretical mode needs the exact VFAProblem")
    dev = resolve_device(device)
    terms = ProblemTerms.from_problem(problem) if problem is not None else None
    return gated_sgd_core(
        rng, w0,
        mode_id=MODE_IDS[cfg.mode],
        thresholds=cfg.trigger.schedule(),
        tx_prob=cfg.random_tx_prob,
        sample_all=make_sample_all(sampler, cfg.num_agents, dev),
        eps=cfg.eps,
        num_agents=cfg.num_agents,
        terms=terms,
        gain_backend=cfg.gain_backend,
        trace=trace,
        step_backend=cfg.step_backend,
        device=dev,
    )


def performance_metric(trace: InnerTrace, lam: float,
                       problem: vfa_lib.VFAProblem) -> torch.Tensor:
    """The paper's criterion (8): lam * comm_rate + J(w_N)."""
    w = trace.weights[-1]
    return lam * trace.comm_rate + problem.objective(w.to(
        problem.phi_matrix.device))


def run_value_iteration(
    rng: torch.Tensor,
    w0,
    make_sampler: Callable,
    cfg: GatedSGDConfig,
    num_outer: int,
    problem_for_v: Optional[Callable] = None,
    device=None,
) -> tuple[torch.Tensor, list]:
    """Algorithm 1 in full: ``num_outer`` Bellman updates (lines 10-12).

    Each outer step splits ``rng`` into the next ``rng`` and the inner
    run's key, fits ``make_sampler(V)``'s targets from ``V`` and makes the
    fit the next ``V``.  Returns the final weights and every inner trace.
    """
    dev = resolve_device(device)
    rng = torch.as_tensor(rng).to(dev)
    v = torch.as_tensor(w0, dtype=torch.float32).to(dev)
    traces = []
    for _ in range(num_outer):
        rng, sub = trandom.split(rng).unbind(-2)
        problem = problem_for_v(v) if problem_for_v is not None else None
        tr = run_gated_sgd(sub, v, make_sampler(v), cfg, problem=problem,
                           device=dev)
        v = tr.weights[-1]
        traces.append(tr)
    return v, traces


def run_value_iteration_scan(
    rng: torch.Tensor,
    w0,
    sampler_fn: Callable,
    make_params: Callable,
    cfg: GatedSGDConfig,
    num_outer: int,
    terms_for_v: Optional[Callable] = None,
    device=None,
) -> tuple[torch.Tensor, InnerTrace]:
    """The reference's ``lax.scan`` form of the outer loop: the outer keys
    are ``split(rng, num_outer)`` up front, and each step rebuilds the
    fleet's params (``make_params(V)``) and, optionally, the exact terms
    (``terms_for_v(V)``, needed by the theoretical trigger) from V.
    Returns the final weights and the inner traces stacked along a leading
    outer axis."""
    if cfg.mode == "theoretical" and terms_for_v is None:
        raise ValueError("theoretical mode needs terms_for_v")
    dev = resolve_device(device)
    v = torch.as_tensor(w0, dtype=torch.float32).to(dev)
    thresholds = cfg.trigger.schedule()
    traces = []
    for rng_o in trandom.split(torch.as_tensor(rng).to(dev), num_outer):
        sampler = ParamSampler(fn=sampler_fn, params=make_params(v))
        tr = gated_sgd_core(
            rng_o, v, MODE_IDS[cfg.mode], thresholds, cfg.random_tx_prob,
            make_sample_all(sampler, cfg.num_agents, dev), cfg.eps,
            cfg.num_agents,
            terms=terms_for_v(v) if terms_for_v is not None else None,
            gain_backend=cfg.gain_backend, step_backend=cfg.step_backend,
            device=dev)
        v = tr.weights[-1]
        traces.append(tr)
    return v, InnerTrace(*(None if xs[0] is None else torch.stack(xs)
                           for xs in zip(*traces)))
