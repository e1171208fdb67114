"""Gated gradient aggregation for federated training, ported from
``repro/core/fed_sgd.py`` (DESIGN.md §4).

Each of the paper's edge agents computes a gradient from its local batch,
estimates the performance gain of contributing it (eq. 13 with the exact
Hessian-vector product, the deep-net generalization of eq. 15), and the
aggregate applied by every agent is the masked mean over transmitters
(eq. 6):

    agg = sum_i(alpha_i * g_i) / max(sum_i(alpha_i), 1).

The reference runs one agent per member of a mesh's federation axis and
sums with ``psum``.  On one card the agents are simulated: they are taken
one after another in a fixed order, and ``GatedSum`` accumulates
``alpha_i * g_i`` into one float32 buffer, so the A full gradients are
never held at once.  Trees are dicts of tensors keyed by the model's
``state_dict`` names; ``FedConfig.axis`` is kept for the reference's
signature and names nothing here.

Gain estimators for non-quadratic losses:
  * ``hvp``   — exact curvature term g^T (hess L) g, eq. 13 as the exact
                second-order Taylor gain.  The reference takes one jvp of
                the gradient function (forward-over-reverse); the port
                takes the vector-Jacobian product of the gradient graph
                with g (reverse-over-reverse, ``create_graph=True``), which
                is exact too.
  * ``gnorm`` — Remark 4 strawman, -eps ||g||^2 (ablation baseline).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple, Optional

import torch

from repro_torch.core.trigger import TriggerConfig

Tree = dict[str, torch.Tensor]
GradFn = Callable[[Tree], Tree]


def tree_vdot(a: Tree, b: Tree) -> torch.Tensor:
    """float32 sum over leaves (in ``a``'s order) of the leaves' dots."""
    total = None
    for k, x in a.items():
        d = torch.dot(x.reshape(-1).float(), b[k].reshape(-1).float())
        total = d if total is None else total + d
    return total


def tree_bytes(tree: Tree) -> int:
    """Wire size of one gradient transmission (the paper's unit comm cost)."""
    return int(sum(x.numel() * x.element_size() for x in tree.values()))


class FedStats(NamedTuple):
    """Running communication accounting over the agents (eq. 7).

    ``steps`` / ``tx`` are the federation's (tx accumulates the agents'
    mean alpha); ``last_alpha`` / ``last_gain`` hold each agent's latest
    decision and gain estimate, (A,) as the reference's global arrays.
    """

    steps: torch.Tensor        # scalar int32
    tx: torch.Tensor           # scalar f32: sum over steps of mean_i alpha_i
    last_alpha: torch.Tensor   # (num_agents,) latest decisions
    last_gain: torch.Tensor    # (num_agents,) latest gain estimates

    @staticmethod
    def init(num_agents: int = 1, device=None) -> "FedStats":
        return FedStats(
            steps=torch.zeros((), dtype=torch.int32, device=device),
            tx=torch.zeros((), dtype=torch.float32, device=device),
            last_alpha=torch.ones((num_agents,), dtype=torch.float32,
                                  device=device),
            last_gain=torch.zeros((num_agents,), dtype=torch.float32,
                                  device=device))

    def comm_rate(self) -> torch.Tensor:
        return self.tx / torch.clamp(self.steps.float(), min=1.0)


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Gated-aggregation configuration for one training run."""

    axis: str = "data"             # the reference's federation axis name
    eps: float = 1.0               # stepsize used inside the gain (eq. 13)
    lam: float = 0.0               # communication price lambda; 0 => always transmit
    rho: float = 0.999             # threshold decay (Assumption 3 analogue)
    horizon: int = 1000            # N for the decaying schedule
    estimator: str = "hvp"         # 'hvp' | 'gnorm'
    include_horizon_norm: bool = True
    # perf knobs of the reference:
    hvp_subsample: int = 1         # curvature g^T H g estimated on batch[:B/k]
    agg_dtype: str = "float32"     # 'bfloat16' rounds g to bf16 before the sum

    def threshold(self, step) -> torch.Tensor:
        """lambda_k = lam / (N rho^(N-1-k)) in float32; steps past N keep
        the final value.  ``rho**e`` is correctly rounded
        (``TriggerConfig.threshold``), within 1 ulp of XLA's ``pow``.  A
        step tensor reads the schedule on its device with no host sync."""
        trig = TriggerConfig(self.lam, self.rho, self.horizon,
                             self.include_horizon_norm)
        if torch.is_tensor(step):
            table = trig.schedule().to(step.device)
            return table[torch.clamp(step.long(), max=self.horizon - 1)]
        return trig.threshold(min(int(step), self.horizon - 1))


def make_grad_fn(loss: Callable[[Tree], torch.Tensor]) -> GradFn:
    """``jax.grad`` of ``loss(params)``, kept differentiable
    (``create_graph=True``) so ``curvature_dot`` can differentiate it
    again.  ``params`` are leaf tensors that require grad."""
    def grad_fn(params: Tree) -> Tree:
        keys = list(params)
        grads = torch.autograd.grad(loss(params), [params[k] for k in keys],
                                    create_graph=True)
        return dict(zip(keys, grads))

    return grad_fn


def curvature_dot(grad_fn: GradFn, params: Tree, g: Tree) -> torch.Tensor:
    """g^T H g as the vjp of the gradient graph with g (reverse over
    reverse).  A gradient leaf that does not depend on the parameters has
    a zero Hessian row, and by symmetry a zero column: it is skipped."""
    graph = grad_fn(params)
    keys = [k for k in g if graph[k].requires_grad]
    hg = torch.autograd.grad([graph[k] for k in keys],
                             [params[k] for k in params],
                             grad_outputs=[g[k].to(graph[k].dtype)
                                           for k in keys],
                             allow_unused=True)
    hg = {k: (torch.zeros_like(params[k]) if h is None else h)
          for k, h in zip(params, hg)}
    return tree_vdot(g, hg)


def local_gain(g: Tree, cfg: FedConfig, grad_fn: Optional[GradFn] = None,
               params: Optional[Tree] = None) -> torch.Tensor:
    """Second-order Taylor gain of applying -eps*g (deep-net eq. 13/15)."""
    gnorm2 = tree_vdot(g, g)
    if cfg.estimator == "gnorm":
        return -cfg.eps * gnorm2
    if cfg.estimator == "hvp":
        if grad_fn is None or params is None:
            raise ValueError("hvp estimator needs grad_fn and params")
        ghg = curvature_dot(grad_fn, params, g)
        return -cfg.eps * gnorm2 + 0.5 * cfg.eps**2 * ghg
    raise ValueError(f"unknown estimator {cfg.estimator!r}")


class GatedSum:
    """The eq. 6 masked mean, accumulated one agent at a time.

    ``add(g, alpha)`` adds ``alpha * g`` (float32, ``g`` first rounded to
    bf16 when ``agg_dtype="bfloat16"``) into one buffer per leaf, in the
    order the agents are added; ``mean()`` divides by max(sum alpha, 1).
    The buffers are made on the first ``add`` and updated in place, so a
    captured CUDA graph can add into them; ``reset()`` zeroes them.
    """

    def __init__(self, agg_dtype: str = "float32"):
        if agg_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown agg_dtype {agg_dtype!r}")
        self.bf16 = agg_dtype == "bfloat16"
        self.acc: Optional[Tree] = None
        self.num_tx: Optional[torch.Tensor] = None

    def add(self, g: Tree, alpha: torch.Tensor) -> None:
        if self.bf16:
            g = {k: x.to(torch.bfloat16) for k, x in g.items()}
        if self.acc is None:
            self.acc = {k: torch.zeros(x.shape, dtype=torch.float32,
                                       device=x.device) for k, x in g.items()}
            self.num_tx = torch.zeros((), dtype=torch.float32,
                                      device=alpha.device)
        for k, x in g.items():
            self.acc[k].add_(alpha * x.float())
        self.num_tx.add_(alpha)

    def reset(self) -> None:
        if self.acc is not None:
            for x in self.acc.values():
                x.zero_()
            self.num_tx.zero_()

    def mean(self) -> tuple[Tree, torch.Tensor]:
        denom = torch.clamp(self.num_tx, min=1.0)
        return {k: x / denom for k, x in self.acc.items()}, self.num_tx.clone()


def gated_psum_mean(gs: Iterable[Tree], alphas: torch.Tensor,
                    agg_dtype: str = "float32") -> tuple[Tree, torch.Tensor]:
    """Masked cross-agent mean (eq. 6) of the agents' trees ``gs`` under
    decisions ``alphas`` (A,).  Returns (aggregate, num_transmitters): a
    zero aggregate if nobody transmits, the server keeping w unchanged
    (the paper's 4th case)."""
    acc = GatedSum(agg_dtype)
    for i, g in enumerate(gs):
        acc.add(g, alphas[i])
    return acc.mean()


def gate(g: Tree, cfg: FedConfig, threshold: torch.Tensor,
         grad_fn: Optional[GradFn] = None,
         params: Optional[Tree] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One agent's gain and eq. 9 decision: (gain, alpha = gain <= -thr)."""
    gain = local_gain(g, cfg, grad_fn=grad_fn, params=params).detach()
    return gain, (gain <= -threshold).float()


def gate_and_aggregate(agents: Iterable[tuple[Tree, Optional[GradFn]]],
                       stats: FedStats, cfg: FedConfig,
                       params: Optional[Tree] = None) -> tuple[Tree, FedStats]:
    """Full per-step gated aggregation: gain -> trigger -> masked sum.

    ``agents`` yields each agent's ``(g, grad_fn)`` in agent order (the
    reference's per-device program, one agent after another); an agent's
    tree is released once it is added.  With lam == 0 this reduces to a
    plain mean (threshold 0 and every gain <= 0 fires).
    """
    thr = cfg.threshold(stats.steps)
    acc = GatedSum(cfg.agg_dtype)
    gains, alphas = [], []
    for g, grad_fn in agents:
        gain, alpha = gate(g, cfg, thr, grad_fn=grad_fn, params=params)
        acc.add(g, alpha)
        gains.append(gain)
        alphas.append(alpha)
        del g, grad_fn     # the next agent's graph is built without this one
    agg, _ = acc.mean()
    return agg, advance(stats, torch.stack(alphas), torch.stack(gains))


def advance(stats: FedStats, alpha: torch.Tensor,
            gain: torch.Tensor) -> FedStats:
    """The step's accounting: one more step, tx += mean alpha."""
    return FedStats(steps=stats.steps + 1, tx=stats.tx + alpha.mean(),
                    last_alpha=alpha, last_gain=gain)
