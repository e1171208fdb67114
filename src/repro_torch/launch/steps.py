"""Step builders, ported from ``repro/launch/steps.py``: the federated
train step, the prefill step and the decode (serve) step.

One device, no mesh and no sharding.  The train step simulates the
reference's federation axis on the card: agent i takes rows
[i B/A, (i+1) B/A) of the global batch (how ``shard_map`` splits the batch
dimension), computes its gradient, clips it, estimates its gain and takes
its eq. 9 decision; the masked mean over transmitters (eq. 6) is
accumulated one agent at a time (``core/fed_sgd.py``).  The serving steps
run the model under ``torch.inference_mode``.  ``launch/mesh.py``,
``hlo_analysis.py`` and ``dryrun.py`` inspect XLA on a TPU mesh and have
no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fed_sgd import (FedConfig, GatedSum, advance, gate,
                                      make_grad_fn)
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          clip_by_global_norm)


@dataclasses.dataclass(frozen=True)
class TrainStepBundle:
    step: Callable            # (params, opt_state, fed_state, batch) -> ...
    num_agents: int


GRAPH_WARMUP = 2     # eager runs on a side stream before a capture


def trainable_params(model) -> dict:
    """The model's parameters by ``state_dict`` name: the ``params`` a
    train step takes (``build_train_step`` makes them require grad)."""
    return dict(model.named_parameters())


class _AgentGraph:
    """One agent's work captured as a CUDA graph (the same kernels, replayed
    without the host: an eager ``hvp`` agent at full width is ~40k
    launches).  Replays read the agent's rows from ``static`` and the
    parameters, the threshold and the sum's buffers by address; ``reset``
    undoes what the warm-up runs added to the sum."""

    def __init__(self, fn: Callable, local: dict, reset: Callable):
        self.static = {k: v.clone() for k, v in local.items()}
        side = torch.cuda.Stream(device=local["tokens"].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                fn(self.static)
        torch.cuda.current_stream().wait_stream(side)
        reset()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(self.static)

    def __call__(self, local: dict):
        for k, v in local.items():
            self.static[k].copy_(v)
        self.graph.replay()
        return tuple(o.clone() for o in self.out)


def build_train_step(model, cfg: ModelConfig, optimizer: Optimizer,
                     fed_cfg: FedConfig | None = None, grad_clip: float = 1.0,
                     num_agents: int = 1, device=None) -> TrainStepBundle:
    """The federated train step for ``num_agents`` agents on ``device``
    (default cuda).

    ``step(params, opt_state, fed_state, batch) -> (params, opt_state,
    fed_state, metrics)``.  ``params`` are the model's own parameters
    (``trainable_params``); they are updated in place, the one-card form
    of the reference's buffer donation, and returned.  Each agent, in
    agent order: ``value_and_grad`` of its own loss on the plain path
    (the kernels are forward-only, and the reference trains through its
    jnp code too); ``clip_by_global_norm(grad_clip)``; with ``fed_cfg``
    and lam > 0, its gain on the clipped g (``hvp``: the curvature of its
    own batch's loss, or of ``batch[: max(B_local // k, 1)]`` under
    ``hvp_subsample`` k) and its decision; its alpha * g is added to the
    masked sum (without gating, alpha = 1: the plain mean, in the
    parameters' dtype, with ``tx += 1``).  Then the optimizer update, and
    metrics: the agents' mean loss, mean pre-clip gradient norm and
    ``comm_rate``.  On a CUDA device each agent's work runs as a CUDA
    graph, captured at the first step of each batch shape, which launches
    the same kernels as the eager code (the CPU runs it eagerly).  The
    reference's mesh, partition specs and donation have no one-card
    meaning, so the bundle carries only ``step`` and ``num_agents``.
    """
    dev = resolve_device(device)
    model.to(dev)
    model.requires_grad_(True)
    own = trainable_params(model)
    keys = list(own)
    gated = fed_cfg is not None and fed_cfg.lam > 0
    hvp = gated and fed_cfg.estimator == "hvp"
    sub_k = fed_cfg.hvp_subsample if hvp else 1
    acc = GatedSum(fed_cfg.agg_dtype if gated else "float32")
    thr = torch.zeros((), dtype=torch.float32, device=dev)
    graphs: dict = {}

    def agent(local):
        """One agent: (loss, pre-clip norm, gain, alpha); adds alpha * g."""
        loss = model.loss_fn(local)[0]
        graph = hvp and sub_k == 1
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [own[k] for k in keys], create_graph=graph)))
        with torch.no_grad():
            g, norm = clip_by_global_norm(grads, grad_clip)
        if gated:
            grad_fn = None
            if graph:        # the graph of this agent's gradient at params
                grad_fn = lambda p: grads  # noqa: E731
            elif hvp:
                sub = {k: v[:max(v.shape[0] // sub_k, 1)]
                       for k, v in local.items()}
                grad_fn = make_grad_fn(lambda p: model.loss_fn(sub)[0])
            gain, alpha = gate(g, fed_cfg, thr, grad_fn=grad_fn, params=own)
        else:
            gain = torch.zeros((), dtype=torch.float32, device=dev)
            alpha = torch.ones((), dtype=torch.float32, device=dev)
        acc.add(g, alpha)
        return loss.detach(), norm, gain, alpha

    def run_agent(local):
        if dev.type != "cuda":
            return agent(local)
        shape = tuple((k, tuple(v.shape), v.dtype) for k, v in local.items())
        if shape not in graphs:
            graphs[shape] = _AgentGraph(agent, local, acc.reset)
        return graphs[shape](local)

    def step(params, opt_state, fed_state, batch):
        if params.keys() != own.keys() or any(
                params[k] is not p for k, p in own.items()):
            raise ValueError("params must be the model's own parameters "
                             "(trainable_params(model))")
        B = batch["tokens"].shape[0]
        if B % num_agents:
            raise ValueError(f"global batch {B} does not split over "
                             f"{num_agents} agents")
        b = B // num_agents
        batch = {k: v.to(dev) for k, v in batch.items()}
        if gated:
            thr.copy_(fed_cfg.threshold(fed_state.steps))
        acc.reset()
        outs = [run_agent({k: v[i * b:(i + 1) * b] for k, v in batch.items()})
                for i in range(num_agents)]
        losses, norms, gains, alphas = (torch.stack(x) for x in zip(*outs))
        with torch.no_grad():
            agg, _ = acc.mean()
            if not gated:
                agg = {k: x.to(params[k].dtype) for k, x in agg.items()}
            updates, opt_state = optimizer.update(agg, opt_state, params)
            new = apply_updates(params, updates)
            for k, p in params.items():
                p.copy_(new[k])
        fed_state = advance(fed_state, alphas, gains)
        metrics = {"loss": losses.mean(), "grad_norm": norms.mean(),
                   "comm_rate": fed_state.comm_rate()}
        return params, opt_state, fed_state, metrics

    return TrainStepBundle(step=step, num_agents=num_agents)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def build_prefill_step(model, cfg: ModelConfig, device=None):
    """``prefill(tokens, prefix_emb=None) -> (last-position logits f32, aux)``
    for a (B, L) token batch (behind the (B, P, frontend_dim) prefix
    embeddings of a vision / audio config), on ``device`` (default cuda)."""
    dev = resolve_device(device)
    model.to(dev)

    def prefill(tokens: torch.Tensor, prefix_emb=None):
        if prefix_emb is not None:
            prefix_emb = prefix_emb.to(dev)
        with torch.inference_mode():
            return model.prefill(tokens.to(dev), prefix_emb)

    return prefill


def build_serve_step(model, cfg: ModelConfig, shape: ShapeConfig, device=None):
    """One-token decode step against a ``shape.seq_len``-deep cache.

    Returns ``(step, init_cache)``: ``step(cache, token (B,), t) -> (logits
    (B, V) f32, cache)`` updates the cache in place; ``init_cache()`` makes
    an empty cache for ``shape.global_batch`` rows on the device.
    """
    dev = resolve_device(device)
    model.to(dev)

    def step(cache, token: torch.Tensor, t: int):
        with torch.inference_mode():
            return model.decode_step(cache, token.to(dev), int(t))

    def init_cache():
        with torch.inference_mode():
            return model.init_cache(shape.global_batch, shape.seq_len)

    return step, init_cache
