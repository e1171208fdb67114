"""Minimal functional optimizers, ported from ``repro/optim/optimizers.py``.

An ``Optimizer`` is a pair of pure functions over dicts of tensors keyed by
the model's ``state_dict`` names:
  init(params) -> state
  update(grads, state, params) -> (updates, state)     # updates are ADDED

The reference's dtypes are kept: moments are float32 whatever the
parameters' dtype, the clip scale is cast to each gradient's dtype, and
``apply_updates`` adds in float32 and casts back to the parameter's dtype
(bf16 at full width).  The step count is an int32 tensor and a schedule
maps it to a float32 tensor, as ``jnp`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Union

import torch

Tree = dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class SgdState(NamedTuple):
    step: torch.Tensor
    mu: Optional[Tree]


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], NamedTuple]
    update: Callable[[Tree, NamedTuple, Tree], tuple[Tree, NamedTuple]]


def _zeros_like_f32(params: Tree) -> Tree:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _step0(params: Tree) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: Union[float, Schedule], momentum: float = 0.0) -> Optimizer:
    def init(params):
        return SgdState(_step0(params),
                        _zeros_like_f32(params) if momentum else None)

    def update(grads, state, params):
        del params
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        if momentum:
            mu = {k: momentum * state.mu[k] + g.float()
                  for k, g in grads.items()}
            return {k: -lr_t * m for k, m in mu.items()}, SgdState(step, mu)
        return ({k: -lr_t * g.float() for k, g in grads.items()},
                SgdState(step, None))

    return Optimizer(init, update)


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return AdamWState(_step0(params), _zeros_like_f32(params),
                          _zeros_like_f32(params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        stepf = step.float()
        bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
        bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

        def upd_leaf(k):
            u = -lr_t * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * params[k].float()
            return u

        return {k: upd_leaf(k) for k in mu}, AdamWState(step, mu, nu)

    return Optimizer(init, update)


def global_norm(grads: Tree) -> torch.Tensor:
    """sqrt of the float32 sum of every leaf's squares, leaves in order."""
    total = None
    for g in grads.values():
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return {k: (p.float() + updates[k]).to(p.dtype) for k, p in params.items()}
