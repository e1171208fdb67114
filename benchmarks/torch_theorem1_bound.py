"""Theorem 1 on the port: the empirical metric (8) against the bound (12)
over a (lambda, rho) grid with the theoretical trigger
(``benchmarks/theorem1_bound.py`` on ``repro_torch``).

The whole grid, both rho settings included, is one ``run_sweep``.
Tr(Phi G) comes from the gradient covariance of 300 batched
``stochastic_gradient`` draws at w0, keyed ``10_000 + s`` on the port's
threefry, so the draws are JAX's.

With ``store=`` the sweep and the constants (Tr(Phi G), J(w0), J(w*))
persist to the ``SweepStore`` tagged ``figure=theorem1``; a warm re-run
checks the entry's inputs digest, reuses the cached constants and
computes nothing.  ``fidelity`` holds both sides of the bound and
``holds`` against JAX 0.9.0's (``JAX_0_9_0``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

EPS = 0.5
N = 150
T = 10
SEEDS = 6
LAMBDAS = (1e-4, 1e-3, 1e-2, 1e-1)


def _scale(smoke: bool) -> tuple:
    return ((30, 2, (1e-3, 1e-1), 60) if smoke
            else (N, SEEDS, LAMBDAS, 300))


def trace_phi_g(fn, params1: dict, w0, prob, draws: int, dev) -> float:
    """Empirical Tr(Phi G) at w0 (Theorem 1 assumes a constant covariance):
    ``draws`` gradients of one agent, keyed ``10_000 + s``, in one batch."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.core.vfa import stochastic_gradient
    rngs = trandom.keys([10_000 + s for s in range(draws)], dev)[:, None]
    params = {k: v.to(dev).expand((draws, 1) + v.shape)
              for k, v in params1.items()}
    phi, targets = fn(params, rngs)                     # (D, 1, T, S)
    w = torch.as_tensor(w0, dtype=torch.float32, device=dev)
    grads = stochastic_gradient(w, phi, targets)[:, 0]
    G = np.cov(grads.cpu().numpy().T)
    return float(np.trace(prob.second_moment().cpu().numpy() @ G))


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.core.bound import theorem1_bound
    from repro_torch.envs import GridWorld
    from repro_torch.experiments import SweepSpec, SweepStore, run_sweep
    from repro_torch.experiments.runtime import (arrays_to_result,
                                                 inputs_digest, store_result)

    dev = resolve_device(device)
    label = common.device_label(dev.type)
    n_iter, seeds, lambdas, draws = _scale(smoke)
    gw = GridWorld()
    w0 = np.zeros(gw.num_states, np.float32)
    prob = gw.vfa_problem(w0)
    fn = gw.sampler_fn(T)
    params1 = gw.agent_param_row(w0)
    rho_min = prob.min_rho(EPS)
    rhos = (rho_min * 1.0001, min(rho_min * 1.05, 0.999))

    # store-backed runs keep the summary trace (the bound needs comm and J
    # only); the bare study keeps the full trace, as the reference does
    spec = SweepSpec(modes=("theoretical",), lambdas=lambdas,
                     seeds=tuple(range(seeds)), rhos=rhos, eps=EPS,
                     num_iterations=n_iter, num_agents=2, tag="theorem1",
                     trace="summary" if store is not None else "full")
    sampler = ParamSampler(fn=fn, params=gw.agent_params(w0, 2))
    if store is not None and not isinstance(store, SweepStore):
        store = SweepStore(store)

    t0 = time.perf_counter()
    entry = None
    if store is not None and store.has(spec):
        # a warm store keeps sweep_or_load's contract: an entry under this
        # hash computed from other inputs is another experiment
        entry = store.get(spec)
        stored = entry.extra.get("inputs_digest")
        if stored is not None and stored != inputs_digest(sampler, w0,
                                                          problem=prob):
            raise ValueError(
                f"store entry {entry.spec_hash} was computed from "
                "different inputs — give this sweep its own SweepSpec.tag")
    if entry is not None:
        res = arrays_to_result(entry, dev)
    else:
        res = run_sweep(spec, sampler, w0, problem=prob, device=dev)
    if entry is not None and "trace_phi_g" in entry.extra:
        tr_phi_g = float(entry.extra["trace_phi_g"])
    else:
        tr_phi_g = trace_phi_g(fn, params1, w0, prob, draws, dev)
    common.sync(dev)
    us = (time.perf_counter() - t0) * 1e6 / int(np.prod(res.comm_rate.shape))

    if entry is not None and "j_w0" in entry.extra:
        j0, jstar = float(entry.extra["j_w0"]), float(entry.extra["j_wstar"])
    else:
        j0 = float(prob.objective(prob.phi_matrix.new_tensor(w0)))
        jstar = float(prob.objective(prob.optimum()))
    if store is not None and entry is None:
        store_result(store, spec, res,
                     inputs_digest_=inputs_digest(sampler, w0, problem=prob),
                     extra={"figure": "theorem1", "trace_phi_g": tr_phi_g,
                            "j_w0": j0, "j_wstar": jstar})
    comm = res.comm_rate.cpu().numpy()
    jf = res.j_final.cpu().numpy()
    rows = []
    for li, lam in enumerate(lambdas):
        for ri, rho in enumerate(rhos):
            # metric (8) per seed, then the mean over seeds
            lhs = float(np.mean(lam * comm[0, li, ri] + jf[0, li, ri]))
            rhs = theorem1_bound(lam, rho, EPS, n_iter, j0, jstar, tr_phi_g)
            rows.append(dict(bench="theorem1", lam=lam, rho=round(rho, 5),
                             lhs_empirical=lhs, rhs_bound=rhs,
                             holds=bool(lhs <= rhs), slack=rhs - lhs,
                             us_per_call=us, device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("theorem1", rows)


# theorem1_bound.run(smoke=...) under JAX 0.9.0 on the CPU
# (JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py
# --only theorem1 [--smoke]): (lam, rho) -> (lhs_empirical, rhs_bound,
# holds)
JAX_0_9_0 = {
    'full': {
        (0.0001, 0.92169): (8.627742499811575e-05, 0.047038210050529085, True),
        (0.0001, 0.96768): (0.00010106206900672987, 0.11994280881289936, True),
        (0.001, 0.92169): (0.0007185949943959713, 0.04793821005052908, True),
        (0.001, 0.96768): (0.0007640044786967337, 0.12084280881289935, True),
        (0.01, 0.92169): (0.0055673252791166306, 0.056938210050529084, True),
        (0.01, 0.96768): (0.005189267452806234, 0.12984280881289936, True),
        (0.1, 0.92169): (0.041329771280288696, 0.1469382100505291, True),
        (0.1, 0.96768): (0.029907142743468285, 0.21984280881289936, True),
    },
    'smoke': {
        (0.001, 0.92169): (0.08763135969638824, 0.12763248274989858, True),
        (0.001, 0.96768): (0.08763135969638824, 0.431581913736808, True),
        (0.1, 0.92169): (0.18663135170936584, 0.2266324827498986, True),
        (0.1, 0.96768): (0.18663135170936584, 0.530581913736808, True),
    },
}

# Metric (8) carries J, evaluated from the problem's terms as a difference
# of terms of size c0 ~ 1 in float32 (fig2's note): 1e-6 absolute plus
# 1e-4 relative.  The bound's side moves only with Tr(Phi G), from the
# same 300 draws, and J(w0), J(w*)
FIELDS = ("lhs_empirical", "rhs_bound", "holds")
TOL = dict(lhs_empirical=(1e-6, 1e-4), rhs_bound=(0.0, 1e-5), holds="equal")


def headlines(rows: list[dict]) -> dict:
    """(lam, rho) -> (lhs_empirical, rhs_bound, holds)."""
    return {(r["lam"], r["rho"]): (r["lhs_empirical"], r["rhs_bound"],
                                   r["holds"]) for r in rows}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Both sides of the bound and ``holds`` against JAX 0.9.0's (no tie
    accounting: ``ties`` stays as it is)."""
    want = want or JAX_0_9_0["smoke" if smoke else "full"]
    return common.compare("theorem1", headlines(rows), want, FIELDS, TOL)
