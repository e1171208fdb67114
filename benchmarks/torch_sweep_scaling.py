"""Env-family sweep scale on the port (``benchmarks/sweep_scaling.py``'s
``env_family`` suite on ``repro_torch``).

64 random garnet MDPs of 20 states ride the sweep engine's ``env_sets``
grid axis: one ``run_sweep`` call sweeps the whole family (per-instance
exact terms included) under the theoretical and practical triggers at
lambda 1e-3, rho 0.999, eps 0.4, 2 seeds, N 150 and 4 agents (smoke: 8
instances, 1 seed, N 20, 2 agents).  The row times the first call (the
kernels' first launches, the plan) apart from a second, steady-state
call, and carries the family's J and comm-rate summaries.  Its
``jitted_calls`` keeps the reference's field: the calls (one) that sweep
the whole family; the port compiles nothing.

It runs in this process on one card, so ``devices`` is 1.  The
reference's other suite, ``device_frontier``, sweeps one grid on 1, 2, 4
and 8 XLA host devices, each count in a subprocess that fixes
``--xla_force_host_platform_device_count`` before JAX starts, with the run
axis sharded over the devices; the port runs on one card and has no
device mesh to widen, so that suite has no counterpart here.

``fidelity`` holds ``J_final_mean``, ``J_final_spread`` and
``comm_rate_mean`` to JAX 0.9.0's at both scales (``JAX_0_9_0``, recorded
by ``tools/jax_study_refs.py``).

Imports numpy, the stdlib and ``repro_torch`` only.
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

STATES = 20
SAMPLES = 10
EPS = 0.4
RHO = 0.999
LAM = 1e-3


def _scale(smoke: bool) -> dict:
    if smoke:
        return dict(env_instances=8, seeds=1, iters=20, agents=2)
    return dict(env_instances=64, seeds=2, iters=150, agents=4)


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import family_sampler_fn, garnet_env_family
    from repro_torch.experiments import SweepSpec, run_sweep

    dev = resolve_device(device)
    cfg = _scale(smoke)
    envs, fam = garnet_env_family(cfg["env_instances"], num_states=STATES,
                                  device=dev)
    w0 = np.zeros(STATES, np.float32)
    spec = SweepSpec(
        modes=("theoretical", "practical"), lambdas=(LAM,),
        seeds=tuple(range(cfg["seeds"])), rhos=(RHO,), eps=EPS,
        num_iterations=cfg["iters"], num_agents=cfg["agents"],
        trace="summary")
    sampler = ParamSampler(fn=family_sampler_fn(SAMPLES),
                           params=envs[0].agent_params(w0, cfg["agents"]))
    runs = cfg["env_instances"] * int(np.prod(spec.grid_shape))

    def sweep():
        return run_sweep(spec, sampler, w0, env_sets=fam, device=dev)

    t0 = time.perf_counter()
    sweep()                                   # first launches + first run
    common.sync(dev)
    t1 = time.perf_counter()
    res = sweep()                             # steady state
    common.sync(dev)
    t2 = time.perf_counter()
    jf = res.j_final.double().cpu().numpy()
    env_ax = res.axes.index("env_set")
    non_env = tuple(i for i in range(jf.ndim) if i != env_ax)
    return [dict(
        bench="sweep_scaling", suite="env_family", devices=1,
        grid_runs=runs, first_call_s=t1 - t0, exec_s=t2 - t1,
        runs_per_s=runs / (t2 - t1), us_per_call=(t2 - t1) * 1e6 / runs,
        env_instances=cfg["env_instances"], iters=cfg["iters"],
        agents=cfg["agents"], jitted_calls=1, axes=list(res.axes),
        J_final_mean=float(jf.mean()),
        J_final_spread=float(np.std(jf.mean(axis=non_env))),
        comm_rate_mean=float(res.comm_rate.double().mean()),
        device=common.device_label(dev.type))]


def gate(rows: list[dict]) -> list[str]:
    return common.gate("sweep_scaling", rows)


# sweep_scaling's env_family sweep under JAX 0.9.0 on the CPU, without
# the device mesh (JAX 0.9.0 refuses the suite's shard_map; the mesh only
# places runs on devices), the means taken in float64 as here
# (JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py
# --only env_family [--smoke]): (J_final_mean, J_final_spread,
# comm_rate_mean).  The committed experiments/bench/sweep_scaling.json
# predates JAX 0.9.0's streams (J_final_mean 3.119e-05 there)
JAX_0_9_0 = {
    "full": (3.0889175832271576e-05, 2.182234269362139e-06,
             0.7130534027237445),
    "smoke": (0.06469829380512238, 0.008209464094431141, 1.0),
}

FIELDS = ("J_final_mean", "J_final_spread", "comm_rate_mean")
# the tabular studies' tolerances (torch_heterogeneity): a comm rate off
# by one or two whole decisions is a tie; J within 1e-6 + 1e-4 relative
TOL = dict(J_final_mean=(1e-6, 1e-4), J_final_spread=(1e-6, 1e-4),
           comm_rate_mean=(1e-6, 0.0))


def headlines(rows: list[dict]) -> dict:
    return {"env_family": tuple(r[f] for f in FIELDS) for r in rows
            if r.get("suite") == "env_family"}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """The family's mean J, its spread across instances and its mean comm
    rate against JAX 0.9.0's at this scale."""
    want = want or {"env_family": JAX_0_9_0["smoke" if smoke else "full"]}
    cfg = _scale(smoke)
    decisions = (cfg["env_instances"] * 2 * cfg["seeds"] * cfg["iters"]
                 * cfg["agents"])
    return common.compare("sweep_scaling env_family", headlines(rows), want,
                          FIELDS, TOL, decisions=decisions, ties=ties)
