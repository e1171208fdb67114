"""Agent-count scaling on the port (``benchmarks/agents_scaling.py`` on
``repro_torch``): for m in {2, 4, 8, 16, 32} agents at a fixed lambda on
the grid MDP, the final J, the per-agent communication rate (eq. 7) and
the fleet's total transmissions, on the summary trace.  One ``run_sweep``
per fleet size (the agent count sets the shapes).  ``fidelity`` holds
each fleet size's numbers against JAX 0.9.0's (``JAX_0_9_0``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

EPS = 0.5
N = 150
SEEDS = 3
LAM = 5e-3
FLEETS = (2, 4, 8, 16, 32)


def _scale(smoke: bool) -> tuple:
    return (30, 2, (2, 4)) if smoke else (N, SEEDS, FLEETS)


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import GridWorld
    from repro_torch.experiments import SweepSpec, run_sweep

    dev = resolve_device(device)
    label = common.device_label(dev.type)
    n_iter, seeds, fleets = _scale(smoke)
    gw = GridWorld()
    w0 = np.zeros(gw.num_states, np.float32)
    prob = gw.vfa_problem(w0)
    rho = prob.min_rho(EPS) * 1.0001
    fn = gw.sampler_fn(10)
    rows = []
    for agents in fleets:
        spec = SweepSpec(modes=("practical",), lambdas=(LAM,),
                         seeds=tuple(range(seeds)), rhos=(rho,), eps=EPS,
                         num_iterations=n_iter, num_agents=agents,
                         trace="summary")
        sampler = ParamSampler(fn=fn, params=gw.agent_params(w0, agents))
        t0 = time.perf_counter()
        res = run_sweep(spec, sampler, w0, problem=prob, device=dev)
        common.sync(dev)
        wall = time.perf_counter() - t0
        rows.append(dict(
            bench="agents_scaling", agents=agents, lam=LAM,
            comm_rate=float(np.mean(res.comm_rate.cpu().numpy())),
            total_transmissions=float(
                res.trace.tx_counts.cpu().numpy().sum(axis=-1).mean()),
            J_final=float(np.mean(res.j_final.cpu().numpy())),
            us_per_call=wall * 1e6 / seeds,
            run_agent_steps_per_s=seeds * agents * n_iter / wall,
            device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("agents_scaling", rows)


# agents_scaling.run(smoke=...) under JAX 0.9.0 on the CPU
# (JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py
# --only agents_scaling [--smoke]): agents -> (comm_rate,
# total_transmissions, J_final), seeds averaged
JAX_0_9_0 = {
    'full': {
        2: (0.5877777934074402, 176.3333282470703, 0.00019820530724246055),
        4: (0.3844444751739502, 230.6666717529297, 0.00013375282287597656),
        8: (0.2477777749300003, 297.3333435058594, 0.00011446078860899433),
        16: (0.12555555999279022, 301.3333435058594, 0.00010176499927183613),
        32: (0.0642361119389534, 308.3333435058594, 9.47713851928711e-05),
    },
    'smoke': {
        2: (1.0, 60.0, 0.0866314172744751),
        4: (1.0, 120.0, 0.08514803647994995),
    },
}

# Decisions agree, so rates and transmissions agree to float32 rounding
# of their means; J as in fig2 (1e-6 absolute: float32 terms of size ~1)
FIELDS = ("comm_rate", "total_transmissions", "J_final")
TOL = dict(comm_rate=(1e-6, 0.0), total_transmissions=(1e-4, 0.0),
           J_final=(1e-6, 1e-4))


def headlines(rows: list[dict]) -> dict:
    """agents -> (comm_rate, total_transmissions, J_final)."""
    return {r["agents"]: (r["comm_rate"], r["total_transmissions"],
                          r["J_final"]) for r in rows}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Each fleet size's numbers against JAX 0.9.0's at this scale; a
    decision tie goes to ``ties``."""
    want = want or JAX_0_9_0["smoke" if smoke else "full"]
    n_iter, seeds, _ = _scale(smoke)
    return common.compare("agents_scaling", headlines(rows), want, FIELDS,
                          TOL, decisions=lambda m: seeds * n_iter * m,
                          ties=ties)
