"""Paper Fig. 2 (right) on the port: the communication-learning tradeoff
on the grid MDP (``benchmarks/fig2_grid_tradeoff.py`` on ``repro_torch``).

Sweeps lambda for the theoretical trigger (eq. 9), the practical estimate
(eq. 15) and the rate-matched random baseline, in both regimes:
homogeneous (every agent draws i.i.d. from d) and heterogeneous (one
informative agent and one junk agent stuck at s = 0 with 5x target
noise).  The whole grid is two ``run_sweep`` calls, the gated triggers
and then the random baseline matched to the theoretical trigger's
measured rates (``matched_random_probs``); one representative slice runs
run by run through ``run_gated_sgd`` to time the engine against it.

With ``store=`` both sweeps go through ``sweep_or_load`` on the summary
trace, tagged ``figure=fig2``, so the torch-free report pipeline
regenerates the figure from the store and a warm re-run computes nothing.

The rows are the reference's plus ``device``; ``fidelity`` holds each
cell's comm rate and J against JAX 0.9.0's (``JAX_0_9_0``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from benchmarks import torch_common as common

EPS = 0.5
N = 250
SEEDS = 4
LAMBDAS = (1e-4, 1e-3, 1e-2, 1e-1, 0.3)
T = 10
REGIMES = ("homogeneous", "heterogeneous")


def _scale(smoke: bool) -> tuple:
    return (25, 2, (1e-3, 1e-1)) if smoke else (N, SEEDS, LAMBDAS)


def _fleets(gw, w0) -> dict:
    """Stacked agent-param sets: regime axis x 2 agents."""
    import torch
    from repro_torch.envs import stack_agent_params
    good = gw.agent_param_row(w0)
    junk = gw.agent_param_row(
        w0, visit_logits=30.0 * torch.nn.functional.one_hot(
            torch.tensor(0), gw.num_states).to(torch.float32),   # stuck at s=0
        noise_scale=5.0)                                        # junk targets
    homog = stack_agent_params(good, good)
    hetero = stack_agent_params(good, junk)
    return {k: torch.stack([homog[k], hetero[k]]) for k in homog}


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import random as trandom
    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import (GatedSGDConfig, ParamSampler,
                                             run_gated_sgd)
    from repro_torch.core.trigger import TriggerConfig
    from repro_torch.envs import GridWorld
    from repro_torch.experiments import (SweepSpec, matched_random_probs,
                                         run_sweep, sweep_or_load,
                                         tradeoff_rows)

    dev = resolve_device(device)
    label = common.device_label(dev.type)
    n_iter, seeds, lambdas = _scale(smoke)
    gw = GridWorld()
    w0 = np.zeros(gw.num_states, np.float32)
    prob = gw.vfa_problem(w0)
    rho = prob.min_rho(EPS) * 1.0001
    sampler = ParamSampler(fn=gw.sampler_fn(T), params=None)
    regimes = _fleets(gw, w0)
    extra = {"figure": "fig2", "regimes": list(REGIMES)}

    def sweep(spec):
        if store is None:
            res = run_sweep(spec, sampler, w0, problem=prob,
                            param_sets=regimes, device=dev)
        else:
            res = sweep_or_load(store, spec, sampler, w0, problem=prob,
                                param_sets=regimes, extra=extra, device=dev)
        common.sync(dev)
        return res

    # -- call 1: both gated triggers, both regimes.  Store-backed runs keep
    # the summary trace (the figure needs comm and J only); the bare study
    # keeps the full trace, as the reference does
    spec = SweepSpec(modes=("theoretical", "practical"), lambdas=lambdas,
                     seeds=tuple(range(seeds)), rhos=(rho,), eps=EPS,
                     num_iterations=n_iter, num_agents=2, tag="fig2",
                     trace="summary" if store is not None else "full")
    t0 = time.perf_counter()
    res = sweep(spec)
    t1 = time.perf_counter()

    # -- call 2: the random baseline matched to the theoretical rates
    spec_rand = dataclasses.replace(
        spec, modes=("random",), seeds=tuple(range(50, 50 + seeds)),
        random_tx_prob=matched_random_probs(res, spec))
    res_rand = sweep(spec_rand)
    t2 = time.perf_counter()

    runs_gated = int(np.prod(res.comm_rate.shape))
    runs_rand = int(np.prod(res_rand.comm_rate.shape))
    rows = []
    for result, sp, tspan, nruns in ((res, spec, t1 - t0, runs_gated),
                                     (res_rand, spec_rand, t2 - t1,
                                      runs_rand)):
        for row in tradeoff_rows(result, sp, bench="fig2"):
            row["regime"] = REGIMES[row.pop("param_set")]
            row.pop("rho", None)
            row["us_per_call"] = tspan * 1e6 / nruns
            row["device"] = label
            rows.append(row)

    # -- the engine against one run at a time: one (mode, lam) slice through
    # run_gated_sgd, the same cell as the reference's (lam 1e-2 on the full
    # grid, clamped for smoke grids)
    fleet = ParamSampler(fn=sampler.fn,
                         params={k: v[0] for k, v in regimes.items()})
    cfg = GatedSGDConfig(
        trigger=TriggerConfig(lam=lambdas[min(2, len(lambdas) - 1)], rho=rho,
                              num_iterations=n_iter),
        eps=EPS, num_agents=2, mode="practical")
    t3 = time.perf_counter()
    for s in range(seeds):
        run_gated_sgd(trandom.key(s, dev), w0, fleet, cfg, problem=prob,
                      device=dev)
    common.sync(dev)
    per_run_us = (time.perf_counter() - t3) * 1e6 / seeds
    engine_us = (t2 - t0) * 1e6 / (runs_gated + runs_rand)
    rows.append(dict(bench="fig2", mode="engine_speedup",
                     us_per_call=engine_us,
                     us_per_run_sequential=per_run_us,
                     speedup=per_run_us / engine_us,
                     grid_runs=runs_gated + runs_rand,
                     wall_s=t2 - t0, device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("fig2", rows)


# fig2_grid_tradeoff.run(smoke=...) under JAX 0.9.0 on the CPU
# (JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py
# --only fig2 [--smoke]): (regime, mode, lam) -> (comm_rate, J_final),
# seeds averaged
JAX_0_9_0 = {
    'full': {
        ('homogeneous', 'theoretical', 0.0001):
            (0.4820000231266022, 6.809830665588379e-06),
        ('homogeneous', 'theoretical', 0.001):
            (0.390500009059906, 6.315112113952637e-05),
        ('homogeneous', 'theoretical', 0.01):
            (0.29250001907348633, 0.0006800144910812378),
        ('homogeneous', 'theoretical', 0.1):
            (0.1965000033378601, 0.0064977556467056274),
        ('homogeneous', 'theoretical', 0.3):
            (0.15650001168251038, 0.017778068780899048),
        ('homogeneous', 'practical', 0.0001):
            (0.5135000348091125, 2.3245811462402344e-06),
        ('homogeneous', 'practical', 0.001):
            (0.4230000376701355, 2.1144747734069824e-05),
        ('homogeneous', 'practical', 0.01):
            (0.3255000114440918, 0.0002180039882659912),
        ('homogeneous', 'practical', 0.1):
            (0.23649999499320984, 0.002078443765640259),
        ('homogeneous', 'practical', 0.3):
            (0.19600000977516174, 0.005950123071670532),
        ('heterogeneous', 'theoretical', 0.0001):
            (0.2784999907016754, 1.3500452041625977e-05),
        ('heterogeneous', 'theoretical', 0.001):
            (0.22600001096725464, 0.00011345744132995605),
        ('heterogeneous', 'theoretical', 0.01):
            (0.1705000102519989, 0.0009923875331878662),
        ('heterogeneous', 'theoretical', 0.1):
            (0.11900000274181366, 0.00833466649055481),
        ('heterogeneous', 'theoretical', 0.3):
            (0.09200000762939453, 0.024586528539657593),
        ('heterogeneous', 'practical', 0.0001):
            (0.6920000314712524, 0.02975185215473175),
        ('heterogeneous', 'practical', 0.001):
            (0.5850000381469727, 0.03233742713928223),
        ('heterogeneous', 'practical', 0.01):
            (0.46650001406669617, 0.03959578275680542),
        ('heterogeneous', 'practical', 0.1):
            (0.362000048160553, 0.06256385147571564),
        ('heterogeneous', 'practical', 0.3):
            (0.3009999990463257, 0.08710195124149323),
        ('homogeneous', 'random', 0.0001):
            (0.48250001668930054, 9.834766387939453e-07),
        ('homogeneous', 'random', 0.001):
            (0.39500001072883606, 4.902482032775879e-06),
        ('homogeneous', 'random', 0.01):
            (0.2825000286102295, 8.764863014221191e-05),
        ('homogeneous', 'random', 0.1):
            (0.19850000739097595, 0.0011477470397949219),
        ('homogeneous', 'random', 0.3):
            (0.1550000011920929, 0.0049219876527786255),
        ('heterogeneous', 'random', 0.0001):
            (0.2735000252723694, 0.0260467529296875),
        ('heterogeneous', 'random', 0.001):
            (0.22700001299381256, 0.03570154309272766),
        ('heterogeneous', 'random', 0.01):
            (0.17149999737739563, 0.07805249094963074),
        ('heterogeneous', 'random', 0.1):
            (0.11400000751018524, 0.19426719844341278),
        ('heterogeneous', 'random', 0.3):
            (0.09000000357627869, 0.2147504836320877),
    },
    'smoke': {
        ('homogeneous', 'theoretical', 0.001): (1.0, 0.12960317730903625),
        ('homogeneous', 'theoretical', 0.1): (1.0, 0.12960317730903625),
        ('homogeneous', 'practical', 0.001): (1.0, 0.12960317730903625),
        ('homogeneous', 'practical', 0.1): (1.0, 0.12960317730903625),
        ('heterogeneous', 'theoretical', 0.001):
            (0.5399999618530273, 0.1343335509300232),
        ('heterogeneous', 'theoretical', 0.1):
            (0.5199999809265137, 0.12959003448486328),
        ('heterogeneous', 'practical', 0.001): (1.0, 0.36531227827072144),
        ('heterogeneous', 'practical', 0.1):
            (0.9900000095367432, 0.35985714197158813),
        ('homogeneous', 'random', 0.001): (1.0, 0.12595662474632263),
        ('homogeneous', 'random', 0.1): (1.0, 0.12595662474632263),
        ('heterogeneous', 'random', 0.001):
            (0.5499999523162842, 0.42147141695022583),
        ('heterogeneous', 'random', 0.1):
            (0.49000000953674316, 0.46086570620536804),
    },
}

# The port draws JAX's streams, derives the same rho and reproduces every
# decision, so the comm rates agree to float32 rounding of their means.
# J is evaluated from the exact problem's terms, w'Phi w - 2 b'w + c0, a
# difference of terms of size c0 ~ 1 in float32 that each framework sums
# in its own order: at J ~ 1e-6 (small lambda) that is most of J, so J is
# held within 1e-6 absolute (8 ulps of c0) plus 1e-4 relative
FIELDS = ("comm_rate", "J_final")
TOL = dict(comm_rate=(1e-6, 0.0), J_final=(1e-6, 1e-4))


def headlines(rows: list[dict]) -> dict:
    """(regime, mode, lam) -> (comm_rate, J_final) of the gated and random
    rows."""
    return {(r["regime"], r["mode"], r["lam"]): (r["comm_rate"], r["J_final"])
            for r in rows if "regime" in r}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Each cell's comm rate and J against JAX 0.9.0's at this scale; a
    decision tie goes to ``ties``."""
    want = want or JAX_0_9_0["smoke" if smoke else "full"]
    n_iter, seeds, _ = _scale(smoke)
    return common.compare("fig2", headlines(rows), want, FIELDS, TOL,
                          decisions=seeds * n_iter * 2, ties=ties)
