"""Paper Fig. 3 on the port: continuous-state value-function approximation
(``benchmarks/fig3_continuous.py`` on ``repro_torch``).

Three panels: (left) a large lambda gives infrequent, late communication;
(middle) a small lambda frequent communication and faster weight
convergence; (right) 10 agents learn faster than 2 at about the same
communication rate.  The 2-agent panels share one ``run_sweep`` (lambda is
data); the 10-agent panel is a second (the fleet size sets the shapes).

With ``store=`` both sweeps persist their full traces through
``sweep_or_load``, tagged ``figure=fig3`` with w* and the panel map, which
is all the torch-free report needs to regenerate the panels' statistics.

``FIG3_JAX``, ``FIG3_COMMITTED`` and ``FIG3_TOL`` are the panels' home:
``chip_smoke.py``'s ``fig3_phase`` imports them, and ``fidelity`` holds the
study's rows to them.
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

N = 1500
T = 1000
PANELS_2 = (("left_infrequent", 1e-1), ("middle_frequent", 1e-4),
            ("right_2agents", 1e-2))


def run(smoke: bool = False, N: int = N, T: int = T, store=None,
        device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import LinearSystem
    from repro_torch.experiments import SweepSpec, run_sweep, sweep_or_load

    dev = resolve_device(device)
    label = common.device_label(dev.type)
    if smoke:
        N, T = 100, 64
    ls = LinearSystem()
    prob = ls.vfa_problem(np.zeros(6))
    eps = 0.9 * prob.max_stable_stepsize()
    rho = min(prob.min_rho(eps) * 1.0001, 0.9995)
    wstar = prob.optimum().numpy()
    w0 = np.zeros(6, np.float32)
    fn = ls.sampler_fn(T)
    rows = []

    def emit(name, lam, agents, res, li, us):
        tr = res.trace
        a = tr.alphas[0, li, 0, 0].cpu().numpy().mean(1)    # (N,) agent mean
        w = tr.weights[0, li, 0, 0].cpu().numpy()           # (N + 1, 6)
        first_tx = int(np.argmax(a > 0)) if a.max() > 0 else N
        rows.append(dict(
            bench="fig3", panel=name, lam=lam, agents=agents,
            comm_rate=float(tr.comm_rate[0, li, 0, 0]),
            first_tx_iter=first_tx,
            early_rate=float(a[: N // 4].mean()),
            late_rate=float(a[3 * N // 4:].mean()),
            J_final=float(res.j_final[0, li, 0, 0]),
            w_err_quarterly=[float(np.linalg.norm(w[k] - wstar))
                             for k in (0, N // 4, N // 2, 3 * N // 4, N)],
            us_per_call=us, device=label))

    def sweep(lambdas, agents, panels):
        spec = SweepSpec(modes=("practical",), lambdas=lambdas, seeds=(0,),
                         rhos=(rho,), eps=eps, num_iterations=N,
                         num_agents=agents, tag=f"fig3-{agents}agents")
        sampler = ParamSampler(fn=fn, params=ls.agent_params(w0, agents))
        t0 = time.perf_counter()
        if store is None:
            res = run_sweep(spec, sampler, w0, problem=prob, device=dev)
        else:
            res = sweep_or_load(
                store, spec, sampler, w0, problem=prob,
                extra={"figure": "fig3", "wstar": wstar.tolist(),
                       "panels": [[n, lam] for n, lam in panels]},
                device=dev)
        common.sync(dev)
        return res, (time.perf_counter() - t0) * 1e6 / len(lambdas)

    res2, us2 = sweep(tuple(lam for _, lam in PANELS_2), agents=2,
                      panels=PANELS_2)
    for li, (name, lam) in enumerate(PANELS_2):
        emit(name, lam, 2, res2, li, us2)
    res10, us10 = sweep((1e-2,), agents=10,
                        panels=(("right_10agents", 1e-2),))
    emit("right_10agents", 1e-2, 10, res10, 0, us10)
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("fig3", rows)


# the study's own numbers, fig3_continuous.run() with no store, under JAX
# 0.9.0 on the CPU (the streams the port reproduces; JAX_PLATFORMS=cpu
# PYTHONPATH=src python3 tools/jax_study_refs.py --only fig3)
FIG3_JAX = {
    "left_infrequent": dict(
        comm_rate=0.041999999433755875, first_tx_iter=0,
        J_final=0.0019502639770507812,
        w_err_quarterly=[1.413479208946228, 1.068789005279541,
                         1.0277268886566162, 0.9594783782958984,
                         0.7316417694091797]),
    "middle_frequent": dict(
        comm_rate=0.6053333282470703, first_tx_iter=0,
        J_final=1.0728836059570312e-05,
        w_err_quarterly=[1.413479208946228, 0.45173683762550354,
                         0.26844385266304016, 0.14067628979682922,
                         0.07037332653999329]),
    "right_2agents": dict(
        comm_rate=0.14766666293144226, first_tx_iter=0,
        J_final=0.00041031837463378906,
        w_err_quarterly=[1.413479208946228, 1.0019376277923584,
                         0.8695611953735352, 0.6612618565559387,
                         0.4010760486125946]),
    "right_10agents": dict(
        comm_rate=0.09593333303928375, first_tx_iter=0,
        J_final=0.00018161535263061523,
        w_err_quarterly=[1.413479208946228, 0.9969350695610046,
                         0.8180505633354187, 0.47494298219680786,
                         0.2701323628425598]),
}
# the same at run(smoke=True)'s scale (N 100, T 64; the same command with
# --smoke)
FIG3_JAX_SMOKE = {
    'left_infrequent': dict(
        comm_rate=0.14499999582767487, first_tx_iter=0,
        J_final=0.0074231624603271484,
        w_err_quarterly=[1.413479208946228, 1.0093508958816528,
                         1.0093508958816528, 1.0093508958816528,
                         1.0045748949050903]),
    'middle_frequent': dict(
        comm_rate=1.0, first_tx_iter=0,
        J_final=0.002023637294769287,
        w_err_quarterly=[1.413479208946228, 0.9718181490898132,
                         0.8844573497772217, 0.8035975694656372,
                         0.7372428178787231]),
    'right_2agents': dict(
        comm_rate=0.7450000047683716, first_tx_iter=0,
        J_final=0.0021623969078063965,
        w_err_quarterly=[1.413479208946228, 0.975517213344574,
                         0.9014392495155334, 0.823662281036377,
                         0.7682282328605652]),
    'right_10agents': dict(
        comm_rate=0.734000027179718, first_tx_iter=0,
        J_final=0.002218484878540039,
        w_err_quarterly=[1.413479208946228, 0.9765839576721191,
                         0.8799230456352234, 0.8005041480064392,
                         0.7340478301048279]),
}
# experiments/bench/fig3.json as committed: older threefry streams, shown
# beside the others and held to nothing
FIG3_COMMITTED = {"left_infrequent": dict(comm_rate=0.04266666620969772,
                                          J_final=0.0019592642784118652),
                  "middle_frequent": dict(comm_rate=0.6036666631698608,
                                          J_final=1.1742115020751953e-05),
                  "right_2agents": dict(comm_rate=0.1550000011920929,
                                        J_final=0.00037091970443725586),
                  "right_10agents": dict(comm_rate=0.09380000084638596,
                                         J_final=0.00016576051712036133)}
# The port derives eps and rho from its own float32 Phi, summed in another
# order than XLA's: eps comes out equal, rho 0.99585203 against JAX's
# 0.99585179 (the min-eigenvalue term of an ill-conditioned 6x6 moment
# matrix).  The thresholds then differ in their last bits, practical-mode
# decisions part near them and the trajectories diverge, so the panels
# agree as two runs of one study, not bit for bit (the backends, which
# share the port's rho, are held to plain torch bit for bit in
# chip_smoke.py).  On the CPU the port read comm rates within 0.007,
# J_final within 12 % and w_err within 0.048 of JAX's; the committed
# fig3.json (older streams) sits within 0.0073, 10 % and 0.018.  Bounds:
# about 3x those.
FIG3_TOL = dict(comm_rate=0.03, J_final_rel=0.3, w_err=0.1)


def panel_gaps(got: dict, want: dict) -> dict:
    """One panel's distance from JAX 0.9.0's, in ``FIG3_TOL``'s terms."""
    return dict(comm_rate=abs(got["comm_rate"] - want["comm_rate"]),
                J_final_rel=abs(got["J_final"] / want["J_final"] - 1),
                w_err=max(abs(a - b) for a, b in zip(
                    got["w_err_quarterly"], want["w_err_quarterly"])))


def headlines(rows: list[dict]) -> dict:
    """panel -> its comm rate, first transmission, J and quarterly weight
    errors, as ``FIG3_JAX``."""
    return {r["panel"]: {k: r[k] for k in ("comm_rate", "first_tx_iter",
                                            "J_final", "w_err_quarterly")}
            for r in rows}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Each panel against JAX 0.9.0's within ``FIG3_TOL``, and its first
    transmission at the same step (``FIG3_TOL`` already covers decisions
    that part: ``ties`` stays as it is)."""
    want = want or (FIG3_JAX_SMOKE if smoke else FIG3_JAX)
    got = headlines(rows)
    if sorted(got) != sorted(want):
        return [f"fig3: panels {sorted(got)}, JAX 0.9.0 has {sorted(want)}"]
    out = []
    for name, w in want.items():
        d = panel_gaps(got[name], w)
        if (got[name]["first_tx_iter"] != w["first_tx_iter"]
                or any(v > FIG3_TOL[k] for k, v in d.items())):
            out.append(f"fig3 {name}: port differs from JAX 0.9.0 by {d} "
                       f"(first tx {got[name]['first_tx_iter']} against "
                       f"{w['first_tx_iter']}; tolerance {FIG3_TOL})")
    return out
