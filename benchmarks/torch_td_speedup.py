"""Federated TD(0) linear-speedup study on the port
(``benchmarks/td_speedup.py`` on ``repro_torch``).

m agents averaging their TD(0) updates on Markovian garnet chains
(``sampling="markov"``) should drive the stationary-weighted error down
about m times faster than one agent.  For m in {1, 4, 16, 64}: gamma 0.8
(so burn-in does not dominate the horizon), per-agent gradient noise
(the floor that averaging divides) and, as the error, the tail mean of
the streamed ``j_trajectory`` over the last quarter of the steps, envs
and seeds averaged.  One ``sweep_or_load`` per m (``num_agents`` is part
of the spec hash), tagged ``figure=td_speedup``; the rows come from
``render_td_speedup`` (error and error x m against m), and the report is
regenerated beside the store (default ``experiments/bench/torch/stores/
td_speedup/store``, git-ignored; smoke runs use a throwaway one).

``TD_STUDY``, ``TD_JAX`` and ``TD_TOL`` are the study's home:
``chip_smoke.py``'s TD phases import them, and ``fidelity`` holds the
rows' tail errors to JAX 0.9.0's.
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

GAMMA = 0.8
EPS = 0.1
NOISE_SCALE = 4.0       # per-agent gradient noise: the floor m divides
RHO = 0.999
LAM = 1e-3
TAIL_FRAC = 0.25
MODES = ("always", "theoretical")


def _scale(smoke: bool) -> dict:
    if smoke:
        return dict(envs=2, states=8, agents=(1, 4, 16), iters=800,
                    samples=4, seeds=(0, 1))
    return dict(envs=6, states=10, agents=(1, 4, 16, 64), iters=6000,
                samples=8, seeds=(0, 1, 2))


# the full-scale study as one dict (chip_smoke.py's TD phases build their
# sweeps from it)
TD_STUDY = dict(_scale(False), gamma=GAMMA, eps=EPS, noise_scale=NOISE_SCALE,
                rho=RHO, lam=LAM, tail_frac=TAIL_FRAC)


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    with common.study_store("td_speedup", smoke, store) as st:
        return _run(_scale(smoke), st, dev)


def _run(cfg: dict, store, dev) -> list[dict]:
    from repro_torch.core.algorithm1 import ParamSampler, TraceSpec
    from repro_torch.core.td import (td_env_family, td_family_sampler_fn,
                                     td_init_states)
    from repro_torch.experiments import SweepSpec, sweep_or_load
    from repro_torch.experiments.report import (generate_report,
                                                render_td_speedup)

    label = common.device_label(dev.type)
    envs, fam = td_env_family(cfg["envs"], num_states=cfg["states"],
                              gamma=GAMMA, device=dev)
    w0 = np.zeros(cfg["states"], np.float32)
    fn = td_family_sampler_fn(cfg["samples"])

    entries, us_per_call, rows = [], {}, []
    for m in cfg["agents"]:
        params = envs[0].agent_params(w0, m, noise_scale=NOISE_SCALE)
        sampler = ParamSampler(fn=fn, params=params)
        spec = SweepSpec(
            modes=MODES, lambdas=(LAM,), rhos=(RHO,),
            seeds=cfg["seeds"], eps=EPS, num_iterations=cfg["iters"],
            num_agents=m, sampling="markov",
            trace=TraceSpec(j_trajectory=True))
        t0 = time.perf_counter()
        res = sweep_or_load(store, spec, sampler, w0, env_sets=fam,
                            state_init_fn=td_init_states,
                            extra={"figure": "td_speedup", "m": m,
                                   "gamma": GAMMA,
                                   "noise_scale": NOISE_SCALE,
                                   "tail_frac": TAIL_FRAC}, device=dev)
        common.sync(dev)
        wall = time.perf_counter() - t0
        runs = int(np.prod(res.comm_rate.shape))
        us_per_call[m] = wall * 1e6 / runs
        entries.append(store.get(spec))
        rows.append(dict(bench="td_speedup", stage="sweep", m=m, runs=runs,
                         wall_s=wall,
                         run_agent_steps_per_s=runs * m * cfg["iters"] / wall,
                         comm_rate_by_mode={
                             mode: float(np.mean(
                                 res.comm_rate[:, mi].cpu().numpy()))
                             for mi, mode in enumerate(MODES)},
                         us_per_call=us_per_call[m], device=label))

    # figure rows from the report pipeline's own renderer
    for row in render_td_speedup(entries)["rows"]:
        row["us_per_call"] = us_per_call[row["m"]]
        row["device"] = label
        rows.append(row)

    out = common.report_dir(store)
    index = generate_report(store, out)
    rows.append(dict(bench="td_speedup", suite="report",
                     env_instances=cfg["envs"], agents=list(cfg["agents"]),
                     store=common.repo_path(store.root),
                     report_dir=common.repo_path(out),
                     artifacts=len(index["artifacts"]), us_per_call=0.0,
                     device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("td_speedup", rows)


# the study's spec through repro.experiments.run_sweep under JAX 0.9.0 on
# the CPU: tail error (mean of J over the last quarter of the steps, envs
# and seeds averaged) and comm rate per mode and m; td_speedup.run(store=
# <a fresh directory>) gives the same tail errors (JAX_PLATFORMS=cpu
# PYTHONPATH=src python3 tools/jax_study_refs.py --only td_speedup)
TD_JAX = {
    1: dict(always=0.2955451254226544, theoretical=0.00039856965453536415,
            comm_theoretical=0.02212962880730629),
    4: dict(always=0.06860475618750961, theoretical=0.00017473269391942909,
            comm_theoretical=0.010877314954996109),
    16: dict(always=0.01881671436627706, theoretical=9.872929255167643e-05,
             comm_theoretical=0.008459489792585373),
    64: dict(always=0.0046690628881807675,
             theoretical=5.724298512494122e-05,
             comm_theoretical=0.008114149793982506),
}
# the same study at run(smoke=True)'s scale (the same command with
# --smoke): tail errors per mode and m
TD_JAX_SMOKE = {
    1: dict(always=0.7009370258450509,
         theoretical=0.0010043764114379882),
    4: dict(always=0.141609106361866,
         theoretical=0.0004209011793136597),
    16: dict(always=0.03578000128269196,
         theoretical=0.00011968463659286498),
}
# experiments/bench/td_speedup.json as committed (older streams; shown only)
TD_COMMITTED_SPEEDUPS = dict(always=(1.0, 4.473652234580297,
                                     16.403772908819157, 71.06726251456973),
                             theoretical=(1.0, 1.9633240177862923,
                                          3.840772994462512,
                                          6.62078908456694))
# Relative bounds on the tail errors.  always: no decision, so only the
# float32 sums differ (the port on the CPU within 6e-6 of JAX).  theoretical:
# J ~ 5e-5 is the difference of terms of size c0 ~ 50 in float32, each
# evaluation off by ~ulp(c0) / J, so its tail mean carries that noise (the
# port on the CPU within 0.35 %, with the same comm rates to 1e-9); a
# decision that flips at a tie on the card moves one run's tail too.
TD_TOL = dict(always=1e-4, theoretical=0.05)


def headlines(rows: list[dict]) -> dict:
    """m -> {mode: tail error}, as ``TD_JAX_SMOKE``."""
    out: dict = {}
    for r in rows:
        if "tail_error" in r:
            out.setdefault(r["m"], {})[r["mode"]] = r["tail_error"]
    return out


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Each (mode, m) tail error against JAX 0.9.0's within ``TD_TOL``
    (which covers a flipped decision: ``ties`` stays as it is)."""
    want = want or (TD_JAX_SMOKE if smoke else {
        m: {mode: v[mode] for mode in MODES} for m, v in TD_JAX.items()})
    got = headlines(rows)
    if sorted(got) != sorted(want) or any(
            sorted(got[m]) != sorted(want[m]) for m in want):
        return [f"td_speedup: cells {got}, JAX 0.9.0 has {want}"]
    return [f"td_speedup {mode} m={m}: tail error {got[m][mode]:.6g}, JAX "
            f"0.9.0 {w:.6g} (relative tolerance {TD_TOL[mode]})"
            for m, by_mode in want.items() for mode, w in by_mode.items()
            if not common.close(got[m][mode], w, rel_tol=TD_TOL[mode])]
