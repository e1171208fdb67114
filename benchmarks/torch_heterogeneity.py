"""Heterogeneity study over garnet fleets on the port
(``benchmarks/heterogeneity.py`` on ``repro_torch``).

A 64-instance garnet family under two fleet classes: ``homogeneous``
(every instance's fleet clean and uniform-visit) and ``mixed`` (half of
each fleet junk: visits collapsed onto an instance-specific state, with
instance-specific target noise; the zipped per-env fleet axis,
``run_sweep(fleet_sets=...)``), both triggers, four lambdas, two seeds:
1024 runs a class, one sweep each through ``sweep_or_load``, tagged
``figure=heterogeneity`` and told apart by ``SweepSpec.tag``.  The rows
come from the report's own renderer (``render_heterogeneity``), the
budget answers per (class, mode) from ``repro_torch.experiments.query``,
and the report is regenerated beside the store.  Beyond the reference's
rows, one row per (mode, lambda) of the mixed class gives the mean
transmissions of a clean and of a junk agent (``tx_per_agent``): the
theoretical trigger's suppression of the junk agents.

The default store is ``experiments/bench/torch/stores/heterogeneity/
store`` (git-ignored); smoke runs use a throwaway one.  ``fidelity`` holds
the cells, the budget answers and the transmissions against JAX 0.9.0's.
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

EPS = 0.4
RHO = 0.999
COMM_BUDGET = 0.5


def _scale(smoke: bool) -> dict:
    if smoke:
        return dict(envs=8, states=10, agents=2, iters=20, samples=8,
                    lambdas=(1e-3, 1e-1), seeds=(0,))
    return dict(envs=64, states=20, agents=4, iters=150, samples=10,
                lambdas=tuple(np.logspace(-4, -1, 4)), seeds=(0, 1))


def tx_per_agent(entry) -> dict:
    """Mean transmissions a run of a clean and of a junk agent (the last
    ``num_junk`` of each fleet), per (mode, lambda), envs and seeds
    averaged: ``{(mode, lam): (clean, junk)}``."""
    tx = np.asarray(entry.arrays["trace/tx_counts"], np.float64)
    junk = int(entry.extra["num_junk"])
    m = tx.shape[-1]
    # (..., M, L, R, S, m) -> (M, L, runs, m)
    tx = np.moveaxis(tx, (entry.axes.index("mode"), entry.axes.index("lam")),
                     (0, 1)).reshape(len(entry.modes), len(entry.lambdas),
                                     -1, m)
    return {(mode, float(lam)): (float(tx[mi, li, :, :m - junk].mean()),
                                 float(tx[mi, li, :, m - junk:].mean()))
            for mi, mode in enumerate(entry.modes)
            for li, lam in enumerate(entry.lambdas)}


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    with common.study_store("heterogeneity", smoke, store) as st:
        return _run(_scale(smoke), st, dev)


def _run(cfg: dict, store, dev) -> list[dict]:
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import (family_sampler_fn, garnet_env_family,
                                  garnet_fleet_sets)
    from repro_torch.experiments import SweepSpec, sweep_or_load
    from repro_torch.experiments import query as query_lib
    from repro_torch.experiments.report import (generate_report,
                                                render_heterogeneity)

    label = common.device_label(dev.type)
    envs, fam = garnet_env_family(cfg["envs"], num_states=cfg["states"],
                                  device=dev)
    w0 = np.zeros(cfg["states"], np.float32)
    sampler = ParamSampler(fn=family_sampler_fn(cfg["samples"]), params=None)
    classes = (("homogeneous", 0), ("mixed", cfg["agents"] // 2))

    rows, entries, timing = [], [], {}
    for cls, num_junk in classes:
        fleets = garnet_fleet_sets(envs, w0, cfg["agents"],
                                   num_junk=num_junk)
        spec = SweepSpec(
            modes=("theoretical", "practical"), lambdas=cfg["lambdas"],
            seeds=cfg["seeds"], rhos=(RHO,), eps=EPS,
            num_iterations=cfg["iters"], num_agents=cfg["agents"],
            trace="summary", tag=f"het-{cls}")
        t0 = time.perf_counter()
        res = sweep_or_load(store, spec, sampler, w0, env_sets=fam,
                            fleet_sets=fleets,
                            extra={"figure": "heterogeneity",
                                   "fleet_class": cls,
                                   "num_junk": num_junk}, device=dev)
        common.sync(dev)
        wall = time.perf_counter() - t0
        runs = int(np.prod(res.comm_rate.shape))
        timing[cls] = wall * 1e6 / runs
        entries.append(store.get(spec))
        rows.append(dict(bench="heterogeneity", fleet_class=cls,
                         stage="sweep", runs=runs, wall_s=wall,
                         run_agent_steps_per_s=(runs * cfg["agents"]
                                                * cfg["iters"] / wall),
                         us_per_call=timing[cls], device=label))

    # figure rows from the report pipeline's own renderer, so the study's
    # JSON and the regenerated report cannot drift apart
    for row in render_heterogeneity(entries)["rows"]:
        row["us_per_call"] = timing[row["fleet_class"]]
        row["device"] = label
        rows.append(row)

    # budget answers per (class, mode): which lambda meets the comm budget
    # and at what J, asked of the store
    for e in entries:
        cls = e.extra["fleet_class"]
        for mode in e.modes:
            curve = query_lib.tradeoff_curve(e, mode=mode)
            best = query_lib.best_lambda(curve, COMM_BUDGET)
            rows.append(dict(
                bench="heterogeneity", fleet_class=cls, mode=mode,
                query=f"best_lambda@{COMM_BUDGET}", lam=best["lam"],
                comm_rate=best["comm_rate"], J_final=best.get("J"),
                feasible=best["feasible"], us_per_call=timing[cls],
                device=label))

    # who transmits in the mixed class: a clean agent against a junk one
    mixed = next(e for e in entries if e.extra["fleet_class"] == "mixed")
    for (mode, lam), (clean, junk) in tx_per_agent(mixed).items():
        rows.append(dict(bench="heterogeneity", fleet_class="mixed",
                         mode=mode, lam=lam, query="tx_per_agent",
                         iterations=cfg["iters"], tx_clean=clean,
                         tx_junk=junk, us_per_call=timing["mixed"],
                         device=label))

    out = common.report_dir(store)
    index = generate_report(store, out)
    rows.append(dict(bench="heterogeneity", suite="report",
                     env_instances=cfg["envs"],
                     fleet_classes=[c for c, _ in classes],
                     store=common.repo_path(store.root),
                     report_dir=common.repo_path(out),
                     artifacts=len(index["artifacts"]), us_per_call=0.0,
                     device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("heterogeneity", rows)


# heterogeneity.run(smoke=..., store=<a fresh directory>) under JAX 0.9.0
# on the CPU (the committed store predates JAX 0.9.0's streams and is
# refused by its inputs digest; JAX_PLATFORMS=cpu PYTHONPATH=src python3
# tools/jax_study_refs.py --only heterogeneity [--smoke]):
# cells (class, mode, lam) -> (comm_rate, J_final); best_lambda (class,
# mode) -> (lam, comm_rate, J_final); tx_per_agent (mode, lam) -> (clean,
# junk) of the mixed class
JAX_0_9_0 = {
    'full': {
        'cells': {
            ('homogeneous', 'theoretical', 0.0001):
                (0.86147141456604, 5.0246017053723335e-06),
            ('homogeneous', 'theoretical', 0.001):
                (0.6697788238525391, 4.8840767703950405e-05),
            ('homogeneous', 'theoretical', 0.01):
                (0.4780208170413971, 0.0005053234053775668),
            ('homogeneous', 'theoretical', 0.1):
                (0.2893880307674408, 0.005081464536488056),
            ('homogeneous', 'practical', 0.0001):
                (0.9395443797111511, 1.9426224753260612e-06),
            ('homogeneous', 'practical', 0.001):
                (0.7563281655311584, 1.2937583960592747e-05),
            ('homogeneous', 'practical', 0.01):
                (0.5649349093437195, 0.00012421421706676483),
            ('homogeneous', 'practical', 0.1):
                (0.3744010627269745, 0.0012436312390491366),
            ('mixed', 'theoretical', 0.0001):
                (0.4472004473209381, 4.7425273805856705e-06),
            ('mixed', 'theoretical', 0.001):
                (0.3478255867958069, 4.6039815060794353e-05),
            ('mixed', 'theoretical', 0.01):
                (0.2510286271572113, 0.00048184418119490147),
            ('mixed', 'theoretical', 0.1):
                (0.15454427897930145, 0.004862422123551369),
            ('mixed', 'practical', 0.0001):
                (0.9998047947883606, 0.010351966135203838),
            ('mixed', 'practical', 0.001):
                (0.9991537928581238, 0.010347096249461174),
            ('mixed', 'practical', 0.01):
                (0.9966928362846375, 0.01038326881825924),
            ('mixed', 'practical', 0.1):
                (0.9410936832427979, 0.022545861080288887),
        },
        'best_lambda': {
            ('homogeneous', 'theoretical'):
                (0.007680343156138641, 0.5, 0.0004530016505903706),
            ('homogeneous', 'practical'):
                (0.021918211540128508, 0.5, 0.0005057172630135287),
            ('mixed', 'theoretical'):
                (0.0001, 0.4472004473209381, 4.7425273805856705e-06),
            ('mixed', 'practical'):
                (0.1, 0.9410936832427979, 0.022545861080288887),
        },
        'tx_per_agent': {
            ('theoretical', 0.0001): (131.36328125, 2.796875),
            ('theoretical', 0.001): (101.69921875, 2.6484375),
            ('theoretical', 0.01): (72.984375, 2.32421875),
            ('theoretical', 0.1): (44.6640625, 1.69921875),
            ('practical', 0.0001): (150.0, 149.94140625),
            ('practical', 0.001): (150.0, 149.74609375),
            ('practical', 0.01): (149.92578125, 149.08203125),
            ('practical', 0.1): (134.30859375, 148.01953125),
        },
    },
    'smoke': {
        'cells': {
            ('homogeneous', 'theoretical', 0.001): (1.0, 0.012341571971774101),
            ('homogeneous', 'theoretical', 0.1):
                (0.690625011920929, 0.02286679483950138),
            ('homogeneous', 'practical', 0.001): (1.0, 0.012341571971774101),
            ('homogeneous', 'practical', 0.1):
                (0.8343750238418579, 0.014100773259997368),
            ('mixed', 'theoretical', 0.001):
                (0.5531250238418579, 0.014469252899289131),
            ('mixed', 'theoretical', 0.1):
                (0.3812500238418579, 0.024873992428183556),
            ('mixed', 'practical', 0.001): (1.0, 0.10615446418523788),
            ('mixed', 'practical', 0.1):
                (0.9906249642372131, 0.10383187979459763),
        },
        'best_lambda': {
            ('homogeneous', 'theoretical'):
                (0.1, 0.690625011920929, 0.02286679483950138),
            ('homogeneous', 'practical'):
                (0.1, 0.8343750238418579, 0.014100773259997368),
            ('mixed', 'theoretical'):
                (0.004151280654639362, 0.5, 0.01768526474243582),
            ('mixed', 'practical'):
                (0.1, 0.9906249642372131, 0.10383187979459763),
        },
        'tx_per_agent': {
            ('theoretical', 0.001): (20.0, 2.125),
            ('theoretical', 0.1): (14.625, 0.625),
            ('practical', 0.001): (20.0, 20.0),
            ('practical', 0.1): (20.0, 19.625),
        },
    },
}

# The tabular studies draw JAX's streams and reproduce every decision, so
# comm rates and transmissions agree to float32 rounding of their means.
# J is evaluated from the exact problem's terms, a difference of float32
# terms that each framework sums in its own order (fig2's note): 1e-6
# absolute plus 1e-4 relative.  A budget answer's lambda is interpolated
# in log lambda between two cells, so a 1e-7 move of their rates moves it
# by up to ~1e-6 relative: 1e-5
FIELDS = dict(cells=("comm_rate", "J_final"),
              best_lambda=("lam", "comm_rate", "J_final"),
              tx_per_agent=("tx_clean", "tx_junk"))
TOL = dict(comm_rate=(1e-6, 0.0), J_final=(1e-6, 1e-4), lam=(0.0, 1e-5),
           tx_clean=(1e-6, 0.0), tx_junk=(1e-6, 0.0))


def headlines(rows: list[dict]) -> dict:
    """The cells, budget answers and mixed-class transmissions, keyed as
    ``JAX_0_9_0``'s tables."""
    return dict(
        cells={(r["fleet_class"], r["mode"], r["lam"]):
               (r["comm_rate"], r["J_final"])
               for r in rows if "J_env_spread" in r},
        best_lambda={(r["fleet_class"], r["mode"]):
                     (r["lam"], r["comm_rate"], r["J_final"])
                     for r in rows
                     if str(r.get("query", "")).startswith("best_lambda")},
        tx_per_agent={(r["mode"], r["lam"]): (r["tx_clean"], r["tx_junk"])
                      for r in rows if r.get("query") == "tx_per_agent"})


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Cells, budget answers and per-agent transmissions against JAX
    0.9.0's at this scale.  A decision tie in a cell goes to ``ties``, and
    the answers that lean on that cell (its class and mode's budget
    answer, its mixed-class transmissions) are set aside with it."""
    want = want or JAX_0_9_0["smoke" if smoke else "full"]
    cfg = _scale(smoke)
    got = headlines(rows)
    found = []
    out = common.compare("heterogeneity cells", got["cells"], want["cells"],
                         FIELDS["cells"], TOL, ties=found,
                         decisions=(len(cfg["seeds"]) * cfg["envs"]
                                    * cfg["iters"] * cfg["agents"]))
    tied = {key for _, key in found}
    for name, skip in (("best_lambda", {k[:2] for k in tied}),
                       ("tx_per_agent", {k[1:] for k in tied
                                         if k[0] == "mixed"})):
        keep = {k: v for k, v in want[name].items() if k not in skip}
        have = {k: v for k, v in got[name].items() if k in keep}
        out += common.compare(f"heterogeneity {name}", have, keep,
                              FIELDS[name], TOL)
    if ties is not None:
        ties += found
    return out
