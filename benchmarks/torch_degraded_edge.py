"""Degraded-edge channel study on the port (``benchmarks/degraded_edge.py``
on ``repro_torch``).

One sweep over a 64-instance garnet family crossed with the channel grid
axis (``SweepSpec.channel_sets=``): a clean control, 10 % and 30 % uplink
loss, delay 1 and 4, staleness 1 and 8, for both triggers and four
lambdas.  The summary trace keeps the trigger's attempted transmissions
(``comm_rate``, what eq. 7 charges) apart from the delivered ones
(``delivered_rate``), and the rows carry both per (channel, trigger,
lambda).  ``best_lambda`` answers per channel ask whether the lambda that
meets a comm budget on a clean channel still meets it, and at what J,
when the channel drops 30 % of updates.

Results persist through ``sweep_or_load`` tagged ``figure=degraded_edge``
(default store ``experiments/bench/torch/stores/degraded_edge/store``,
git-ignored; smoke runs use a throwaway one) and the report is
regenerated beside the store.  ``fidelity`` holds every cell and budget
answer against JAX 0.9.0's (``JAX_0_9_0``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

EPS = 0.4
RHO = 0.999
COMM_BUDGET = 0.5


def channels() -> tuple:
    """The channel grid: one clean control plus each degradation axis
    alone, so every effect in the report comes from a single knob."""
    from repro_torch.core.channel import ChannelSpec
    return (("clean", ChannelSpec()),
            ("loss10", ChannelSpec(drop_prob=0.10)),
            ("loss30", ChannelSpec(drop_prob=0.30)),
            ("delay1", ChannelSpec(delay=1)),
            ("delay4", ChannelSpec(delay=4)),
            ("stale1", ChannelSpec(staleness=1)),
            ("stale8", ChannelSpec(staleness=8)))


def _scale(smoke: bool) -> dict:
    ch = channels()
    if smoke:
        return dict(envs=8, states=10, agents=2, iters=20, samples=8,
                    lambdas=(1e-3, 1e-1), seeds=(0,),
                    channels=ch[:3] + ch[4:5])
    return dict(envs=64, states=20, agents=4, iters=150, samples=10,
                lambdas=tuple(np.logspace(-4, -1, 4)), seeds=(0, 1),
                channels=ch)


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    with common.study_store("degraded_edge", smoke, store) as st:
        return _run(_scale(smoke), st, dev)


def _run(cfg: dict, store, dev) -> list[dict]:
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import (family_sampler_fn, garnet_env_family,
                                  garnet_fleet_sets)
    from repro_torch.experiments import SweepSpec, sweep_or_load
    from repro_torch.experiments import query as query_lib
    from repro_torch.experiments.report import (generate_report,
                                                render_degraded_edge)

    label = common.device_label(dev.type)
    envs, fam = garnet_env_family(cfg["envs"], num_states=cfg["states"],
                                  device=dev)
    w0 = np.zeros(cfg["states"], np.float32)
    sampler = ParamSampler(fn=family_sampler_fn(cfg["samples"]), params=None)
    # clean uniform-visit fleets: the channel is the only degradation axis
    fleets = garnet_fleet_sets(envs, w0, cfg["agents"], num_junk=0)
    labels = [name for name, _ in cfg["channels"]]

    spec = SweepSpec(
        modes=("theoretical", "practical"), lambdas=cfg["lambdas"],
        seeds=cfg["seeds"], rhos=(RHO,), eps=EPS,
        num_iterations=cfg["iters"], num_agents=cfg["agents"],
        trace="summary",
        channel_sets=tuple(c for _, c in cfg["channels"]),
        # megastep fuses the server update into its kernel and cannot hold
        # a delivery back d steps; fused runs the family-stats kernel
        step_backend="fused")
    t0 = time.perf_counter()
    res = sweep_or_load(store, spec, sampler, w0, env_sets=fam,
                        fleet_sets=fleets,
                        extra={"figure": "degraded_edge",
                               "channels": labels}, device=dev)
    common.sync(dev)
    wall = time.perf_counter() - t0
    runs = int(np.prod(res.comm_rate.shape))
    us_per_run = wall * 1e6 / runs
    entry = store.get(spec)

    rows = [dict(bench="degraded_edge", stage="sweep", runs=runs,
                 wall_s=wall,
                 run_agent_steps_per_s=(runs * cfg["agents"] * cfg["iters"]
                                        / wall),
                 us_per_call=us_per_run, device=label)]
    # figure rows from the report pipeline's own renderer
    for row in render_degraded_edge(entry)["rows"]:
        row["us_per_call"] = us_per_run
        row["device"] = label
        rows.append(row)

    # budget answers per channel, asked of the store
    for ci, ch in enumerate(labels):
        for mode in entry.modes:
            curve = query_lib.tradeoff_curve(entry, mode=mode,
                                             select={"channel": ci})
            best = query_lib.best_lambda(curve, COMM_BUDGET)
            rows.append(dict(
                bench="degraded_edge", channel=ch, mode=mode,
                query=f"best_lambda@{COMM_BUDGET}", lam=best["lam"],
                comm_rate=best["comm_rate"], J_final=best.get("J"),
                feasible=best["feasible"], us_per_call=us_per_run,
                device=label))

    out = common.report_dir(store)
    index = generate_report(store, out)
    rows.append(dict(bench="degraded_edge", suite="report",
                     env_instances=cfg["envs"], channels=labels,
                     store=common.repo_path(store.root),
                     report_dir=common.repo_path(out),
                     artifacts=len(index["artifacts"]), us_per_call=0.0,
                     device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("degraded_edge", rows)


def delivered_over_attempted(rows: list[dict], channel: str) -> float:
    """Delivered over attempted transmissions on ``channel``, over all its
    (mode, lambda) cells: loss30's is about 0.70."""
    cells = [r for r in rows
             if r.get("channel") == channel and "delivered_rate" in r]
    return (sum(r["delivered_rate"] for r in cells)
            / sum(r["comm_rate"] for r in cells))


# degraded_edge.run(smoke=..., store=<a fresh directory>) under JAX 0.9.0
# on the CPU (the committed store predates JAX 0.9.0's streams and is
# refused by its inputs digest; JAX_PLATFORMS=cpu PYTHONPATH=src python3
# tools/jax_study_refs.py --only degraded_edge [--smoke]): cells (channel,
# mode, lam) -> (comm_rate, delivered_rate, J_final); best_lambda
# (channel, mode) -> (lam, comm_rate, J_final)
JAX_0_9_0 = {
    'full': {
        'cells': {
            ('clean', 'theoretical', 0.0001):
                (0.86147141456604, 0.86147141456604, 5.0246017053723335e-06),
            ('clean', 'theoretical', 0.001):
                (0.6697788238525391,
                 0.6697788238525391,
                 4.8840767703950405e-05),
            ('clean', 'theoretical', 0.01):
                (0.4780208170413971,
                 0.4780208170413971,
                 0.0005053234053775668),
            ('clean', 'theoretical', 0.1):
                (0.2893880307674408, 0.2893880307674408, 0.005081464536488056),
            ('clean', 'practical', 0.0001):
                (0.9395443797111511,
                 0.9395443797111511,
                 1.9426224753260612e-06),
            ('clean', 'practical', 0.001):
                (0.7563281655311584,
                 0.7563281655311584,
                 1.2937583960592747e-05),
            ('clean', 'practical', 0.01):
                (0.5649349093437195,
                 0.5649349093437195,
                 0.00012421421706676483),
            ('clean', 'practical', 0.1):
                (0.3744010627269745,
                 0.3744010627269745,
                 0.0012436312390491366),
            ('loss10', 'theoretical', 0.0001):
                (0.8644400835037231,
                 0.7763541340827942,
                 5.0674425438046455e-06),
            ('loss10', 'theoretical', 0.001):
                (0.67201828956604, 0.6028255224227905, 4.785927012562752e-05),
            ('loss10', 'theoretical', 0.01):
                (0.4796484410762787, 0.4267447590827942, 0.000495807733386755),
            ('loss10', 'theoretical', 0.1):
                (0.29055988788604736,
                 0.2555468678474426,
                 0.005071185529232025),
            ('loss10', 'practical', 0.0001):
                (0.9404427409172058,
                 0.8460676670074463,
                 2.025044523179531e-06),
            ('loss10', 'practical', 0.001):
                (0.7577604055404663,
                 0.6807292103767395,
                 1.3396027497947216e-05),
            ('loss10', 'practical', 0.01):
                (0.566809892654419,
                 0.5053516030311584,
                 0.00012585334479808807),
            ('loss10', 'practical', 0.1):
                (0.37684890627861023,
                 0.3331120014190674,
                 0.0012722049141302705),
            ('loss30', 'theoretical', 0.0001):
                (0.8668619990348816,
                 0.6038540601730347,
                 5.116686224937439e-06),
            ('loss30', 'theoretical', 0.001):
                (0.6767058372497559,
                 0.47158846259117126,
                 4.908093251287937e-05),
            ('loss30', 'theoretical', 0.01):
                (0.4830339848995209,
                 0.3372786343097687,
                 0.0005033973138779402),
            ('loss30', 'theoretical', 0.1):
                (0.29414063692092896,
                 0.20018234848976135,
                 0.0050797779113054276),
            ('loss30', 'practical', 0.0001):
                (0.9432032704353333,
                 0.6615365743637085,
                 2.1277228370308876e-06),
            ('loss30', 'practical', 0.001):
                (0.7638801336288452,
                 0.5317577719688416,
                 1.3744109310209751e-05),
            ('loss30', 'practical', 0.01):
                (0.5745572447776794,
                 0.40033847093582153,
                 0.00013121915981173515),
            ('loss30', 'practical', 0.1):
                (0.38268226385116577,
                 0.2651432156562805,
                 0.0012890298385173082),
            ('delay1', 'theoretical', 0.0001):
                (0.831666886806488, 0.831666886806488, 4.6978238970041275e-06),
            ('delay1', 'theoretical', 0.001):
                (0.6469271779060364,
                 0.6469271779060364,
                 4.686496686190367e-05),
            ('delay1', 'theoretical', 0.01):
                (0.4644010365009308,
                 0.4644010365009308,
                 0.0004898111801594496),
            ('delay1', 'theoretical', 0.1):
                (0.2832682132720947, 0.2832682132720947, 0.005007494240999222),
            ('delay1', 'practical', 0.0001):
                (0.9090365767478943,
                 0.9090365767478943,
                 1.5397090464830399e-06),
            ('delay1', 'practical', 0.001):
                (0.7286197543144226,
                 0.7286197543144226,
                 1.2430013157427311e-05),
            ('delay1', 'practical', 0.01):
                (0.5464583039283752,
                 0.5464583039283752,
                 0.00011992536019533873),
            ('delay1', 'practical', 0.1):
                (0.3653125762939453,
                 0.3653125762939453,
                 0.0012229999992996454),
            ('delay4', 'theoretical', 0.0001):
                (0.7336850166320801,
                 0.7336850166320801,
                 3.382563591003418e-06),
            ('delay4', 'theoretical', 0.001):
                (0.5725260376930237,
                 0.5725260376930237,
                 3.8454076275229454e-05),
            ('delay4', 'theoretical', 0.01):
                (0.4228515923023224,
                 0.4228515923023224,
                 0.00036169798113405704),
            ('delay4', 'theoretical', 0.1):
                (0.2653906047344208, 0.2653906047344208, 0.004023419693112373),
            ('delay4', 'practical', 0.0001):
                (0.8046095967292786,
                 0.8046095967292786,
                 9.193317964673042e-07),
            ('delay4', 'practical', 0.001):
                (0.6428906917572021,
                 0.6428906917572021,
                 1.009088009595871e-05),
            ('delay4', 'practical', 0.01):
                (0.48858073353767395,
                 0.48858073353767395,
                 0.00010212522465735674),
            ('delay4', 'practical', 0.1):
                (0.336158812046051, 0.336158812046051, 0.0010718373814597726),
            ('stale1', 'theoretical', 0.0001):
                (0.831666886806488, 0.831666886806488, 4.6978238970041275e-06),
            ('stale1', 'theoretical', 0.001):
                (0.6469271779060364,
                 0.6469271779060364,
                 4.686496686190367e-05),
            ('stale1', 'theoretical', 0.01):
                (0.4644010365009308,
                 0.4644010365009308,
                 0.0004898111801594496),
            ('stale1', 'theoretical', 0.1):
                (0.2832682132720947, 0.2832682132720947, 0.005007494240999222),
            ('stale1', 'practical', 0.0001):
                (0.9090365767478943,
                 0.9090365767478943,
                 1.5266705304384232e-06),
            ('stale1', 'practical', 0.001):
                (0.7286197543144226,
                 0.7286197543144226,
                 1.2430013157427311e-05),
            ('stale1', 'practical', 0.01):
                (0.5464583039283752,
                 0.5464583039283752,
                 0.00011992536019533873),
            ('stale1', 'practical', 0.1):
                (0.3653125762939453,
                 0.3653125762939453,
                 0.0012229999992996454),
            ('stale8', 'theoretical', 0.0001):
                (0.5549739599227905,
                 0.5549739599227905,
                 1.0668300092220306e-06),
            ('stale8', 'theoretical', 0.001):
                (0.4628906548023224,
                 0.4628906548023224,
                 9.884359315037727e-06),
            ('stale8', 'theoretical', 0.01):
                (0.35324224829673767,
                 0.35324224829673767,
                 0.00013572652824223042),
            ('stale8', 'theoretical', 0.1):
                (0.24328123033046722,
                 0.24328123033046722,
                 0.0018896890105679631),
            ('stale8', 'practical', 0.0001):
                (0.5955337882041931,
                 0.5955337882041931,
                 3.725290298461914e-07),
            ('stale8', 'practical', 0.001):
                (0.5026692152023315,
                 0.5026692152023315,
                 3.4740660339593887e-06),
            ('stale8', 'practical', 0.01):
                (0.397890567779541, 0.397890567779541, 4.121463280171156e-05),
            ('stale8', 'practical', 0.1):
                (0.2917317748069763,
                 0.2917317748069763,
                 0.00042938324622809887),
        },
        'best_lambda': {
            ('clean', 'theoretical'):
                (0.007680343156138641, 0.5, 0.0004530016505903706),
            ('clean', 'practical'):
                (0.021918211540128508, 0.5, 0.0005057172630135287),
            ('loss10', 'theoretical'):
                (0.007838014949472836, 0.5, 0.00044841751284845446),
            ('loss10', 'practical'):
                (0.022475182706261903, 0.5, 0.0005290288954861169),
            ('loss30', 'theoretical'):
                (0.008173313116187126, 0.5, 0.0004635983524227894),
            ('loss30', 'practical'):
                (0.024466508540717365, 0.5, 0.0005811119689816996),
            ('delay1', 'theoretical'):
                (0.0063821223137202066, 0.5, 0.000403421220026379),
            ('delay1', 'practical'):
                (0.01804966818612238, 0.5, 0.000402830055262794),
            ('delay4', 'theoretical'):
                (0.0030518176927745756, 0.5, 0.00019508468590692524),
            ('delay4', 'practical'):
                (0.00843330610637028, 0.5, 9.531448660546134e-05),
            ('stale1', 'theoretical'):
                (0.0063821223137202066, 0.5, 0.000403421220026379),
            ('stale1', 'practical'):
                (0.01804966818612238, 0.5, 0.000402830055262794),
            ('stale8', 'theoretical'):
                (0.0003953688619551021, 0.5, 6.3309167189875884e-06),
            ('stale8', 'practical'):
                (0.0010604124086832924, 0.5, 4.435499465664309e-06),
        },
    },
    'smoke': {
        'cells': {
            ('clean', 'theoretical', 0.001): (1.0, 1.0, 0.012341571971774101),
            ('clean', 'theoretical', 0.1):
                (0.690625011920929, 0.690625011920929, 0.02286679483950138),
            ('clean', 'practical', 0.001): (1.0, 1.0, 0.012341571971774101),
            ('clean', 'practical', 0.1):
                (0.8343750238418579, 0.8343750238418579, 0.014100773259997368),
            ('loss10', 'theoretical', 0.001):
                (1.0, 0.9000000357627869, 0.015079209581017494),
            ('loss10', 'theoretical', 0.1):
                (0.75, 0.6812500357627869, 0.0234906617552042),
            ('loss10', 'practical', 0.001):
                (1.0, 0.9000000357627869, 0.015079209581017494),
            ('loss10', 'practical', 0.1):
                (0.878125011920929, 0.796875, 0.016711385920643806),
            ('loss30', 'theoretical', 0.001):
                (1.0, 0.6500000357627869, 0.012597629800438881),
            ('loss30', 'theoretical', 0.1):
                (0.7437500357627869,
                 0.46562498807907104,
                 0.022905277088284492),
            ('loss30', 'practical', 0.001):
                (1.0, 0.6500000357627869, 0.012597629800438881),
            ('loss30', 'practical', 0.1):
                (0.8812499642372131, 0.565625011920929, 0.01562456227838993),
            ('delay4', 'theoretical', 0.001):
                (0.996874988079071, 0.996874988079071, 0.0065615978091955185),
            ('delay4', 'theoretical', 0.1):
                (0.6968750357627869, 0.6968750357627869, 0.007517645135521889),
            ('delay4', 'practical', 0.001): (1.0, 1.0, 0.0065615978091955185),
            ('delay4', 'practical', 0.1):
                (0.78125, 0.78125, 0.006534690037369728),
        },
        'best_lambda': {
            ('clean', 'theoretical'):
                (0.1, 0.690625011920929, 0.02286679483950138),
            ('clean', 'practical'):
                (0.1, 0.8343750238418579, 0.014100773259997368),
            ('loss10', 'theoretical'): (0.1, 0.75, 0.0234906617552042),
            ('loss10', 'practical'):
                (0.1, 0.878125011920929, 0.016711385920643806),
            ('loss30', 'theoretical'):
                (0.1, 0.7437500357627869, 0.022905277088284492),
            ('loss30', 'practical'):
                (0.1, 0.8812499642372131, 0.01562456227838993),
            ('delay4', 'theoretical'):
                (0.1, 0.6968750357627869, 0.007517645135521889),
            ('delay4', 'practical'): (0.1, 0.78125, 0.006534690037369728),
        },
    },
}

# The tabular studies draw JAX's streams (the channel's drop draws too)
# and reproduce every decision and delivery, so both rates agree to
# float32 rounding of their means; J as in the heterogeneity study (1e-6
# absolute plus 1e-4 relative: float32 terms summed in another order); a
# budget answer's lambda, interpolated in log lambda, within 1e-5
FIELDS = dict(cells=("comm_rate", "delivered_rate", "J_final"),
              best_lambda=("lam", "comm_rate", "J_final"))
TOL = dict(comm_rate=(1e-6, 0.0), delivered_rate=(1e-6, 0.0),
           J_final=(1e-6, 1e-4), lam=(0.0, 1e-5))


def headlines(rows: list[dict]) -> dict:
    """The cells and budget answers, keyed as ``JAX_0_9_0``'s tables."""
    return dict(
        cells={(r["channel"], r["mode"], r["lam"]):
               (r["comm_rate"], r["delivered_rate"], r["J_final"])
               for r in rows if "delivered_rate" in r},
        best_lambda={(r["channel"], r["mode"]):
                     (r["lam"], r["comm_rate"], r["J_final"])
                     for r in rows
                     if str(r.get("query", "")).startswith("best_lambda")})


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Every cell and budget answer against JAX 0.9.0's at this scale.  A
    decision tie in a cell goes to ``ties``, and the budget answer that
    interpolates over that cell (its channel and mode) is set aside with
    it."""
    want = want or JAX_0_9_0["smoke" if smoke else "full"]
    cfg = _scale(smoke)
    got = headlines(rows)
    found = []
    out = common.compare("degraded_edge cells", got["cells"], want["cells"],
                         FIELDS["cells"], TOL, ties=found,
                         decisions=(len(cfg["seeds"]) * cfg["envs"]
                                    * cfg["iters"] * cfg["agents"]))
    skip = {key[:2] for _, key in found}
    keep = {k: v for k, v in want["best_lambda"].items() if k not in skip}
    out += common.compare("degraded_edge best_lambda",
                          {k: v for k, v in got["best_lambda"].items()
                           if k in keep}, keep,
                          FIELDS["best_lambda"], TOL)
    if ties is not None:
        ties += found
    return out
