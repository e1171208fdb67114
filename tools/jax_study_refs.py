#!/usr/bin/env python3
"""The reference's figure studies at full scale under JAX on the CPU: the
headline numbers that the port's studies (``benchmarks/torch_*.py``) hold
their own against.

Runs ``benchmarks.<study>.run()`` of the JAX package for fig2, theorem1,
agents_scaling, fig3, heterogeneity, degraded_edge, td_speedup,
comm_savings and resume_query (and sweep_scaling's env_family suite's
sweep, in this process), each with a fresh temporary store where the
study takes one (the committed heterogeneity and degraded-edge stores
predate JAX 0.9.0's streams and are refused by their inputs digest), and
prints one JSON object a study with the quantities each port module keeps
as its ``*_JAX`` table (``--smoke``: at ``run(smoke=True)``'s scale, the
``smoke`` half of each table).  Needs jax (CPU); takes about 5 minutes,
most of it comm_savings.  Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py \
        [--smoke] [--only fig2,theorem1,...] [--out FILE]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))


def fig2(store, smoke):
    from benchmarks import fig2_grid_tradeoff as S
    rows = S.run(smoke=smoke)
    return {f"{r['regime']}/{r['mode']}/{r['lam']}":
            dict(comm_rate=r["comm_rate"], J_final=r["J_final"])
            for r in rows if "regime" in r}


def theorem1(store, smoke):
    from benchmarks import theorem1_bound as S
    rows = S.run(smoke=smoke)
    return [dict(lam=r["lam"], rho=r["rho"], lhs_empirical=r["lhs_empirical"],
                 rhs_bound=r["rhs_bound"], holds=r["holds"]) for r in rows]


def agents_scaling(store, smoke):
    from benchmarks import agents_scaling as S
    return {r["agents"]: dict(comm_rate=r["comm_rate"],
                              total_transmissions=r["total_transmissions"],
                              J_final=r["J_final"])
            for r in S.run(smoke=smoke)}


def fig3(store, smoke):
    from benchmarks import fig3_continuous as S
    return {r["panel"]: dict(comm_rate=r["comm_rate"],
                             first_tx_iter=r["first_tx_iter"],
                             J_final=r["J_final"],
                             w_err_quarterly=r["w_err_quarterly"])
            for r in S.run(smoke=smoke)}


def heterogeneity(store, smoke):
    from benchmarks import heterogeneity as S
    rows = S.run(smoke=smoke, store=store)
    cells = {f"{r['fleet_class']}/{r['mode']}/{r['lam']}":
             dict(comm_rate=r["comm_rate"], J_final=r["J_final"])
             for r in rows if "J_env_spread" in r}
    best = {f"{r['fleet_class']}/{r['mode']}":
            dict(lam=r["lam"], comm_rate=r["comm_rate"], J_final=r["J_final"])
            for r in rows if r.get("query")}
    # the mixed class's transmissions, by the port study's own reduction
    from benchmarks.torch_heterogeneity import tx_per_agent
    from repro.experiments.store import SweepStore
    st = SweepStore(store)
    mixed = next(e for e in map(st.get, st.hashes())
                 if e.extra.get("fleet_class") == "mixed")
    tx = {f"{mode}/{lam}": dict(clean=c, junk=j)
          for (mode, lam), (c, j) in tx_per_agent(mixed).items()}
    return dict(cells=cells, best_lambda=best, tx_per_agent=tx)


def degraded_edge(store, smoke):
    from benchmarks import degraded_edge as S
    rows = S.run(smoke=smoke, store=store)
    cells = {f"{r['channel']}/{r['mode']}/{r['lam']}":
             dict(comm_rate=r["comm_rate"],
                  delivered_rate=r["delivered_rate"], J_final=r["J_final"])
             for r in rows if "delivered_rate" in r}
    best = {f"{r['channel']}/{r['mode']}":
            dict(lam=r["lam"], comm_rate=r["comm_rate"], J_final=r["J_final"])
            for r in rows if r.get("query")}
    return dict(cells=cells, best_lambda=best)


def td_speedup(store, smoke):
    from benchmarks import td_speedup as S
    return {f"{r['mode']}/{r['m']}": dict(tail_error=r["tail_error"],
                                          speedup_vs_m1=r["speedup_vs_m1"])
            for r in S.run(smoke=smoke, store=store) if "tail_error" in r}


def env_family(store, smoke):
    """sweep_scaling's env_family suite: its subprocess's sweep, run here
    without the device mesh.  The suite's own subprocess shards the run
    axis with ``shard_map``, which JAX 0.9.0 refuses (a scan carry's
    varying-manual-axes type); the mesh only places runs on devices, so
    the sweep's numbers are the unsharded run's."""
    import jax.numpy as jnp
    import numpy as np
    from repro.core.algorithm1 import ParamSampler
    from repro.envs import family_sampler_fn, garnet_env_family
    from repro.experiments import SweepSpec, run_sweep
    cfg = (dict(env_instances=8, seeds=1, iters=20, agents=2) if smoke
           else dict(env_instances=64, seeds=2, iters=150, agents=4))
    envs, fam = garnet_env_family(cfg["env_instances"], num_states=20)
    w0 = jnp.zeros(20)
    spec = SweepSpec(
        modes=("theoretical", "practical"), lambdas=(1e-3,),
        seeds=tuple(range(cfg["seeds"])), rhos=(0.999,), eps=0.4,
        num_iterations=cfg["iters"], num_agents=cfg["agents"],
        trace="summary")
    sampler = ParamSampler(fn=family_sampler_fn(10),
                           params=envs[0].agent_params(w0, cfg["agents"]))
    res = run_sweep(spec, sampler, w0, env_sets=fam)
    jf = np.asarray(res.j_final, np.float64)
    env_ax = res.axes.index("env_set")
    non_env = tuple(i for i in range(jf.ndim) if i != env_ax)
    return dict(J_final_mean=float(jf.mean()),
                J_final_spread=float(np.std(jf.mean(axis=non_env))),
                comm_rate_mean=float(np.mean(np.asarray(res.comm_rate,
                                                        np.float64))))


def resume_query(store, smoke):
    from benchmarks import resume_query as S
    (row,) = [r for r in S.run(smoke=smoke) if r["bench"] == "query_latency"]
    return {k: row[k] for k in ("best_lam", "best_feasible", "pareto_points")}


def comm_savings(store, smoke):
    from benchmarks import comm_savings as S
    rows = S.run(smoke=smoke)
    return {r["lam"]: dict(comm_rate=r["comm_rate"],
                           loss_first=r["loss_first"],
                           loss_last=r["loss_last"]) for r in rows}


STUDIES = dict(fig2=fig2, theorem1=theorem1, agents_scaling=agents_scaling,
               fig3=fig3, heterogeneity=heterogeneity,
               degraded_edge=degraded_edge, td_speedup=td_speedup,
               comm_savings=comm_savings, env_family=env_family,
               resume_query=resume_query)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(STUDIES))
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the studies' smoke scale (run(smoke=True))")
    args = ap.parse_args()
    import jax
    out = {"jax": jax.__version__, "smoke": args.smoke}
    for name in args.only.split(","):
        tmp = tempfile.mkdtemp(prefix=f"jax_ref_{name}_")
        try:
            t0 = time.perf_counter()
            out[name] = STUDIES[name](os.path.join(tmp, "store"),
                                      args.smoke)
            out[f"{name}_wall_s"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({name: out[name]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
