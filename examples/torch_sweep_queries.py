"""Resumable sweeps and the trigger-threshold query service on the
PyTorch/CUDA port, end to end (``examples/sweep_queries.py`` on
``repro_torch``).

The deployment question the paper answers is "which λ?": what trigger
threshold hits my communication budget and what value-function error it
costs.  This example

  1. runs a λ frontier grid through the resumable runtime (kill it at any
     point and re-run: it picks up at the last finished chunk, bitwise),
  2. lands the summaries in an append-only SweepStore,
  3. extends the grid with extra λ points, computing only the new cells,
  4. answers budget queries from the store with no device work (the
     answers ``python -m repro_torch.experiments.serve_sweeps STORE``
     serves over HTTP),
  5. moves to the serving tier: a ``StoreRegistry`` precomputes the
     entry's ``QueryTable`` once, then a budget vector is one numpy
     lookup.

Its store and chunks live under ``--root`` (default the git-ignored
``experiments/stores/torch_sweep_queries/``).

  PYTHONPATH=src python examples/torch_sweep_queries.py [--device cpu]
"""

import argparse
import dataclasses
import os

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "experiments", "stores", "torch_sweep_queries")
BUDGETS = (0.8, 0.5, 0.2)
BUDGET_VECTOR = (0.05, 0.2, 0.5, 0.8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the CPU)")
    ap.add_argument("--root", default=ROOT,
                    help="where the store and the chunk checkpoints go")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import GridWorld
    from repro_torch.experiments import SweepSpec, query
    from repro_torch.experiments.runtime import (run_sweep_extend,
                                                 run_sweep_resumable)
    from repro_torch.experiments.store import SweepStore, spec_hash

    dev = resolve_device(args.device)
    root = args.root
    # 1. the experiment: a λ frontier on the windy grid (paper §V / Fig. 2)
    gw = GridWorld()
    prob = gw.vfa_problem(np.zeros(gw.num_states))
    w0 = np.zeros(gw.num_states, np.float32)
    spec = SweepSpec(
        modes=("theoretical", "practical"),
        lambdas=tuple(np.logspace(-4, -1, 6)),
        seeds=(0, 1, 2), rhos=(prob.min_rho(0.5) * 1.0001,), eps=0.5,
        num_iterations=200, num_agents=2,
        trace="summary",      # O(1)-memory streaming summaries
        chunk_size=6,         # checkpoint granularity: 6 runs per segment
    )
    sampler = ParamSampler(fn=gw.sampler_fn(10), params=gw.agent_params(w0, 2))

    store = SweepStore(os.path.join(root, "store"))
    chunks = []
    run_sweep_resumable(
        spec, sampler, w0, problem=prob,
        store_dir=os.path.join(root, "chunks"),   # kill + re-run => resume
        summary_store=store, device=dev,
        on_chunk=lambda i, n, restored: (chunks.append(restored), print(
            f"  chunk {i + 1}/{n} {'restored' if restored else 'computed'}")))
    print(f"sweep {spec_hash(spec)[:12]}… in store "
          f"({int(np.prod(spec.grid_shape))} runs)")

    # 2. extend the frontier: only the two new λ columns are computed
    wider = dataclasses.replace(spec, lambdas=spec.lambdas + (3e-1, 1.0))
    run_sweep_extend(store, wider, sampler, w0, problem=prob, device=dev)
    print(f"extended to {len(wider.lambdas)} λ points "
          f"(store entries: {len(store.hashes())})")

    # 3. deployment-time questions, answered from disk: no device, no torch
    #    needed on the serving host (repro_torch.experiments.serve_sweeps)
    entry = store.get(wider)
    curve = query.tradeoff_curve(entry, mode="theoretical")
    out = dict(chunks=chunks, store_entries=len(store.hashes()), best={})
    for budget in BUDGETS:
        best = query.best_lambda(curve, budget)
        out["best"][budget] = best
        tag = "" if best["feasible"] else "  (budget unmet — closest)"
        print(f"comm budget {budget:4.0%} -> λ = {best['lam']:.3e}  "
              f"comm = {best['comm_rate']:5.1%}  J = {best['J']:.3e}{tag}")
    out["pareto"] = [(r["comm_rate"], r["J"])
                     for r in query.pareto_front(curve)]
    print("pareto front (comm, J):",
          [(round(c, 3), round(j, 4)) for c, j in out["pareto"]])

    # 4. the serving tier: register the store once, query tables after
    from repro_torch.experiments import StoreRegistry

    reg = StoreRegistry([os.path.join(root, "store")])
    table = reg.table(spec_hash(wider))
    batch = table.best_lambda_batch(list(BUDGET_VECTOR))  # one numpy pass
    out["budget_vector"] = [b["lam"] for b in batch]
    out["registry_stats"] = dict(reg.stats)
    print("budget vector ->",
          [(b["comm_budget"], f"{b['lam']:.2e}") for b in batch])
    print("registry stats:", reg.stats)     # 1 entry load, then all hits

    store_path = os.path.normpath(os.path.join(root, "store"))
    print(f"\nserve it:  PYTHONPATH=src python -m "
          f"repro_torch.experiments.serve_sweeps {store_path}\n"
          f"then:      GET /query/best_lambda?budget=0.05,0.2,0.5 "
          f"| POST /query/batch")
    return out


if __name__ == "__main__":
    main()
