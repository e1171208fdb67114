"""Heterogeneity study and store-backed report regeneration on the
PyTorch/CUDA port, end to end (``examples/heterogeneity_report.py`` on
``repro_torch``).

The zipped per-env fleet axis at example scale: a garnet family where
every instance carries its own agent fleet, swept under two fleet
classes, persisted to a SweepStore, queried, regenerated as report
artifacts (JSON + SVG) with no device work and no torch, and finally
garbage-collected down to the deliverable.  The script is idempotent:
re-running it computes nothing (every sweep hash-hits the store).

Its store, chunks and report live under ``--root`` (default the
git-ignored ``experiments/stores/torch_heterogeneity_example/``).

  PYTHONPATH=src python examples/torch_heterogeneity_report.py [--device cpu]
"""

import argparse
import os

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                    "experiments", "stores", "torch_heterogeneity_example")
E, M = 16, 4                       # 16 garnet instances, 4 agents each
CLASSES = (("homogeneous", 0), ("mixed", M // 2))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the CPU)")
    ap.add_argument("--root", default=ROOT,
                    help="where the store, chunks and report go")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import (family_sampler_fn, garnet_env_family,
                                  garnet_fleet_sets)
    from repro_torch.experiments import SweepSpec, generate_report, query
    from repro_torch.experiments.runtime import gc_finished, sweep_or_load
    from repro_torch.experiments.store import SweepStore

    dev = resolve_device(args.device)
    root = args.root
    # 1. the family: 16 random MDPs; the `mixed` class gives each instance
    #    a fleet with 2 junk agents stuck on an instance-specific state
    envs, fam = garnet_env_family(E, num_states=12, device=dev)
    w0 = np.zeros(12, np.float32)
    sampler = ParamSampler(fn=family_sampler_fn(8), params=None)
    store = SweepStore(os.path.join(root, "store"))

    out = dict(J={}, best={}, gc={})
    entries = {}
    for cls, junk in CLASSES:
        fleets = garnet_fleet_sets(envs, w0, M, num_junk=junk)
        spec = SweepSpec(
            modes=("theoretical", "practical"),
            lambdas=tuple(np.logspace(-3, -1, 3)), seeds=(0, 1),
            rhos=(0.999,), eps=0.4, num_iterations=60, num_agents=M,
            trace="summary", chunk_size=8,
            tag=f"het-{cls}")      # same grid, different fleets: tag it
        res = sweep_or_load(
            store, spec, sampler, w0, env_sets=fam, fleet_sets=fleets,
            store_dir=os.path.join(root, f"chunks-{cls}"),   # resumable
            extra={"figure": "heterogeneity", "fleet_class": cls},
            device=dev)
        entries[cls] = store.get(spec)
        jf = res.j_final.double().cpu().numpy()
        out["J"][cls] = (float(jf[:, 0].mean()), float(jf[:, 1].mean()))
        print(f"{cls:12s} J(theoretical) = {out['J'][cls][0]:.2e}   "
              f"J(practical) = {out['J'][cls][1]:.2e}")

    # 2. the deployment question per class: λ for a 50% comm budget (numpy
    #    over disk arrays, what serve_sweeps answers over HTTP)
    for cls, entry in entries.items():
        best = query.best_lambda(query.tradeoff_curve(entry,
                                                      mode="theoretical"),
                                 comm_budget=0.5)
        out["best"][cls] = best
        print(f"{cls:12s} 50% budget -> λ = {best['lam']:.2e}  "
              f"J = {best['J']:.2e}")

    # 3. regenerate the figure artifacts from the cold store (the torch-free
    #    path; `python -m repro_torch.experiments.report <store>` does the
    #    same)
    index = generate_report(store, os.path.join(root, "report"))
    out["artifacts"] = [a["json"] for a in index["artifacts"]]
    print("report artifacts:", out["artifacts"])

    # 4. retention: the summaries are in the store, so the chunk
    #    checkpoints are reclaimable recovery state (refused mid-run)
    for cls in entries:
        stats = gc_finished(os.path.join(root, f"chunks-{cls}"))
        out["gc"][cls] = stats
        print(f"gc {cls}: collected={stats['collected']} "
              f"files={stats['files']} bytes={stats['bytes']}")
    return out


if __name__ == "__main__":
    main()
