"""The port's study harness: the paper's figure studies and the chaos
matrix on ``repro_torch`` (``benchmarks/run.py``'s counterpart).

Prints ``name,us_per_call,derived`` CSV per row and writes each suite's
rows to ``experiments/bench/torch/<suite>.json``, after the suite's
``gate`` (``check_bench.check_suite`` against the reference's committed
rows) passes; any violation fails the run.  Each figure study's headline
numbers are also held to JAX 0.9.0's (its ``fidelity``): a miss is
printed and fails the run, but the rows are still written.

  PYTHONPATH=src python -m benchmarks.torch_run                  # all, cuda
  PYTHONPATH=src python -m benchmarks.torch_run --only fig2,theorem1
  PYTHONPATH=src python -m benchmarks.torch_run --smoke --device cpu \
      --out-dir /tmp/rows                                        # rehearsal

``--smoke`` runs each suite's seconds-scale grid; its rows are written
only with ``--out-dir`` (they would overwrite the real numbers).
``--store ROOT`` makes the store-aware studies persist to (and reuse)
that ``SweepStore``; ``--from-store ROOT`` regenerates every figure
artifact of that store through the torch-free report pipeline
(``torch_report_regen``) and runs nothing else.  ``--device`` (default
cuda) is where the studies run; without a GPU pass ``--device cpu``.

Imports nothing of ``repro`` and never JAX.
"""

from __future__ import annotations

import argparse
import sys
import time

from benchmarks import (torch_agents_scaling, torch_chaos, torch_comm_savings,
                        torch_degraded_edge, torch_fig2_grid_tradeoff,
                        torch_fig3_continuous, torch_heterogeneity,
                        torch_report_regen, torch_td_speedup,
                        torch_theorem1_bound)
from benchmarks.common import save_rows
from benchmarks.torch_common import OUT_DIR

SUITES = {
    "fig2": torch_fig2_grid_tradeoff,
    "fig3": torch_fig3_continuous,
    "theorem1": torch_theorem1_bound,
    "agents_scaling": torch_agents_scaling,
    "heterogeneity": torch_heterogeneity,
    "degraded_edge": torch_degraded_edge,
    "td_speedup": torch_td_speedup,
    "comm_savings": torch_comm_savings,
    "report_regen": torch_report_regen,
    "chaos": torch_chaos,
}

# suites that accept store= (persist results / reuse cached sweeps)
STORE_AWARE = {"fig2", "fig3", "theorem1", "comm_savings", "heterogeneity",
               "degraded_edge", "td_speedup", "report_regen"}


def resolve_suites(only):
    """Validate a ``--only`` value into a list of suite names.

    ``None`` means every suite.  Names are comma-separated; surrounding
    whitespace is tolerated.  An unknown name, or a value with no names at
    all (``--only ""``), raises ``ValueError`` naming the offender and the
    valid choices.
    """
    if only is None:
        return list(SUITES)
    names = [n.strip() for n in only.split(",") if n.strip()]
    if not names:
        raise ValueError("--only given but named no suite "
                         f"(choose from {', '.join(SUITES)})")
    for name in names:
        if name not in SUITES:
            raise ValueError(f"unknown suite {name!r} "
                             f"(choose from {', '.join(SUITES)})")
    return names


def _derived(row: dict) -> str:
    for key in ("J_final", "rhs_bound", "tx_junk", "overhead_pct",
                "savings_pct", "speedup", "speedup_vs_m1",
                "run_agent_steps_per_s", "byte_deterministic",
                "artifacts", "recovered_bitwise"):
        if key in row:
            return f"{key}={row[key]}"
    return ""


def _label(name: str, row: dict) -> str:
    label = row.get("bench", name)
    sub = [str(row[k]) for k in ("regime", "fleet_class", "channel", "mode",
                                 "site", "kind", "query", "panel", "stage",
                                 "lam", "agents", "m", "suite")
           if k in row]
    return label + ("[" + "/".join(sub) + "]" if sub else "")


def run_suite(name: str, smoke: bool, store, device: str) -> tuple:
    """One suite: ``(rows, gate violations, fidelity misses, ties)``; a
    tie is a decision that falls the other way than in JAX 0.9.0 by a
    whole decision or two, reported and not failed."""
    mod = SUITES[name]
    kwargs = dict(smoke=smoke, device=device)
    if name in STORE_AWARE and store:
        kwargs["store"] = store
    rows = mod.run(**kwargs)
    ties: list = []
    misses = (mod.fidelity(rows, smoke, ties=ties)
              if hasattr(mod, "fidelity") else [])
    return rows, mod.gate(rows), misses, sorted(set(ties), key=repr)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None, metavar="SUITE[,SUITE...]",
                    help="run one or more comma-separated suites: "
                         + ",".join(SUITES))
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale grids; skips JSON output (unless "
                         "--out-dir is given)")
    ap.add_argument("--out-dir", default=None, metavar="DIR", dest="out_dir",
                    help="write per-suite JSON here instead of "
                         "experiments/bench/torch/; also enables JSON under "
                         "--smoke")
    ap.add_argument("--store", default=None, metavar="ROOT",
                    help="SweepStore root: the store-aware studies persist "
                         "and reuse their sweeps there")
    ap.add_argument("--from-store", default=None, metavar="ROOT",
                    dest="from_store",
                    help="regenerate the figure artifacts of this SweepStore "
                         "through the torch-free report pipeline")
    ap.add_argument("--device", default="cuda",
                    help="where the studies run (default cuda)")
    args = ap.parse_args(argv)
    try:
        only = None if args.only is None else resolve_suites(args.only)
    except ValueError as e:
        ap.error(str(e))
    if args.from_store:
        if only not in (None, ["report_regen"]):
            ap.error("--from-store regenerates through the report pipeline; "
                     "combine it only with --only report_regen")
        names = ["report_regen"]
    else:
        names = only if only else list(SUITES)

    print("name,us_per_call,derived", flush=True)
    failures = 0
    for name in names:
        t0 = time.time()
        try:
            rows, violations, misses, ties = run_suite(
                name, args.smoke, args.from_store or args.store, args.device)
        except Exception as e:  # keep the harness going; report at the end
            print(f"{name},ERROR,{type(e).__name__}:{e}", flush=True)
            failures += 1
            continue
        for row in rows:
            print(f"{_label(name, row)},{row.get('us_per_call', 0):.1f},"
                  f"{_derived(row)}", flush=True)
        for line in violations + misses:
            print(f"FAIL {line}", file=sys.stderr, flush=True)
        for label, key in ties:
            print(f"TIE {label} {key}: a decision fell the other way than "
                  "in JAX 0.9.0", file=sys.stderr, flush=True)
        failures += bool(violations) + bool(misses)
        if not violations and (args.out_dir or not args.smoke):
            save_rows(name, rows, out_dir=args.out_dir or OUT_DIR)
        print(f"# {name} done in {time.time() - t0:.1f}s", file=sys.stderr,
              flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
