#!/usr/bin/env python3
"""How far the port's study rows sit from JAX 0.9.0's headline numbers.

Reads each suite's rows (``experiments/bench/torch/<suite>.json`` by
default, as ``python -m benchmarks.torch_run`` writes them) and prints,
per suite and headline field, the largest absolute and relative gap to
the study module's JAX 0.9.0 table at that scale (the numbers each
module's ``fidelity`` holds to its stated tolerance), with the number of
cells compared.  numpy and the stdlib only.  Run from the repository
root:

    python3 tools/study_gaps.py [--rows DIR] [--smoke] [suite ...]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmarks import torch_run  # noqa: E402
from benchmarks.torch_common import OUT_DIR  # noqa: E402

STUDIES = ("fig2", "theorem1", "agents_scaling", "fig3", "heterogeneity",
           "degraded_edge", "td_speedup", "comm_savings")


def _flat(got: dict, want: dict, fields) -> dict:
    out = {}
    for i, field in enumerate(fields):
        pairs = [(float(got[k][i]), float(w[i])) for k, w in want.items()
                 if k in got]
        out[field] = dict(
            cells=len(pairs),
            max_abs=max(abs(g - w) for g, w in pairs),
            max_rel=max(abs(g - w) / abs(w) if w else abs(g - w)
                        for g, w in pairs))
    return out


def gaps(name: str, rows: list[dict], smoke: bool) -> dict:
    mod = torch_run.SUITES[name]
    got = mod.headlines(rows)
    if name == "fig3":
        want = mod.FIG3_JAX_SMOKE if smoke else mod.FIG3_JAX
        per = {p: mod.panel_gaps(got[p], w) for p, w in want.items()}
        return {k: max(d[k] for d in per.values())
                for k in next(iter(per.values()))}
    if name == "td_speedup":
        want = mod.TD_JAX_SMOKE if smoke else mod.TD_JAX
        return {mode: max(abs(got[m][mode] / w[mode] - 1)
                          for m, w in want.items())
                for mode in mod.MODES}
    want = mod.JAX_0_9_0["smoke" if smoke else "full"]
    if isinstance(mod.FIELDS, dict):
        return {sec: _flat(got[sec], want[sec], fields)
                for sec, fields in mod.FIELDS.items()}
    return _flat(got, want, [f for f in mod.FIELDS if f != "holds"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default=OUT_DIR,
                    help="directory of <suite>.json rows")
    ap.add_argument("--smoke", action="store_true",
                    help="the rows are smoke-scale")
    ap.add_argument("suites", nargs="*", default=list(STUDIES))
    args = ap.parse_args()
    for name in args.suites:
        with open(os.path.join(args.rows, f"{name}.json")) as f:
            rows = json.load(f)
        print(json.dumps({name: gaps(name, rows, args.smoke)}))


if __name__ == "__main__":
    main()
