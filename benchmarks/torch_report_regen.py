"""Report regeneration on the port: a cold port ``SweepStore`` to every
figure artifact with torch never imported (``benchmarks/report_regen.py``
on ``repro_torch``).

The regeneration runs in a subprocess that asserts neither torch nor JAX
enters ``sys.modules``: the figure JSONs and SVG charts come from arrays
already on disk, with no device work.  It runs twice, into separate
directories, and the trees are compared byte for byte, so a
nondeterministic renderer fails the study.

Store: ``store=`` (``torch_run --from-store``); else, at full scale, the
port's heterogeneity store when a heterogeneity run has left one
(``experiments/bench/torch/stores/heterogeneity/store``); else a
throwaway store that the port fills with a small fig2-style sweep and a
two-class heterogeneity study, on ``device``.  At full scale a
persistent store's report is published beside it (``<store>/../report``,
as every study renders its own); smoke and throwaway renders stay
scratch.
"""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from benchmarks import torch_common as common

_REGEN_CODE = r"""
import json, sys
from repro_torch.experiments.report import generate_report
from repro_torch.experiments.store import SweepStore
store_root, out_dir = sys.argv[1], sys.argv[2]
index = generate_report(SweepStore(store_root), out_dir)
assert "torch" not in sys.modules, "torch leaked into the report path"
assert index["torch_loaded"] is False
index["jax_loaded"] = "jax" in sys.modules
print(json.dumps(index))
"""


def _populate(store_root: str, device: str) -> None:
    """Fill an empty store with one entry per renderer family, made by the
    port (the regeneration below still runs torch-free)."""
    from benchmarks import torch_fig2_grid_tradeoff, torch_heterogeneity
    torch_fig2_grid_tradeoff.run(smoke=True, store=store_root, device=device)
    torch_heterogeneity.run(smoke=True, store=store_root, device=device)


def _regen(store_root: str, out_dir: str) -> dict:
    env = dict(os.environ, PYTHONPATH=common.SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-c", _REGEN_CODE, store_root, out_dir],
        capture_output=True, text=True, cwd=common.REPO, env=env,
        timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"report regeneration failed: {r.stderr[-800:]}")
    return json.loads(r.stdout)


def _identical_trees(a: str, b: str) -> bool:
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    if fa != fb:
        return False
    _, mismatch, errors = filecmp.cmpfiles(a, b, fa, shallow=False)
    return not mismatch and not errors


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    label = common.device_label(dev.type)
    het_store = os.path.join(common.STORE_DIR, "heterogeneity", "store")
    if store is None and not smoke and os.path.isdir(het_store):
        store = het_store
    tmp = None
    if store is None:
        tmp = tempfile.mkdtemp(prefix="torch_report_regen_")
        store = os.path.join(tmp, "store")
    store = os.fspath(getattr(store, "root", store))
    try:
        t0 = time.perf_counter()
        if not os.path.isdir(store) or not os.listdir(store):
            _populate(store, dev)
        populate_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as scratch:
            out_a = os.path.join(scratch, "report_a")
            out_b = os.path.join(scratch, "report_b")
            t0 = time.perf_counter()
            index = _regen(store, out_a)
            regen_s = time.perf_counter() - t0
            _regen(store, out_b)
            deterministic = _identical_trees(out_a, out_b)
            if tmp is None and not smoke:
                final = os.path.join(os.path.dirname(os.path.abspath(store)),
                                     "report")
                shutil.rmtree(final, ignore_errors=True)
                shutil.copytree(out_a, final)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    n_art = len(index["artifacts"])
    row = dict(bench="report_regen",
               us_per_call=regen_s * 1e6 / max(n_art, 1),
               store_entries=index["entries"], artifacts=n_art,
               figures=sorted({a["figure"] for a in index["artifacts"]}),
               jax_loaded=index["jax_loaded"],
               torch_loaded=index["torch_loaded"],
               byte_deterministic=deterministic, regen_wall_s=regen_s,
               populate_s=populate_s, device=label)
    if not deterministic:
        row["error"] = "report regeneration is not byte-deterministic"
    if index["jax_loaded"] or index["torch_loaded"]:
        row["error"] = "a framework leaked into the report path"
    return [row]


def gate(rows: list[dict]) -> list[str]:
    out = common.gate("report_regen", rows)
    return out + [f"report_regen: {r['error']}" for r in rows
                  if isinstance(r.get("error"), str)]
