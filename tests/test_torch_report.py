"""repro_torch.experiments.{report,query}: the report pipeline and the
threshold queries, held against the reference.

* the port's ``generate_report`` over a copy of each committed store of
  the JAX package (heterogeneity, degraded_edge, td_speedup) writes the
  committed artifact bytes exactly, twice over; ``index.json`` differs
  only in ``store`` and ``jax_loaded`` / ``torch_loaded``;
* every renderer, ``figure_rows`` and the query functions give the
  reference's answers on identical arrays, and ``figure_rows`` mirrors
  the port's own ``tradeoff_rows``;
* the report path (library and CLI) never imports torch (subprocess).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import trigger as jtrigger  # noqa: E402
from repro.experiments import query as jquery  # noqa: E402
from repro.experiments import report as jreport  # noqa: E402
from repro.experiments import store as jstore  # noqa: E402

from repro_torch.core.algorithm1 import ParamSampler  # noqa: E402
from repro_torch.core.trigger import theorem1_bound  # noqa: E402
from repro_torch.envs import GridWorld  # noqa: E402
from repro_torch.experiments import query, report  # noqa: E402
from repro_torch.experiments import store as tstore  # noqa: E402
from repro_torch.experiments.runtime import store_result  # noqa: E402
from repro_torch.experiments.sweep import (SweepSpec, run_sweep,  # noqa: E402
                                           tradeoff_rows)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "experiments", "bench")
STUDIES = ("heterogeneity", "degraded_edge", "td_speedup")


def _copy_store(study, tmp_path):
    """A copy of a committed store: never render or poison one in place."""
    dst = str(tmp_path / f"{study}-store")
    shutil.copytree(os.path.join(BENCH, study, "store"), dst)
    return dst


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


# ------------------------------------------- committed artifacts, exactly --


@pytest.mark.parametrize("study", STUDIES)
def test_report_reproduces_committed_artifacts(study, tmp_path):
    root = _copy_store(study, tmp_path)
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    idx = report.generate_report(tstore.SweepStore(root), out_a)
    report.generate_report(tstore.SweepStore(root), out_b)
    got, again = _files(out_a), _files(out_b)
    assert got == again                       # byte-stable rendering
    want = _files(os.path.join(BENCH, study, "report"))
    assert sorted(got) == sorted(want)
    for name in want:
        if name != "index.json":
            assert got[name] == want[name], name
    mine, theirs = (json.loads(got["index.json"]),
                    json.loads(want["index.json"]))
    # the flag reads the process it ran in: this one holds torch
    assert mine.pop("torch_loaded") is ("torch" in sys.modules)
    theirs.pop("jax_loaded")
    assert mine.pop("store") == os.path.abspath(root)
    theirs.pop("store")
    assert mine == theirs
    assert idx["artifacts"] == mine["artifacts"]


# ------------------------------------------------ renderers on same arrays --


def _pair(spec, axes, arrays, extra=None, h="ab" * 32):
    """The same entry as the port's and the reference's StoredSweep."""
    kw = dict(spec=spec, spec_hash=h, family_hash="cd" * 32, axes=axes,
              arrays=arrays, extra=dict(extra or {}))
    return tstore.StoredSweep(**kw), jstore.StoredSweep(**kw)


def _grid(rng, shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _entries():
    rng = np.random.default_rng(7)
    lams = [1e-4, 1e-3, 1e-2, 1e-1]
    base = dict(modes=["theoretical", "practical"], lambdas=lams,
                rhos=[0.9, 0.99], seeds=[0, 1], eps=0.5, num_iterations=20)
    out = {}
    axes = ("mode", "lam", "rho", "seed")
    out["tradeoff"] = _pair(base, axes, {
        "trace/comm_rate": _grid(rng, (2, 4, 2, 2)),
        "trace/j_final": _grid(rng, (2, 4, 2, 2), 0.01, 2.0)})
    out["tradeoff_no_j"] = _pair(base, axes, {
        "trace/comm_rate": _grid(rng, (2, 4, 2, 2))})
    out["fig2"] = _pair(base, ("param_set",) + axes, {
        "trace/comm_rate": _grid(rng, (3, 2, 4, 2, 2)),
        "trace/j_final": _grid(rng, (3, 2, 4, 2, 2), 0.01, 2.0)},
        {"figure": "fig2", "regimes": ["easy", "mid", "hard"]})
    N, n, m = 16, 6, 3
    alphas = (rng.uniform(size=(1, 3, 1, 1, N, m)) < 0.3).astype(np.float32)
    out["fig3"] = _pair(dict(base, lambdas=lams[:3], rhos=[0.99], seeds=[0]),
                        axes, {
        "trace/comm_rate": _grid(rng, (1, 3, 1, 1)),
        "trace/j_final": _grid(rng, (1, 3, 1, 1), 1e-5, 1e-2),
        "trace/weights": _grid(rng, (1, 3, 1, 1, N + 1, n), -1, 1),
        "trace/alphas": alphas},
        {"figure": "fig3", "wstar": rng.uniform(-1, 1, n).tolist(),
         "panels": [["left", 1e-4], ["middle", 1e-3], ["right", 1e-2]]})
    out["theorem1"] = _pair(dict(base, modes=["theoretical"]), axes, {
        "trace/comm_rate": _grid(rng, (1, 4, 2, 2)),
        "trace/j_final": _grid(rng, (1, 4, 2, 2), 0.01, 1.0)},
        {"figure": "theorem1", "j_w0": 1.3, "j_wstar": 0.2,
         "trace_phi_g": 0.7})
    out["comm_savings"] = _pair(base, ("lam",), {
        "comm_rate": _grid(rng, (4,)),
        "bytes_per_step_gated": _grid(rng, (4,), 1e3, 1e6),
        "bytes_per_step_full": _grid(rng, (4,), 1e6, 2e6)},
        {"figure": "comm_savings", "agents": 8, "grad_bytes": 123456})
    return out


@pytest.mark.parametrize("name", ["tradeoff", "tradeoff_no_j", "fig2",
                                  "fig3", "theorem1", "comm_savings"])
def test_render_entry_matches_reference(name):
    mine, theirs = _entries()[name]
    got, want = report.render_entry(mine), jreport.render_entry(theirs)
    assert got["figure"] == want["figure"]
    assert report._json_text(got["rows"]) == jreport._json_text(want["rows"])
    assert got["svg"] == want["svg"]


@pytest.mark.parametrize("study", STUDIES)
def test_figure_rows_and_queries_match_reference(study):
    root = os.path.join(BENCH, study, "store")     # read only
    ts, js = tstore.SweepStore(root), jstore.SweepStore(root)
    budgets = [0.0, 0.01, 0.05, 0.2, 0.5, 1.0]
    for h in ts.hashes():
        mine, theirs = ts.get(h, verify=True), js.get(h, verify=True)
        assert report.figure_rows(mine) == jreport.figure_rows(theirs)
        for mode in mine.modes:
            select = ({"env_set": 5} if "env_set" in mine.axes else None)
            for sel in (None, select):
                if sel is None and "channel" in mine.axes:
                    sel = {"channel": 3}
                c = query.tradeoff_curve(mine, mode=mode, select=sel)
                jc = jquery.tradeoff_curve(theirs, mode=mode, select=sel)
                assert c.as_rows() == jc.as_rows()
                assert query.pareto_front(c) == jquery.pareto_front(jc)
                assert query.best_lambda_batch(c, budgets) == \
                    jquery.best_lambda_batch(jc, budgets)
                for b in budgets:
                    assert query.best_lambda(c, b) == jquery.best_lambda(jc, b)
                for lam in (c.lambdas[0], np.sqrt(c.lambdas[0]
                                                  * c.lambdas[-1])):
                    assert query.tradeoff_at(c, lam) == \
                        jquery.tradeoff_at(jc, lam)


@pytest.mark.parametrize("comm", [(1.0, 0.6, 0.3, 0.1), (1.0, 0.3, 0.6, 0.1),
                                  (0.9, 0.9, 0.9, 0.9)])
def test_queries_match_reference_on_synthetic_curves(comm):
    """Monotone, non-monotone (the skipped crossing) and flat curves, with
    and without J; and the errors the reference raises."""
    lams = np.asarray([1e-4, 1e-3, 1e-2, 1e-1])
    for j in (np.asarray([0.01, 0.02, 0.05, 0.2]), None):
        c = query.TradeoffCurve("theoretical", 0.9, lams, np.asarray(comm),
                                j, "h")
        jc = jquery.TradeoffCurve("theoretical", 0.9, lams, np.asarray(comm),
                                  j, "h")
        budgets = [0.0, 0.1, 0.2, 0.45, 0.9, 1.0]
        assert query.best_lambda_batch(c, budgets) == \
            jquery.best_lambda_batch(jc, budgets)
        assert [query.best_lambda(c, b) for b in budgets] == \
            query.best_lambda_batch(c, budgets)
        assert query.pareto_front(c) == jquery.pareto_front(jc)
        for bad in (-0.1, 1.5, float("nan")):
            with pytest.raises(ValueError):
                query.best_lambda(c, bad)
            with pytest.raises(ValueError):
                query.best_lambda_batch(c, [0.2, bad])
        with pytest.raises(ValueError, match="run_sweep_extend"):
            query.tradeoff_at(c, 1.0)


def test_theorem1_rhs_matches_port_bound():
    # one copy of eq. 12, torch-free, shared by the report and core.trigger
    assert report.theorem1_bound is theorem1_bound
    for lam, rho in ((1e-3, 0.9), (1e-1, 0.999)):
        want = float(jtrigger.theorem1_bound(lam, rho, 0.5, 40, 1.3, 0.2, 0.7))
        assert theorem1_bound(lam, rho, 0.5, 40, 1.3, 0.2, 0.7) == \
            pytest.approx(want, rel=1e-12)


def test_figure_rows_mirror_ports_tradeoff_rows(tmp_path):
    gw = GridWorld()
    w0 = np.zeros(gw.num_states, np.float32)
    prob = gw.vfa_problem(w0)
    spec = SweepSpec(modes=("theoretical", "practical"),
                     lambdas=(1e-3, 1e-1), seeds=(0, 1),
                     rhos=(prob.min_rho(0.5) * 1.0001,), eps=0.5,
                     num_iterations=12, num_agents=2, trace="summary")
    sampler = ParamSampler(gw.sampler_fn(10), gw.agent_params(w0, 2))
    res = run_sweep(spec, sampler, w0, prob, device="cpu")
    s = tstore.SweepStore(str(tmp_path / "store"))
    store_result(s, spec, res)
    got = {(r["mode"], r["lam"]): r for r in report.figure_rows(s.get(spec))}
    want = tradeoff_rows(res, spec)
    assert len(got) == len(want) == 4
    for w in want:
        g = got[(w["mode"], w["lam"])]
        for k in ("comm_rate", "J_final", "metric8"):
            assert g[k] == pytest.approx(w[k], rel=1e-6)


# -------------------------------------------------- torch stays out -------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    return env


def test_report_path_never_imports_torch(tmp_path):
    root = _copy_store("degraded_edge", tmp_path)
    out = str(tmp_path / "report")
    code = (
        "import sys\n"
        "from repro_torch.experiments import generate_report, SweepStore\n"
        f"idx = generate_report(SweepStore({root!r}), {out!r})\n"
        "assert idx['artifacts'], 'nothing rendered'\n"
        "assert 'torch' not in sys.modules, 'torch in the report path'\n"
        "assert idx['torch_loaded'] is False\n"
        "print('REPORT-TORCH-FREE-OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "REPORT-TORCH-FREE-OK" in r.stdout
    cli = str(tmp_path / "cli")
    r = subprocess.run([sys.executable, "-m", "repro_torch.experiments.report",
                        root, "--out", cli], capture_output=True, text=True,
                       env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    index = json.loads(r.stdout)
    assert index["torch_loaded"] is False and index["entries"] == 1
    assert _files(cli) == _files(out)
