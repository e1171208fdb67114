"""The grid-MDP studies on the port against the reference, at smoke
scale on the CPU: Fig. 2's tradeoff (``benchmarks/torch_fig2_grid_tradeoff
.py``), Theorem 1's bound (``torch_theorem1_bound.py``) and agent-count
scaling (``torch_agents_scaling.py``).  Each reference study runs once;
the port's rows must pass the reference rows' schema, match the headline
numbers at the module's stated tolerance, and a warm store must compute
nothing."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks.check_bench import check_suite  # noqa: E402
from benchmarks import agents_scaling as j_agents  # noqa: E402
from benchmarks import fig2_grid_tradeoff as j_fig2  # noqa: E402
from benchmarks import theorem1_bound as j_thm1  # noqa: E402
from benchmarks import torch_agents_scaling as t_agents  # noqa: E402
from benchmarks import torch_fig2_grid_tradeoff as t_fig2  # noqa: E402
from benchmarks import torch_theorem1_bound as t_thm1  # noqa: E402

from study_parity import (ExecSpy, one_thread, run_pair,  # noqa: E402
                          store_of)

STUDIES = {"fig2": (j_fig2, t_fig2, True),
           "theorem1": (j_thm1, t_thm1, True),
           "agents_scaling": (j_agents, t_agents, False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (ref, port, takes_store) in STUDIES.items():
        root = tmp_path_factory.mktemp(name)
        jax_rows, torch_rows = run_pair(ref, port, root, takes_store)
        out[name] = dict(root=root, jax=jax_rows, torch=torch_rows)
    return out


@pytest.mark.parametrize("name", list(STUDIES))
def test_rows_pass_the_reference_schema(runs, name):
    r = runs[name]
    assert check_suite(name, r["jax"], r["torch"]) == []
    assert all(row["device"] == "cpu" for row in r["torch"])


@pytest.mark.parametrize("name", list(STUDIES))
def test_headlines_match_the_reference_run(runs, name):
    port = STUDIES[name][1]
    r = runs[name]
    assert port.fidelity(r["torch"], True,
                         want=port.headlines(r["jax"])) == []


@pytest.mark.parametrize("name", list(STUDIES))
def test_recorded_jax_numbers_are_the_reference_run(runs, name):
    """The module's JAX 0.9.0 table at smoke scale is what the reference
    gives here, and the port meets it."""
    port = STUDIES[name][1]
    r = runs[name]
    assert port.fidelity(r["jax"], True) == []
    assert port.fidelity(r["torch"], True) == []


@pytest.mark.parametrize("name", ["fig2", "theorem1"])
def test_warm_store_computes_nothing(runs, name, monkeypatch):
    port = STUDIES[name][1]
    r = runs[name]
    spy = ExecSpy(monkeypatch)
    phi_g = []
    monkeypatch.setattr(t_thm1, "trace_phi_g",
                        lambda *a, **kw: phi_g.append(a) or 0.0)
    with one_thread():
        again = port.run(smoke=True, store=str(store_of(r["root"], "torch")),
                         device="cpu")
    assert spy.calls == 0 and phi_g == []
    assert port.headlines(again) == port.headlines(r["torch"])


def test_fig2_junk_agent_regime_orders_the_triggers(runs):
    """Fig. 2's heterogeneous regime at the smallest lambda: the
    theoretical trigger transmits less than the practical one, in the port
    as in the reference."""
    for rows in (runs["fig2"]["jax"], runs["fig2"]["torch"]):
        h = t_fig2.headlines(rows)
        lam = min(k[2] for k in h)
        assert (h["heterogeneous", "theoretical", lam][0]
                <= h["heterogeneous", "practical", lam][0])


def test_theorem1_bound_holds_everywhere(runs):
    rows = runs["theorem1"]["torch"]
    assert rows and all(r["holds"] and r["slack"] >= 0 for r in rows)


def test_theorem1_trace_phi_g_draws_are_jax(runs):
    """Tr(Phi G) from the port's 60 threefry draws keyed 10_000 + s equals
    the reference's estimate (its rhs_bound at the bound's own inputs)."""
    j = {(r["lam"], r["rho"]): r["rhs_bound"] for r in runs["theorem1"]["jax"]}
    t = {(r["lam"], r["rho"]): r["rhs_bound"]
         for r in runs["theorem1"]["torch"]}
    assert sorted(j) == sorted(t)
    np.testing.assert_allclose([t[k] for k in j], list(j.values()),
                               rtol=1e-6)


def test_agents_scaling_total_transmissions_grow_with_the_fleet(runs):
    rows = sorted(runs["agents_scaling"]["torch"], key=lambda r: r["agents"])
    assert all(a["total_transmissions"] <= b["total_transmissions"]
               for a, b in zip(rows, rows[1:]))
    assert all(r["run_agent_steps_per_s"] > 0 for r in rows)
