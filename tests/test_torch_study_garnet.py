"""The garnet-family studies on the port against the reference, at smoke
scale on the CPU: heterogeneity (``benchmarks/torch_heterogeneity.py``,
two fleet classes) and the degraded edge (``torch_degraded_edge.py``,
four channels at smoke scale).  Each reference study runs once into a
fresh store; the port's rows must pass the reference rows' schema, match
the headline numbers (cells, budget answers, the junk agents'
transmissions) at the module's stated tolerance, and a warm store must
compute nothing."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks.check_bench import check_suite  # noqa: E402
from benchmarks import degraded_edge as j_edge  # noqa: E402
from benchmarks import heterogeneity as j_het  # noqa: E402
from benchmarks import torch_degraded_edge as t_edge  # noqa: E402
from benchmarks import torch_heterogeneity as t_het  # noqa: E402
from repro.experiments.store import SweepStore as JaxStore  # noqa: E402

from study_parity import (ExecSpy, one_thread, run_pair,  # noqa: E402
                          store_of)

STUDIES = {"heterogeneity": (j_het, t_het), "degraded_edge": (j_edge, t_edge)}


def _jax_tx_rows(root):
    """The reference's mixed-class transmissions as the port's
    ``tx_per_agent`` rows, read from the reference's own store."""
    store = JaxStore(store_of(root, "jax"))
    entry = next(e for e in map(store.get, store.hashes())
                 if e.extra.get("fleet_class") == "mixed")
    return [dict(bench="heterogeneity", fleet_class="mixed", mode=mode,
                 lam=lam, query="tx_per_agent", tx_clean=c, tx_junk=j)
            for (mode, lam), (c, j) in t_het.tx_per_agent(entry).items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (ref, port) in STUDIES.items():
        root = tmp_path_factory.mktemp(name)
        jax_rows, torch_rows = run_pair(ref, port, root)
        if name == "heterogeneity":
            jax_rows = jax_rows + _jax_tx_rows(root)
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
    want = port.headlines(r["jax"])
    ties = []
    assert port.fidelity(r["torch"], True, want=want, ties=ties) == []
    assert ties == []
    got = port.headlines(r["torch"])
    assert all(sorted(got[k]) == sorted(want[k]) for k in want)


@pytest.mark.parametrize("name", list(STUDIES))
def test_recorded_jax_numbers_are_the_reference_run(runs, name):
    port = STUDIES[name][1]
    r = runs[name]
    assert port.fidelity(r["jax"], True) == []
    assert port.fidelity(r["torch"], True) == []


@pytest.mark.parametrize("name", list(STUDIES))
def test_warm_store_computes_nothing(runs, name, monkeypatch):
    port = STUDIES[name][1]
    r = runs[name]
    spy = ExecSpy(monkeypatch)
    with one_thread():
        again = port.run(smoke=True, store=str(store_of(r["root"], "torch")),
                         device="cpu")
    assert spy.calls == 0
    assert port.headlines(again) == port.headlines(r["torch"])


@pytest.mark.parametrize("name", list(STUDIES))
def test_report_renders_beside_the_store(runs, name):
    (report,) = [row for row in runs[name]["torch"]
                 if row.get("suite") == "report"]
    assert report["artifacts"] >= 1
    assert (runs[name]["root"] / "torch" / "report").is_dir()


def test_junk_agents_transmit_less_under_the_theoretical_trigger(runs):
    h = t_het.headlines(runs["heterogeneity"]["torch"])["tx_per_agent"]
    for (mode, lam), (clean, junk) in h.items():
        if mode == "theoretical":
            assert junk <= clean


def test_loss_channel_delivers_less_than_it_attempts(runs):
    rows = runs["degraded_edge"]["torch"]
    assert t_edge.delivered_over_attempted(rows, "clean") == 1.0
    assert t_edge.delivered_over_attempted(rows, "loss30") < 1.0
