"""Fig. 3 and the TD(0) linear-speedup study on the port against the
reference, at smoke scale on the CPU (``benchmarks/torch_fig3_continuous
.py``, ``torch_td_speedup.py``).  Each reference study runs once; the
port's rows must pass the reference rows' schema, hold their headline
numbers within ``FIG3_TOL`` and ``TD_TOL`` (the modules' stated bounds),
and a warm store must compute nothing."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks.check_bench import check_suite  # noqa: E402
from benchmarks import fig3_continuous as j_fig3  # noqa: E402
from benchmarks import td_speedup as j_td  # noqa: E402
from benchmarks import torch_fig3_continuous as t_fig3  # noqa: E402
from benchmarks import torch_td_speedup as t_td  # noqa: E402

from study_parity import (ExecSpy, one_thread, run_pair,  # noqa: E402
                          store_of)

STUDIES = {"fig3": (j_fig3, t_fig3), "td_speedup": (j_td, t_td)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, (ref, port) in STUDIES.items():
        root = tmp_path_factory.mktemp(name)
        jax_rows, torch_rows = run_pair(ref, port, root)
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


def test_fig3_large_lambda_communicates_less(runs):
    h = t_fig3.headlines(runs["fig3"]["torch"])
    assert (h["left_infrequent"]["comm_rate"]
            <= h["middle_frequent"]["comm_rate"])


def test_td_speedup_grows_with_the_fleet(runs):
    """The always mode's speedup rises with m, in the port as in the
    reference (check_bench's m-monotone rule holds both)."""
    for rows in (runs["td_speedup"]["jax"], runs["td_speedup"]["torch"]):
        s = sorted((r["m"], r["speedup_vs_m1"]) for r in rows
                   if r.get("mode") == "always" and "speedup_vs_m1" in r)
        assert [m for m, _ in s] == [1, 4, 16]
        assert all(a < b for (_, a), (_, b) in zip(s, s[1:]))


def test_study_constants_match_the_reference_modules():
    """The port's studies run the reference's settings: the moved
    ``TD_STUDY`` is td_speedup's full scale, Fig. 3's sizes and panels are
    fig3_continuous's."""
    s = t_td.TD_STUDY
    assert {k: s[k] for k in j_td._scale(False)} == j_td._scale(False)
    assert (s["gamma"], s["eps"], s["noise_scale"], s["rho"], s["lam"],
            s["tail_frac"]) == (j_td.GAMMA, j_td.EPS, j_td.NOISE_SCALE,
                                j_td.RHO, j_td.LAM, j_td.TAIL_FRAC)
    assert (t_fig3.N, t_fig3.T, t_fig3.PANELS_2) == (j_fig3.N, j_fig3.T,
                                                     j_fig3.PANELS_2)
    assert sorted(t_fig3.FIG3_JAX) == sorted(t_fig3.FIG3_COMMITTED)
