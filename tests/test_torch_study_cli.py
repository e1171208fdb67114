"""Report regeneration and the study harness on the port, on the CPU:
``benchmarks/torch_report_regen.py`` (a cold port store to every figure
artifact, torch-free, byte for byte twice, against the reference's
``report_regen``) and ``benchmarks/torch_run.py`` (``--only``,
``--smoke``, ``--out-dir``, ``--from-store``, ``--device``), whose
argument checks mirror ``tests/test_bench_cli.py``."""

import inspect
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks.check_bench import check_suite  # noqa: E402
from benchmarks import report_regen as j_regen  # noqa: E402
from benchmarks import torch_fig2_grid_tradeoff as t_fig2  # noqa: E402
from benchmarks import torch_report_regen as t_regen  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from benchmarks.torch_common import OUT_DIR  # noqa: E402

from study_parity import one_thread, run_pair  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _cli(*args, timeout=600):
    return subprocess.run([sys.executable, "-m", "benchmarks.torch_run",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=_env(), timeout=timeout)


@pytest.fixture(scope="module")
def regen(tmp_path_factory):
    jax_rows, torch_rows = run_pair(j_regen, t_regen,
                                    tmp_path_factory.mktemp("report_regen"),
                                    takes_store=False)
    return dict(jax=jax_rows, torch=torch_rows)


@pytest.fixture(scope="module")
def fig2_store(tmp_path_factory):
    """A cold port store holding a smoke-scale fig2 sweep."""
    store = tmp_path_factory.mktemp("fig2_store") / "store"
    with one_thread():
        t_fig2.run(smoke=True, store=str(store), device="cpu")
    return store


# ---------------------------------------------------- report regen -------


def test_report_regen_rows_pass_the_reference_schema(regen):
    assert check_suite("report_regen", regen["jax"], regen["torch"]) == []
    assert t_regen.gate(regen["torch"]) == []


def test_report_regen_is_framework_free_and_byte_stable(regen):
    (row,) = regen["torch"]
    assert row["byte_deterministic"] is True
    assert row["torch_loaded"] is False and row["jax_loaded"] is False
    assert "error" not in row
    (ref,) = regen["jax"]
    assert row["figures"] == ref["figures"]
    assert row["artifacts"] == ref["artifacts"]
    assert row["store_entries"] == ref["store_entries"]


def test_regen_subprocess_keeps_torch_out(fig2_store, tmp_path):
    """The regeneration child asserts torch never enters sys.modules, and
    two renders of one store are the same bytes."""
    a = t_regen._regen(str(fig2_store), str(tmp_path / "a"))
    b = t_regen._regen(str(fig2_store), str(tmp_path / "b"))
    assert a["torch_loaded"] is False and a["jax_loaded"] is False
    assert a["artifacts"] == b["artifacts"]
    assert t_regen._identical_trees(str(tmp_path / "a"), str(tmp_path / "b"))


def test_cli_from_store_regenerates_without_torch(fig2_store, tmp_path):
    out = tmp_path / "rows"
    p = _cli("--from-store", str(fig2_store), "--device", "cpu",
             "--out-dir", str(out))
    assert p.returncode == 0, p.stderr[-2000:]
    (row,) = json.loads((out / "report_regen.json").read_text())
    assert row["torch_loaded"] is False and row["byte_deterministic"] is True
    assert row["figures"] == ["fig2"]


# ----------------------------------------------------------- the CLI -----


def test_none_means_every_suite():
    assert torch_run.resolve_suites(None) == list(torch_run.SUITES)


def test_single_and_multiple_names_resolve_in_order():
    assert torch_run.resolve_suites("fig2") == ["fig2"]
    assert torch_run.resolve_suites("td_speedup,fig2") == ["td_speedup",
                                                           "fig2"]


def test_whitespace_and_trailing_commas_are_tolerated():
    assert torch_run.resolve_suites(" fig2 , td_speedup ,") == [
        "fig2", "td_speedup"]


def test_unknown_suite_raises_naming_it_and_the_choices():
    with pytest.raises(ValueError) as e:
        torch_run.resolve_suites("fig2,nope")
    assert "'nope'" in str(e.value) and "fig2" in str(e.value)


def test_empty_only_raises_instead_of_running_everything():
    for value in ("", " ", ",", " , "):
        with pytest.raises(ValueError, match="named no suite"):
            torch_run.resolve_suites(value)


def test_suites_are_this_slice_and_chaos():
    assert sorted(torch_run.SUITES) == sorted(
        ["fig2", "fig3", "theorem1", "agents_scaling", "heterogeneity",
         "degraded_edge", "td_speedup", "comm_savings", "report_regen",
         "chaos"])


@pytest.mark.parametrize("name", sorted(torch_run.SUITES))
def test_store_aware_suites_take_a_store(name):
    params = inspect.signature(torch_run.SUITES[name].run).parameters
    assert ("store" in params) == (name in torch_run.STORE_AWARE)
    assert params["device"].default == "cuda"


def test_cli_rejects_unknown_and_empty_only():
    for bad in ("nope", ""):
        p = _cli("--only", bad, timeout=120)
        assert p.returncode == 2, (bad, p.stdout, p.stderr)
        assert "suite" in p.stderr


def test_cli_from_store_runs_only_report_regen():
    p = _cli("--from-store", "x", "--only", "fig2", timeout=120)
    assert p.returncode == 2 and "report_regen" in p.stderr


def test_cli_smoke_writes_rows_only_with_out_dir(tmp_path):
    committed = os.path.join(OUT_DIR, "agents_scaling.json")
    before = (open(committed, "rb").read() if os.path.exists(committed)
              else None)
    p = _cli("--only", "agents_scaling", "--smoke", "--device", "cpu")
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[0] == "name,us_per_call,derived"
    after = (open(committed, "rb").read() if os.path.exists(committed)
             else None)
    assert after == before
    p = _cli("--only", "agents_scaling,theorem1", "--smoke", "--device",
             "cpu", "--out-dir", str(tmp_path))
    assert p.returncode == 0, p.stderr[-2000:]
    for name in ("agents_scaling", "theorem1"):
        rows = json.loads((tmp_path / f"{name}.json").read_text())
        assert rows and all(r["device"] == "cpu" for r in rows)


def test_cli_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = _cli("--only", "agents_scaling", "--smoke")
    assert p.returncode == 1
    assert "agents_scaling,ERROR,RuntimeError" in p.stdout
