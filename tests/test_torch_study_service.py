"""The runtime and service suites on the port against the reference's, at
smoke scale on the CPU: ``benchmarks/torch_resume_query.py`` and
``torch_serve_load.py``.

- resume_query: the port's rows pass ``check_suite`` against the
  reference's smoke rows, the resumed sweep is bitwise, the budget answer
  and the Pareto front's size are the live reference's and JAX 0.9.0's
  recorded ones, and the suite writes only under the store it is given
  (never under ``REPRO_STORE_DIR``, the reference's).
- serve_load: the port's rows pass ``check_suite`` against the
  reference's smoke rows through exactly one relabel (``torch_loaded`` ->
  ``jax_loaded``) and fail it without; every response reported
  ``torch_loaded`` false with no error.  Over a temporary copy of the
  reference's committed heterogeneity store, the port's and the
  reference's ``serve_sweeps`` subprocesses answer every GET of the
  workload and its batch with equal bodies, the ``*_loaded`` keys set
  aside, and the port's suite serves that copy.
"""

import http.client
import json
import os
import re
import shutil
import subprocess
import sys
import threading

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from benchmarks import resume_query as j_resume  # noqa: E402
from benchmarks import serve_load as j_serve  # noqa: E402
from benchmarks import torch_resume_query as t_resume  # noqa: E402
from benchmarks import torch_serve_load as t_serve  # noqa: E402
from benchmarks.check_bench import check_suite  # noqa: E402
from benchmarks.common import EXP_DIR  # noqa: E402

from study_parity import one_thread  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADED = ("jax_loaded", "torch_loaded")


@pytest.fixture(scope="module")
def resume(tmp_path_factory):
    """Both suites' smoke rows, the reference's store directory set (as
    its CI job sets it) while both run."""
    ref_root = tmp_path_factory.mktemp("reference_store_dir")
    store = tmp_path_factory.mktemp("resume_query") / "store"
    with pytest.MonkeyPatch.context() as mp, one_thread():
        mp.setenv("REPRO_STORE_DIR", str(ref_root))
        jax_rows = j_resume.run(smoke=True)
        before = sorted(os.listdir(ref_root))
        torch_rows = t_resume.run(smoke=True, store=str(store), device="cpu")
        after = sorted(os.listdir(ref_root))
    return dict(jax=jax_rows, torch=torch_rows, store=store,
                ref_before=before, ref_after=after)


@pytest.fixture(scope="module")
def load(tmp_path_factory):
    with one_thread():
        return dict(jax=j_serve.run(smoke=True),
                    torch=t_serve.run(smoke=True, device="cpu"))


# --------------------------------------------------------- resume_query ---


def test_resume_query_rows_pass_the_reference_schema(resume):
    assert check_suite("resume_query", resume["jax"], resume["torch"]) == []
    assert t_resume.gate(resume["torch"]) == []
    assert all(r["device"] == "cpu" for r in resume["torch"])


def test_resume_query_resumes_bitwise(resume):
    (kill,) = [r for r in resume["torch"]
               if r["bench"] == "resume_kill_resume"]
    assert kill["bitwise_identical"] is True
    assert kill["restored_chunks"] == kill["recomputed_chunks"] == 2
    (over,) = [r for r in resume["torch"] if r["bench"] == "resume_overhead"]
    assert over["chunks"] == 4 and over["grid_runs"] == 16


def test_resume_query_answers_match_the_reference_run(resume):
    want = t_resume.headlines(resume["jax"])
    assert t_resume.fidelity(resume["torch"], True, want=want) == []
    assert t_resume.fidelity(resume["jax"], True) == []
    assert t_resume.fidelity(resume["torch"], True) == []


def test_resume_query_writes_only_under_its_store(resume):
    store = resume["store"]
    assert (store.parent / "resume_query_chunks").is_dir()
    assert any((store / h / "meta.json").is_file()
               for h in os.listdir(store))
    # the reference's REPRO_STORE_DIR saw only the reference's run
    assert resume["ref_after"] == resume["ref_before"]


def test_resume_query_default_stores_are_the_ports(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(t_resume, "_run",
                        lambda smoke, root, dev: seen.setdefault(smoke, root))
    t_resume.run(smoke=False, device="cpu")
    t_resume.run(smoke=True, device="cpu")
    from benchmarks.torch_common import STORE_DIR
    assert seen[False] == os.path.join(STORE_DIR, "resume_query", "store")
    assert not seen[True].startswith(EXP_DIR)


# ----------------------------------------------------------- serve_load ---


def test_serve_load_rows_pass_the_reference_schema_through_one_relabel(load):
    jax_rows, torch_rows = load["jax"], load["torch"]
    assert check_suite("serve_load", jax_rows,
                       t_serve.relabel(torch_rows)) == []
    assert t_serve.gate(torch_rows) == []
    assert any("jax_loaded" in v
               for v in check_suite("serve_load", jax_rows, torch_rows))
    for row, copy in zip(torch_rows, t_serve.relabel(torch_rows)):
        assert set(copy) == set(row) - {"torch_loaded"} | {"jax_loaded"}
        assert copy["jax_loaded"] is row["torch_loaded"] is False
        assert all(copy[k] == v for k, v in row.items() if k != "torch_loaded")


def test_serve_load_every_response_torch_free_and_answered(load):
    rows = load["torch"]
    assert [r["concurrency"] for r in rows if r["bench"] == "serve_load"] == \
        list(t_serve.SMOKE_CONCURRENCY)
    assert all(r["torch_loaded"] is False for r in rows)
    assert all(r.get("errors", 0) == 0 for r in rows)
    assert all(r["device"] == "cpu" for r in rows)
    bad = [dict(r) for r in rows]
    bad[0]["torch_loaded"] = True
    assert any("torch_loaded" in v for v in t_serve.gate(bad))


def _boot_reference(root):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.experiments.serve_sweeps", root,
         "--port", "0", "--quiet"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    line = proc.stdout.readline()
    m = re.search(r"http://([\d.]+):(\d+)", line)
    assert m, line
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return proc, m.group(1), int(m.group(2))


def _get(host, port, url, body=None):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        if body is None:
            conn.request("GET", url)
        else:
            conn.request("POST", url, body=json.dumps(body).encode(),
                         headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _strip(body):
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in LOADED}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


def test_both_services_answer_the_workload_alike(tmp_path):
    # one copy, served read-only by both (the listing names its root)
    troot = shutil.copytree(os.path.join(EXP_DIR, "heterogeneity", "store"),
                            tmp_path / "store")
    jproc, jhost, jport = _boot_reference(str(troot))
    tproc, thost, tport = t_serve._boot_server(str(troot))
    try:
        urls, n = t_serve.workload(thost, tport)
        assert (urls, n) == t_serve.workload(jhost, jport)
        for url in urls:
            js, jb = _get(jhost, jport, url)
            ts, tb = _get(thost, tport, url)
            assert (ts, _strip(tb)) == (js, _strip(jb)), url
            assert tb["torch_loaded"] is False and jb["jax_loaded"] is False
        _, items = t_serve.batch_items(urls)
        js, jb = _get(jhost, jport, "/query/batch", {"queries": items})
        ts, tb = _get(thost, tport, "/query/batch", {"queries": items})
        assert ts == js == 200 and _strip(tb) == _strip(jb)
    finally:
        for p in (jproc, tproc):
            p.kill()
            p.wait(timeout=30)
    rows = t_serve.run(smoke=True, store=str(troot), device="cpu")
    assert t_serve.gate(rows) == []
    assert all(r["store_entries"] == n for r in rows)
