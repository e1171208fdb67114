"""repro_torch.experiments.{registry,serve_sweeps,client}: the sweep
service, held against the reference's.

* the port's and the reference's ``make_handler``, each over its own copy
  of one committed store, answer every endpoint (``/sweeps``, ``/stats``,
  ``best_lambda`` with a scalar and a vector budget, ``tradeoff``,
  ``pareto``, ``curve``, ``POST /query/batch``, the 400s) with equal
  bodies, the ``jax_loaded`` / ``torch_loaded`` key set aside;
* a poisoned hash (bit flip, vanished directory, injected ``oserror``)
  answers a structured 503 with its reason while healthy hashes keep
  answering 200;
* the client's retry and response-error counters move as the
  reference's under the same faults;
* ``serve_sweeps --once`` and the serving half's imports keep torch out
  of the process (subprocesses).
"""

import json
import os
import shutil
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import pytest

from repro import faults as jfaults
from repro.experiments import client as jclient
from repro.experiments import serve_sweeps as jserve

from repro_torch import faults
from repro_torch.experiments import client
from repro_torch.experiments import serve_sweeps
from repro_torch.experiments.store import SweepStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "experiments", "bench")
LOADED = ("jax_loaded", "torch_loaded")


@pytest.fixture(autouse=True)
def _clean_plans():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _copy_store(study, dst):
    """A copy of a committed store: poisoning quarantines by renaming."""
    shutil.copytree(os.path.join(BENCH, study, "store"), dst)
    return dst


class _Server:
    """One package's handler over one root, on a free loopback port."""

    def __init__(self, serve_mod, root):
        self.handler = serve_mod.make_handler(root, quiet=True)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), self.handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.httpd.server_address[1]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def servers(tmp_path):
    opened = []

    def start(serve_mod, root):
        s = _Server(serve_mod, root)
        opened.append(s)
        return s

    yield start
    for s in opened:
        s.close()


def _strip(body):
    """A body with the package-specific keys (the ``*_loaded`` flag, each
    entry's store root) set aside."""
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items()
                if k not in LOADED + ("store_root",)}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


def _queries(hashes, lams, sel):
    """(GET path, params) for every query endpoint, and one batch."""
    gets = [("/sweeps", {}), ("sweeps", {})]
    for h in hashes + [None]:
        kw = {} if h is None else {"hash": h}
        kw.update(sel)
        gets += [("best_lambda", dict(kw, budget=0.2)),
                 ("best_lambda", dict(kw, budget="0.01,0.1,0.5,1.0")),
                 ("best_lambda", dict(kw, budget=0.05, mode="practical")),
                 ("tradeoff", dict(kw, lam=lams[0])),
                 ("tradeoff", dict(kw, lam=(lams[0] * lams[-1]) ** 0.5)),
                 ("tradeoff", dict(kw, lam=lams[-1] * 10)),      # 400
                 ("pareto", kw), ("curve", dict(kw, mode="practical")),
                 ("best_lambda", dict(kw, budget=2.0))]           # 400
    gets += [("curve", {"hash": "deadbeef" * 8}), ("nope", {}),
             ("/stats", {})]
    batch = [{"query": "best_lambda", "budget": 0.2, "hash": hashes[0], **sel},
             {"query": "curve", "hash": hashes[-1], **sel},
             {"query": "tradeoff", "lam": None, "hash": hashes[0]},
             {"query": "pareto", "hash": "deadbeef" * 8}, "not-an-object",
             {"query": "sweeps"}]
    return gets, batch


@pytest.mark.parametrize("study,sel", [("heterogeneity", {}),
                                       ("degraded_edge", {"sel_channel": 3}),
                                       ("td_speedup", {"sel_env_set": 2})])
def test_served_bodies_equal_reference(study, sel, tmp_path, servers):
    mine = servers(serve_sweeps, _copy_store(study, str(tmp_path / "port")))
    theirs = servers(jserve, _copy_store(study, str(tmp_path / "ref")))
    hashes = SweepStore(str(tmp_path / "port")).hashes()
    lams = SweepStore(str(tmp_path / "port")).get(hashes[0]).lambdas
    gets, batch = _queries(hashes, lams, sel)
    with client.QueryServiceClient("127.0.0.1", mine.port) as a, \
            client.QueryServiceClient("127.0.0.1", theirs.port) as b:
        statuses = []
        for path, params in gets:
            got, want = a.get(path, **params), b.get(path, **params)
            assert got[0] == want[0], (path, params, got, want)
            assert _strip(got[1]) == _strip(want[1]), (path, params)
            statuses.append(got[0])
            if got[0] == 200:
                assert got[1]["torch_loaded"] is ("torch" in sys.modules)
        got, want = a.batch(batch), b.batch(batch)
        assert got[0] == want[0] == 200
        assert _strip(got[1]) == _strip(want[1])
        assert a.stats == b.stats                # one keep-alive connection
    assert 200 in statuses and 400 in statuses


# ------------------------------------------------ per-hash degradation ----


@pytest.fixture
def poisoned(tmp_path, servers):
    root = _copy_store("td_speedup", str(tmp_path / "store"))
    srv = servers(serve_sweeps, root)
    c = client.QueryServiceClient("127.0.0.1", srv.port, timeout=10,
                                  policy=client.RetryPolicy(
                                      retries=3, base_s=0.005, seed=3))
    yield root, sorted(SweepStore(root).hashes()), c, srv.handler.registry
    c.close()


def _healthy(c, hashes):
    return all(c.get("best_lambda", budget=0.2, hash=h)[0] == 200
               for h in hashes)


@pytest.mark.parametrize("kind", ["flip", "vanish", "oserror"])
def test_poisoned_hash_answers_503_healthy_keep_serving(poisoned, kind):
    root, hashes, c, registry = poisoned
    victim, healthy = hashes[1], hashes[:1] + hashes[2:]
    if kind == "flip":
        faults.flip_bit(os.path.join(root, victim, "arrays.npz"))
    elif kind == "vanish":
        assert c.get("curve", hash=victim)[0] == 200      # warm its table
        before = registry.cached_tables()
        shutil.rmtree(os.path.join(root, victim))
    else:
        faults.install("registry.load:oserror:1")
    st, body = c.get("curve", hash=victim)
    assert st == 503, body
    assert body["unavailable"] is True and body["spec_hash"] == victim
    assert body["reason"] and body["torch_loaded"] is ("torch" in sys.modules)
    if kind == "vanish":
        assert registry.cached_tables() < before
    if kind == "oserror":                     # fired once: healed
        assert c.get("curve", hash=victim)[0] == 200
    assert _healthy(c, healthy)
    st, body = c.batch([{"query": "curve", "hash": victim},
                        {"query": "pareto", "hash": healthy[0]}])
    assert st == 200
    assert body["results"][1]["spec_hash"] == healthy[0]
    assert c.stats["transient_retries"] == 0


# ------------------------------------------------------- client retries ----


def _client_scenario(fmod, serve_mod, client_mod, root, srv):
    """The same faults against one package's server and client: each
    request's status, and the client's counters after it."""
    h, cold = sorted(SweepStore(root).hashes())[:2]
    out = []
    c = client_mod.QueryServiceClient(
        "127.0.0.1", srv.port, timeout=10,
        policy=client_mod.RetryPolicy(retries=3, base_s=0.001, seed=5))
    with c:
        steps = [("", lambda: c.get("curve", hash=h)),
                 ("serve.request:oserror:1", lambda: c.get("curve", hash=h)),
                 ("", lambda: c.get("curve", hash="00" * 32)),
                 ("registry.load:oserror:1",
                  lambda: c.get("pareto", hash=cold, mode="theoretical")),
                 ("serve.request:oserror:1,serve.request:oserror:2",
                  lambda: c.batch([{"query": "curve", "hash": h}])),
                 ("serve.request:latency:1", lambda: c.sweeps())]
        for rules, call in steps:
            fmod.reset()
            if rules:
                fmod.install(rules)
            st, _ = call()
            out.append((st, dict(c.stats)))
        fmod.install(",".join(f"serve.request:oserror:{n}"
                              for n in range(1, 5)))
        with pytest.raises(client_mod.RetryError) as ei:
            c.get("curve", hash=h)
        out.append((ei.value.attempts, dict(c.stats)))
    fmod.reset()
    return out


def test_client_counters_match_reference(tmp_path, servers):
    got = _client_scenario(
        faults, serve_sweeps, client,
        _copy_store("td_speedup", str(tmp_path / "p")),
        servers(serve_sweeps, str(tmp_path / "p")))
    want = _client_scenario(
        jfaults, jserve, jclient,
        _copy_store("td_speedup", str(tmp_path / "r")),
        servers(jserve, str(tmp_path / "r")))
    assert got == want
    assert got[-1] == (4, {"requests": 7, "transient_retries": 6,
                           "response_errors": 2})


def test_retry_policy_delays_match_reference():
    for kw in (dict(), dict(retries=5, base_s=0.02, cap_s=0.1, seed=9),
               dict(retries=2, jitter=0.0, seed=3)):
        assert list(client.RetryPolicy(**kw).delays()) == \
            list(jclient.RetryPolicy(**kw).delays())


# -------------------------------------------------- torch stays out -------

SERVING_HALF = ("repro_torch.faults", "repro_torch.experiments.store",
                "repro_torch.experiments.query",
                "repro_torch.experiments.report",
                "repro_torch.experiments.registry",
                "repro_torch.experiments.serve_sweeps",
                "repro_torch.experiments.client")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.pop(faults.ENV_VAR, None)
    return env


def test_serving_half_imports_no_torch():
    code = ("import importlib, sys\n"
            f"for m in {SERVING_HALF!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.experiments import (SweepStore, StoreRegistry,\n"
            "    QueryTable, StoredSweep, family_hash, best_lambda,\n"
            "    generate_report, render_entry)\n"
            "from repro_torch import resolve_device\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n"
            "from repro_torch.experiments import run_sweep\n"
            "assert 'torch' in sys.modules\n"
            "print('SERVING-HALF-TORCH-FREE')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "SERVING-HALF-TORCH-FREE" in r.stdout


def test_serve_once_cli_is_torch_free(tmp_path):
    root = _copy_store("degraded_edge", str(tmp_path / "store"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.serve_sweeps", root,
         "--once", "best_lambda?budget=0.2&sel_channel=1"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    body = json.loads(r.stdout)
    assert body["torch_loaded"] is False and body["query"] == "best_lambda"
    assert body["result"]["comm_budget"] == 0.2 and "lam" in body["result"]
    assert body["spec_hash"] == SweepStore(root).hashes()[0]
