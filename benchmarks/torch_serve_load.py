"""The port's sweep service under load: p50/p99 latency and throughput
against concurrent clients (``benchmarks/serve_load.py`` on
``repro_torch``).

Boots ``python -m repro_torch.experiments.serve_sweeps`` in a subprocess
over a real ``SweepStore`` and drives it closed-loop from {1, 8, 32, 128}
concurrent keep-alive clients (smoke: {1, 8}) through the reference's
mixed workload (best_lambda with a scalar and a vector budget, tradeoff,
pareto, curve, the listing), derived from the store's own ``/sweeps``.
The serving process must stay torch-free: every response carries
``torch_loaded`` and the suite fails if any says true.

Row kinds, the reference's:

* ``serve_load`` — one per concurrency level: requests, p50/p99 latency
  (ms), throughput (requests/s), errors;
* ``serve_batch`` — the same queries as one ``POST /query/batch`` round
  trip against one keep-alive GET each (the answers must be equal);
* ``table_warm_vs_cold`` — in this process: the registry's precomputed
  ``QueryTable`` against a fresh store open, entry load and full grid
  reduction per request (the answers must be equal).

The store served is the port's own heterogeneity store
(``benchmarks/torch_heterogeneity.py``): at full scale its default store,
swept on ``device`` first if it is not there; at smoke scale a throwaway
smoke-scale one.  ``store=`` serves another store root instead (the
tests serve a copy of the reference's committed heterogeneity store).
The reference's rows carry ``jax_loaded`` where the port's carry
``torch_loaded``, so ``gate`` renames exactly that key (``RELABEL``) in
the copy it hands ``check_suite``.

Imports numpy, the stdlib and ``repro_torch`` (its torch-free serving
half; torch only to sweep the store when it is missing).
"""

from __future__ import annotations

import http.client
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from benchmarks import torch_common as common
from benchmarks.common import timed

CONCURRENCY = (1, 8, 32, 128)
SMOKE_CONCURRENCY = (1, 8)
# the port's key -> the reference's, for check_suite only
RELABEL = {"torch_loaded": "jax_loaded"}


def _has_entries(root: str) -> bool:
    return os.path.isdir(root) and any(
        os.path.isfile(os.path.join(root, h, "meta.json"))
        for h in os.listdir(root))


def _boot_server(store_root: str):
    """Start serve_sweeps on a free port; returns (proc, host, port)."""
    env = dict(os.environ, PYTHONPATH=common.SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.experiments.serve_sweeps",
         store_root, "--port", "0", "--quiet"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=common.REPO)
    deadline = time.time() + 60
    line = ""
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line and proc.poll() is not None:
            raise RuntimeError(f"server died at boot (rc={proc.returncode})")
        m = re.search(r"http://([\d.]+):(\d+)", line)
        if m:
            # drain further output so the pipe never blocks the server
            threading.Thread(target=proc.stdout.read, daemon=True).start()
            return proc, m.group(1), int(m.group(2))
    proc.kill()
    proc.wait(timeout=30)
    raise RuntimeError(f"server never announced its port (last: {line!r})")


def workload(host: str, port: int) -> tuple[list[str], int]:
    """The reference's mixed query URLs, from the served store's listing."""
    conn = http.client.HTTPConnection(host, port)
    try:
        conn.request("GET", "/sweeps")
        listing = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    entries = listing["entries"]
    if not entries:
        raise RuntimeError("served store is empty")
    urls = ["/sweeps"]
    for meta in entries:
        h = meta["spec_hash"]
        lams = [float(l) for l in meta["spec"]["lambdas"]]
        mid = float(np.sqrt(min(lams) * max(lams)))
        modes = list(meta["spec"]["modes"])
        urls += [
            f"/query/curve?hash={h}",
            f"/query/pareto?hash={h}",
            f"/query/best_lambda?hash={h}&budget=0.2",
            f"/query/best_lambda?hash={h}&budget=0.05,0.2,0.5,0.8",
            f"/query/tradeoff?hash={h}&lam={mid:.6e}",
        ]
        if len(modes) > 1:
            urls.append(f"/query/best_lambda?hash={h}&budget=0.5"
                        f"&mode={modes[-1]}")
        if "env_set" in meta.get("axes", []):
            urls.append(f"/query/curve?hash={h}&sel_env_set=1")
    return urls, len(entries)


class _Client(threading.Thread):
    """One closed-loop keep-alive client on ``QueryServiceClient``:
    transient connection errors are retried (``transient_retries``),
    non-200 answers counted (``response_errors``); ``errors`` counts the
    requests that got no 200 answer at all."""

    def __init__(self, host, port, urls, n_requests, offset):
        super().__init__(daemon=True)
        self.host, self.port = host, port
        self.urls, self.n, self.offset = urls, n_requests, offset
        self.latencies: list[float] = []
        self.errors = 0
        self.transient_retries = 0
        self.response_errors = 0
        self.torch_loaded = False

    def run(self):
        from repro_torch.experiments.client import (QueryServiceClient,
                                                    RetryError, RetryPolicy)
        client = QueryServiceClient(self.host, self.port, timeout=30,
                                    policy=RetryPolicy(seed=self.offset))
        try:
            for i in range(self.n):
                url = self.urls[(self.offset + i) % len(self.urls)]
                t0 = time.perf_counter()
                try:
                    status, body = client.get(url)
                except RetryError:
                    self.errors += 1     # retries exhausted: a real failure
                    continue
                self.latencies.append(time.perf_counter() - t0)
                if status != 200:
                    self.errors += 1
                    self.response_errors += 1
                elif body.get("torch_loaded") is not False:
                    self.torch_loaded = True
        finally:
            self.transient_retries = client.stats["transient_retries"]
            client.close()


def _load_level(host, port, urls, concurrency, n_per_client) -> dict:
    clients = [_Client(host, port, urls, n_per_client, i * 7)
               for i in range(concurrency)]
    t0 = time.perf_counter()
    for c in clients:
        c.start()
    for c in clients:
        c.join()
    wall = time.perf_counter() - t0
    lats = np.asarray([l for c in clients for l in c.latencies])
    errors = sum(c.errors for c in clients)
    if lats.size == 0:
        raise RuntimeError(f"all {concurrency * n_per_client} requests "
                           "failed")
    if any(c.torch_loaded for c in clients):
        raise RuntimeError("the serving subprocess did not report "
                           "torch_loaded false")
    return dict(
        bench="serve_load", concurrency=concurrency,
        requests=int(lats.size), errors=errors,
        transient_retries=sum(c.transient_retries for c in clients),
        response_errors=sum(c.response_errors for c in clients),
        us_per_call=float(lats.mean() * 1e6),
        p50_ms=float(np.percentile(lats, 50) * 1e3),
        p99_ms=float(np.percentile(lats, 99) * 1e3),
        throughput_rps=float(lats.size / wall),
        wall_s=float(wall), keep_alive=True, torch_loaded=False)


def batch_items(urls: list[str]) -> tuple[list[str], list[dict]]:
    """The workload's query GETs and the same queries as batch items."""
    gets = [u for u in urls if u != "/sweeps"]
    items = []
    for u in gets:
        path, _, qs = u.partition("?")
        item = {"query": path[len("/query/"):]}
        for kv in qs.split("&"):
            k, _, v = kv.partition("=")
            item[k] = v
        items.append(item)
    return gets, items


def _batch_row(host, port, urls, reps) -> dict:
    """N queries as one POST round trip against N keep-alive GETs."""
    gets, items = batch_items(urls)
    payload = json.dumps({"queries": items}).encode()
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        def via_gets():
            out = []
            for u in gets:
                conn.request("GET", u)
                out.append(json.loads(conn.getresponse().read()))
            return out

        def via_batch():
            conn.request("POST", "/query/batch", body=payload,
                         headers={"Content-Type": "application/json"})
            body = json.loads(conn.getresponse().read())
            if body.get("torch_loaded") is not False:
                raise RuntimeError("the batch answer did not report "
                                   "torch_loaded false")
            return body["results"]

        seq, seq_us = timed(via_gets, reps=reps)
        bat, bat_us = timed(via_batch, reps=reps)
    finally:
        conn.close()
    if seq != bat:
        raise RuntimeError("batch answers differ from sequential GETs")
    if any(b.get("torch_loaded") is not False for b in seq):
        raise RuntimeError("a GET answer did not report torch_loaded false")
    return dict(
        bench="serve_batch", queries=len(gets),
        us_per_call=bat_us / len(gets),
        get_us_per_query=seq_us / len(gets),
        batch_us_per_query=bat_us / len(gets),
        speedup_batch_vs_gets=seq_us / bat_us,
        round_trips_saved=len(gets) - 1, torch_loaded=False)


def _warm_vs_cold_row(store_root: str, reps) -> dict:
    """Precomputed QueryTable lookups against the cold path."""
    from repro_torch.experiments import query as query_lib
    from repro_torch.experiments.registry import StoreRegistry
    from repro_torch.experiments.store import SweepStore

    h = SweepStore(store_root).hashes()[0]
    budgets = [0.05, 0.2, 0.5, 0.8]

    def cold():
        # per request: open the store, load the entry, reduce the grid
        s = SweepStore(store_root)
        curve = query_lib.tradeoff_curve(s.get(h))
        return [query_lib.best_lambda(curve, b) for b in budgets]

    reg = StoreRegistry([store_root])
    reg.table(h)                                   # registration: tables built

    def warm():
        return reg.table(h).best_lambda_batch(budgets)

    cold_res, cold_us = timed(cold, reps=reps)
    warm_res, warm_us = timed(warm, reps=reps)
    if cold_res != warm_res:
        raise RuntimeError("warm table answers differ from the cold path")
    return dict(
        bench="table_warm_vs_cold", queries_per_rep=len(budgets),
        us_per_call=warm_us, cold_us_per_call=cold_us,
        speedup_warm_vs_cold=cold_us / warm_us,
        entry_loads=reg.stats["entry_loads"],
        # the registry and query modules import no torch (the reference's
        # row carries its jax_loaded false the same way)
        torch_loaded=False)


def heterogeneity_store(smoke: bool, device: str, tmp: str) -> str:
    """The port's heterogeneity store to serve: the study's default store
    at full scale (swept on ``device`` when it holds no entry), a fresh
    smoke-scale one under ``tmp`` at smoke scale."""
    from benchmarks import torch_heterogeneity
    if smoke:
        root = os.path.join(tmp, "heterogeneity", "store")
        torch_heterogeneity.run(smoke=True, store=root, device=device)
        return root
    root = os.path.join(common.STORE_DIR, "heterogeneity", "store")
    if not _has_entries(root):
        torch_heterogeneity.run(smoke=False, store=root, device=device)
    return root


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    tmp = tempfile.mkdtemp(prefix="torch_serve_load_")
    try:
        root = store or heterogeneity_store(smoke, device, tmp)
        if not _has_entries(root):
            raise RuntimeError(f"no store entries to serve under {root}")
        return _run(smoke, root,
                    common.device_label(str(device).split(":")[0]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(smoke: bool, store_root: str, label: str) -> list[dict]:
    levels = SMOKE_CONCURRENCY if smoke else CONCURRENCY
    n_per_client = 10 if smoke else 50
    reps = 3 if smoke else 20
    rows = []
    proc, host, port = _boot_server(store_root)
    try:
        urls, n_entries = workload(host, port)
        # warm the server's tables and the client path once
        _load_level(host, port, urls, 1, min(len(urls), n_per_client))
        for c in levels:
            rows.append(_load_level(host, port, urls, c, n_per_client))
        rows.append(_batch_row(host, port, urls, reps))
    finally:
        proc.kill()
        proc.wait(timeout=30)
    rows.append(_warm_vs_cold_row(store_root, reps))
    for row in rows:
        row["store_entries"] = n_entries
        row["workload_urls"] = len(urls)
        row["store"] = common.repo_path(store_root)
        row["device"] = label
    return rows


def relabel(rows: list[dict]) -> list[dict]:
    """Copies of ``rows`` with ``torch_loaded`` named as the reference's
    committed rows name their key (``RELABEL``); nothing else changes."""
    return [{RELABEL.get(k, k): v for k, v in r.items()} for r in rows]


def gate(rows: list[dict]) -> list[str]:
    out = common.gate("serve_load", relabel(rows))
    for r in rows:
        if r.get("torch_loaded") is not False:
            out.append(f"serve_load: {r['bench']} row reports torch_loaded "
                       f"{r.get('torch_loaded')!r}")
        if r.get("errors", 0):
            out.append(f"serve_load: {r['bench']} at concurrency "
                       f"{r.get('concurrency')} had {r['errors']} errors")
    return out
