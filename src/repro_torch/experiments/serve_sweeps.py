"""Trigger-threshold query service over federated ``SweepStore``s, the
port's own copy of ``repro/experiments/serve_sweeps.py``.

    PYTHONPATH=src python -m repro_torch.experiments.serve_sweeps \
        ROOT [ROOT...] [--port 8321] [--quiet]

serves JSON over stdlib HTTP (no torch, no device — every request is a
pure lookup into precomputed ``QueryTable``s behind a ``StoreRegistry``,
see ``repro_torch.experiments.registry``):

    GET  /sweeps                     entries across all federated roots
    GET  /stats                      registry cache counters
    GET  /query/best_lambda?budget=0.2[&hash=..&mode=..&rho_index=0]
                                     budget may be a vector: budget=0.1,0.2
    GET  /query/tradeoff?lam=3e-3[&hash=..&mode=..]
    GET  /query/pareto[?hash=..&mode=..]
    GET  /query/curve[?hash=..&mode=..]
    POST /query/batch                {"queries": [{"query": "best_lambda",
                                     "budget": 0.2, ...}, ...]} — a list of
                                     queries answered in one round trip

Connections are HTTP/1.1 keep-alive: a client opens one TCP connection
and streams queries over it.  ``hash`` selects a store entry from any
federated root (defaulting to the only entry, or to the merged union of
a single experiment family); ``mode`` defaults to the paper's
theoretical trigger when present.  Every response carries
``torch_loaded`` (where the reference's carry ``jax_loaded``) so
deployments can assert the serving path never touched the accelerator
stack (tests/test_torch_serving.py and ``chip_smoke.py`` do).  Each
request is one occurrence of the ``serve.request`` fault site.

One-shot mode for scripts and CI (prints the JSON and exits):

    python -m repro_torch.experiments.serve_sweeps STORE --once \
        'best_lambda?budget=0.2&mode=theoretical'
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch import faults
from repro_torch.experiments import query as query_lib
from repro_torch.experiments.registry import (EntryUnavailableError,
                                              StoreRegistry)


def _unavailable_body(e: EntryUnavailableError) -> dict:
    """The structured 503 body: per-hash reason, machine-checkable flag."""
    return {"error": str(e), "unavailable": True, "spec_hash": e.spec_hash,
            "reason": e.reason, "torch_loaded": "torch" in sys.modules}

QUERY_NAMES = ("best_lambda", "tradeoff", "pareto", "curve", "sweeps",
               "stats")


def _curve(registry: StoreRegistry, params: dict):
    select = {k[4:]: int(v) for k, v in params.items()
              if k.startswith("sel_")}
    table = registry.table(params.get("hash"))
    return table, table.curve(mode=params.get("mode"),
                              rho_index=int(params.get("rho_index", 0)),
                              select=select or None)


def handle_query(registry: StoreRegistry, name: str, params: dict) -> dict:
    """Dispatch one query; shared by GET, ``/query/batch`` and ``--once``."""
    if name in ("", "sweeps"):
        return {"query": "sweeps", "entries": registry.entries(),
                "torch_loaded": "torch" in sys.modules}
    if name == "stats":
        return {"query": "stats", "stats": dict(registry.stats),
                "cached_tables": registry.cached_tables(),
                "torch_loaded": "torch" in sys.modules}
    if name not in ("best_lambda", "tradeoff", "pareto", "curve"):
        raise KeyError(f"unknown query {name!r} "
                       f"(one of {' | '.join(QUERY_NAMES)})")
    table, curve = _curve(registry, params)
    if name == "best_lambda":
        budgets = [float(b) for b in str(params["budget"]).split(",")]
        if len(budgets) == 1:
            result = query_lib.best_lambda(curve, budgets[0])
        else:                       # vectorized: one numpy pass, B answers
            result = {"results": query_lib.best_lambda_batch(curve, budgets)}
    elif name == "tradeoff":
        result = query_lib.tradeoff_at(curve, float(params["lam"]))
    elif name == "pareto":
        select = {k[4:]: int(v) for k, v in params.items()
                  if k.startswith("sel_")}
        result = {"front": table.pareto_front(
            mode=params.get("mode"),
            rho_index=int(params.get("rho_index", 0)),
            select=select or None)}
    else:                                              # "curve"
        result = {"rows": curve.as_rows()}
    return {"query": name, "spec_hash": curve.spec_hash, "mode": curve.mode,
            "result": result, "torch_loaded": "torch" in sys.modules}


def handle_batch(registry: StoreRegistry, payload: dict) -> dict:
    """Answer a list of queries in one round trip.

    Each item is ``{"query": <name>, ...params...}``; items fail
    independently (an ``error`` body in that slot) so one bad query
    never voids the rest of the batch.
    """
    queries = payload.get("queries")
    if not isinstance(queries, list):
        raise ValueError('batch body must be {"queries": [...]}')
    results = []
    for item in queries:
        if not isinstance(item, dict):
            results.append({"error": f"batch item must be an object, "
                                     f"got {type(item).__name__}"})
            continue
        params = {str(k): v for k, v in item.items() if k != "query"}
        try:
            results.append(handle_query(registry, str(item.get("query", "")),
                                        params))
        except EntryUnavailableError as e:
            # one poisoned hash degrades its slot, the rest of the batch
            # (and every other hash) keeps serving
            registry.evict(e.spec_hash)
            results.append(_unavailable_body(e))
        except (KeyError, ValueError, IndexError, TypeError) as e:
            # TypeError covers malformed JSON param types (lam=null,
            # budget={...}): float(None) etc. must 400 the item, not 500
            # the whole batch
            results.append({"error": str(e)})
    return {"query": "batch", "count": len(results), "results": results,
            "torch_loaded": "torch" in sys.modules}


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 => persistent connections: Content-Length is always set
    # below, so one client connection serves many queries (keep-alive).
    protocol_version = "HTTP/1.1"
    # headers and body flush as two small writes; without TCP_NODELAY,
    # Nagle + delayed ACK turns every keep-alive response into a ~40 ms
    # stall on loopback (measured by the reference's
    # benchmarks/serve_load.py)
    disable_nagle_algorithm = True
    registry: StoreRegistry = None   # set by make_handler()
    quiet = False

    def _respond(self, body: dict, code: int = 200) -> None:
        blob = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_GET(self):  # noqa: N802 (stdlib API)
        parsed = urllib.parse.urlparse(self.path)
        params = {k: v[-1] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        path = parsed.path.strip("/")
        name = path[len("query/"):] if path.startswith("query/") else path
        try:
            with faults.scope("serve.request"):
                body, code = handle_query(self.registry, name, params), 200
        except faults.TransientFault:
            # injected connection-level fault: drop the connection with no
            # response, like a socket reset — the client's retry policy is
            # what recovers this, not the server
            self.close_connection = True
            return
        except EntryUnavailableError as e:
            # degrade per hash: evict any stale cached table and answer a
            # structured 503; other entries (and this connection) keep
            # serving
            self.registry.evict(e.spec_hash)
            body, code = _unavailable_body(e), 503
        except (KeyError, ValueError, IndexError) as e:
            body, code = {"error": str(e)}, 400
        self._respond(body, code)

    def do_POST(self):  # noqa: N802 (stdlib API)
        path = urllib.parse.urlparse(self.path).path.strip("/")
        if path not in ("query/batch", "batch"):
            self._respond({"error": f"POST {self.path}: only /query/batch "
                                    "accepts POST"}, 404)
            return
        try:
            with faults.scope("serve.request"):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"null")
                if not isinstance(payload, dict):
                    raise ValueError("batch body must be a JSON object")
                body, code = handle_batch(self.registry, payload), 200
        except faults.TransientFault:
            self.close_connection = True
            return
        except (ValueError, KeyError, TypeError) as e:
            body, code = {"error": str(e)}, 400
        self._respond(body, code)

    def log_message(self, fmt, *args):
        if not self.quiet:
            print(f"[serve_sweeps] {fmt % args}", file=sys.stderr)


def make_handler(registry, quiet: bool = False) -> type:
    """An HTTP handler class bound to a registry (or roots / a store)."""
    if not isinstance(registry, StoreRegistry):
        if hasattr(registry, "root"):            # a SweepStore
            registry = StoreRegistry([registry.root])
        else:                                    # root str | list of roots
            registry = StoreRegistry(registry)
    return type("Handler", (_Handler,),
                {"registry": registry, "quiet": quiet})


def serve(store_roots, port: int = 8321, quiet: bool = False) -> None:
    handler = make_handler(store_roots, quiet=quiet)
    reg = handler.registry
    httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
    print(f"[serve_sweeps] serving {len(reg.hashes())} entries from "
          f"{len(reg.stores)} root(s) on "
          f"http://127.0.0.1:{httpd.server_address[1]}", flush=True)
    httpd.serve_forever()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stores", nargs="+", metavar="STORE",
                    help="SweepStore root directories (federated)")
    ap.add_argument("--port", type=int, default=8321,
                    help="bind port (0 picks a free one)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-request logging (load tests)")
    ap.add_argument("--once", default=None, metavar="QUERY",
                    help="answer 'name?k=v&…' once to stdout and exit")
    args = ap.parse_args(argv)
    if args.once is not None:
        name, _, qs = args.once.partition("?")
        params = {k: v[-1] for k, v in urllib.parse.parse_qs(qs).items()}
        print(json.dumps(handle_query(StoreRegistry(args.stores), name,
                                      params), indent=1, sort_keys=True))
        return
    serve(args.stores, args.port, quiet=args.quiet)


if __name__ == "__main__":
    main()
