"""Query-service HTTP client with bounded retry and backoff, the port's
own copy of ``repro/experiments/client.py``.

The server may drop a connection mid-request (injected through the
``serve.request`` fault site, or a real socket reset on a flaky edge
link) and may answer a poisoned hash with a structured 503.  This client
encodes the matching policy:

* **transient connection errors** — reset/refused/timeout/keep-alive
  teardown — are retried up to ``RetryPolicy.retries`` times with
  exponential backoff + deterministic jitter, on a fresh connection.
* **response errors** — any HTTP status the server *did* answer
  (400 bad query, 503 entry-unavailable) — are returned to the caller
  immediately and never retried: the server spoke; hammering it with
  the same request can only reproduce the same answer.

Retries and response errors are counted separately (``stats``), so a
load benchmark layered on this client cannot let the retry path mask
real failures.

Stdlib only, never imports torch: the same serving half as the store
and the registry.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import socket
import time
import urllib.parse
from typing import Optional

#: connection-level failures worth retrying: the request may never have
#: reached the server, or the server dropped the link before answering
TRANSIENT_ERRORS = (ConnectionError, socket.timeout, TimeoutError,
                    http.client.NotConnected, http.client.BadStatusLine,
                    http.client.CannotSendRequest,
                    http.client.ResponseNotReady,
                    http.client.RemoteDisconnected, OSError)


class RetryError(ConnectionError):
    """Every retry burned and the server still never answered."""

    def __init__(self, url: str, attempts: int, last: BaseException):
        super().__init__(f"{url}: no response after {attempts} attempts "
                         f"(last: {last!r})")
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    Delay before retry k (0-based) is ``base_s * 2**k``, capped at
    ``cap_s``, times a jitter factor drawn uniformly from
    ``[1 - jitter, 1 + jitter]`` from a seeded PRNG — reproducible
    schedules for the chaos harness, desynchronized clients in a fleet
    (each client seeds differently, so a blip does not re-arrive as a
    synchronized thundering herd).
    """

    retries: int = 3
    base_s: float = 0.02
    cap_s: float = 1.0
    jitter: float = 0.5
    seed: int = 0

    def delays(self):
        rng = random.Random(self.seed)
        for k in range(self.retries):
            yield (min(self.base_s * (2 ** k), self.cap_s)
                   * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))


class QueryServiceClient:
    """One keep-alive connection to ``serve_sweeps``, with retry.

    ``get``/``batch`` return ``(status, body_dict)``; only transport
    failures raise (``RetryError`` once the policy is exhausted).
    ``stats`` counts ``requests``, ``transient_retries`` (connection
    errors that were retried) and ``response_errors`` (non-200 answers,
    returned not retried) — the two failure kinds must never be summed
    into one opaque counter.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 policy: Optional[RetryPolicy] = None):
        self.host, self.port, self.timeout = host, int(port), timeout
        self.policy = policy or RetryPolicy()
        self.stats = {"requests": 0, "transient_retries": 0,
                      "response_errors": 0}
        self._conn: Optional[http.client.HTTPConnection] = None

    # ------------------------------------------------------------ transport

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "QueryServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(self, method: str, url: str, body: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> tuple[int, dict]:
        self.stats["requests"] += 1
        delays = list(self.policy.delays())
        last: BaseException | None = None
        for attempt in range(len(delays) + 1):
            if attempt:
                self.stats["transient_retries"] += 1
                time.sleep(delays[attempt - 1])
            try:
                conn = self._connection()
                conn.request(method, url, body=body, headers=headers or {})
                r = conn.getresponse()
                blob = r.read()
            except TRANSIENT_ERRORS as e:
                last = e
                self.close()           # keep-alive state is poisoned
                continue
            if r.status != 200:
                self.stats["response_errors"] += 1
            try:
                payload = json.loads(blob) if blob else {}
            except ValueError:
                payload = {"error": f"non-JSON response ({len(blob)} bytes)"}
            return r.status, payload
        raise RetryError(url, len(delays) + 1, last)

    # -------------------------------------------------------------- queries

    def get(self, path_or_name: str, **params) -> tuple[int, dict]:
        """GET a raw path (``/query/curve?...``) or a query by name with
        keyword params (``get("best_lambda", budget=0.2, hash=h)``)."""
        url = path_or_name
        if not url.startswith("/"):
            url = f"/query/{url}"
            if params:
                url += "?" + urllib.parse.urlencode(
                    {k: str(v) for k, v in params.items()})
        elif params:
            sep = "&" if "?" in url else "?"
            url += sep + urllib.parse.urlencode(
                {k: str(v) for k, v in params.items()})
        return self._request("GET", url)

    def batch(self, queries: list[dict]) -> tuple[int, dict]:
        """POST a list of queries as one ``/query/batch`` round trip."""
        payload = json.dumps({"queries": queries}).encode()
        return self._request("POST", "/query/batch", body=payload,
                             headers={"Content-Type": "application/json"})

    def sweeps(self) -> tuple[int, dict]:
        return self._request("GET", "/sweeps")
