"""Store registry and precomputed query tables: the serving tier, the
port's own copy of ``repro/experiments/registry.py``.

Two layers:

* ``QueryTable`` — one resolved store entry with its reduced
  (mode, rho) → (λ, comm, J) curves **materialized once at
  registration** (pareto fronts included).  ``tradeoff_at`` /
  ``best_lambda`` / ``pareto_front`` become O(L) pure lookups: no grid
  reduction, no array I/O, nothing mutated per request.  ``select``-ed
  variants (fixing extra leading axes) reduce on first use and memoize
  into the same table under its lock.
* ``StoreRegistry`` — many store roots / spec hashes federated behind
  one resolution index, with a thread-safe LRU of resolved tables.

Cache invalidation contract: stores are append-only, so a resolved table
is valid exactly while the federation's hash-list *snapshot* is
unchanged.  Every cache key embeds the snapshot; a new entry changes it,
strands the old keys, and the bounded LRU ages them out.  Steady-state
queries therefore touch the lock only for one dict lookup and never
contend on array I/O; a cold concurrent first touch may load an entry
twice, which is harmless (loads are idempotent: append-only bytes) and
never wrong.

Like ``store`` and ``query``, this module never imports torch: it is the
half of the system a serving host runs (tests/test_torch_serving.py
asserts the subprocess stays torch-free).  Entry loads are the
``registry.load`` fault site.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Union

from repro_torch import faults
from repro_torch.experiments import query as query_lib
from repro_torch.experiments.store import (StoreCorruptError, StoredSweep,
                                           SweepStore)


class EntryUnavailableError(Exception):
    """One spec hash cannot be served right now — corrupt bytes, vanished
    store directory, or transient I/O during the load.

    Deliberately NOT a ``KeyError``: a hash nobody ever stored is a
    client error (400), a hash the federation *advertised* but cannot
    load is a server-side degradation (503 + per-hash reason) that must
    leave every other entry serving.
    """

    def __init__(self, spec_hash: Optional[str], reason: str):
        super().__init__(f"entry {spec_hash or '<default>'} unavailable: "
                         f"{reason}")
        self.spec_hash = spec_hash
        self.reason = reason


def _select_key(select: Optional[dict]) -> tuple:
    return tuple(sorted((str(k), int(v)) for k, v in (select or {}).items()))


class QueryTable:
    """Precomputed λ-tradeoff lookups for one resolved store entry."""

    def __init__(self, entry: StoredSweep):
        self.entry = entry
        self.spec_hash = entry.spec_hash
        self._lock = threading.Lock()
        self._curves: dict[tuple, query_lib.TradeoffCurve] = {}
        self._fronts: dict[tuple, list[dict]] = {}
        for mode in entry.modes:                 # eager: every (mode, rho)
            for ri in range(len(entry.spec["rhos"])):
                self._materialize(mode, ri, None)

    def _materialize(self, mode: str, rho_index: int,
                     select: Optional[dict]):
        curve = query_lib.tradeoff_curve(self.entry, mode=mode,
                                         rho_index=rho_index, select=select)
        front = query_lib.pareto_front(curve)
        key = (mode, int(rho_index), _select_key(select))
        with self._lock:
            self._curves[key] = curve
            self._fronts[key] = front
        return curve, front

    def _key(self, mode, rho_index, select) -> tuple:
        if mode is None:
            modes = self.entry.modes
            mode = "theoretical" if "theoretical" in modes else modes[0]
        return (mode, int(rho_index), _select_key(select))

    def curve(self, mode: Optional[str] = None, rho_index: int = 0,
              select: Optional[dict] = None) -> query_lib.TradeoffCurve:
        key = self._key(mode, rho_index, select)
        got = self._curves.get(key)
        if got is None:                          # select variants: lazy
            got, _ = self._materialize(key[0], key[1], select)
        return got

    def pareto_front(self, mode: Optional[str] = None, rho_index: int = 0,
                     select: Optional[dict] = None) -> list[dict]:
        key = self._key(mode, rho_index, select)
        if key not in self._fronts:
            self._materialize(key[0], key[1], select)
        return self._fronts[key]

    def tradeoff_at(self, lam: float, **curve_kw) -> dict:
        return query_lib.tradeoff_at(self.curve(**curve_kw), lam)

    def best_lambda(self, comm_budget: float, **curve_kw) -> dict:
        return query_lib.best_lambda(self.curve(**curve_kw), comm_budget)

    def best_lambda_batch(self, comm_budgets, **curve_kw) -> list[dict]:
        return query_lib.best_lambda_batch(self.curve(**curve_kw),
                                           comm_budgets)


class StoreRegistry:
    """Many append-only store roots behind one thread-safe serving index.

    Resolution (the old ``serve_sweeps`` rules, lifted across roots):
    an explicit spec hash picks that entry from whichever root holds it;
    with no hash, a single-entry federation serves its one entry, and a
    multi-entry federation whose entries all belong to ONE experiment
    family serves the family's λ-union merge.  Anything else needs
    ``hash=`` (the ``/sweeps`` listing shows the choices).
    """

    def __init__(self, roots: Union[str, os.PathLike,
                                    Sequence[Union[str, os.PathLike]]],
                 max_tables: int = 64):
        if isinstance(roots, (str, os.PathLike)):
            roots = [roots]
        self.stores = [SweepStore(r) for r in roots]
        if not self.stores:
            raise ValueError("StoreRegistry needs at least one store root")
        if max_tables < 1:
            raise ValueError(f"max_tables must be >= 1, got {max_tables}")
        self.max_tables = int(max_tables)
        self._lock = threading.Lock()
        self._tables: OrderedDict[tuple, QueryTable] = OrderedDict()
        # entry_loads counts actual array I/O (store.get / family merges);
        # the LRU regression test alternates entries and watches it stay put
        self.stats = {"entry_loads": 0, "table_hits": 0, "table_misses": 0}

    # ------------------------------------------------------------ listing --

    def snapshot(self) -> tuple:
        """The federation's (root, hash) list — the cache-validity epoch."""
        return tuple((s.root, h) for s in self.stores for h in s.hashes())

    def hashes(self) -> list[str]:
        return [h for s in self.stores for h in s.hashes()]

    def entries(self) -> list[dict]:
        """All entry metadata across roots (cheap: no arrays loaded)."""
        out = []
        for s in self.stores:
            for meta in s.entries():
                out.append({**meta, "store_root": s.root})
        return out

    # --------------------------------------------------------- resolution --

    def _get_checked(self, s: SweepStore, h: str) -> StoredSweep:
        """Load one entry with checksums verified; failures degrade to a
        per-hash ``EntryUnavailableError`` instead of tearing the caller
        down (the registration-time verification the checksums exist for).
        """
        try:
            with faults.scope("registry.load"):
                return s.get(h, verify=True)
        except StoreCorruptError as e:
            raise EntryUnavailableError(h, e.reason) from e
        except KeyError as e:
            # advertised in the snapshot, gone by load time (store dir
            # deleted after registration): server-side degradation
            raise EntryUnavailableError(
                h, f"entry vanished after registration: {e}") from e
        except OSError as e:
            raise EntryUnavailableError(h, f"store I/O failed: {e!r}") from e

    def _load_entry(self, spec_hash: Optional[str],
                    snap: tuple) -> StoredSweep:
        with self._lock:
            self.stats["entry_loads"] += 1
        if spec_hash:
            for s in self.stores:
                if s.has(spec_hash):
                    return self._get_checked(s, spec_hash)
            if any(h == spec_hash for _, h in snap):
                raise EntryUnavailableError(
                    spec_hash, "entry vanished after registration")
            raise KeyError(f"no store entry {spec_hash} in any federated "
                           "root (see /sweeps)")
        if not snap:
            raise KeyError("federation is empty — no store entries yet")
        if len(snap) == 1:
            root, h = snap[0]
            return self._get_checked(
                next(s for s in self.stores if s.root == root), h)
        # several entries, no hash: serve the merged union iff they form
        # one family (membership from meta.json alone — arrays load only
        # for the actual merge)
        metas = self.entries()
        families = {m["family_hash"] for m in metas}
        if len(families) != 1:
            raise KeyError(
                f"federation has {len(snap)} entries across {len(families)} "
                "families — pass ?hash=<spec_hash> (see /sweeps)")
        fh = families.pop()
        members: dict[str, StoredSweep] = {}
        try:
            for s in self.stores:                # dedupe mirrored roots
                for e in s.family(fh):           # verified loads
                    members.setdefault(e.spec_hash, e)
        except StoreCorruptError as e:
            raise EntryUnavailableError(e.spec_hash, e.reason) from e
        except OSError as e:
            raise EntryUnavailableError(None,
                                        f"store I/O failed: {e!r}") from e
        entries = list(members.values())
        if len(entries) == 1:
            return entries[0]
        return self.stores[0].merge(entries)

    def evict(self, spec_hash: Optional[str] = None) -> int:
        """Drop cached tables touching ``spec_hash`` (all when None).

        The serving path calls this when an entry turns unavailable:
        stale tables resolved under an older snapshot must not keep
        answering for bytes that are gone or corrupt.  Returns the number
        of tables dropped.
        """
        with self._lock:
            if spec_hash is None:
                n = len(self._tables)
                self._tables.clear()
                return n
            drop = [k for k in self._tables
                    if k[1] == spec_hash
                    or any(h == spec_hash for _, h in k[0])]
            for k in drop:
                del self._tables[k]
            return len(drop)

    def table(self, spec_hash: Optional[str] = None) -> QueryTable:
        """The (possibly cached) query table for one resolution.

        ``spec_hash=None`` means the default resolution (single entry or
        single-family merge).  Array I/O happens outside the lock, so
        concurrent requests for already-resolved tables never wait on a
        cold load.
        """
        snap = self.snapshot()
        key = (snap, spec_hash)
        with self._lock:
            got = self._tables.get(key)
            if got is not None:
                self._tables.move_to_end(key)
                self.stats["table_hits"] += 1
                return got
            self.stats["table_misses"] += 1
        try:
            tab = QueryTable(self._load_entry(spec_hash, snap))
        except KeyError:
            # unknown hash — unless we once served it (stale tables cached
            # under an older snapshot): then its store directory was
            # deleted after registration, which is a per-hash degradation,
            # and the stale tables must go with it
            if spec_hash is not None and self.evict(spec_hash):
                raise EntryUnavailableError(
                    spec_hash,
                    "store directory deleted after registration") from None
            raise
        with self._lock:
            self._tables[key] = tab
            self._tables.move_to_end(key)
            while len(self._tables) > self.max_tables:
                self._tables.popitem(last=False)
        return tab

    def curve(self, spec_hash: Optional[str] = None,
              **curve_kw) -> query_lib.TradeoffCurve:
        return self.table(spec_hash).curve(**curve_kw)

    def cached_tables(self) -> int:
        with self._lock:
            return len(self._tables)
