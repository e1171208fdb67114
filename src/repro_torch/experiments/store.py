"""Append-only sweep-summary store and canonical spec hashing: the port's
own copy of ``repro/experiments/store.py`` (numpy only, no torch).

* **spec hash** — sha256 of the canonical JSON of the spec's dataclass
  fields (sorted keys; arrays digested by shape, dtype and bytes).  The
  payload carries ``framework: "torch"``, so a port entry never takes a
  JAX entry's hash, and the backend defaults resolve the port's own
  variables (``REPRO_TORCH_GAIN_BACKEND``, ``REPRO_TORCH_STEP_BACKEND``).
  ``chunk_size`` is left out, as in the reference: a chunked port run
  gives the unchunked run's bytes (tests/test_torch_runtime.py on the CPU,
  ``chip_smoke.py`` on the card), so both share one entry.
* **family hash** — the spec hash without the λ grid: entries of one
  family are the same experiment at other thresholds and merge along λ.

Entries are directories ``<root>/<spec_hash>/`` holding ``arrays.npz`` and
``meta.json`` (written last: the commit marker), with the arrays file's
sha256 recorded in ``meta.json`` before any byte reaches disk.  Re-putting
a hash must give the same bytes.  Merging holds overlapping λ cells
bitwise on every array except ``j_final``, which it holds at 1e-6
relative: J is a reduction whose bytes may change with the batch shape
(ROADMAP queue 3 item 1), where the reference compares it bitwise too.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
from typing import Iterable, Optional, Union

import numpy as np

from repro_torch import faults


class StoreCorruptError(ValueError):
    """A store entry's bytes are wrong: unreadable npz, a file sha256
    that no longer matches ``meta.json``'s ``checksums`` record, or a
    ``meta.json`` whose spec no longer hashes to its directory name.

    Carries ``spec_hash`` and ``reason`` so the serving tier can degrade
    to a structured per-hash error instead of tearing down a connection,
    and the runtime can quarantine-and-recompute.
    """

    def __init__(self, spec_hash: str, reason: str):
        super().__init__(f"store entry {spec_hash} corrupt: {reason}")
        self.spec_hash = spec_hash
        self.reason = reason

# Fields that select how a sweep executes and provably cannot change its
# results, left out of the spec hash so equivalent runs share one entry:
# chunked and unchunked port runs are bitwise equal on the CPU
# (tests/test_torch_runtime.py) and on the card (chip_smoke.py checks it).
EXEC_ONLY_FIELDS = ("chunk_size",)

# What makes a port entry's hash differ from every JAX entry's.
FRAMEWORK = "torch"

# Arrays a merge holds at tolerance rather than bitwise, and the tolerance.
TOLERANT_ARRAYS = ("trace/j_final", "j_final")
TOLERANT_RTOL = 1e-6

# The grid axis the store can extend/merge along.  λ is the deliverable —
# "what threshold hits this budget" — so it is the one axis worth growing
# incrementally; modes/rhos/seeds stay part of the experiment identity.
MERGE_FIELD = "lambdas"

_META = "meta.json"
_ARRAYS = "arrays.npz"


def _fsync_dir(dirname: str) -> None:
    fd = os.open(dirname or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _canon(v):
    """Canonical JSON-able form of one spec field value."""
    if v is None or isinstance(v, (str, bool)):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if hasattr(v, "_asdict"):                       # NamedTuple (TraceSpec)
        return {k: _canon(x) for k, x in v._asdict().items()}
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _canon(x) for k, x in sorted(v.items())}
    a = np.asarray(v)
    if a.dtype == object:
        raise TypeError(f"cannot canonicalize object-dtype field value {v!r}")
    if a.ndim == 0:
        return _canon(a.item())
    return {"__array__": {
        "shape": list(a.shape), "dtype": str(a.dtype),
        "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}}


def spec_payload(spec) -> dict:
    """Canonical dict of a ``SweepSpec`` (or an already-built payload).

    Key order never matters — the payload is sorted and hashed with
    ``sort_keys`` — so the hash is stable under dataclass field reordering
    (the hypothesis property tests in tests/test_sweep_store.py).
    """
    if dataclasses.is_dataclass(spec) and not isinstance(spec, type):
        items = {f.name: getattr(spec, f.name)
                 for f in dataclasses.fields(spec)}
    elif isinstance(spec, dict):
        items = dict(spec)
    else:
        raise TypeError(f"spec must be a dataclass or dict, got {type(spec)}")
    for k in EXEC_ONLY_FIELDS:
        items.pop(k, None)
    # trace="summary" is shorthand for the default TraceSpec — identical
    # results, so identical hash.  Mirrors repro_torch.core.algorithm1
    # .SUMMARY_TRACE; pinned by tests/test_torch_store.py.
    if items.get("trace") == "summary":
        items["trace"] = {"j_trajectory": False, "alphas": False,
                          "gains": False}
    # Backend fields resolve their env-var defaults here (mirroring
    # repro_torch.core.gain_dispatch), so a spec hashes by the backend that
    # actually computed it.  As in the reference, step_backend="reference"
    # is dropped from the payload.
    if "gain_backend" in items and items["gain_backend"] is None:
        items["gain_backend"] = os.environ.get("REPRO_TORCH_GAIN_BACKEND",
                                               "kernel")
    if items.get("step_backend", "reference") is None:
        items["step_backend"] = os.environ.get("REPRO_TORCH_STEP_BACKEND",
                                               "megastep")
    if items.get("step_backend", None) == "reference":
        items.pop("step_backend", None)
    # The perfect channel (channel_sets=None) is the pre-channel program
    # byte-for-byte, so the default is dropped from the payload — the PR 5/6
    # pattern again: every committed store hash stays stable, and only
    # genuinely lossy sweeps hash apart.
    if items.get("channel_sets", None) is None:
        items.pop("channel_sets", None)
    # sampling="iid" is the stateless pre-TD program byte-for-byte (the
    # sampler state rides the scan carry as an *empty* pytree), so the
    # default is dropped — same hash-stability rule as channel_sets/
    # step_backend: committed hashes never move, and only genuinely
    # Markovian sweeps hash apart.
    if items.get("sampling", "iid") == "iid":
        items.pop("sampling", None)
    items["framework"] = FRAMEWORK
    return {str(k): _canon(v) for k, v in sorted(items.items())}


def _digest(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def spec_hash(spec) -> str:
    """Content hash identifying one sweep's results."""
    return _digest(spec_payload(spec))


def family_payload(spec) -> dict:
    p = dict(spec_payload(spec))
    p.pop(MERGE_FIELD, None)
    return p


def family_hash(spec) -> str:
    """Content hash identifying the experiment *up to* its λ grid."""
    return _digest(family_payload(spec))


def arrays_digest(arrays: dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _same_cell(key: str, a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two entries' values of one λ cell agree: bitwise, or within
    ``TOLERANT_RTOL`` for the arrays in ``TOLERANT_ARRAYS``."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if key in TOLERANT_ARRAYS:
        return bool(np.allclose(a, b, rtol=TOLERANT_RTOL, atol=0.0,
                                equal_nan=True))
    return a.tobytes() == b.tobytes()


@dataclasses.dataclass(frozen=True)
class StoredSweep:
    """One store entry, loaded to plain numpy."""

    spec: dict                       # canonical payload (spec_payload form)
    spec_hash: str
    family_hash: str
    axes: tuple[str, ...]
    arrays: dict[str, np.ndarray]    # flat result arrays ("trace/...", "j_final")
    extra: dict

    @property
    def lambdas(self) -> list[float]:
        return [float(x) for x in self.spec[MERGE_FIELD]]

    @property
    def modes(self) -> list[str]:
        return list(self.spec["modes"])


class SweepStore:
    """Append-only directory of finished sweep summaries keyed by spec hash."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------ layout --

    def _dir(self, h: str) -> str:
        return os.path.join(self.root, h)

    def hashes(self) -> list[str]:
        try:
            names = sorted(os.listdir(self.root))
        except FileNotFoundError:
            # a vanished root is an empty store, not a connection-killing
            # 500 — the serving tier lists hashes on live requests
            return []
        return [name for name in names
                if ".quarantined" not in name
                and os.path.isfile(os.path.join(self.root, name, _META))]

    def entries(self) -> list[dict]:
        """All entry metadata (cheap: no arrays loaded)."""
        out = []
        for h in self.hashes():
            with open(os.path.join(self._dir(h), _META)) as f:
                out.append(json.load(f))
        return out

    def _resolve(self, spec_or_hash) -> str:
        if isinstance(spec_or_hash, str):
            return spec_or_hash
        return spec_hash(spec_or_hash)

    def has(self, spec_or_hash) -> bool:
        return os.path.isfile(
            os.path.join(self._dir(self._resolve(spec_or_hash)), _META))

    # -------------------------------------------------------------- I/O --

    def put(self, spec, arrays: dict[str, np.ndarray],
            axes: Iterable[str], extra: Optional[dict] = None,
            durable: bool = False) -> str:
        """Append one finished sweep; returns its spec hash.

        Idempotent for byte-identical re-puts; raises if the hash exists
        with different bytes (append-only: results are never overwritten).
        The arrays npz is serialized in memory and its file sha256
        recorded in ``meta.json["checksums"]`` *before* any byte reaches
        disk, so on-disk corruption can never be blessed into the commit
        marker.  ``durable=True`` fsyncs the entry directory after the
        meta commit.
        """
        payload = spec_payload(spec)
        h = _digest(payload)
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        for k, a in arrays.items():
            if a.dtype == object or a.dtype.kind == "V":
                raise TypeError(f"array {k!r} has non-native dtype {a.dtype}; "
                                "view it as a native dtype before storing")
        if self.has(h):
            try:
                prev = self.get(h, verify=True)
            except StoreCorruptError as e:
                # a committed-but-corrupt entry (torn arrays under a valid
                # commit marker): quarantine it and fall through to write
                # the fresh bytes — the recompute path, not an overwrite
                self.quarantine(h, e.reason)
            else:
                if (sorted(prev.arrays) != sorted(arrays)
                        or arrays_digest(prev.arrays)
                        != arrays_digest(arrays)):
                    raise ValueError(
                        f"store entry {h} already exists with different "
                        "results — the store is append-only and a spec hash "
                        "must map to one set of bytes")
                return h
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getvalue()
        meta = {
            "spec": payload,
            "spec_hash": h,
            "family_hash": _digest(family_payload(payload)),
            "axes": list(axes),
            "arrays": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                       for k, a in arrays.items()},
            "checksums": {_ARRAYS: hashlib.sha256(blob).hexdigest(),
                          "arrays_digest": arrays_digest(arrays)},
            "extra": dict(extra or {}),
        }
        d = self._dir(h)
        with faults.scope("store.commit") as fs:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(d, _ARRAYS))
            # torn/flip faults land on the already-renamed arrays file, so
            # the commit marker below still lands: the store ends up
            # holding a committed-but-corrupt entry, the case the checksum
            # verification and quarantine path exists for
            fs.mangle(os.path.join(d, _ARRAYS))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(d, _META))  # commit marker, last
            if durable:
                _fsync_dir(d)
                _fsync_dir(self.root)
        return h

    def _read_meta(self, h: str) -> dict:
        d = self._dir(h)
        if not os.path.isfile(os.path.join(d, _META)):
            raise KeyError(f"no store entry {h} under {self.root}")
        try:
            with open(os.path.join(d, _META)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise StoreCorruptError(h, f"meta.json unreadable: {e!r}") from e
        return meta

    def verify_meta(self, h: str, meta: dict) -> None:
        """meta.json self-consistency: its spec must hash to its dirname.

        meta.json is plain JSON with no CRC, so a bit flip there is
        caught by re-deriving the spec hash (any flip inside ``spec``
        moves the digest) and checking the recorded hash fields.
        """
        if meta.get("spec_hash") != h:
            raise StoreCorruptError(
                h, f"meta.json records spec_hash {meta.get('spec_hash')!r}")
        derived = _digest(meta.get("spec", {}))
        if derived != h:
            raise StoreCorruptError(
                h, f"meta.json spec re-hashes to {derived} (bit flip in "
                   "spec payload or wrong directory)")

    def get(self, spec_or_hash, verify: bool = False) -> StoredSweep:
        """Load one entry.  Decode failures always raise
        ``StoreCorruptError``; ``verify=True`` additionally re-derives
        the spec hash from ``meta.json`` and the arrays-file sha256
        against the ``checksums`` record.
        """
        h = self._resolve(spec_or_hash)
        d = self._dir(h)
        meta = self._read_meta(h)
        if verify:
            self.verify_meta(h, meta)
            want = meta.get("checksums", {}).get(_ARRAYS)
            if want is not None:
                with open(os.path.join(d, _ARRAYS), "rb") as f:
                    got = hashlib.sha256(f.read()).hexdigest()
                if got != want:
                    raise StoreCorruptError(
                        h, f"{_ARRAYS} sha256 {got} != recorded {want}")
        try:
            with np.load(os.path.join(d, _ARRAYS), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:
            raise StoreCorruptError(
                h, f"{_ARRAYS} unreadable (torn or corrupt): {e!r}") from e
        return StoredSweep(spec=meta["spec"], spec_hash=meta["spec_hash"],
                           family_hash=meta["family_hash"],
                           axes=tuple(meta["axes"]), arrays=arrays,
                           extra=meta.get("extra", {}))

    # -------------------------------------------------------- durability --

    def quarantine(self, spec_or_hash, reason: str) -> str:
        """Rename a corrupt entry directory aside; returns the new path.

        Quarantine, never delete: the corrupt bytes stay on disk as
        evidence, the hash becomes free for a clean recompute, and
        ``hashes()`` skips ``.quarantined`` names.
        """
        h = self._resolve(spec_or_hash)
        return faults.quarantine_path(self._dir(h), reason)

    def verify_all(self) -> dict[str, Optional[str]]:
        """Checksum-verify every entry; hash -> None (ok) or reason."""
        out: dict[str, Optional[str]] = {}
        for h in self.hashes():
            try:
                self.get(h, verify=True)
                out[h] = None
            except StoreCorruptError as e:
                out[h] = e.reason
        return out

    # ------------------------------------------------- merge / extension --

    def family(self, spec_or_family_hash,
               inputs_digest: Optional[str] = None) -> list[StoredSweep]:
        """All entries of one experiment family (optionally one input set)."""
        if isinstance(spec_or_family_hash, str):
            fh = spec_or_family_hash
        else:
            fh = family_hash(spec_or_family_hash)
        # filter on meta.json alone; arrays load (checksum-verified: these
        # entries feed merges) only for actual members
        return [self.get(m["spec_hash"], verify=True)
                for m in self._family_metas(fh, inputs_digest)]

    def _family_metas(self, fh: str,
                      inputs_digest: Optional[str]) -> list[dict]:
        out = []
        for meta in self.entries():
            if meta["family_hash"] != fh:
                continue
            if (inputs_digest is not None
                    and meta.get("extra", {}).get("inputs_digest")
                    != inputs_digest):
                continue
            out.append(meta)
        return out

    def covered_lambdas(self, spec,
                        inputs_digest: Optional[str] = None) -> list[float]:
        lams: set[float] = set()
        for meta in self._family_metas(family_hash(spec), inputs_digest):
            lams.update(float(l) for l in meta["spec"][MERGE_FIELD])
        return sorted(lams)

    def missing_lambdas(self, spec,
                        inputs_digest: Optional[str] = None) -> tuple[float, ...]:
        """The λ values of ``spec`` not yet covered by its family's entries."""
        covered = set(self.covered_lambdas(spec, inputs_digest=inputs_digest))
        want = spec_payload(spec)[MERGE_FIELD]
        return tuple(float(l) for l in want if float(l) not in covered)

    def merge(self, entries: list[StoredSweep]) -> StoredSweep:
        """Merge same-family entries along the λ axis.

        Disjoint λ sub-grids concatenate (sorted ascending); overlapping λ
        cells must be byte-identical across entries, except ``j_final``
        (``TOLERANT_ARRAYS``), which must agree within ``TOLERANT_RTOL``,
        or the merge raises — two runs claiming the same cell with other
        results means the inputs differed and the family hash failed to
        capture it.
        """
        faults.event("store.merge")
        if not entries:
            raise ValueError("nothing to merge")
        base = entries[0]
        lam_axis = base.axes.index("lam")
        keyset = sorted(base.arrays)
        for e in entries[1:]:
            if e.family_hash != base.family_hash:
                raise ValueError(
                    f"cannot merge across families: {e.spec_hash} vs "
                    f"{base.spec_hash}")
            if e.axes != base.axes:
                raise ValueError(f"axes mismatch: {e.axes} vs {base.axes}")
            if sorted(e.arrays) != keyset:
                raise ValueError(
                    f"array keys mismatch: {sorted(e.arrays)} vs {keyset}")
            if e.extra.get("inputs_digest") != base.extra.get("inputs_digest"):
                raise ValueError(
                    "cannot merge entries computed from different sweep "
                    "inputs (w0/sampler/problem digests differ)")
        cells: dict[float, tuple[StoredSweep, int]] = {}
        for e in entries:
            for i, lam in enumerate(e.lambdas):
                if lam in cells:
                    prev_e, prev_i = cells[lam]
                    for k in keyset:
                        a = np.take(prev_e.arrays[k], prev_i, axis=lam_axis)
                        b = np.take(e.arrays[k], i, axis=lam_axis)
                        if not _same_cell(k, a, b):
                            raise ValueError(
                                f"overlapping λ={lam} cell differs between "
                                f"{prev_e.spec_hash} and {e.spec_hash} "
                                f"(array {k!r}) — refusing to merge")
                else:
                    cells[lam] = (e, i)
        lams = sorted(cells)
        arrays = {
            k: np.stack([np.take(cells[l][0].arrays[k], cells[l][1],
                                 axis=lam_axis) for l in lams], axis=lam_axis)
            for k in keyset}
        spec = dict(base.spec)
        spec[MERGE_FIELD] = [_canon(l) for l in lams]
        return StoredSweep(spec=spec, spec_hash=_digest(spec),
                           family_hash=base.family_hash, axes=base.axes,
                           arrays=arrays, extra=dict(base.extra))

    def merged(self, spec_or_family_hash,
               inputs_digest: Optional[str] = None,
               put: bool = False) -> StoredSweep:
        """The family's union λ grid as one entry (optionally persisted)."""
        entries = self.family(spec_or_family_hash,
                              inputs_digest=inputs_digest)
        m = self.merge(entries)
        if put:
            self.put(m.spec, m.arrays, m.axes, extra=m.extra)
        return m
