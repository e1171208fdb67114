"""Resumable, checkpointed sweep runtime, ported from
``repro/experiments/runtime.py``.

``run_sweep_resumable`` runs the plan of ``run_sweep``
(``repro_torch.experiments.sweep.plan_sweep``) one segment of
``SweepSpec.chunk_size`` runs at a time and checkpoints each finished
segment through ``repro_torch.checkpoint.store`` (atomic npz with sha256
sidecar), tagged with a hash of the spec, the inputs and the execution.  A
killed sweep re-invoked with the same ``store_dir`` restores the finished
segments and computes only the rest; a segment is the same batch that
``run_sweep`` runs at that ``chunk_size``, so the resumed result equals the
uninterrupted one and ``run_sweep``'s bit for bit.

Segments land in one preallocated run-stacked accumulator on the device,
written in place (the reference donates its accumulator to XLA instead).
Checkpoint writes overlap the next segment: the main thread records a CUDA
event after segment k and queues segment k+1; one writer thread waits on
the event, copies segment k to the host on a stream of its own and writes
it, so the write order is the segment order.

Finished sweeps go to the port's ``SweepStore``
(``repro_torch.experiments.store``); ``run_sweep_extend`` computes only the
λ columns the store lacks, and ``sweep_or_load`` loads a stored spec with
no device work at all.  ``gc_finished`` deletes a finished sweep's chunk
files once its record is in the store, never while the ``INCOMPLETE``
resume lock stands.  The lock's creation and release and the deletion
are the fault sites ``runtime.lock``, ``runtime.unlock`` and
``runtime.gc`` (``repro_torch.faults``), as in the reference.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import re
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import faults, resolve_device
from repro_torch.checkpoint import store as ckpt
from repro_torch.core import vfa as vfa_lib
from repro_torch.core.algorithm1 import InnerTrace, ProblemTerms, SummaryTrace
from repro_torch.experiments import store as store_lib
from repro_torch.experiments.sweep import (SweepPlan, SweepResult, SweepSpec,
                                           exec_plan_segment, finalize_sweep,
                                           plan_sweep, run_sweep,
                                           segment_shapes)

_CHUNK_RE = re.compile(r"chunk_(\d{6})\.npz$")
_MANIFEST = "manifest.json"
_INCOMPLETE = "INCOMPLETE"
_FORMAT_VERSION = 1


def _chunk_path(store_dir: str, index: int) -> str:
    return os.path.join(store_dir, f"chunk_{index:06d}.npz")


def _tree_digest(h, tree) -> None:
    flat = ckpt._flatten(tree)
    h.update(json.dumps([type(tree).__name__, list(flat)]).encode())
    for dtype, a in flat.values():
        h.update(dtype.encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def inputs_digest(sampler, w0, problem=None, param_sets=None,
                  env_sets=None, fleet_sets=None) -> str:
    """Content digest of everything outside the spec that shapes results:
    w0 (as float32), the fleet's sampler params (ignored, as by the
    engine, when param_sets or fleet_sets give the fleets), the exact
    problem, the param sets, the env family and the per-env fleets.  It
    rides in every chunk and store entry, so a resume or merge against
    other inputs raises.  The sampler function is identified by the arrays
    it consumes."""
    h = hashlib.sha256()
    terms = (problem if isinstance(problem, ProblemTerms)
             else ProblemTerms.from_problem(problem) if problem is not None
             else None)
    _tree_digest(h, torch.as_tensor(w0, dtype=torch.float32))
    _tree_digest(h, None if (param_sets is not None or fleet_sets is not None)
                 else getattr(sampler, "params", None))
    _tree_digest(h, terms)
    _tree_digest(h, param_sets)
    if env_sets is not None:
        _tree_digest(h, env_sets.params)
        _tree_digest(h, env_sets.terms)
    else:
        _tree_digest(h, None)
    _tree_digest(h, fleet_sets)
    return h.hexdigest()


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _exec_hash(spec_hash_: str, in_digest: str, plan: SweepPlan) -> str:
    """Identity of one chunked execution: results and chunk layout, and the
    software and device that computed them — bitwise identity holds only
    within one torch build, one device kind and one build of the kernels,
    so a resume after any of them changed refuses the old chunks."""
    from repro_torch.kernels import build
    blob = json.dumps({
        "version": _FORMAT_VERSION,
        "spec_hash": spec_hash_,
        "inputs_digest": in_digest,
        "segment_runs": plan.segment_runs,
        "padded_runs": plan.padded_runs,
        "batching": plan.spec.batching,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": _device_name(plan.device),
        "kernels": build._digest(),
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _map(fn, tree):
    return type(tree)(*(None if x is None else fn(x) for x in tree))


def _segment_template(plan: SweepPlan):
    """Zero host tensors shaped like one segment's output."""
    return _map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                segment_shapes(plan))


def _result_accumulator(plan: SweepPlan):
    """Zero device tensors shaped like the whole padded run-stacked result."""
    return _map(lambda s: torch.zeros((plan.padded_runs,) + s.shape[1:],
                                      dtype=s.dtype, device=plan.device),
                segment_shapes(plan))


def _scatter_segment(acc, seg, start: int):
    """Copy one segment's rows into the accumulator, in place; returns it."""
    for a, s in zip(acc, seg):
        if a is not None:
            a[start:start + s.shape[0]].copy_(s)
    return acc


def _write_manifest(store_dir: str, meta: dict) -> None:
    path = os.path.join(store_dir, _MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if prev.get("exec_hash") != meta["exec_hash"]:
            raise ValueError(
                f"{store_dir} already holds chunks of a different sweep "
                f"(exec_hash {prev.get('exec_hash')!r} != "
                f"{meta['exec_hash']!r}); use a fresh store_dir per sweep")
        if meta.get("summary_store") in (None, prev.get("summary_store")):
            return
        # resume added/changed the summary store: record it for gc_finished
        meta = {**prev, "summary_store": meta["summary_store"]}
    _write_json(path, meta)


def _write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _note_summary_store(store_dir: str, root: str) -> None:
    """Record (post hoc) which summary store holds this sweep's final
    record — what ``gc_finished`` verifies against by default."""
    path = os.path.join(store_dir, _MANIFEST)
    if not os.path.isfile(path):
        return
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("summary_store") != root:
        _write_json(path, {**manifest, "summary_store": root})


def completed_chunks(store_dir: str, exec_hash: str) -> dict[int, str]:
    """Map of segment index -> path for valid finished chunk checkpoints;
    an unreadable chunk is quarantined (and then recomputed)."""
    out: dict[int, str] = {}
    if not os.path.isdir(store_dir):
        return out
    for name in os.listdir(store_dir):
        m = _CHUNK_RE.match(name)
        if not m:
            continue
        path = os.path.join(store_dir, name)
        try:
            meta = ckpt.load_metadata(path)
        except ckpt.CorruptCheckpointError as e:
            faults.quarantine_path(path, f"unreadable chunk: {e}")
            continue
        if meta.get("exec_hash") == exec_hash:
            out[int(m.group(1))] = path
    return out


def run_sweep_resumable(
    spec: SweepSpec,
    sampler,
    w0,
    problem: Optional[Union[vfa_lib.VFAProblem, ProblemTerms]] = None,
    *,
    store_dir: str,
    param_sets=None,
    env_sets=None,
    fleet_sets=None,
    mesh=None,
    state_init_fn=None,
    summary_store: Optional[Union[str, store_lib.SweepStore]] = None,
    on_chunk=None,
    durable: bool = False,
    device=None,
) -> SweepResult:
    """``run_sweep``, executed in checkpointed segments so it can resume.

    Args (beyond ``run_sweep``'s):
      store_dir:     directory of the chunk checkpoints and the manifest,
                     one sweep per directory; re-invoking with the same
                     inputs resumes from the finished chunks.
      summary_store: optional ``SweepStore`` (or its root): the finished
                     result is appended there under the spec hash.
      on_chunk:      optional ``fn(index, total, restored: bool)``, called
                     when a segment is restored (True) or has been queued
                     and handed to the writer (False) — not a durability
                     signal: a chunk is on disk once this function returns.
      durable:       fsync the chunk directory after each rename (and the
                     store entry on commit).
      device:        where to run (default cuda; raises without a GPU
                     unless the caller passes "cpu").

    A chunk that fails its checksums is quarantined and recomputed.  With
    ``chunk_size=None`` the whole grid is one segment.  While the sweep
    runs, and after a crash, the directory holds the ``INCOMPLETE`` lock.
    """
    plan = plan_sweep(spec, sampler, w0, problem, param_sets=param_sets,
                      env_sets=env_sets, fleet_sets=fleet_sets, mesh=mesh,
                      state_init_fn=state_init_fn, device=device)
    dev = plan.device
    sh = store_lib.spec_hash(spec)
    in_digest = inputs_digest(sampler, w0, problem=problem,
                              param_sets=param_sets, env_sets=env_sets,
                              fleet_sets=fleet_sets)
    exec_hash = _exec_hash(sh, in_digest, plan)
    segments = plan.segments()

    if summary_store is not None and not isinstance(summary_store,
                                                    store_lib.SweepStore):
        summary_store = store_lib.SweepStore(summary_store)
    os.makedirs(store_dir, exist_ok=True)
    _write_manifest(store_dir, {
        "version": _FORMAT_VERSION,
        "spec": store_lib.spec_payload(spec),
        "spec_hash": sh,
        "inputs_digest": in_digest,
        "exec_hash": exec_hash,
        "axes": list(plan.axes),
        "grid_shape": list(plan.gs),
        "num_segments": len(segments),
        "segment_runs": plan.segment_runs,
        "padded_runs": plan.padded_runs,
        "summary_store": (summary_store.root
                          if summary_store is not None else None),
    })
    with faults.scope("runtime.lock"):
        with open(os.path.join(store_dir, _INCOMPLETE), "w") as f:
            f.write(exec_hash)
    done = completed_chunks(store_dir, exec_hash)
    template = _segment_template(plan) if done else None
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def _save_chunk(path: str, index: int, out, ready) -> None:
        # the writer thread: copy segment ``index`` to the host once its
        # event has fired, on a stream of its own so the copy does not wait
        # for the segments queued after it, then write the checkpoint
        if side is None:
            host = out
        else:
            with torch.cuda.stream(side):
                side.wait_event(ready)
                host = _map(lambda t: t.to("cpu"), out)
        ckpt.save(path, host, durable=durable, metadata={
            "exec_hash": exec_hash, "spec_hash": sh,
            "inputs_digest": in_digest, "segment_index": index,
            "segment": list(segments[index]),
            "grid_coords": {"start": segments[index][0],
                            "stop": segments[index][1],
                            "axes": list(plan.axes),
                            "grid_shape": list(plan.gs)},
        })

    # one segment needs no accumulator; more land in one, in place
    single = None
    acc = _result_accumulator(plan) if len(segments) > 1 else None
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="sweep-ckpt") as pool:
        pending = []
        for i, (a, b) in enumerate(segments):
            seg = None
            if i in done:
                try:
                    restored, meta = ckpt.restore(done[i], template)
                except ckpt.CorruptCheckpointError as e:
                    faults.quarantine_path(done[i], str(e))
                    del done[i]
                else:
                    if tuple(meta["segment"]) != (a, b):
                        raise ValueError(
                            f"chunk {done[i]} covers runs {meta['segment']}, "
                            f"expected [{a}, {b}) — stale store_dir?")
                    seg = _map(lambda t: t.to(dev), restored)
                    if on_chunk is not None:
                        on_chunk(i, len(segments), True)
            if seg is None:
                seg = exec_plan_segment(plan, a, b)        # queued on dev
                ready = None
                if side is not None:
                    ready = torch.cuda.Event()
                    ready.record()
                pending.append(pool.submit(
                    _save_chunk, _chunk_path(store_dir, i), i, seg, ready))
                if on_chunk is not None:
                    on_chunk(i, len(segments), False)
            if acc is None:
                single = seg
            else:
                acc = _scatter_segment(acc, seg, a)
        for f in pending:
            f.result()                                 # re-raise I/O errors

    result = finalize_sweep(plan, single if acc is None else acc)
    if summary_store is not None:
        store_result(summary_store, spec, result, inputs_digest_=in_digest,
                     durable=durable)
    # every chunk is on disk and the record committed: release the lock.
    # A crash before this remove leaves a committed entry under a live
    # lock: _lock_is_stale lets gc_finished collect it, and a re-run
    # restores every chunk and re-puts the same bytes.
    with faults.scope("runtime.unlock"):
        os.remove(os.path.join(store_dir, _INCOMPLETE))
    return result


def _lock_is_stale(store_dir: str, lock_path: str,
                   store: Optional[Union[str, store_lib.SweepStore]]) -> bool:
    """True iff an INCOMPLETE lock belongs to a provably finished sweep: a
    crash between the store commit and the lock's removal.  That needs the
    lock's exec hash to be the manifest's, every segment's chunk on disk,
    and the store to hold the spec hash with the same inputs digest;
    anything less, unreadable state included, is a live lock."""
    try:
        with open(lock_path) as f:
            lock_hash = f.read().strip()
        with open(os.path.join(store_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        if lock_hash != manifest.get("exec_hash"):
            return False
        done = completed_chunks(store_dir, manifest["exec_hash"])
        if sorted(done) != list(range(manifest["num_segments"])):
            return False
        root = store if store is not None else manifest.get("summary_store")
        if root is None:
            return False
        s = (root if isinstance(root, store_lib.SweepStore)
             else store_lib.SweepStore(root))
        sh = manifest["spec_hash"]
        if not s.has(sh):
            return False
        return (s.get(sh).extra.get("inputs_digest")
                == manifest.get("inputs_digest"))
    except (OSError, ValueError, KeyError):
        return False


def gc_finished(store_dir: str,
                store: Optional[Union[str, store_lib.SweepStore]] = None,
                ) -> dict:
    """Delete a finished sweep's chunk checkpoints and manifest (and the
    directory when it is then empty).

    Refuses (``RuntimeError``) while the ``INCOMPLETE`` resume lock stands,
    unless the lock is provably stale (``_lock_is_stale``), and refuses
    (``LookupError``) unless the summary store (``store=``, or the root the
    manifest records) holds the manifest's spec hash with the same inputs
    digest.  Idempotent; returns the files and bytes freed.
    """
    manifest_path = os.path.join(store_dir, _MANIFEST)
    if not os.path.isdir(store_dir) or not os.path.isfile(manifest_path):
        chunks = [n for n in (os.listdir(store_dir)
                              if os.path.isdir(store_dir) else [])
                  if _CHUNK_RE.match(n)]
        if chunks:
            raise LookupError(
                f"{store_dir} holds chunk files but no manifest — not a "
                "sweep this runtime finished; refusing to delete")
        return {"collected": False, "files": 0, "bytes": 0,
                "reason": "nothing to collect"}
    lock_path = os.path.join(store_dir, _INCOMPLETE)
    if os.path.exists(lock_path):
        if not _lock_is_stale(store_dir, lock_path, store):
            raise RuntimeError(
                f"{store_dir} carries the INCOMPLETE resume lock — the sweep "
                "is running or crashed mid-run; resume it to completion (or "
                "delete the dir manually) before collecting")
        os.remove(lock_path)
    with open(manifest_path) as f:
        manifest = json.load(f)
    if store is None:
        store = manifest.get("summary_store")
        if store is None:
            raise LookupError(
                f"{store_dir} ran without summary_store= and no store= was "
                "passed — cannot verify the final record is committed")
    if not isinstance(store, store_lib.SweepStore):
        store = store_lib.SweepStore(store)
    sh = manifest["spec_hash"]
    if not store.has(sh):
        raise LookupError(
            f"summary store {store.root} has no entry {sh} — the final "
            "merged record is not committed; refusing to delete chunks")
    entry_digest = store.get(sh).extra.get("inputs_digest")
    if entry_digest != manifest["inputs_digest"]:
        raise LookupError(
            f"store entry {sh} was computed from different inputs "
            f"({entry_digest} != {manifest['inputs_digest']}) — refusing "
            "to treat it as this sweep's final record")
    files, freed = 0, 0
    with faults.scope("runtime.gc"):
        for name in sorted(os.listdir(store_dir)):
            if _CHUNK_RE.match(name) or name == _MANIFEST:
                path = os.path.join(store_dir, name)
                freed += os.path.getsize(path)
                os.remove(path)
                files += 1
    if not os.listdir(store_dir):
        os.rmdir(store_dir)
    return {"collected": True, "files": files, "bytes": freed,
            "spec_hash": sh}


# ---------------------------------------------------------------------------
# SweepResult <-> SweepStore
# ---------------------------------------------------------------------------


def result_arrays(result: SweepResult) -> dict[str, np.ndarray]:
    """Flatten a ``SweepResult`` to the store's flat numpy dict."""
    out = {f"trace/{k}": v.detach().cpu().numpy()
           for k, v in result.trace._asdict().items() if v is not None}
    if result.j_final is not None and not isinstance(result.trace,
                                                     SummaryTrace):
        out["j_final"] = result.j_final.detach().cpu().numpy()
    return out


def arrays_to_result(entry: store_lib.StoredSweep,
                     device=None) -> SweepResult:
    """Rebuild a ``SweepResult`` on ``device`` from a store entry."""
    dev = resolve_device(device)
    kind = entry.extra.get("trace_kind", "summary")
    cls = InnerTrace if kind == "full" else SummaryTrace
    vals = {name: None for name in cls._fields}
    for k, v in entry.arrays.items():
        if k.startswith("trace/"):
            vals[k[len("trace/"):]] = torch.from_numpy(v.copy()).to(dev)
    trace = cls(**vals)
    if kind == "full":
        j_final = (torch.from_numpy(entry.arrays["j_final"].copy()).to(dev)
                   if "j_final" in entry.arrays else None)
    else:
        j_final = trace.j_final
    return SweepResult(trace=trace, comm_rate=trace.comm_rate,
                       j_final=j_final, axes=tuple(entry.axes))


def store_result(store: store_lib.SweepStore, spec: SweepSpec,
                 result: SweepResult, *,
                 inputs_digest_: Optional[str] = None,
                 extra: Optional[dict] = None,
                 durable: bool = False) -> str:
    """Append a finished sweep to the summary store; returns its hash."""
    kind = "full" if isinstance(result.trace, InnerTrace) else "summary"
    meta = {"trace_kind": kind}
    if inputs_digest_ is not None:
        meta["inputs_digest"] = inputs_digest_
    meta.update(extra or {})
    return store.put(spec, result_arrays(result), result.axes, extra=meta,
                     durable=durable)


def _select_lambdas(entry: store_lib.StoredSweep,
                    lambdas: tuple[float, ...]) -> store_lib.StoredSweep:
    """Restrict an entry to the requested λ values (requested order)."""
    lam_axis = entry.axes.index("lam")
    have = entry.lambdas
    idx = []
    for lam in lambdas:
        if float(lam) not in have:
            raise KeyError(f"λ={lam} not in entry (has {have})")
        idx.append(have.index(float(lam)))
    arrays = {k: np.take(v, idx, axis=lam_axis)
              for k, v in entry.arrays.items()}
    spec = dict(entry.spec)
    spec[store_lib.MERGE_FIELD] = [float(l) for l in lambdas]
    return store_lib.StoredSweep(
        spec=spec, spec_hash=store_lib.spec_hash(spec),
        family_hash=entry.family_hash, axes=entry.axes, arrays=arrays,
        extra=dict(entry.extra))


def run_sweep_extend(
    store: Union[str, store_lib.SweepStore],
    spec: SweepSpec,
    sampler,
    w0,
    problem: Optional[Union[vfa_lib.VFAProblem, ProblemTerms]] = None,
    *,
    param_sets=None,
    env_sets=None,
    fleet_sets=None,
    mesh=None,
    state_init_fn=None,
    store_dir: Optional[str] = None,
    extra: Optional[dict] = None,
    device=None,
) -> SweepResult:
    """Grid extension: compute only the λ cells the store does not have.

    Looks up the spec's family (same everything but λ, same inputs digest)
    in ``store``, runs a sub-sweep over the missing λ values (resumable
    when ``store_dir`` is given), appends it, and returns the result for
    exactly the requested λ grid, which is also stored under its own hash.
    A fully cached request computes nothing.  ``extra`` lands in the
    stored entries' metadata.  A corrupt family member found while merging
    is quarantined and its columns recomputed.
    """
    dev = resolve_device(device)
    if not isinstance(store, store_lib.SweepStore):
        store = store_lib.SweepStore(store)
    in_digest = inputs_digest(sampler, w0, problem=problem,
                              param_sets=param_sets, env_sets=env_sets,
                              fleet_sets=fleet_sets)
    kw = dict(param_sets=param_sets, env_sets=env_sets,
              fleet_sets=fleet_sets, mesh=mesh, state_init_fn=state_init_fn,
              device=dev)
    attempt = 0
    while True:
        missing = store.missing_lambdas(spec, inputs_digest=in_digest)
        if missing:
            sub = dataclasses.replace(spec, lambdas=tuple(missing))
            # one store_dir holds one chunk layout: a retry's sub-sweep
            # (another λ set) must not reuse the directory
            if store_dir is not None and attempt == 0:
                result = run_sweep_resumable(sub, sampler, w0, problem,
                                             store_dir=store_dir, **kw)
            else:
                result = run_sweep(sub, sampler, w0, problem, **kw)
            store_result(store, sub, result, inputs_digest_=in_digest,
                         extra=extra)
            if store_dir is not None:
                _note_summary_store(store_dir, store.root)
        try:
            merged = store.merged(spec, inputs_digest=in_digest)
            break
        except store_lib.StoreCorruptError as e:
            store.quarantine(e.spec_hash, e.reason)
            attempt += 1
    entry = _select_lambdas(merged, tuple(float(l) for l in spec.lambdas))
    if extra:
        entry = dataclasses.replace(entry, extra={**entry.extra, **extra})
    if not store.has(entry.spec_hash):
        store.put(entry.spec, entry.arrays, entry.axes, extra=entry.extra)
    return arrays_to_result(entry, dev)


def sweep_or_load(
    store: Union[str, store_lib.SweepStore],
    spec: SweepSpec,
    sampler,
    w0,
    problem: Optional[Union[vfa_lib.VFAProblem, ProblemTerms]] = None,
    *,
    param_sets=None,
    env_sets=None,
    fleet_sets=None,
    mesh=None,
    state_init_fn=None,
    store_dir: Optional[str] = None,
    extra: Optional[dict] = None,
    device=None,
) -> SweepResult:
    """Store-first sweep: load when cached, compute only what is missing.

    When ``store`` holds the exact spec with the same inputs digest the
    stored entry is returned with no device computation; a corrupt entry
    is quarantined and recomputed; otherwise ``run_sweep_extend`` fills the
    missing λ columns.  Either way the result is the stored entry's bytes.
    """
    dev = resolve_device(device)
    if not isinstance(store, store_lib.SweepStore):
        store = store_lib.SweepStore(store)
    if store.has(spec):
        try:
            entry = store.get(spec, verify=True)
        except store_lib.StoreCorruptError as e:
            store.quarantine(e.spec_hash, e.reason)
        else:
            in_digest = inputs_digest(sampler, w0, problem=problem,
                                      param_sets=param_sets,
                                      env_sets=env_sets,
                                      fleet_sets=fleet_sets)
            stored = entry.extra.get("inputs_digest")
            if stored is not None and stored != in_digest:
                raise ValueError(
                    f"store entry {entry.spec_hash} was computed from "
                    "different inputs (w0/sampler/env/fleet digests differ) "
                    "— same spec, different experiment; give this sweep its "
                    "own SweepSpec.tag")
            return arrays_to_result(entry, dev)
    return run_sweep_extend(store, spec, sampler, w0, problem,
                            param_sets=param_sets, env_sets=env_sets,
                            fleet_sets=fleet_sets, mesh=mesh,
                            state_init_fn=state_init_fn,
                            store_dir=store_dir, extra=extra, device=dev)
