"""Flat-key npz checkpoints of trees of tensors, ported from
``repro/checkpoint/store.py``.

The file layout is the reference's, so a checkpoint written by either
package restores in the other: one npz member per leaf, keyed by its tree
path (``/``-joined, with ``/`` and ``%`` inside a component
percent-escaped); NamedTuples contribute their field names, dicts their
keys (in sorted order, as a JAX pytree has them), lists and tuples their
indices; ``None`` holds no leaf.  Sidecar members ``__dtypes__`` (bf16 is
stored as its uint16 bits), ``__meta__`` (the caller's metadata) and
``__checksums__`` (sha256 of every stored array, taken from memory before
any byte reaches disk).  Writes are atomic (temp file, then rename);
``restore`` is strict about the template's keys, dtypes and shapes.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

Tree = Any

_RESERVED = ("__dtypes__", "__meta__", "__checksums__")


class CorruptCheckpointError(ValueError):
    """The checkpoint file is unreadable or fails its checksums.

    Distinct from the plain ``ValueError`` of a template mismatch: corrupt
    bytes are quarantined and recomputed by the resumable runtime, a
    mismatch is the caller's error and is never recomputed away.
    """


def _escape(part: str) -> str:
    """Make a path component separator-free (injective, so no collisions)."""
    return part.replace("%", "%25").replace("/", "%2F")


def _leaves(tree: Tree, path: tuple = ()):
    """(path, leaf) pairs in the order of a JAX pytree of the same tree."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, child in zip(tree._fields, tree):
            yield from _leaves(child, path + (name,))
    elif isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError as e:
            raise ValueError(f"dict keys {list(tree)} do not sort, so they "
                             "have no pytree order") from e
        for k in keys:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, path + (i,))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return "/".join(_escape(str(p)) for p in path)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _stored(leaf) -> np.ndarray:
    """A leaf as the array the npz holds (bf16 as its uint16 bits)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Tree) -> dict[str, tuple[str, np.ndarray]]:
    """Flat key -> (dtype name, stored array), in tree order."""
    out = {}
    for path, leaf in _leaves(tree):
        key = _key(path)
        if key in out:
            raise ValueError(
                f"duplicate flat key {key!r}: two tree paths escape to the "
                "same npz key (e.g. dict keys 1 and '1'); rename the "
                "colliding keys")
        if key in _RESERVED:
            raise ValueError(f"tree key {key!r} collides with the reserved "
                             f"npz sidecar names {_RESERVED}")
        out[key] = (_dtype_name(leaf), _stored(leaf))
    return out


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def fsync_dir(dirname: str) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    fd = os.open(dirname or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(path: str, tree: Tree, metadata: dict | None = None,
         durable: bool = False) -> None:
    """Atomic checkpoint write: temp file -> checksum sidecar -> rename.

    The checksums are taken from the in-memory arrays, so on-disk
    corruption can never be recorded as good.  ``durable=True`` also
    fsyncs the directory after the rename.  A failed write removes its
    temp file and leaves any earlier checkpoint at ``path`` as it was.
    """
    flat = _flatten(tree)
    dtypes = {k: d for k, (d, _) in flat.items()}
    payload = {k: a for k, (_, a) in flat.items()}
    checksums = {k: _sha256(a) for k, a in payload.items()}
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __dtypes__=json.dumps(dtypes),
                     __meta__=json.dumps(metadata or {}),
                     __checksums__=json.dumps(checksums), **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if durable:
        fsync_dir(directory)


def load_metadata(path: str) -> dict:
    """Read just the metadata sidecar (no array is decompressed)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            return json.loads(str(z["__meta__"]))
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint {path} metadata unreadable: {e!r}") from e


def _read_raw(path: str) -> tuple[dict, dict, dict]:
    """Decode the npz and verify its checksums; any failure here means
    corrupt bytes (zip CRCs catch torn writes and most flips, the sha256
    sidecar the rest)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            dtypes = json.loads(str(z["__dtypes__"]))
            meta = json.loads(str(z["__meta__"]))
            checksums = (json.loads(str(z["__checksums__"]))
                         if "__checksums__" in z.files else None)
            raw = {k: z[k] for k in set(z.files) - set(_RESERVED)}
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint {path} unreadable (torn or corrupt): {e!r}") from e
    if checksums is not None:
        for k, arr in raw.items():
            want, got = checksums.get(k), _sha256(arr)
            if got != want:
                raise CorruptCheckpointError(
                    f"checkpoint {path} fails checksum for {k!r}: "
                    f"stored {want}, recomputed {got}")
    return dtypes, meta, raw


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored array as a tensor of its recorded dtype on ``device``."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _rebuild(tree: Tree, values: dict, path: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(c, values, path + (name,))
                            for name, c in zip(tree._fields, tree)))
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(c, values, path + (i,))
                          for i, c in enumerate(tree))
    return values[_key(path)]


def restore(path: str, like: Tree) -> tuple[Tree, dict]:
    """Restore into the structure of ``like`` (a tree of tensors); returns
    (tree, metadata), each leaf on its template leaf's device.

    Corrupt bytes raise ``CorruptCheckpointError``; a readable checkpoint
    whose keys, dtypes or shapes disagree with ``like`` raises a plain
    ``ValueError``.
    """
    dtypes, meta, raw = _read_raw(path)
    templ = {_key(p): leaf for p, leaf in _leaves(like)}
    missing = sorted(set(templ) - set(raw))
    extra = sorted(set(raw) - set(templ))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path} does not match the `like` template: "
            f"missing from checkpoint {missing}, "
            f"unexpected in checkpoint {extra}")
    values = {}
    for k, leaf in templ.items():
        want = _dtype_name(leaf)
        if dtypes.get(k) != want:
            raise ValueError(
                f"dtype mismatch for {k!r}: checkpoint stores "
                f"{dtypes.get(k)}, `like` expects {want}")
        if raw[k].shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {k!r}: checkpoint has "
                             f"{raw[k].shape}, `like` expects "
                             f"{tuple(leaf.shape)}")
        values[k] = _tensor(raw[k], want, leaf.device)
    return _rebuild(like, values), meta
