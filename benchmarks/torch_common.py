"""Shared plumbing of the port's figure studies (``benchmarks/torch_*.py``).

Each study mirrors its reference in ``benchmarks/`` on ``repro_torch``:
``run(smoke=False, store=None, device="cuda")`` returns the reference's
rows plus a ``device`` field (the card's ``nvidia-smi`` name and power
limit, ``cpu`` on the CPU), ``gate(rows)`` holds them to the reference's
committed schema (``benchmarks.check_bench.check_suite``), and
``fidelity(rows, smoke)`` to the headline numbers JAX 0.9.0 gives at the
same scale on the CPU (``tools/jax_study_refs.py``).  Default stores live
under the git-ignored ``experiments/bench/torch/stores/``, never in the
reference's store directories.

Imports numpy, the stdlib and ``repro_torch`` only: never JAX, never
``repro``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import sys
import tempfile

from benchmarks.common import EXP_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from benchmarks.torch_chaos import device_label  # noqa: E402,F401

OUT_DIR = os.path.join(EXP_DIR, "torch")
STORE_DIR = os.path.join(OUT_DIR, "stores")


def sync(dev) -> None:
    """Wait for the device, so a wall clock read after it is the work's."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def committed_rows(suite: str) -> list[dict]:
    """The reference's committed ``experiments/bench/<suite>.json``."""
    with open(os.path.join(EXP_DIR, f"{suite}.json")) as f:
        return json.load(f)


def gate(suite: str, rows: list[dict]) -> list[str]:
    """``check_suite``'s violations of ``rows`` against the reference's
    committed rows of ``suite``."""
    from benchmarks.check_bench import check_suite
    return check_suite(suite, committed_rows(suite), rows)


@contextlib.contextmanager
def study_store(suite: str, smoke: bool, store=None):
    """The ``SweepStore`` a study persists to: ``store`` when given, a
    throwaway one for smoke runs (they must not touch a real-scale store),
    else ``experiments/bench/torch/stores/<suite>/store``."""
    from repro_torch.experiments.store import SweepStore
    tmp = None
    if store is None:
        if smoke:
            tmp = tempfile.mkdtemp(prefix=f"torch_{suite}_store_")
            store = os.path.join(tmp, "store")
        else:
            store = os.path.join(STORE_DIR, suite, "store")
    try:
        yield store if isinstance(store, SweepStore) else SweepStore(store)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def report_dir(store) -> str:
    """Where a study renders its report: beside its store, as the
    reference does."""
    return os.path.join(os.path.dirname(os.path.abspath(store.root)), "report")


def repo_path(path: str) -> str:
    """``path`` relative to the repository root when it lies inside it, so
    committed rows name no machine's directories."""
    path = os.path.abspath(path)
    inside = os.path.commonpath([path, REPO]) == REPO
    return os.path.relpath(path, REPO) if inside else path


def close(got: float, want: float, abs_tol: float = 0.0,
          rel_tol: float = 0.0) -> bool:
    """|got - want| within ``abs_tol`` + ``rel_tol`` * |want|."""
    return (math.isfinite(got)
            and abs(got - want) <= abs_tol + rel_tol * abs(want))


# A rate that differs from JAX's by a whole number of single decisions, at
# most this many in a cell, is a decision tie (ROADMAP queue 3 item 3: a
# gain within float noise of its threshold can fall either way across
# frameworks); it is reported, not failed
MAX_TIES = 2


def compare(label: str, got: dict, want: dict, fields: tuple, tol: dict,
            decisions=0, ties: list | None = None) -> list[str]:
    """Violations of the headline table ``got`` against ``want``: the same
    keys, and each key's tuple of ``fields`` within ``tol[field]``, an
    ``(abs, rel)`` pair or ``"equal"``.  With ``decisions`` (the trigger
    decisions a cell's rate averages: a count, or a function of the key),
    a ``*_rate`` field off by one or two whole decisions is a tie,
    appended to ``ties`` as ``(label, key)`` instead of failing."""
    if sorted(got, key=repr) != sorted(want, key=repr):
        return [f"{label}: cells {sorted(got, key=repr)}, JAX 0.9.0 has "
                f"{sorted(want, key=repr)}"]
    out = []
    for key, w in want.items():
        for field, g, v in zip(fields, got[key], w):
            t = tol[field]
            if g == v if t == "equal" else close(float(g), float(v), *t):
                continue
            n = decisions(key) if callable(decisions) else decisions
            flips = abs(g - v) * n if field.endswith("rate") else 0
            whole = abs(flips - round(flips)) < 0.01
            if whole and 1 <= round(flips) <= MAX_TIES:
                if ties is not None:
                    ties.append((label, key))
                continue
            out.append(f"{label} {key} {field}: port {g!r}, JAX 0.9.0 {v!r} "
                       f"(tolerance {t})")
    return out
