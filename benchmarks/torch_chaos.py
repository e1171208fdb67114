"""Chaos suite on the PyTorch port: the fault matrix of
``benchmarks/chaos.py``, asserted end to end on ``repro_torch``.

Every durability fault site gets a cell per applicable kind: a CHILD
process runs a real garnet sweep through the port's resumable runtime
(``run_sweep_resumable`` / ``sweep_or_load`` / ``gc_finished``), on the
card by default, with ``REPRO_TORCH_FAULTS`` injecting the fault.
Crashes are hard ``os._exit(43)`` deaths: no ``finally`` blocks, no
writer-queue drain, exactly like a kill.  A clean RECOVERY child then
re-runs and the parent asserts that the recovered store entry is
**bitwise identical** (content digest) to a clean uninterrupted child
run of the same mode on the same device, with corrupt files quarantined
rather than silently merged.  Torn/flip cells pair the mangle with a
later crash (``site:torn:1,site:crash_after:2``) so the resume path
actually *reads* the corrupt chunk instead of the in-memory copy.

Serving cells run in-process: a federation of store entries is poisoned
one hash at a time (bit flip, vanished entry dir, injected transient
I/O) and the rows assert that the poisoned hash answers a structured 503
with a per-hash reason while every healthy hash keeps serving 200, and
that the ``QueryServiceClient`` retry policy absorbs dropped connections
(``serve.request`` faults) without masking real failures.

Rows follow ``benchmarks/chaos.py`` (``chaos`` and ``chaos_serving``)
plus a ``device`` field: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (``cpu`` on the CPU).  The run gates its rows with
``benchmarks.check_bench.check_suite`` against the reference's committed
``experiments/bench/chaos.json`` and writes them to
``experiments/bench/torch/chaos.json``:

    PYTHONPATH=src python -m benchmarks.torch_chaos [--smoke] [--device cpu]
        [--out-dir DIR]

Imports nothing of ``repro`` and never JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from benchmarks.common import EXP_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch import faults  # noqa: E402

OUT_DIR = os.path.join(EXP_DIR, "torch")

EPS = 0.4
RHO = 0.999

# site -> applicable kinds, as in benchmarks/chaos.py.  Kinds with no
# surface at a site (torn at a lock transition: nothing is mangle-able
# there) are exercised where the surface exists; crash kinds run
# everywhere.
DURABILITY_CELLS = (
    # (site, kind, REPRO_TORCH_FAULTS spec, child mode)
    ("ckpt.write", "crash_before", "ckpt.write:crash_before:2", "sweep"),
    ("ckpt.write", "crash_after", "ckpt.write:crash_after:2", "sweep"),
    ("ckpt.write", "torn",
     "ckpt.write:torn:1,ckpt.write:crash_after:2", "sweep"),
    ("ckpt.write", "flip",
     "ckpt.write:flip:1,ckpt.write:crash_after:2", "sweep"),
    ("ckpt.rename", "crash_before", "ckpt.rename:crash_before:2", "sweep"),
    ("ckpt.rename", "crash_after", "ckpt.rename:crash_after:2", "sweep"),
    ("ckpt.fsync", "crash_before", "ckpt.fsync:crash_before:2", "durable"),
    ("ckpt.fsync", "crash_after", "ckpt.fsync:crash_after:2", "durable"),
    ("store.commit", "crash_before", "store.commit:crash_before:1", "sweep"),
    ("store.commit", "crash_after", "store.commit:crash_after:1", "sweep"),
    ("store.commit", "torn", "store.commit:torn:1", "sweep"),
    ("store.commit", "flip", "store.commit:flip:1", "sweep"),
    ("store.merge", "crash_before", "store.merge:crash_before:1", "extend"),
    ("runtime.lock", "crash_after", "runtime.lock:crash_after:1", "sweep"),
    ("runtime.unlock", "crash_before",
     "runtime.unlock:crash_before:1", "sweep"),
    ("runtime.gc", "crash_before", "runtime.gc:crash_before:1", "gc"),
)

SMOKE_CELLS = ("ckpt.write:crash_after", "ckpt.write:torn",
               "store.commit:torn", "store.commit:crash_after",
               "runtime.unlock:crash_before")


def _scale(smoke: bool) -> dict:
    if smoke:
        return dict(envs=4, states=8, agents=2, iters=12, samples=6,
                    lam_base=(1e-3, 1e-1), lam_ext=(1e-2,), chunk=2)
    return dict(envs=8, states=12, agents=2, iters=40, samples=8,
                lam_base=(1e-4, 1e-3, 1e-1), lam_ext=(1e-2,), chunk=4)


def device_label(device: str) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    if device == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- child -----
# One real garnet sweep through the resumable runtime.  Runs in a
# subprocess so injected crashes (os._exit(43)) die like a kill; the
# parent only ever reads the store and chunk directories it leaves.


def _lambdas(cfg: dict, mode: str) -> tuple:
    if mode == "extend":
        return tuple(cfg["lam_base"]) + tuple(cfg["lam_ext"])
    return tuple(cfg["lam_base"])


def child_spec(cfg: dict, lambdas: tuple):
    from repro_torch.experiments import SweepSpec
    return SweepSpec(
        modes=("theoretical", "practical"), lambdas=tuple(lambdas),
        seeds=(0,), rhos=(RHO,), eps=EPS, num_iterations=cfg["iters"],
        num_agents=cfg["agents"], trace="summary", chunk_size=cfg["chunk"],
        tag="chaos")


def _child_inputs(cfg: dict, device: str):
    import numpy as np
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import (family_sampler_fn, garnet_env_family,
                                  garnet_fleet_sets)
    w0 = np.zeros(cfg["states"], np.float32)
    envs, fam = garnet_env_family(cfg["envs"], num_states=cfg["states"],
                                  device=device)
    sampler = ParamSampler(family_sampler_fn(cfg["samples"]), None)
    fleets = garnet_fleet_sets(envs, w0, cfg["agents"], num_junk=0)
    return sampler, w0, fam, fleets


def child_main(mode: str, root: str, smoke: bool, device: str) -> None:
    """One child run: ``sweep`` / ``durable`` (run_sweep_resumable into
    ``root/chunks`` and ``root/store``), ``extend`` (sweep_or_load on the
    base grid plus ``lam_ext``: the ``store.merge`` site) or ``gc``
    (gc_finished of ``root/chunks``)."""
    from repro_torch.experiments.runtime import (gc_finished,
                                                 run_sweep_resumable,
                                                 sweep_or_load)
    cfg = _scale(smoke)
    chunks = os.path.join(root, "chunks")
    store_root = os.path.join(root, "store")
    if mode == "gc":
        gc_finished(chunks, store_root)
        return
    spec = child_spec(cfg, _lambdas(cfg, mode))
    sampler, w0, fam, fleets = _child_inputs(cfg, device)
    if mode == "extend":
        # store-first extension: reuses the base-λ entry the parent
        # seeded, computes only lam_ext, merges, persists
        sweep_or_load(store_root, spec, sampler, w0, env_sets=fam,
                      fleet_sets=fleets,
                      store_dir=os.path.join(root, "chunks_ext"),
                      device=device)
    else:
        run_sweep_resumable(spec, sampler, w0, env_sets=fam,
                            fleet_sets=fleets, store_dir=chunks,
                            summary_store=store_root,
                            durable=(mode == "durable"), device=device)


def spawn(mode: str, root: str, smoke: bool, device: str,
          fault_spec: str = "") -> tuple[int, float, str]:
    """One child in a subprocess: (exit code, wall s, output tail)."""
    env = dict(os.environ,
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop(faults.ENV_VAR, None)
    env.pop(faults.ENV_CRASH, None)
    if fault_spec:
        env[faults.ENV_VAR] = fault_spec
    cmd = [sys.executable, "-m", "benchmarks.torch_chaos", "--child", mode,
           "--root", root, "--device", device]
    if smoke:
        cmd.append("--smoke")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=1200)
    wall = time.perf_counter() - t0
    return proc.returncode, wall, (proc.stdout + proc.stderr)[-2000:]


def in_process(mode: str, root: str, smoke: bool, device: str,
               fault_spec: str = "") -> bool:
    """One child run in this process, the faults in raise mode; True iff
    an injected crash (``FaultInjected``) ended it."""
    try:
        if fault_spec:
            faults.install(fault_spec, crash_mode="raise")
        child_main(mode, root, smoke, device)
    except faults.FaultInjected:
        return True
    finally:
        faults.reset()
    return False


def entry_digest(store_root: str, spec_hash: str) -> str:
    from repro_torch.experiments.store import SweepStore, arrays_digest
    entry = SweepStore(store_root).get(spec_hash, verify=True)
    return arrays_digest(entry.arrays)


def cell_hash(smoke: bool, mode: str) -> str:
    """The spec hash a cell's recovered entry must have."""
    from repro_torch.experiments.store import spec_hash
    cfg = _scale(smoke)
    return spec_hash(child_spec(cfg, _lambdas(cfg, mode)))


def count_quarantined(root: str) -> int:
    n = 0
    for _, dirs, files in os.walk(root):
        n += sum(".quarantined" in name for name in dirs + files)
    return n


def seed_mode(mode: str) -> str:
    """The run that makes a cell's pre-fault state ("" for none)."""
    return {"extend": "sweep", "gc": "sweep"}.get(mode, "")


def _durability_rows(smoke: bool, work: str, device: str,
                     label: str) -> list[dict]:
    rows = []
    cells = [c for c in DURABILITY_CELLS
             if not smoke or f"{c[0]}:{c[1]}" in SMOKE_CELLS]

    def must(rc, out, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed (rc={rc}): {out}")

    # clean reference runs: one for the sweep/durable/gc cells, one for
    # the extension path (base grid, then extend)
    clean_root = os.path.join(work, "clean")
    rc, clean_s, out = spawn("sweep", clean_root, smoke, device)
    must(rc, out, "clean reference run")
    base_hash = cell_hash(smoke, "sweep")
    want = {"sweep": entry_digest(os.path.join(clean_root, "store"),
                                  base_hash)}
    if any(c[3] == "extend" for c in cells):
        ext_clean = os.path.join(work, "clean_ext")
        for phase in ("sweep", "extend"):
            rc, _, out = spawn(phase, ext_clean, smoke, device)
            must(rc, out, f"clean {phase} reference")
        want["extend"] = entry_digest(os.path.join(ext_clean, "store"),
                                      cell_hash(smoke, "extend"))

    for site, kind, fault_spec, mode in cells:
        root = os.path.join(work, f"{site}.{kind}")
        if seed_mode(mode):
            rc, _, out = spawn(seed_mode(mode), root, smoke, device)
            must(rc, out, f"{site}:{kind} seed")
        expect_crash = "crash" in fault_spec
        faulted_rc, _, out = spawn(mode, root, smoke, device, fault_spec)
        crashed = faulted_rc == faults.CRASH_EXIT
        if expect_crash and not crashed:
            raise RuntimeError(
                f"{site}:{kind}: child exited rc={faulted_rc}, expected "
                f"injected crash rc={faults.CRASH_EXIT}\n{out}")
        if not expect_crash and faulted_rc != 0:
            raise RuntimeError(f"{site}:{kind}: faulted child failed "
                               f"(rc={faulted_rc}): {out}")

        # recovery: a clean re-run of the same child mode
        rc, recovery_s, out = spawn(mode, root, smoke, device)
        must(rc, out, f"{site}:{kind}: recovery run")
        key = "extend" if mode == "extend" else "sweep"
        got = entry_digest(os.path.join(root, "store"),
                           cell_hash(smoke, key))
        if got != want[key]:
            raise RuntimeError(
                f"{site}:{kind}: recovered entry digest {got} != clean "
                f"{want[key]}: recovery is NOT bitwise identical")
        if mode == "gc":
            chunks = os.path.join(root, "chunks")
            left = ([n for n in os.listdir(chunks) if n.startswith("chunk_")]
                    if os.path.isdir(chunks) else [])
            if left:
                raise RuntimeError(f"gc recovery left chunks: {left}")
        rows.append(dict(
            bench="chaos", site=site, kind=kind, child=mode,
            faults=fault_spec, crashed=crashed, faulted_rc=faulted_rc,
            recovered_bitwise=True,
            quarantined=count_quarantined(root),
            recovery_s=float(recovery_s), clean_s=float(clean_s),
            overhead_pct=round(100.0 * (recovery_s / clean_s - 1.0), 1),
            us_per_call=recovery_s * 1e6, device=label))
    return rows


# ------------------------------------------------------- serving cells -----


def _serving_rows(clean_store: str, label: str) -> list[dict]:
    from http.server import ThreadingHTTPServer

    from repro_torch.experiments.client import QueryServiceClient, RetryPolicy
    from repro_torch.experiments.serve_sweeps import make_handler
    from repro_torch.experiments.store import SweepStore

    work = tempfile.mkdtemp(prefix="torch_chaos_serving_")
    root = os.path.join(work, "store")
    shutil.copytree(clean_store, root)
    s = SweepStore(root)
    h1 = s.hashes()[0]
    base = s.get(h1)
    victims = []
    for tag in ("chaos-b", "chaos-c", "chaos-d"):
        spec = dict(base.spec)
        spec["tag"] = tag
        victims.append(s.put(spec, base.arrays, base.axes, extra=base.extra))
    h2, h3, h4 = victims

    handler = make_handler(root, quiet=True)
    registry = handler.registry
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    rows = []
    try:
        client = QueryServiceClient("127.0.0.1", httpd.server_address[1],
                                    policy=RetryPolicy(retries=4, seed=7))

        def healthy() -> bool:
            st, _ = client.get("best_lambda", budget=0.2, hash=h1)
            return st == 200

        def row(site, kind, t0, **kw):
            rows.append(dict(bench="chaos_serving", site=site, kind=kind,
                             healthy_kept_serving=healthy(),
                             us_per_call=(time.perf_counter() - t0) * 1e6,
                             device=label, **kw))

        # bit-flipped entry: structured 503 for that hash, others serve
        t0 = time.perf_counter()
        if not healthy():
            raise RuntimeError("the healthy hash does not serve before any "
                               "fault")
        faults.flip_bit(os.path.join(root, h2, "arrays.npz"))
        st, body = client.get("curve", hash=h2)
        row("registry.load", "flip", t0, poisoned_status=st,
            structured=bool(body.get("unavailable"))
            and body.get("spec_hash") == h2)

        # entry dir deleted after registration: 503 + stale-table eviction
        t0 = time.perf_counter()
        st, _ = client.get("curve", hash=h3)
        if st != 200:
            raise RuntimeError(f"warming {h3} answered {st}")
        cached_before = registry.cached_tables()
        shutil.rmtree(os.path.join(root, h3))
        st, body = client.get("curve", hash=h3)
        row("registry.load", "vanish", t0, poisoned_status=st,
            structured=bool(body.get("unavailable")),
            evicted=registry.cached_tables() < cached_before)

        # transient I/O during a cold load: one 503, then recovers
        t0 = time.perf_counter()
        faults.install("registry.load:oserror:1")
        st1, body1 = client.get("curve", hash=h4)
        st2, _ = client.get("curve", hash=h4)
        faults.reset()
        row("registry.load", "oserror", t0, poisoned_status=st1,
            structured=bool(body1.get("unavailable")), recovered=st2 == 200)

        # dropped connection mid-request: the client's bounded
        # backoff+jitter retry recovers it transparently
        t0 = time.perf_counter()
        faults.install("serve.request:oserror:1")
        before = client.stats["transient_retries"]
        st, _ = client.get("best_lambda", budget=0.2, hash=h1)
        faults.reset()
        row("serve.request", "oserror", t0, poisoned_status=st,
            recovered=st == 200,
            transient_retries=client.stats["transient_retries"] - before)

        # injected latency: slow but correct
        t0 = time.perf_counter()
        faults.install("serve.request:latency:1")
        st, _ = client.get("best_lambda", budget=0.2, hash=h1)
        faults.reset()
        row("serve.request", "latency", t0, poisoned_status=st,
            recovered=st == 200)

        client.close()
    finally:
        faults.reset()
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
        shutil.rmtree(work, ignore_errors=True)
    for r in rows:
        if not r["healthy_kept_serving"]:
            raise RuntimeError(f"healthy hash stopped serving during "
                               f"{r['site']}:{r['kind']}")
    return rows


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    label = device_label(device)
    work = tempfile.mkdtemp(prefix="torch_chaos_")
    try:
        rows = _durability_rows(smoke, work, device, label)
        rows += _serving_rows(os.path.join(work, "clean", "store"), label)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rows


def gate(rows: list[dict]) -> list[str]:
    """``check_suite``'s violations of ``rows`` against the reference's
    committed chaos rows."""
    from benchmarks.check_bench import check_suite
    with open(os.path.join(EXP_DIR, "chaos.json")) as f:
        return check_suite("chaos", json.load(f), rows)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", default=None,
                    choices=("sweep", "durable", "extend", "gc"))
    ap.add_argument("--root", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the children's device (default cuda)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where chaos.json is written "
                         "(default experiments/bench/torch)")
    args = ap.parse_args(argv)
    if args.child:
        child_main(args.child, args.root, args.smoke, args.device)
        return
    rows = run(smoke=args.smoke, device=args.device)
    for row in rows:
        print(json.dumps(row))
    violations = gate(rows)
    for line in violations:
        print(f"FAIL {line}", file=sys.stderr)
    if violations:
        sys.exit(1)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "chaos.json"), "w") as f:
        json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
