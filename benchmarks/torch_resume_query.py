"""Resume overhead and query latency of the port's checkpointed runtime
(``benchmarks/resume_query.py`` on ``repro_torch``).

Three rows on the reference's grid (the windy gridworld, 4 modes x 4
lambdas x 4 seeds = 64 runs of N 300 with 2 agents, checkpointed in
chunks of 8 runs; smoke: 4 x 2 x 2 runs of N 25 in chunks of 4):

* ``resume_overhead`` — ``run_sweep_resumable`` (per-chunk execution and
  asynchronous checkpoint writes, into a fresh chunk directory) against
  the plain ``run_sweep``, both after a warm-up run;
* ``resume_kill_resume`` — the chunk directory cut to its first half (a
  crash after half the chunks), then resumed: the result must equal the
  uninterrupted sweep's bit for bit (else this raises), and the row gives
  the wall the restart saved;
* ``query_latency`` — ``best_lambda`` + ``pareto_front`` +
  ``tradeoff_at`` from a cold ``SweepStore`` (re-opened and re-read each
  repetition, no device work).

``store=`` is the summary ``SweepStore`` root (``torch_run --store``);
the chunk checkpoints go beside it, in ``resume_query_chunks/``.  By
default smoke runs use a throwaway store and full-scale runs the
git-ignored ``experiments/bench/torch/stores/resume_query/store``, kept
afterwards.  The reference's runs use ``REPRO_STORE_DIR`` or a temporary
directory, never these.  ``fidelity`` holds ``best_lam``,
``best_feasible`` and ``pareto_points`` equal to JAX 0.9.0's.

Imports numpy, the stdlib and ``repro_torch`` only.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from benchmarks import torch_common as common
from benchmarks.common import timed

BUDGET = 0.5


def _setup(smoke: bool):
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import GridWorld
    from repro_torch.experiments import SweepSpec

    gw = GridWorld()
    prob = gw.vfa_problem(np.zeros(gw.num_states))
    w0 = np.zeros(gw.num_states, np.float32)
    rho = prob.min_rho(0.5) * 1.0001
    if smoke:
        lambdas, seeds, iters, chunk = (1e-3, 1e-1), (0, 1), 25, 4
    else:
        lambdas = tuple(np.logspace(-4, -1, 4))
        seeds, iters, chunk = tuple(range(4)), 300, 8
    spec = SweepSpec(
        modes=("theoretical", "practical", "random", "never"),
        lambdas=lambdas, seeds=seeds, rhos=(rho,), eps=0.5,
        num_iterations=iters, num_agents=2, random_tx_prob=0.4,
        trace="summary", chunk_size=chunk)
    sampler = ParamSampler(fn=gw.sampler_fn(10),
                           params=gw.agent_params(w0, 2))
    return spec, sampler, w0, prob


def _chunk_files(d):
    return sorted(f for f in os.listdir(d) if f.startswith("chunk_"))


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    tmp = None
    if store is None:
        if smoke:
            tmp = tempfile.mkdtemp(prefix="torch_resume_query_")
            store = os.path.join(tmp, "store")
        else:
            store = os.path.join(common.STORE_DIR, "resume_query", "store")
    try:
        return _run(smoke, os.path.abspath(str(store)), dev)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _run(smoke: bool, store_root: str, dev) -> list[dict]:
    from repro_torch.experiments import query as query_lib
    from repro_torch.experiments import run_sweep
    from repro_torch.experiments.runtime import (inputs_digest,
                                                 run_sweep_resumable,
                                                 store_result)
    from repro_torch.experiments.store import SweepStore

    label = common.device_label(dev.type)
    spec, sampler, w0, prob = _setup(smoke)
    runs = int(np.prod(spec.grid_shape))
    root = os.path.dirname(store_root)
    os.makedirs(root, exist_ok=True)
    chunks = os.path.join(root, "resume_query_chunks")
    shutil.rmtree(chunks, ignore_errors=True)     # always measure fresh
    rows = []

    def wall(fn):
        common.sync(dev)
        t0 = time.perf_counter()
        out = fn()
        common.sync(dev)
        return out, time.perf_counter() - t0

    # -- resume_overhead: the plain engine against the checkpointed runtime
    run_sweep(spec, sampler, w0, problem=prob, device=dev)          # warm
    ref, base_s = wall(lambda: run_sweep(spec, sampler, w0, problem=prob,
                                         device=dev))
    warm = os.path.join(root, "resume_query_chunks_warmup")
    shutil.rmtree(warm, ignore_errors=True)
    run_sweep_resumable(spec, sampler, w0, problem=prob, store_dir=warm,
                        device=dev)
    shutil.rmtree(warm)
    res, resum_s = wall(lambda: run_sweep_resumable(
        spec, sampler, w0, problem=prob, store_dir=chunks, device=dev))
    n_chunks = len(_chunk_files(chunks))
    rows.append(dict(
        bench="resume_overhead", us_per_call=resum_s * 1e6 / runs,
        grid_runs=runs, chunks=n_chunks, base_exec_s=base_s,
        resumable_exec_s=resum_s,
        overhead_pct=round(100.0 * (resum_s - base_s) / base_s, 2),
        device=label))

    # -- resume_kill_resume: a crash after half the chunks, then restart
    for f in _chunk_files(chunks)[n_chunks // 2:]:
        os.remove(os.path.join(chunks, f))
    restored = []
    res2, resume_s = wall(lambda: run_sweep_resumable(
        spec, sampler, w0, problem=prob, store_dir=chunks, device=dev,
        on_chunk=lambda i, n, r: restored.append(r)))
    for name, got in (("resumed", res2), ("checkpointed", res)):
        if not (np.array_equal(got.final_weights.cpu().numpy(),
                               ref.final_weights.cpu().numpy())
                and np.array_equal(got.comm_rate.cpu().numpy(),
                                   ref.comm_rate.cpu().numpy())):
            raise AssertionError(f"the {name} sweep is not bitwise the "
                                 "uninterrupted one")
    rows.append(dict(
        bench="resume_kill_resume", us_per_call=resume_s * 1e6 / runs,
        resume_wall_s=resume_s, full_wall_s=resum_s,
        restored_chunks=sum(restored),
        recomputed_chunks=len(restored) - sum(restored),
        bitwise_identical=True,
        savings_pct=round(100.0 * (1 - resume_s / max(resum_s, 1e-9)), 1),
        device=label))

    # -- query_latency: a cold store, no device work
    store = SweepStore(store_root)
    h = store_result(store, spec, res, inputs_digest_=inputs_digest(
        sampler, w0, problem=prob))

    def cold_queries():
        s = SweepStore(store_root)                # cold: re-open, re-read
        curve = query_lib.tradeoff_curve(s.get(h))
        best = query_lib.best_lambda(curve, BUDGET)
        front = query_lib.pareto_front(curve)
        mid = float(np.sqrt(curve.lambdas[0] * curve.lambdas[-1]))
        return best, front, query_lib.tradeoff_at(curve, mid)

    (best, front, _), us = timed(cold_queries, reps=5 if smoke else 25)
    rows.append(dict(
        bench="query_latency", us_per_call=us,
        query="load+best_lambda+pareto+tradeoff_at",
        store_entries=len(store.hashes()), best_lam=best["lam"],
        best_feasible=best["feasible"], pareto_points=len(front),
        store=common.repo_path(store_root), device=label))
    return rows


def gate(rows: list[dict]) -> list[str]:
    return common.gate("resume_query", rows)


# resume_query.run(smoke=...) under JAX 0.9.0 on the CPU
# (JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py
# --only resume_query [--smoke]): the query row's (best_lam,
# best_feasible, pareto_points)
JAX_0_9_0 = {"full": (0.0001, True, 4), "smoke": (0.001, False, 1)}

FIELDS = ("best_lam", "best_feasible", "pareto_points")
# the port draws JAX's streams and takes every decision as JAX does, so
# the cells' rates are the same counts over the same totals, and the
# budget answer (numpy over them) is the same number
TOL = dict(best_lam="equal", best_feasible="equal", pareto_points="equal")


def headlines(rows: list[dict]) -> dict:
    return {"query": tuple(r[f] for f in FIELDS) for r in rows
            if r.get("bench") == "query_latency"}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """The budget answer and the Pareto front's size against JAX 0.9.0's
    at this scale."""
    want = want or {"query": JAX_0_9_0["smoke" if smoke else "full"]}
    return common.compare("resume_query", headlines(rows), want, FIELDS, TOL,
                          ties=ties)
