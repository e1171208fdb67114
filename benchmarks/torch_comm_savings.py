"""Gated gradient aggregation on a real (reduced) model on the port
(``benchmarks/comm_savings.py`` on ``repro_torch``): the comm rate and
the cross-agent bytes a step against lambda.

The reduced mamba2-370m trains with 8 agents through
``repro_torch.launch.steps.build_train_step`` (sgd 0.1; ``FedConfig(eps
0.1, rho 0.995, horizon 30, estimator "hvp")``) for 30 steps at each
lambda of ``LAMBDAS``, on the reference's synthetic LM batches (key 1,
bit for bit JAX's).  The lambda grid is scaled to the LM's gradient
magnitudes (||g||^2 ~ tens at init).  It runs in process: the reference
needs a subprocess to fix the host device count before JAX starts, the
port has no such count.  With ``store=`` the rows land in one dict-spec
``SweepStore`` entry (axes: just lambda), from which the torch-free report
regenerates the savings table.

The weights are the reference's ``model.init(jax.random.key(0))`` drawn on
the port's threefry (``ssm_model.reference_weights``), so the study
trains the reference's model, and ``fidelity`` holds the comm rates and
losses against JAX 0.9.0's (``JAX_0_9_0``).
"""

from __future__ import annotations

import time

import numpy as np

from benchmarks import torch_common as common

LAMBDAS = (0.0, 1.0, 30.0, 300.0)
AGENTS = 8
ARCH = "mamba2-370m"


def _scale(smoke: bool) -> tuple:
    return (4, (0.0, 30.0)) if smoke else (30, LAMBDAS)


def run(smoke: bool = False, store=None, device: str = "cuda") -> list[dict]:
    from repro_torch import random as trandom
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.fed_sgd import FedConfig, FedStats, tree_bytes
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import build_train_step, trainable_params
    from repro_torch.models import build_model
    from repro_torch.models.ssm_model import reference_weights
    from repro_torch.optim import sgd

    dev = resolve_device(device)
    label = common.device_label(dev.type)
    steps, lambdas = _scale(smoke)
    cfg = get_config(ARCH).reduced()
    t0 = time.perf_counter()
    model = reference_weights(build_model(cfg, dev), seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = sgd(0.1)
    lmc = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=128,
                            global_batch=8)
    key = trandom.key(1, dev)
    rows = []
    for lam in lambdas:
        t1 = time.perf_counter()
        model.load_state_dict(init)
        fed = FedConfig(eps=0.1, lam=lam, rho=0.995, horizon=30,
                        estimator="hvp")
        bundle = build_train_step(model, cfg, opt,
                                  fed_cfg=fed if lam > 0 else None,
                                  num_agents=AGENTS, device=dev)
        own = trainable_params(model)
        state, fs = opt.init(own), FedStats.init(bundle.num_agents, dev)
        losses = []
        for step in range(steps):
            batch = make_lm_batch(lmc, key, step)
            own, state, fs, m = bundle.step(own, state, fs, batch)
            losses.append(float(m["loss"]))
        rate = float(m["comm_rate"])
        gbytes = tree_bytes(own)
        wall = time.perf_counter() - t1
        rows.append(dict(
            bench="comm_savings", lam=lam, agents=bundle.num_agents,
            comm_rate=rate, grad_bytes=gbytes,
            bytes_per_step_full=gbytes * bundle.num_agents,
            bytes_per_step_gated=gbytes * bundle.num_agents * rate,
            loss_first=losses[0], loss_last=losses[-1],
            savings_pct=100.0 * (1.0 - rate),
            us_per_call=wall * 1e6 / steps, device=label))
    rows[0]["sweep_wall_s"] = time.perf_counter() - t0
    if store is not None:
        _persist(store, lambdas, steps, rows)
    return rows


def _persist(store, lambdas, steps, recs) -> None:
    """One dict-spec ``SweepStore`` entry (axes: just lambda), so the
    torch-free report regenerates the savings table and chart from a cold
    store.  Skipped when the entry exists: measured LM losses are not
    covered by the byte-identity guarantee of the sweep engine's entries."""
    from repro_torch.experiments.store import SweepStore
    if not isinstance(store, SweepStore):
        store = SweepStore(store)
    spec = {"figure": "comm_savings", "model": f"{ARCH}-reduced",
            "lambdas": [float(l) for l in lambdas], "num_steps": steps,
            "agents": recs[0]["agents"]}
    if store.has(spec):
        return
    arrays = {k: np.asarray([rec[k] for rec in recs], np.float64)
              for k in ("comm_rate", "bytes_per_step_full",
                        "bytes_per_step_gated", "loss_first", "loss_last")}
    store.put(spec, arrays, axes=("lam",),
              extra={"figure": "comm_savings",
                     "grad_bytes": recs[0]["grad_bytes"],
                     "agents": recs[0]["agents"]})


def gate(rows: list[dict]) -> list[str]:
    return common.gate("comm_savings", rows)


# comm_savings.run(smoke=...) under JAX 0.9.0 on the CPU (8 forced host
# devices; JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/jax_study_refs.py
# --only comm_savings [--smoke]): lam -> (comm_rate, loss_first, loss_last)
JAX_0_9_0 = {
    'full': {
        0.0: (1.0, 7.288747310638428, 6.795533180236816),
        1.0: (1.0, 7.288747310638428, 6.795533180236816),
        30.0: (0.0, 7.288747310638428, 7.250165939331055),
        300.0: (0.0, 7.288747310638428, 7.250165939331055),
    },
    'smoke': {
        0.0: (1.0, 7.288747310638428, 7.231115341186523),
        30.0: (0.0, 7.288747310638428, 7.271733283996582),
    },
}

# The port trains the reference's weights (a_log within one ulp) on the
# reference's batches, so the losses differ by float32 summation order
# only: the port read them within 6.6e-8 relative of JAX's, on the CPU
# and on the card (NVIDIA H100 80GB HBM3, 700.00 W); bound 1e-6.  The
# gains that decide each agent's transmission sit far from the thresholds
# at these lambdas, so the comm rates agree exactly
FIELDS = ("comm_rate", "loss_first", "loss_last")
TOL = dict(comm_rate=(1e-6, 0.0), loss_first=(0.0, 1e-6),
           loss_last=(0.0, 1e-6))


def headlines(rows: list[dict]) -> dict:
    """lam -> (comm_rate, loss_first, loss_last)."""
    return {r["lam"]: (r["comm_rate"], r["loss_first"], r["loss_last"])
            for r in rows}


def fidelity(rows: list[dict], smoke: bool, want=None,
             ties: list | None = None) -> list[str]:
    """Each lambda's comm rate and losses against JAX 0.9.0's (no tie
    accounting: ``ties`` stays as it is)."""
    want = want or JAX_0_9_0["smoke" if smoke else "full"]
    return common.compare("comm_savings", headlines(rows), want, FIELDS, TOL)
