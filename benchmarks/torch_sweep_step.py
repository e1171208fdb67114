"""Sweep-step microbenchmark on the port: the reference, fused and
megastep step backends (``benchmarks/sweep_step.py`` on ``repro_torch``).

Stages, swept over the reference's (m, T, n) grids:

* ``gain_family`` — the per-step gain-family evaluation
  (``gain_dispatch.mode_gains``) on the reference and fused step
  structures: three independent passes against one shared-projection
  pass.  On the ``kernel`` gain backend the reference structure is one
  ``gain_matvec`` launch over the m agents, the fused one one
  ``gain_family_stats`` launch.
* ``full_step`` — one whole gated-SGD inner run
  (``algorithm1.gated_sgd_core``: sampling, gradients, gains, trigger,
  update) on the reference's synthetic linear problem, per step, under
  each step backend.
* ``attribution`` — the reference step split into ``sample_grad``
  (sampling and per-agent gradients, timed by a loop that stops there,
  its draws made for every step in one pass as the core makes them),
  ``gain_family`` (timed per call) and ``post_gain`` (trigger and update,
  derived as full - sample_grad - gain_family and clamped at 0; its rows
  carry ``derived=true``).
* ``sweep_step`` — ``SWEEP_RUNS`` runs through the full step at once (the
  sweep engine's batched run axis), per run-step.

The synthetic sampler draws each agent's features and target noise as the
reference does (``jax.random.split`` of the agent's key, then ``normal``),
on the port's threefry, which is JAX's bit for bit.  Walls are read after
the device is synchronized (``torch_common.sync``): median of ``trials``
trials of ``reps`` calls.  Every step backend's final weights are held to
the reference step backend's on the same gain backend within the repo's
1e-5 contract; a miss raises.

The gain backends are ``reference`` and ``kernel`` (the port's name of
the hand-written kernels); the reference's committed rows call the latter
``pallas``, so ``gate`` relabels exactly that one value (``RELABEL``) in
the copy it hands ``check_suite``, and the rows keep ``kernel``.  The
reference states an order (megastep > fused > 1x on the kernel full step
at m >= 32); each kernel ``full_step`` row reports whether it held here
(``order_holds``), and nothing gates on it: the step is host-bound and
walls vary between calls.

Imports numpy, the stdlib and ``repro_torch`` only.
"""

from __future__ import annotations

import numpy as np

from benchmarks import torch_common as common

EPS = 0.5
THRESHOLD = 1e-3
WEIGHT_TOL = 1e-5

GAIN_SHAPES = [(8, 64, 32), (32, 64, 32), (128, 64, 32), (32, 256, 64),
               (128, 256, 64)]
KERNEL_SHAPES = [(32, 64, 32), (128, 64, 32)]
STEP_SHAPES = [(32, 64, 32), (128, 64, 32)]
SWEEP_RUNS = 4
SWEEP_SHAPES = [(32, 64, 32)]
SMOKE_GAIN_SHAPES = [(8, 16, 8), (32, 16, 8)]
SMOKE_KERNEL_SHAPES = [(8, 16, 8)]
SMOKE_STEP_SHAPES = [(8, 16, 8)]
SMOKE_SWEEP_SHAPES = [(8, 16, 8)]

GAIN_BACKENDS = ("reference", "kernel")
STEP_BACKENDS = ("reference", "fused", "megastep")
# the port's gain-backend name -> the reference's, for check_suite only
RELABEL = {"kernel": "pallas"}


def _scale(smoke: bool) -> dict:
    if smoke:
        return dict(reps=3, trials=3, iters=5, gain=SMOKE_GAIN_SHAPES,
                    kernel=SMOKE_KERNEL_SHAPES, step=SMOKE_STEP_SHAPES,
                    sweep=SMOKE_SWEEP_SHAPES)
    return dict(reps=20, trials=7, iters=30, gain=GAIN_SHAPES,
                kernel=KERNEL_SHAPES, step=STEP_SHAPES, sweep=SWEEP_SHAPES)


def _inputs(m: int, T: int, n: int, dev):
    import torch
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(m, n)).astype(np.float32)
    phi = rng.normal(size=(m, T, n)).astype(np.float32)
    gj = rng.normal(size=(n,)).astype(np.float32)
    pm = rng.normal(size=(n, n)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (grads, phi, gj, (pm + pm.T) / 2))


def _gain_family(dev, m, T, n, gain_backend, step_backend, reps, trials):
    from repro_torch.core import gain_dispatch
    grads, phi, gj, pm = _inputs(m, T, n, dev)
    return common.median_wall_us(dev, lambda: gain_dispatch.mode_gains(
        gain_dispatch.MODE_PRACTICAL, grads, phi, EPS, gj, pm,
        backend=gain_backend, step_backend=step_backend), reps, trials)[1]


def make_sample_all(T: int, n: int, w_true):
    """The reference's synthetic linear sampler, batched: keys (R, m, 2)
    -> phi (R, m, T, n) standard normal, targets phi w_true + 0.1 noise."""
    from repro_torch import random as trandom

    def sample_all(rngs):
        ks = trandom.split(rngs, 2)
        phi = trandom.normal(ks[..., 0, :], (T, n))
        noise = trandom.normal(ks[..., 1, :], (T,))
        return phi, phi @ w_true + 0.1 * noise
    return sample_all


def _w_true(n: int, dev):
    import torch
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.normal(size=(n,)).astype(np.float32)).to(dev)


def _core(dev, m, T, n, gain_backend, step_backend, iters, runs=None):
    """A closure running one gated-SGD inner run (``runs`` of them at once
    when given) on the synthetic problem; returns its final weights."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import gain_dispatch
    from repro_torch.core.algorithm1 import gated_sgd_core
    sample_all = make_sample_all(T, n, _w_true(n, dev))
    thresholds = torch.full((iters,), THRESHOLD, dtype=torch.float32,
                            device=dev)
    key = trandom.key(0, dev)
    if runs is None:
        rng, mode = key, gain_dispatch.MODE_PRACTICAL
    else:
        # the mode id rides in per run, as the sweep engine feeds it
        rng = trandom.split(key, runs)
        mode = torch.full((runs,), gain_dispatch.MODE_PRACTICAL,
                          dtype=torch.int64, device=dev)
    w0 = torch.zeros((n,), device=dev)

    def run():
        return gated_sgd_core(
            rng, w0, mode, thresholds, 0.5, sample_all, EPS, m,
            trace="summary", gain_backend=gain_backend,
            step_backend=step_backend, device=dev).final_weights
    return run


def _sample_grad(dev, m, T, n, iters, reps, trials):
    """The step's pre-gain slice, us per step: the agents' draws for every
    step in one pass (as ``gated_sgd_core`` draws its key-only numbers),
    then each step's per-agent gradients and an update that stops short of
    the gains."""
    from repro_torch import random as trandom
    from repro_torch.core import vfa as vfa_lib
    sample_all = make_sample_all(T, n, _w_true(n, dev))
    keys = trandom.split(trandom.key(0, dev), iters)

    def run():
        import torch
        rngs = trandom.split(keys, m + 1)[:, :m]          # (iters, m, 2)
        phi, targets = sample_all(rngs)
        w = torch.zeros((n,), device=dev)
        for k in range(iters):
            grads = vfa_lib.stochastic_gradient(w, phi[k], targets[k])
            w = w - 1e-6 * grads.sum(0)
        return w
    return common.median_wall_us(dev, run, reps, trials)[1] / iters


def _held(label, final, ref):
    """Raise unless ``final`` equals the reference step backend's weights
    within the 1e-5 contract."""
    err = float((final - ref).abs().max())
    if not err <= WEIGHT_TOL:
        raise AssertionError(f"sweep_step {label}: final weights differ from "
                             f"the reference step backend's by {err:.3g}")
    return err


def _step_times(dev, label, shape, gain_backend, cfg, step_reps, runs=None):
    """{step backend: us per (run-)step} and each backend's final-weight
    distance from the reference step backend's."""
    m, T, n = shape
    times, finals = {}, {}
    for sb in STEP_BACKENDS:
        fn = _core(dev, m, T, n, gain_backend, sb, cfg["iters"], runs)
        finals[sb], us = common.median_wall_us(dev, fn, step_reps,
                                               cfg["trials"])
        times[sb] = us / (cfg["iters"] * (runs or 1))
    errs = {sb: _held(f"{label} {shape} {gain_backend}/{sb}", finals[sb],
                      finals["reference"]) for sb in STEP_BACKENDS}
    return times, errs


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    from repro_torch import resolve_device
    dev = resolve_device(device)
    label = common.device_label(dev.type)
    cfg = _scale(smoke)
    reps, trials = cfg["reps"], cfg["trials"]
    step_reps = max(reps // 4, 2)
    rows = []

    for gb, shapes in (("reference", cfg["gain"]), ("kernel", cfg["kernel"])):
        for (m, T, n) in shapes:
            ref = _gain_family(dev, m, T, n, gb, "reference", reps, trials)
            fus = _gain_family(dev, m, T, n, gb, "fused", reps, trials)
            for sb, us in (("reference", ref), ("fused", fus)):
                rows.append(dict(
                    bench="sweep_step", stage="gain_family", m=m, T=T, n=n,
                    gain_backend=gb, step_backend=sb, us_per_call=us,
                    speedup_vs_reference=ref / us, device=label))

    for gb in GAIN_BACKENDS:
        for (m, T, n) in cfg["step"]:
            times, errs = _step_times(dev, "full_step", (m, T, n), gb, cfg,
                                      step_reps)
            order = times["megastep"] < times["fused"] < times["reference"]
            for sb in STEP_BACKENDS:
                row = dict(
                    bench="sweep_step", stage="full_step", m=m, T=T, n=n,
                    gain_backend=gb, step_backend=sb, us_per_call=times[sb],
                    speedup_vs_reference=times["reference"] / times[sb],
                    final_weights_max_abs_vs_reference=errs[sb],
                    device=label)
                if gb == "kernel":
                    row["order_holds"] = order
                rows.append(row)
            # what megastep can and cannot touch: sample_grad is outside
            # the fusion boundary
            sample = _sample_grad(dev, m, T, n, cfg["iters"], step_reps,
                                  trials)
            gain = _gain_family(dev, m, T, n, gb, "reference", reps, trials)
            post = max(times["reference"] - sample - gain, 0.0)
            for comp, us, derived in (("sample_grad", sample, False),
                                      ("gain_family", gain, False),
                                      ("post_gain", post, True)):
                rows.append(dict(
                    bench="sweep_step", stage="attribution", m=m, T=T, n=n,
                    gain_backend=gb, component=comp, us_per_call=us,
                    fraction_of_step=us / times["reference"],
                    derived=derived, device=label))

    for gb in GAIN_BACKENDS:
        for (m, T, n) in cfg["sweep"]:
            times, errs = _step_times(dev, "sweep_step", (m, T, n), gb, cfg,
                                      step_reps, runs=SWEEP_RUNS)
            for sb in STEP_BACKENDS:
                rows.append(dict(
                    bench="sweep_step", stage="sweep_step", m=m, T=T, n=n,
                    runs=SWEEP_RUNS, gain_backend=gb, step_backend=sb,
                    us_per_call=times[sb],
                    speedup_vs_reference=times["reference"] / times[sb],
                    final_weights_max_abs_vs_reference=errs[sb],
                    device=label))
    return rows


def relabel(rows: list[dict]) -> list[dict]:
    """Copies of ``rows`` with the gain backend named as the reference's
    committed rows name it (``RELABEL``); nothing else changes."""
    return [dict(r, gain_backend=RELABEL.get(r["gain_backend"],
                                             r["gain_backend"]))
            if "gain_backend" in r else dict(r) for r in rows]


def gate(rows: list[dict]) -> list[str]:
    return common.gate("sweep_step", relabel(rows))
