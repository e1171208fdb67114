#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Phases, in order; any failed check exits non-zero and prints no ok line:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Hold each kernel against its plain-torch version on the card: the
   ragged shapes of the reference's kernel tests in float32 and bf16, and
   the main path's full shape (with and without a model, shared and
   per-run Phi, with and without the channel keep mask, all six modes),
   plus a bitwise repeat of every launch; time kernel, plain version and
   (for gain_matvec) ``torch.matmul`` with CUDA events.  The family kernel
   (``family_phase``): gain_family_stats and megastep_call at
   ``FAMILY_TIMED`` (wide-192, the kernel suite's m 64 x T 1024 x n 512
   and every ``SLICE_SHAPES`` entry) timed beside their plain versions and
   bounds (``time_ms`` and a CUDA graph's replay);
   runs launched alone equal to their slices of a batched launch, and a
   CUDA graph's replays (after a larger eager call on its capture stream)
   equal to an eager call, bitwise (``FAMILY_ALONE``); ``block_m`` alone changing no bit; all of it again
   under ``REPRO_TORCH_KERNEL_BLOCKS`` (``FAMILY_ENV_BLOCKS``) and
   per-call overrides (``FAMILY_CALL_BLOCKS``).
3. Run Algorithm 1's batched sweep in three cells (``CELLS``) under each
   kernel step backend and once on plain torch, and compare them; each
   kernel's launch counter must equal its expected count in its sweep:
   - ``heterogeneity-mixed`` / ``heterogeneity-homogeneous``: the repo's
     documented heterogeneity study at its own scale
     (``benchmarks/heterogeneity.py``: 64 garnets, S=20, 4 agents of which
     2 or 0 junk, T=10, N=150, 2 modes x 4 lambdas x 2 seeds = 1024 runs);
   - ``wide-192``: a full-width stress size of the same study, a 4-instance
     garnet family (S=256, A=4, b=3), 64-agent fleets with 16 junk agents,
     T=128, six modes x 4 lambdas x 1 rho x 2 seeds = 192 runs, N=100.
   Each gain kernel is also held at the shapes of the cells below
   (``SLICE_SHAPES``).
3b. The degraded-edge cell (``DEGRADED_EDGE``): four backend pairs
   against plain torch over seven channels, clean channel against none,
   ``run_sweep_resumable`` cut and resumed, a ``sweep_or_load`` reload.
3c. Fig. 3 (``fig3_phase``, benchmarks/fig3_continuous.py at its own
   scale: the continuous-state linear system, N=1500, T=1000, 2 agents at
   three lambdas and 10 at one) on plain torch and the three kernel
   backends, the panels held against JAX 0.9.0's (``FIG3_JAX``); the TD(0)
   linear-speedup study (``td_speedup_phase``, benchmarks/td_speedup.py
   at full scale: 6 garnet chains of 10 states, m in {1, 4, 16, 64}, T=8,
   N=6000, Markovian sampling) on the fused backend, its tail errors held
   against JAX 0.9.0's (``TD_JAX``), then every backend against plain
   torch at m=64 with N cut to ``TD_CUT_ITERS`` and the step's stages with
   the walk apart; the Markov runtime and channel at that size
   (``td_runtime_channel_phase``: resume bitwise, clean channel = none
   bitwise, loss 30 % against plain torch); value iteration on the
   gridworld (``run_value_iteration_scan``, megastep) and Q-learning
   (``run_value_iteration``, gain_matvec) against plain torch and the
   reference tests' error bounds (``value_iteration_phase``).
3d. The sweep service (``sweep_service_phase``, after td-speedup) over
   the degraded-edge and td-speedup phases' own stores:
   ``generate_report`` twice over each, byte for byte, the degraded-edge
   artifact's per-channel rates against the phase's own
   (``per_channel_rates``, within ``RATE_TOL``) and the td_speedup
   artifact's speedups against td-speedup's (``SERVICE_TD_RTOL``); both
   roots behind one ``serve_sweeps`` server, every endpoint and a
   ``POST /query/batch`` over one keep-alive ``QueryServiceClient`` equal
   to the port's query functions exactly, with the warm GET's p50 and the
   batch's round trip; ``serve_sweeps --once`` and the report CLI in
   subprocesses, each torch-free; then two cells of
   ``benchmarks/torch_chaos.py`` on the card (a raise-mode torn write plus
   crash in this process, a hard-crash child at the lock's release), each
   recovered bitwise against a clean run; these toy-shape sweeps' launches
   stand in the phase's own line, not in the kernels line.
4. Hold flash attention and the SSD kernels (the LM substrate's) against
   their plain versions on the card: the reference's own test cases at
   their tolerances (tests/test_kernels.py:175-213) and the serving
   slice's shapes in float32 and bf16, plus a bitwise repeat of every
   launch; time kernel, plain version and (flash)
   ``scaled_dot_product_attention``.  Flash attention has two routes:
   bf16 at head dims 64, 96 and 128 runs ``flash_wgmma_kernel`` (tensor
   cores; the main path's), everything else ``flash_kernel`` (float32 on
   CUDA cores); each case is checked to have launched its route's kernel,
   and the float32 route is reported inside the flash record.  The
   tensor-core route is also held within one bf16 ulp of the reference
   computed in float32 (``bf16_ulps``), a check that a single bf16 P
   fails (``tools/flash_copies.py single-p``).  The SSD tile has three routes:
   Q in {64, 128} with N, P in {64, 128} runs ``ssd_chunk_wgmma_kernel``
   (tensor cores; mamba2's main path), the same Q and P at N 16
   ``ssd_chunk_wgmma_n16_kernel`` (tensor cores; jamba's), the reference's
   small case and other shapes ``ssd_chunk_kernel`` (float32 CUDA cores,
   reported inside the tile's record).  The tile is held at ``SSD_TILE_TOL`` at the slice, at
   a smaller case with a partial head group and at the route's other
   shapes.  The inter-chunk pass routes the same way: Q in {64, 128}, N a
   multiple of 16 and P a multiple of 32 run ``ssd_state_pass_wgmma_kernel``
   (tensor cores; the main path's), other shapes ``ssd_state_pass_kernel``
   (float32 CUDA cores, reported and timed at the slice inside the pass's
   record); the pass alone at the slice and the reference's small case,
   and the whole ``ssd_chunked`` (tile + pass) against the plain chunked
   SSD at the reference's cases, at L=1000 (a padded last chunk) and at
   the slice.  Then head dim 96 on both flash routes
   (``flash_d96_phase``: the ``flash_attention_d96`` record, phi3-mini's
   prefill attention, timed beside SDPA) and the SSD at jamba's state
   width N 16 (``jamba_ssd_phase``: the narrow tensor-core tile
   ``ssd_chunk_wgmma_n16_kernel``, timed beside ``ssd_chunk_kernel``, the
   tensor-core pass with one k16 step, and the whole ``ssd_chunked``; the
   ``ssd_chunk_tiles_n16`` and ``ssd_state_pass_n16`` records).
4b. The reference kernels' whole contracts (``contract_phase``): every
   route that takes what only those contracts ask for, none on a main
   path (each record's ``launches`` must be 0): flash attention in
   float16 and at other head dims on the tensor cores, on 16-bit inputs
   TMA cannot read on their loaded route (offsets 1-7, head dims that are
   not multiples of 8; bitwise equal to TMA's route where both run), in
   float32 at head dims 1-256 on the padded ``flash_kernel``, past 256 on
   ``flash_wide_kernel``, and on q, k, v of mixed dtypes; the generic SSD
   tile and pass (widths past 128,
   ragged P and N, float16 B/C and output, unaligned inputs; each equal
   bitwise to the fixed-shape CUDA-core kernel, and timed beside it, at
   ``SSD_FIXED_VS_GENERIC``); the gain
   kernels on float16 and mixed phi and g, and megastep at 16,384 agents.
   Each route against its plain version (float16 outputs at
   ``CONTRACT_F16_TOL``), repeated bitwise, its one launch checked, and
   timed at published shapes beside its plain version and library call.
5. Serve the LM substrate at full width in five cells (``SERVE_CELLS``):
   ``serve-mamba2-370m`` (the SSD kernels' path: per layer one tensor-core
   tile and one tensor-core state pass), ``serve-yi-6b`` (the flash
   kernel's path), ``serve-olmoe-1b-7b`` (MoE: 64 experts, top 8),
   ``serve-phi3-mini-3.8b`` (flash at head dim 96) and
   ``serve-jamba-v0.1-52b-8l`` (one super-block of the hybrid: flash, the
   narrow tensor-core SSD tile and the tensor-core pass at N 16, MoE), random
   weights from a seeded generator.  Each first checks the float32 model
   at a 1024-token prompt (kernel vs plain prefill within 1e-4 of the max
   logit, the kernel path replaying the plain path's MoE routing, with the
   free routing's flips reported and failed above ``ROUTING_TIE_MARGIN``;
   decode vs prefill at t = 3 and 1023 within 2e-3, MoE at capacity factor
   8) and compares kernel and plain prefill in bf16 (both on the float32
   plain path's MoE routing, flash also checked at the cell's attention
   shape in ``lm-kernels``), then runs the main
   path in bf16: ``build_prefill_step`` at 8192 tokens (cut from
   ``prefill_32k``'s 32768 x 32) three times and ``serve`` at batch 4, 64
   + 32 tokens, with each kernel's launch count held to the cell's
   per-prefill count x prefill calls; last, one prefill under
   ``torch.profiler`` (and, for MoE, its stages by CUDA events), its
   launches held to the cell's per-prefill counts by the wrappers' own
   counters read around that call, its trace to name no CUDA-core kernel
   (a trace without device time fails the cell) and to give the times.
   Then
   every ported arch's reduced config in float32 (``reduced_archs_phase``:
   kernel vs plain and decode vs prefill at 2 x 256 tokens; checks, not a
   main path).
6. Train the LM substrate (``TRAIN_CELLS``), random weights from a seeded
   generator, on the plain path (no kernel is on it: each entry run is
   driven with the kernel counts at 0 and must leave them there):
   ``train-mamba2-370m-12l`` at full width (d 1024) with its depth cut to
   12 of 48 layers runs ``launch.train.train`` for
   20 steps (8 agents, 8 x 1024 tokens, adamw on the cosine schedule at
   lr 3e-4, the ``hvp`` gain, eps 1, lambda 1e-3; a checkpoint written
   and restored bitwise; the loss must fall), the reference's
   ``comm_savings`` study at that size (``COMM_SAVINGS``; the batches'
   tokens held to JAX 0.9.0's digests, lambda 0 at comm rate 1, one
   step at lambda 1e9 frozen bitwise), the step on the card against the
   port's own CPU run (``TRAIN_PARITY``) and g^T H g against a central
   difference (``FD_CHECK``); ``train-yi-6b-4l`` runs the dense family
   cut to 4 layers for 5 steps.  Each reports the step's stages by CUDA
   events, an ``hvp`` step against a ``gnorm`` step, tokens/s, peak
   memory and one profiled step.
7. The paper's studies (``studies_phase``, after the training cells'
   CUDA graphs): every suite of ``benchmarks/torch_run.py`` but chaos
   (fig2, fig3, theorem1, agents_scaling, heterogeneity, degraded_edge,
   td_speedup, comm_savings, report_regen, sweep_step, kernels,
   sweep_scaling, resume_query, serve_load) at smoke scale on the card
   through ``run_suite``, rows written to a temporary out-dir, each held
   to its ``gate`` (the reference's schema; the kernels suite's own error
   bounds) and its headline numbers to JAX 0.9.0's at the module's stated
   tolerance (``fidelity``); their toy-shape launches stand in the
   phase's own line.  The full-scale suites run from
   ``python -m benchmarks.torch_run``, not here.
8. The examples (``examples_phase``, last): each of
   ``examples/torch_*.py`` through its ``main`` at its own defaults on
   the card (quickstart, serve_batched, sweep_queries,
   heterogeneity_report, federated_lm_training, train_100m at 20 steps),
   their printed lines on standard error, their launches in the phase's
   own line.

Every line before the last is one JSON object (device, build, kernels,
sweeps, studies, serving cells, each phase's seconds) except the card's
``nvidia-smi`` name and power limit; the last is ``{"ok": true, "device":
{...}}``.  Run it from the
repository root with no arguments: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

# the studies' JAX 0.9.0 numbers and bounds have one home, the study
# modules (numpy and the stdlib at import: no torch, no JAX)
from benchmarks.torch_fig3_continuous import (  # noqa: E402
    FIG3_COMMITTED, FIG3_JAX, FIG3_TOL, panel_gaps)
from benchmarks.torch_td_speedup import (  # noqa: E402
    MODES as TD_MODES, TD_COMMITTED_SPEEDUPS, TD_JAX, TD_STUDY, TD_TOL)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, the float32
# rate outside the tensor cores (what the gain and SSD kernels' function
# is computed in) and the dense bf16 tensor-core rate (attention on bf16
# inputs).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

WEIGHT_TOL = 1e-5      # weights / gains / statistics (tests/parity.py)
RATE_TOL = 1e-6        # comm_rate
# random ragged kernel inputs (normal phi, g and a non-PSD Phi) sum with
# cancellation, so the summation order shows above 1e-5; the reference's
# own kernel tests hold these cases at 2e-4 (tests/test_kernels.py)
KERNEL_TOL = 2e-4
# gain_matvec and torch.matmul at the main path's shape: alternating trials,
# enough pairs to read a win rate and the trials' spread
MATVEC_TRIALS = 10
# (T, n) of one agent: the kernel suite's (benchmarks/torch_kernels_bench.py)
# and a ragged long-T one on the generic pass; gain_matvec's tiling checks
# run at these in every dtype, at the default block_t and at
# MATVEC_BLOCK_TS (the last, None, is T itself: one tile)
MATVEC_LONG = ((4096, 2048), (4097, 1030))
MATVEC_BLOCK_TS = (16, 200, None)

MODES = ("theoretical", "practical", "norm", "random", "always", "never")
# eps as a fraction of the max stable step 1/lambda_max(Phi), for a cell
# without a fixed eps: at 1/2 the wide cell's junk agents' one-state
# batches blow the always/random/norm runs up to inf within N=100 steps,
# at 1/32 every mode stays finite
EPS_FRACTION = 1.0 / 32


class Cell(NamedTuple):
    """One sweep configuration (PERF.md "Cells")."""

    name: str
    envs: int             # garnet instances (the env grid axis)
    states: int           # S = n, the tabular feature width
    agents: int           # m
    junk: int             # junk agents per fleet
    samples: int          # T per agent per step
    iters: int            # N
    modes: tuple
    lambdas: tuple
    rhos: tuple
    seeds: tuple
    eps: Optional[float]  # None: EPS_FRACTION of the max stable step
    channels: tuple = ()  # (label, (drop_prob, delay, staleness)) rows

    @property
    def runs(self):
        return (self.envs * max(1, len(self.channels)) * len(self.modes)
                * len(self.lambdas) * len(self.rhos) * len(self.seeds))


LAMBDAS = (1e-4, 1e-3, 1e-2, 1e-1)      # np.logspace(-4, -1, 4)
# benchmarks/heterogeneity.py _scale(smoke=False), EPS and RHO, one cell per
# fleet class of that study
HET_MIXED = Cell("heterogeneity-mixed", 64, 20, 4, 2, 10, 150,
                 ("theoretical", "practical"), LAMBDAS, (0.999,), (0, 1),
                 0.4)
HET_HOMOGENEOUS = HET_MIXED._replace(name="heterogeneity-homogeneous",
                                     junk=0)
# the same study at full width: the main path's kernel shape.  Every cell
# takes the garnet defaults A=4, b=3, gamma=0.95.
WIDE = Cell("wide-192", 4, 256, 64, 16, 128, 100, MODES, LAMBDAS, (0.95,),
            (0, 1), None)
CELLS = (HET_MIXED, HET_HOMOGENEOUS, WIDE)
# benchmarks/degraded_edge.py: CHANNELS and _scale(smoke=False), with its
# clean uniform-visit fleets (num_junk=0), EPS and RHO; 7168 runs, no cut
DEGRADED_EDGE = HET_HOMOGENEOUS._replace(
    name="degraded-edge",
    channels=(("clean", (0.0, 0, 0)), ("loss10", (0.10, 0, 0)),
              ("loss30", (0.30, 0, 0)), ("delay1", (0.0, 1, 0)),
              ("delay4", (0.0, 4, 0)), ("stale1", (0.0, 0, 1)),
              ("stale8", (0.0, 0, 8))))
# the resume phase's segment: 7 segments of the 7168 runs
RESUME_CHUNK = 1024
RESUME_KEEP = 3           # chunks left after the simulated crash


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(bytes_moved, flops, peak_flops=PEAK_F32_FLOPS):
    """Least time (ms) for the work: bytes over HBM rate vs ops over the
    peak rate of their type (float32 unless given)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def rel_err(got, want, scale=None):
    """max |got - want| / scale and the max abs error.  ``scale`` defaults
    to |want| + 1, the scale-normalized error of tests/test_kernels.py.
    A gain is a difference of terms of size eps ||g||^2 that may nearly
    cancel, so gains pass the size of their terms (``gain_scale``)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = want.abs() + 1.0 if scale is None else scale
    return float((diff / scale).max()), float(diff.max())


def gain_scale(stats, eps, num_samples):
    """Per agent, the summed size of every term a gain is built from."""
    s = stats.abs()
    scale = eps * s[..., 0] + eps**2 * s[..., 1] / num_samples
    if stats.shape[-1] == 4:
        scale = scale + eps * s[..., 2] + eps**2 * s[..., 3]
    return scale + 1.0


class KernelLog:
    def __init__(self):
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.cases = 0
        self.repeat_bitwise = True
        self.tie_flips = 0
        self.extra = {}        # kernel-specific fields of its record
        self.nested = {}       # logs of routes that its record holds inside

    def close(self, name, got, want, tol, scale=None):
        rel, ab = rel_err(got, want, scale)
        self.max_rel = max(self.max_rel, rel)
        self.max_abs = max(self.max_abs, ab)
        check(rel <= tol, f"{name}: error {rel:.3g} over tolerance {tol}")

    def summary(self):
        """A nested route's entry in its record: its cases, errors, repeat
        and own fields."""
        return dict(cases=self.cases, max_abs_err=self.max_abs,
                    max_rel_err=self.max_rel,
                    repeat_bitwise=self.repeat_bitwise, **self.extra)

    def repeat(self, name, fn):
        import torch
        a, b = fn(), fn()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        self.repeat_bitwise &= same
        check(same, f"{name}: two launches on the same inputs differ")

    def decisions(self, name, got_a, want_a, want_g, thresh, tol, scale=None):
        """Exact transmit decisions, except flips whose oracle gain sits
        within tolerance of -threshold (reported, not failed)."""
        diff = got_a != want_a
        if bool(diff.any()):
            scale = want_g.abs() + 1.0 if scale is None else scale
            margin = (want_g + thresh).abs() / scale
            worst = float(margin[diff].max())
            check(worst <= tol,
                  f"{name}: {int(diff.sum())} decisions differ, margin {worst:.3g}")
            self.tie_flips += int(diff.sum())


def kernel_phase(dev):
    import torch
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    logs = {k: KernelLog() for k in ("gain_matvec", "gain_family_stats",
                                     "megastep")}

    # -- gain_matvec / practical_gain: the reference kernel tests' shapes,
    #    plus the main path's (R, m) batch
    lg = logs["gain_matvec"]
    passes = lg.extra["passes"] = {"vector": 0, "scalar": 0}
    for T, n in [(10, 6), (100, 25), (257, 130), (128, 256), (1024, 512),
                 (33, 1040)] + list(MATVEC_LONG):
        for dt in (torch.float32, torch.bfloat16):
            for batch in ((), (3, 2)):
                phi, g = randn(*batch, T, n, dtype=dt), randn(*batch, n, dtype=dt)
                vec = K.matvec_vector_pass(n, dt, phi.data_ptr(), g.data_ptr())
                passes["vector" if vec else "scalar"] += 1
                lg.close(f"gain_matvec {batch} {T}x{n} {dt}",
                         K.gain_matvec(phi, g), ref.gain_matvec_ref(phi, g), KERNEL_TOL)
                lg.close(f"practical_gain {batch} {T}x{n} {dt}",
                         K.practical_gain(phi, g, 0.5),
                         ref.practical_gain_ref(phi, g, 0.5), KERNEL_TOL)
                lg.repeat("gain_matvec", lambda: K.gain_matvec(phi, g))
                lg.cases += 1

    lg.extra["tiling"] = matvec_tiling_checks(dev, gen)

    # -- gain_family_stats: ragged agent blocks, both variants, per-run Phi
    lf = logs["gain_family_stats"]
    for m, T, n in [(1, 10, 6), (2, 8, 25), (8, 128, 256), (13, 100, 30),
                    (33, 257, 130)]:
        for dt in (torch.float32, torch.bfloat16):
            phi, g = randn(m, T, n, dtype=dt), randn(m, n, dtype=dt)
            gj, pm = randn(n), randn(n, n)
            lf.close(f"family {m}x{T}x{n} {dt}", K.gain_family_stats(phi, g, gj, pm),
                     ref.gain_family_stats_ref(phi, g, gj, pm), KERNEL_TOL)
            got2 = K.gain_family_stats(phi, g)
            lf.close(f"family 2-col {m}x{T}x{n} {dt}", got2,
                     ref.gain_family_stats_ref(phi, g), KERNEL_TOL)
            lf.repeat("gain_family_stats",
                      lambda: K.gain_family_stats(phi, g, gj, pm))
            lf.cases += 2
    G, m, T, n = 3, 5, 12, 9
    phi, g = randn(G, m, T, n), randn(G, m, n)
    gj, pm = randn(G, n), randn(G, n, n)
    lf.close("family per-run Phi", K.gain_family_stats(phi, g, gj, pm),
             ref.gain_family_stats_ref(phi, g, gj, pm), KERNEL_TOL)
    lf.cases += 1

    # -- megastep: every mode, with/without model, deliver, per-run Phi
    lm = logs["megastep"]

    def mega_case(name, R, m, T, n, dt, with_model, per_run_pm, deliver):
        phi, g = randn(R, m, T, n, dtype=dt), randn(R, m, n, dtype=dt)
        w = randn(R, n)
        arand = torch.randint(0, 2, (R, m), generator=gen).float().to(dev)
        gj = randn(R, n) if with_model else None
        pm = (randn(R, n, n) if per_run_pm else randn(n, n)) if with_model else None
        dl = (torch.randint(0, 2, (R, m), generator=gen).float().to(dev)
              if deliver else None)
        thresh = 0.8 * float(g.float().abs().median())
        for mode in range(6):
            if mode == 0 and not with_model:
                continue
            ctl = torch.tensor([[thresh, float(mode)]], device=dev).repeat(R, 1)
            got = K.megastep_call(phi, g, w, ctl, arand, gj, pm, dl, eps=0.5)
            want = ref.megastep_ref(phi, g, w, ctl, arand, gj, pm, dl, eps=0.5)
            label = f"megastep {name} mode {mode}"
            lm.decisions(label, got[1], want[1], want[2], thresh, KERNEL_TOL)
            if bool((got[1] == want[1]).all()):
                lm.close(label + " w_next", got[0], want[0], KERNEL_TOL)
            lm.close(label + " gains", got[2], want[2], KERNEL_TOL)
            lm.cases += 1
        lm.repeat("megastep", lambda: K.megastep_call(
            phi, g, w, ctl, arand, gj, pm, dl, eps=0.5))

    for m, T, n in [(2, 8, 25), (5, 37, 23), (33, 129, 30)]:
        for dt in (torch.float32, torch.bfloat16):
            mega_case(f"{m}x{T}x{n} {dt}", 2, m, T, n, dt, True, False, False)
    mega_case("model-free", 2, 5, 20, 9, torch.float32, False, False, False)
    mega_case("per-run Phi + deliver", 3, 5, 12, 9, torch.float32, True, True,
              True)
    return logs


def matvec_tiling_checks(dev, gen):
    """gain_matvec and practical_gain at MATVEC_LONG in float32, bf16 and
    float16: proj and the gain bitwise equal at the default block_t and at
    each of MATVEC_BLOCK_TS (one tile: the in-place sum the fold must
    repeat), launched alone and as the middle agent of a batch of three,
    and (on the card) in a CUDA graph's replays after a larger eager call.
    Returns each case's tile counts."""
    import torch
    from repro_torch.kernels import gain as K

    out = {}
    for T, n in MATVEC_LONG:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            batch = torch.randn(3, T, n, generator=gen).to(dt).to(dev)
            gb = torch.randn(3, n, generator=gen).to(dt).to(dev)
            phi, g = batch[1].clone(), gb[1].clone()
            label = f"gain_matvec {T}x{n} {dt}"
            base = (K.gain_matvec(phi, g), K.practical_gain(phi, g, 0.5))
            tiles = {"default": K.matvec_geometry(T, n, dt).tiles}
            for bt in MATVEC_BLOCK_TS:
                bt = T if bt is None else bt
                tiles[bt] = K.matvec_geometry(T, n, dt, bt).tiles
                got = (K.gain_matvec(phi, g, block_t=bt),
                       K.practical_gain(phi, g, 0.5, block_t=bt))
                check(all(torch.equal(x, y) for x, y in zip(got, base)),
                      f"{label}: block_t={bt} changed the bits")
            if dev.type == "cuda":   # (the plain versions' BLAS may differ)
                got = (K.gain_matvec(batch, gb)[1],
                       K.practical_gain(batch, gb, 0.5)[1])
                check(all(torch.equal(x, y) for x, y in zip(got, base)),
                      f"{label}: alone differs from inside a batch")
                for fn, larger in (
                        (lambda: K.gain_matvec(phi, g),
                         lambda: K.gain_matvec(batch, gb)),
                        (lambda: K.practical_gain(phi, g, 0.5),
                         lambda: K.practical_gain(batch, gb, 0.5))):
                    check(graph_replays_bitwise(fn, larger),
                          f"{label}: a CUDA graph's replays differ from an "
                          "eager call")
            out[label] = tiles
            del batch, gb, phi, g, base
    empty_cache(dev)
    return out


def full_shape_phase(dev, logs):
    """Each kernel at the main path's shape: agreement, bitwise repeat and
    timings of kernel, plain version and (gain_matvec) torch.matmul."""
    import torch
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref

    R, m, T, n = WIDE.runs, WIDE.agents, WIDE.samples, WIDE.states
    gen = torch.Generator(device=dev).manual_seed(1)
    # one-hot feature rows, as the tabular envs produce
    x = torch.randint(0, n, (R, m, T), device=dev, generator=gen)
    phi = torch.nn.functional.one_hot(x, n).float()
    g = torch.randn(R, m, n, device=dev, generator=gen)
    w = torch.randn(R, n, device=dev, generator=gen)
    gj = torch.randn(R, n, device=dev, generator=gen)
    pm = torch.eye(n, device=dev).expand(R, n, n).contiguous() / n
    # a distinct, non-symmetric Phi per run, so that a wrong per-run offset
    # shows (the tabular envs' Phi is I/S for every run)
    pm_rand = torch.randn(R, n, n, device=dev, generator=gen) / n
    arand = (torch.rand(R, m, device=dev, generator=gen) < 0.5).float()
    deliver = (torch.rand(R, m, device=dev, generator=gen) < 0.7).float()
    out = {}

    # gain_matvec: projection + eq. 15 over all R*m agents in one launch,
    # through the kernel's vector pass
    lg = logs["gain_matvec"]
    check(K.matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr()),
          "gain_matvec: the main path's shape does not take the vector pass")
    lg.close("gain_matvec full", K.gain_matvec(phi, g), ref.gain_matvec_ref(phi, g), WEIGHT_TOL)
    lg.close("practical_gain full", K.practical_gain(phi, g, 8.0),
             ref.practical_gain_ref(phi, g, 8.0), WEIGHT_TOL)
    lg.repeat("gain_matvec full", lambda: K.practical_gain(phi, g, 8.0))
    b_ms, b_by = bound(nbytes(phi, g) + R * m * T * 4, 2 * R * m * T * n)
    # kernel and torch.matmul timed in alternating trials; the record keeps
    # every trial's median, so the comparison shows its spread
    trials = {"ms": [], "library_ms": []}
    for _ in range(MATVEC_TRIALS):
        trials["ms"].append(time_ms(lambda: K.gain_matvec(phi, g)))
        trials["library_ms"].append(
            time_ms(lambda: torch.matmul(phi, g.unsqueeze(-1))))
    lg.extra["trials"] = trials
    lg.extra["kernel_suite"] = matvec_suite_timing(dev)
    out["gain_matvec"] = dict(
        ms=statistics.median(trials["ms"]),
        plain_ms=time_ms(lambda: ref.gain_matvec_ref(phi, g)),
        library_ms=statistics.median(trials["library_ms"]),
        bound_ms=b_ms, bound_by=b_by)

    lf = logs["gain_family_stats"]
    lf.close("family full", K.gain_family_stats(phi, g, gj, pm),
             ref.gain_family_stats_ref(phi, g, gj, pm), WEIGHT_TOL)
    lf.close("family full per-run random Phi",
             K.gain_family_stats(phi, g, gj, pm_rand),
             ref.gain_family_stats_ref(phi, g, gj, pm_rand), WEIGHT_TOL)
    lf.close("family full 2-col", K.gain_family_stats(phi, g),
             ref.gain_family_stats_ref(phi, g), WEIGHT_TOL)
    lf.repeat("family full", lambda: K.gain_family_stats(phi, g, gj, pm))
    fam_flops = 2 * R * m * (T * n + T + 2 * n + n * n)
    b_ms, b_by = bound(nbytes(phi, g, gj, pm) + R * m * 4 * 4, fam_flops)
    out["gain_family_stats"] = dict(
        ms=time_ms(lambda: K.gain_family_stats(phi, g, gj, pm)),
        plain_ms=time_ms(lambda: ref.gain_family_stats_ref(phi, g, gj, pm)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)

    lm = logs["megastep"]
    modes = torch.arange(R, device=dev) % 6
    for dl in (None, deliver):
        for pmx in (pm, pm[0].contiguous(), pm_rand):
            stats = ref.gain_family_stats_ref(phi, g, gj, pmx)
            gains0 = ref.gains_from_stats_ref(stats, modes.unsqueeze(-1), 8.0, T)
            # ~half transmit; the midpoint of two middle |gains|, so that no
            # oracle gain sits exactly on its threshold
            mid = gains0.abs().sort(dim=-1).values[:, m // 2 - 1: m // 2 + 1]
            thresh = mid.mean(dim=-1)
            ctl = torch.stack([thresh, modes.float()], -1).contiguous()
            got = K.megastep_call(phi, g, w, ctl, arand, gj, pmx, dl, eps=8.0)
            want = ref.megastep_ref(phi, g, w, ctl, arand, gj, pmx, dl, eps=8.0)
            label = (f"megastep full deliver={dl is not None} "
                     f"pm={tuple(pmx.shape)} random={pmx is pm_rand}")
            scale = gain_scale(stats, 8.0, T)
            lm.decisions(label, got[1], want[1], want[2], thresh.unsqueeze(-1),
                         WEIGHT_TOL, scale)
            same = (got[1] == want[1]).all(dim=-1)
            lm.close(label + " w_next", got[0][same], want[0][same], WEIGHT_TOL)
            lm.close(label + " gains", got[2], want[2], WEIGHT_TOL, scale)
            lm.cases += 1
    lm.repeat("megastep full", lambda: K.megastep_call(
        phi, g, w, ctl, arand, gj, pm, deliver, eps=8.0))
    mega_bytes = nbytes(phi, g, w, ctl, arand, gj, pm) + (R * n + 2 * R * m) * 4
    b_ms, b_by = bound(mega_bytes, fam_flops + 2 * R * m * n)
    out["megastep"] = dict(
        ms=time_ms(lambda: K.megastep_call(phi, g, w, ctl, arand, gj, pm,
                                           eps=8.0)),
        plain_ms=time_ms(lambda: ref.megastep_ref(phi, g, w, ctl, arand, gj,
                                                  pm, eps=8.0)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    slice_shapes_phase(dev, logs, gen)
    family_phase(dev, logs)
    return out


def matvec_suite_timing(dev):
    """gain_matvec at the kernel suite's one agent (MATVEC_LONG[0], float32)
    in alternating trials beside ``phi @ g`` (torch.matmul, the plain
    version's one call), practical_gain (the fold over its tiles) and the
    one-tile layout (block_t = T, one block for the agent), with the bound:
    phi and g read once, proj written once."""
    import torch
    from repro_torch.kernels import gain as K
    T, n = MATVEC_LONG[0]
    gen = torch.Generator(device=dev).manual_seed(4)
    phi = torch.randn(T, n, device=dev, generator=gen)
    g = torch.randn(n, device=dev, generator=gen)
    b_ms, b_by = bound(nbytes(phi, g) + T * 4, 2 * T * n)
    trials = {"ms": [], "library_ms": []}
    for _ in range(MATVEC_TRIALS):
        trials["ms"].append(time_ms(lambda: K.gain_matvec(phi, g)))
        trials["library_ms"].append(time_ms(lambda: phi @ g))
    return dict(
        T_n=[T, n], dtype="float32", geometry=K.matvec_geometry(
            T, n, phi.dtype)._asdict(),
        ms=statistics.median(trials["ms"]),
        library_ms=statistics.median(trials["library_ms"]),
        practical_gain_ms=time_ms(lambda: K.practical_gain(phi, g)),
        one_tile_ms=time_ms(lambda: K.gain_matvec(phi, g, block_t=T)),
        ms_graph=time_graph_ms(lambda: K.gain_matvec(phi, g)),
        library_ms_graph=time_graph_ms(lambda: phi @ g),
        bound_ms=b_ms, bound_by=b_by, trials=trials)


# (label, (R, m, T, n), one-hot phi): the kernels' shapes on this slice's
# main paths — Fig. 3's dense polynomial phi (partial 4-agent blocks, rows
# of n = 6 on the scalar pass), the TD study's one-hot phi at each m, the
# gridworld's value iteration and Q-learning's S x A features
SLICE_SHAPES = (("fig3-2agents", (3, 2, 1000, 6), False),
                ("fig3-10agents", (1, 10, 1000, 6), False),
                ("td m=1", (36, 1, 8, 10), True),
                ("td m=4", (36, 4, 8, 10), True),
                ("td m=16", (36, 16, 8, 10), True),
                ("td m=64", (36, 64, 8, 10), True),
                ("value-iteration", (1, 2, 20, 25), True),
                ("q-learning", (1, 2, 60, 100), True))


def family_inputs(dev, gen, shape, onehot):
    """Inputs of gain_family_stats and megastep_call at (R, m, T, n): phi
    one-hot (the tabular envs) or uniform (Fig. 3's dense features), g, w,
    a per-run grad J and Phi, random-mode draws, and per-run controls
    (modes 0-5 in turn, thresholds near the middle |gain| at eps 0.5)."""
    import torch
    from repro_torch.kernels import ref
    R, m, T, n = shape
    if onehot:
        x = torch.randint(0, n, (R, m, T), device=dev, generator=gen)
        phi = torch.nn.functional.one_hot(x, n).float()
    else:
        phi = torch.rand(R, m, T, n, device=dev, generator=gen)
    g = torch.randn(R, m, n, device=dev, generator=gen)
    w = torch.randn(R, n, device=dev, generator=gen)
    gj = torch.randn(R, n, device=dev, generator=gen)
    pm = torch.randn(R, n, n, device=dev, generator=gen) / n
    arand = (torch.rand(R, m, device=dev, generator=gen) < 0.5).float()
    stats = ref.gain_family_stats_ref(phi, g, gj, pm)
    modes = torch.arange(R, device=dev) % 6
    gains0 = ref.gains_from_stats_ref(stats, modes.unsqueeze(-1), 0.5, T)
    thresh = gains0.abs().median(dim=-1).values * 0.9 + 1e-3
    ctl = torch.stack([thresh, modes.float()], -1).contiguous()
    return dict(phi=phi, g=g, w=w, gj=gj, pm=pm, arand=arand, ctl=ctl,
                stats=stats)


def family_check(logs, label, inp, **blocks):
    """gain_family_stats and megastep_call (with ``blocks``) against their
    plain versions at WEIGHT_TOL, decisions exact but for reported ties,
    and each repeated bitwise.  Returns the two kernels' outputs."""
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref
    lf, lm = logs["gain_family_stats"], logs["megastep"]
    phi, g, w, gj, pm = (inp[k] for k in ("phi", "g", "w", "gj", "pm"))
    ctl, arand, stats = inp["ctl"], inp["arand"], inp["stats"]
    T = phi.shape[-2]
    fam = K.gain_family_stats(phi, g, gj, pm, **blocks)
    lf.close(f"family {label}", fam, stats, WEIGHT_TOL)
    lf.repeat(f"family {label}",
              lambda: K.gain_family_stats(phi, g, gj, pm, **blocks))
    lf.cases += 1
    got = K.megastep_call(phi, g, w, ctl, arand, gj, pm, eps=0.5, **blocks)
    want = ref.megastep_ref(phi, g, w, ctl, arand, gj, pm, eps=0.5)
    scale = gain_scale(stats, 0.5, T)
    thresh = ctl[:, :1]
    lm.decisions(f"megastep {label}", got[1], want[1], want[2], thresh,
                 WEIGHT_TOL, scale)
    same = (got[1] == want[1]).all(dim=-1)
    lm.close(f"megastep {label} w_next", got[0][same], want[0][same],
             WEIGHT_TOL)
    lm.close(f"megastep {label} gains", got[2], want[2], WEIGHT_TOL, scale)
    lm.repeat(f"megastep {label}", lambda: K.megastep_call(
        phi, g, w, ctl, arand, gj, pm, eps=0.5, **blocks))
    lm.cases += 1
    return fam, got


def slice_shapes_phase(dev, logs, gen):
    """Each gain kernel at SLICE_SHAPES against its plain version, with the
    pass ``gain_matvec`` takes there (vector only for n = 100)."""
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref

    lg = logs["gain_matvec"]
    passes = lg.extra.setdefault("slice_shape_passes", {})
    for label, shape, onehot in SLICE_SHAPES:
        inp = family_inputs(dev, gen, shape, onehot)
        phi, g = inp["phi"], inp["g"]
        n = shape[-1]
        vec = K.matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr())
        check(vec == (n % 4 == 0), f"gain_matvec {label}: vector pass {vec}")
        passes[label] = "vector" if vec else "scalar"
        lg.close(f"gain_matvec {label}", K.gain_matvec(phi, g),
                 ref.gain_matvec_ref(phi, g), WEIGHT_TOL)
        lg.close(f"practical_gain {label}", K.practical_gain(phi, g, 0.5),
                 ref.practical_gain_ref(phi, g, 0.5), WEIGHT_TOL)
        lg.cases += 1
        family_check(logs, label, inp)


# family_stats_kernel's shapes (label, (R, m, T, n), one-hot phi), each
# timed with both of its wrappers beside their plain versions and bounds:
# the main path's (wide-192), the kernel suite's gain_family_stats with a
# model (benchmarks/torch_kernels_bench.py: m 64 x T 1024 x n 512, as one
# run) and every SLICE_SHAPES entry
FAMILY_SUITE = ("kernel-suite", (1, 64, 1024, 512), False)
FAMILY_TIMED = (("wide-192", (WIDE.runs, WIDE.agents, WIDE.samples,
                              WIDE.states), True), FAMILY_SUITE) + SLICE_SHAPES
# shapes of the alone-versus-batched check: the main path's, and two of
# several T-tiles (the vector pass with a ragged agent block, and Fig. 3's
# lane-group pass); runs of each batch launched alone: first, middle, last
FAMILY_ALONE = (FAMILY_TIMED[0], ("multi-tile", (8, 6, 1000, 64), False),
                SLICE_SHAPES[0])
# one non-default tiling through REPRO_TORCH_KERNEL_BLOCKS, and per-call
# overrides (agents per block and rows per T-tile)
FAMILY_ENV_BLOCKS = "block_m=3,family_block_t=48,megastep_block_m=5"
# (R, m, T, n): 4,096 agent blocks of two T-tiles at the default tiling
FAMILY_GROW = (256, 64, 128, 8)
FAMILY_CALL_BLOCKS = dict(block_m=1, block_t=200)
GRAPH_CALLS = 20
LOOP_CALLS = 200


def _graph(fn, calls, stream=None):
    """A CUDA graph of ``calls`` calls of ``fn()`` (warmed up on a side
    stream first, as torch.cuda.graph asks; captured on ``stream``, else
    torch's capture stream) and the last call's output."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            out = fn()
    return graph, out


def time_graph_ms(fn, calls=GRAPH_CALLS, reps=5):
    """Median over ``reps`` replays of a CUDA graph of ``calls`` calls of
    ``fn()``, per call: the device's time with no host work between
    launches."""
    import torch
    graph, _ = _graph(fn, calls)
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def loop_ms(fn, calls=LOOP_CALLS):
    """Wall time per call of ``calls`` back-to-back calls of ``fn()`` and
    one synchronize: what a step loop pays for the call, the host's work
    included (the larger of the host's and the device's time a call)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def graph_replays_bitwise(fn, larger, replays=3):
    """Whether ``fn()`` captured in a CUDA graph gives an eager call's
    outputs bitwise on every replay, after ``larger()`` (a launch of more
    agent blocks) and ``fn()`` ran eagerly on the capture stream (the family
    kernel's arrival counters are the call's own scratch, zeroed with it,
    so nothing a graph holds can go stale)."""
    import torch
    tup = lambda x: x if isinstance(x, tuple) else (x,)
    want = tup(fn())
    stream = torch.cuda.Stream()
    graph, out = _graph(fn, 1, stream)
    out = tup(out)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        larger()
        eager = tup(fn())
    torch.cuda.synchronize()
    ok = all(torch.equal(x, y) for x, y in zip(eager, want))
    for _ in range(replays):
        for o in out:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        ok &= all(torch.equal(x, y) for x, y in zip(out, want))
    return ok


def family_timing(K, ref, inp, **blocks):
    """gain_family_stats and megastep_call (``K``, with ``blocks``) and their
    plain versions (``ref``) timed on ``inp`` (``time_ms``, ``loop_ms`` and
    a CUDA graph's replay), with their bounds: bytes read once and written
    once (Phi once per run), operations 2 R m (T n + T + 2 n + n^2) (+ 2 R
    m n for megastep's update)."""
    phi, g, w, gj, pm = (inp[k] for k in ("phi", "g", "w", "gj", "pm"))
    ctl, arand = inp["ctl"], inp["arand"]
    R, m, T, n = phi.shape
    fam_flops = 2 * R * m * (T * n + T + 2 * n + n * n)
    fb, fby = bound(nbytes(phi, g, gj, pm) + R * m * 4 * 4, fam_flops)
    mb, mby = bound(nbytes(phi, g, w, ctl, arand, gj, pm)
                    + (R * n + 2 * R * m) * 4, fam_flops + 2 * R * m * n)
    fam = lambda: K.gain_family_stats(phi, g, gj, pm, **blocks)
    mega = lambda: K.megastep_call(phi, g, w, ctl, arand, gj, pm, eps=0.5,
                                   **blocks)
    fam_plain = lambda: ref.gain_family_stats_ref(phi, g, gj, pm)
    mega_plain = lambda: ref.megastep_ref(phi, g, w, ctl, arand, gj, pm,
                                          eps=0.5)
    return {
        "gain_family_stats": dict(
            ms=time_ms(fam), ms_loop=loop_ms(fam),
            ms_graph=time_graph_ms(fam), plain_ms=time_ms(fam_plain),
            plain_ms_loop=loop_ms(fam_plain),
            plain_ms_graph=time_graph_ms(fam_plain),
            bound_ms=fb, bound_by=fby),
        "megastep": dict(
            ms=time_ms(mega), ms_loop=loop_ms(mega),
            ms_graph=time_graph_ms(mega), plain_ms=time_ms(mega_plain),
            plain_ms_loop=loop_ms(mega_plain),
            plain_ms_graph=time_graph_ms(mega_plain),
            bound_ms=mb, bound_by=mby)}


def _run_slice(inp, r):
    """Run r of a batch's family inputs as a batch of one, copied apart."""
    return {k: v[r:r + 1].clone() for k, v in inp.items()}


def family_alone_check(logs, label, inp, **blocks):
    """Each of three runs launched alone equals its slice of the batched
    launch bitwise: the statistics and megastep's three outputs."""
    import torch
    from repro_torch.kernels import gain as K
    R = inp["phi"].shape[0]
    args = lambda d: (d["phi"], d["g"], d["gj"], d["pm"])
    mega = lambda d: K.megastep_call(d["phi"], d["g"], d["w"], d["ctl"],
                                     d["arand"], d["gj"], d["pm"], eps=0.5,
                                     **blocks)
    fam_all = K.gain_family_stats(*args(inp), **blocks)
    mega_all = mega(inp)
    runs = sorted({0, R // 2, R - 1})
    for r in runs:
        one = _run_slice(inp, r)
        check(torch.equal(K.gain_family_stats(*args(one), **blocks),
                          fam_all[r:r + 1]),
              f"family {label}: run {r} alone differs from the batch")
        for name, x, y in zip(("w_next", "alphas", "gains"), mega(one),
                              mega_all):
            check(torch.equal(x, y[r:r + 1]),
                  f"megastep {label}: run {r} alone differs in {name}")
    return runs


def family_phase(dev, logs):
    """family_stats_kernel's layout on the card.  At FAMILY_TIMED: both
    wrappers against their plain versions, timed beside them and their
    bounds, with block_m alone changed the same bits; at FAMILY_ALONE, runs
    launched alone equal to their slices of the batch, bitwise, and each
    wrapper's CUDA graph replayed equal to an eager call; and all of it
    again under FAMILY_ENV_BLOCKS and under FAMILY_CALL_BLOCKS."""
    import torch
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(2)
    # more agent blocks than any FAMILY_ALONE shape, launched eagerly on a
    # graph's capture stream between its capture and its replays
    grow = family_inputs(dev, torch.Generator(device=dev).manual_seed(3),
                         FAMILY_GROW, False)
    lf, lm = logs["gain_family_stats"], logs["megastep"]
    timed = {"gain_family_stats": [], "megastep": []}
    alone, replay = {}, {}
    settings = (("default", None, {}),
                ("env " + FAMILY_ENV_BLOCKS, FAMILY_ENV_BLOCKS, {}),
                ("per call " + json.dumps(FAMILY_CALL_BLOCKS), None,
                 FAMILY_CALL_BLOCKS))
    for label, shape, onehot in FAMILY_TIMED + FAMILY_ALONE[1:2]:
        inp = family_inputs(dev, gen, shape, onehot)
        for name, env, blocks in settings:
            with blocks_env(env):
                tag = f"{label} [{name}]"
                fam, mega = family_check(logs, tag, inp, **blocks)
                if not blocks:
                    # bm only regroups agents: the bits stay
                    bm = dict(block_m=1)
                    check(torch.equal(K.gain_family_stats(
                        inp["phi"], inp["g"], inp["gj"], inp["pm"], **bm),
                        fam), f"family {tag}: block_m=1 changed the bits")
                    got = K.megastep_call(
                        inp["phi"], inp["g"], inp["w"], inp["ctl"],
                        inp["arand"], inp["gj"], inp["pm"], eps=0.5, **bm)
                    check(all(torch.equal(x, y) for x, y in zip(got, mega)),
                          f"megastep {tag}: block_m=1 changed the bits")
                if any(label == a[0] for a in FAMILY_ALONE):
                    alone[tag] = family_alone_check(logs, tag, inp, **blocks)
                    if dev.type == "cuda":
                        replay[tag] = [graph_replays_bitwise(
                            fn, lambda: fn(grow)) for fn in (
                            lambda d=inp: K.gain_family_stats(
                                d["phi"], d["g"], d["gj"], d["pm"], **blocks),
                            lambda d=inp: K.megastep_call(
                                d["phi"], d["g"], d["w"], d["ctl"], d["arand"],
                                d["gj"], d["pm"], eps=0.5, **blocks))]
                        check(all(replay[tag]), f"family {tag}: a CUDA "
                              "graph's replays differ from an eager call")
                if env is None and not blocks and any(
                        label == t[0] for t in FAMILY_TIMED):
                    for k, v in family_timing(K, ref, inp).items():
                        timed[k].append(dict(shape=label,
                                             R_m_T_n=list(shape), **v))
        del inp
        empty_cache(dev)
    lf.extra["shapes"] = timed["gain_family_stats"]
    lm.extra["shapes"] = timed["megastep"]
    lf.extra["alone_vs_batched_bitwise"] = alone
    lf.extra["graph_replays_bitwise"] = replay
    lf.extra["block_settings"] = [s[0] for s in settings]


class blocks_env:
    """Set REPRO_TORCH_KERNEL_BLOCKS to ``value`` inside the block (None:
    leave it), and restore it on leaving."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        if self.value is not None:
            from repro_torch.kernels import gain as K
            self.old = os.environ.get(K.BLOCKS_ENV)
            os.environ[K.BLOCKS_ENV] = self.value

    def __exit__(self, *exc):
        if self.value is None:
            return
        from repro_torch.kernels import gain as K
        if self.old is None:
            os.environ.pop(K.BLOCKS_ENV, None)
        else:
            os.environ[K.BLOCKS_ENV] = self.old


# ---------------------------------------------------------------------------
# Phase 3: the full-width sweep on every step backend
# ---------------------------------------------------------------------------


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


# kernel each step backend runs, and its launches per sweep step
EXPECT = {"reference": ("gain_matvec", 1), "fused": ("gain_family_stats", 1),
          "megastep": ("megastep", 2)}


def sweep_phase(dev, cell):
    """One cell under every kernel step backend and once on plain torch."""
    import numpy as np
    import torch
    from repro_torch.core.algorithm1 import ParamSampler, TraceSpec
    from repro_torch.envs import (family_sampler_fn, garnet_env_family,
                                  garnet_fleet_sets)
    from repro_torch.experiments import SweepSpec, run_sweep

    w0 = np.zeros(cell.states, np.float32)
    envs, fam = garnet_env_family(cell.envs, num_states=cell.states,
                                  device=dev)
    fleets = garnet_fleet_sets(envs, w0, cell.agents, num_junk=cell.junk)
    eps = (cell.eps if cell.eps is not None else
           EPS_FRACTION * envs[0].vfa_problem(w0).max_stable_stepsize())
    sampler = ParamSampler(family_sampler_fn(cell.samples), None)
    G, N = cell.runs, cell.iters
    results, lines, launches = {}, [], {}
    for step, gain in (("reference", "reference"), ("reference", "kernel"),
                       ("fused", "kernel"), ("megastep", "kernel")):
        spec = SweepSpec(modes=cell.modes, lambdas=cell.lambdas,
                         seeds=cell.seeds, rhos=cell.rhos, eps=eps,
                         num_iterations=N, num_agents=cell.agents,
                         trace=TraceSpec(alphas=True, gains=True),
                         step_backend=step, gain_backend=gain)
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_all_launches()                   # the chaos sweeps start here
        t0 = time.perf_counter()
        res = run_sweep(spec, sampler, w0, env_sets=fam, fleet_sets=fleets,
                        device=dev)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = all_launches()                # ... and ends here
        label = f"{cell.name} {step}/{gain}"
        if gain == "kernel":
            name, per_step = EXPECT[step]
            check(counts[name] == per_step * N,
                  f"{label}: {name} launched {counts[name]} times, "
                  f"expected {per_step * N}")
            check(sum(counts.values()) == counts[name],
                  f"{label}: other kernels launched: {counts}")
            launches[name] = counts[name]
        else:
            check(sum(counts.values()) == 0, f"{label}: launched {counts}")
        tr = res.trace
        check(tuple(tr.final_weights.shape)
              == (cell.envs, len(cell.modes), len(cell.lambdas),
                  len(cell.rhos), len(cell.seeds), cell.states),
              f"{label}: final weights shape {tuple(tr.final_weights.shape)}")
        check(bool(torch.isfinite(tr.final_weights).all())
              and bool(torch.isfinite(res.j_final).all()),
              f"{label}: non-finite weights or J")
        results[(step, gain)] = res
        lines.append(dict(
            cell=cell.name, sweep=f"{step}+{gain}", runs=G,
            agents=cell.agents, junk=cell.junk, samples=cell.samples,
            states=cell.states, iterations=N, eps=eps, wall_s=wall,
            run_agent_steps_per_s=G * cell.agents * N / wall,
            peak_mem_bytes=(int(torch.cuda.max_memory_allocated())
                            if dev.type == "cuda" else None),
            launches=counts))

    oracle = results[("reference", "reference")]
    # lambda_k of every flattened run, in grid order (env, mode, lam, rho, seed)
    grid = tuple(oracle.comm_rate.shape)
    thresholds = np.broadcast_to(
        spec.thresholds()[None, None, :, :, None, :],
        grid + (N,)).reshape(-1, N)
    for key, res in results.items():
        if key == ("reference", "reference"):
            continue
        cmp = compare_sweeps(res, oracle, thresholds, cell)
        next(l for l in lines if l["sweep"] == "+".join(key)).update(cmp)
    lines[0].update(comm_rate_mean=float(oracle.comm_rate.mean()),
                    j_final_mean=float(oracle.j_final.mean()))
    mega = next(l for l in lines if l["sweep"] == "megastep+kernel")
    lines.append({"cell": cell.name, "step_breakdown_ms": dict(
        step_breakdown(dev, cell, fam, fleets, eps),
        sweep_step_ms=mega["wall_s"] / N * 1e3)})
    return lines, launches


def compare_sweeps(got, ref, thresholds, cell):
    """Decisions exact per run up to its first flip; a flip whose oracle gain
    sits within tolerance of -lambda_k is a tie (counted, its run set
    aside); every other run must match at the parity tolerances."""
    import torch
    ga, ra = got.trace.alphas, ref.trace.alphas           # (..., N, m)
    flat = lambda x: x.reshape(-1, *x.shape[-2:])
    ga, ra, rg = flat(ga), flat(ra), flat(ref.trace.gains)
    # a gain nearly cancels terms of size eps ||g||^2 (see rel_err): its
    # error is measured against the run's largest gain
    run_scale = rg.abs().amax(dim=(1, 2)) + 1.0
    diff = (ga != ra)
    runs_flipped = diff.any(dim=(1, 2))
    tie_margin = 0.0
    for r in torch.nonzero(runs_flipped).flatten().tolist():
        k = int(torch.nonzero(diff[r].any(dim=-1))[0])
        agents = diff[r, k]
        gain = rg[r, k][agents]
        lam_k = float(thresholds[r, k])
        margin = float(((gain + lam_k).abs() / run_scale[r]).max())
        check(margin <= WEIGHT_TOL,
              f"{cell.name} run {r} step {k}: decision differs, "
              f"gain margin {margin:.3g}")
        tie_margin = max(tie_margin, margin)
    keep = ~runs_flipped
    check(bool(keep.any()), f"{cell.name}: every run's decisions flipped")
    fw = lambda res: res.trace.final_weights.reshape(-1, cell.states)
    w_rel, w_abs = rel_err(fw(got)[keep], fw(ref)[keep])
    check(w_rel <= WEIGHT_TOL, f"{cell.name}: final weights differ by {w_rel:.3g}")
    g_rel = rel_err(flat(got.trace.gains)[keep], rg[keep],
                    run_scale[keep, None, None])[0]
    per_agent = lambda x: x.reshape(-1, cell.agents)[keep]
    for field in ("gain_mean", "gain_min", "gain_max"):
        g_rel = max(g_rel, rel_err(per_agent(getattr(got.trace, field)),
                                   per_agent(getattr(ref.trace, field)),
                                   run_scale[keep, None])[0])
    check(g_rel <= WEIGHT_TOL, f"{cell.name}: gain statistics differ by {g_rel:.3g}")
    rate = float((got.comm_rate.flatten()[keep]
                  - ref.comm_rate.flatten()[keep]).abs().max())
    check(rate <= RATE_TOL, f"{cell.name}: comm_rate differs by {rate:.3g}")
    check(bool(torch.equal(per_agent(got.trace.tx_counts),
                           per_agent(ref.trace.tx_counts))),
          f"{cell.name}: tx_counts differ outside tie-flipped runs")
    out = dict(weights_max_rel=w_rel, weights_max_abs=w_abs,
               gains_max_rel=g_rel, comm_rate_max_abs=rate,
               tie_flipped_runs=int(runs_flipped.sum()),
               tie_margin_max=tie_margin)
    if ref.trace.delivered_counts is not None:
        check(bool(torch.equal(per_agent(got.trace.delivered_counts),
                               per_agent(ref.trace.delivered_counts))),
              f"{cell.name}: delivered_counts differ outside tie-flipped runs")
        out["delivered_rate_max_abs"] = float(
            (got.trace.delivered_rate.flatten()[keep]
             - ref.trace.delivered_rate.flatten()[keep]).abs().max())
        check(out["delivered_rate_max_abs"] <= RATE_TOL,
              f"{cell.name}: delivered_rate differs by "
              f"{out['delivered_rate_max_abs']:.3g}")
    return dict(vs_plain=out)


def step_breakdown(dev, cell, fam, fleets, eps):
    """CUDA-event times of each stage of one megastep+kernel sweep step of
    ``cell``, as the engine runs it: one pass of key-only draws for as
    many steps as ``DRAW_BYTES`` holds (every run's step-key split and
    random-mode draw, the keep mask on a channel, and the distinct sample
    streams' batches — one per env and seed — for every step of the
    pass), reported per pass and per step; then per step the gather to
    every run, the gradients, grad J and the megastep kernel (and on a
    channel the stale ring's read and write)."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import algorithm1 as A1
    from repro_torch.core import vfa
    from repro_torch.core.algorithm1 import ProblemTerms
    from repro_torch.envs import family_sampler_fn
    from repro_torch.kernels import gain as K

    G, E, S = cell.runs, cell.envs, len(cell.seeds)
    m, T, nmodes = cell.agents, cell.samples, len(cell.modes)
    # grid order (env, [channel,] mode, lam, rho, seed): run -> (env, seed)
    run = torch.arange(G, device=dev)
    env_of, seed_of = run // (G // E), run % S
    mode_of = run // (len(cell.lambdas) * len(cell.rhos) * S) % nmodes
    stream_env = torch.arange(E, device=dev).repeat_interleave(S)
    stream_seed = torch.arange(S, device=dev).repeat(E)
    first = stream_env * (G // E) + stream_seed      # a stream's first run
    inv = env_of * S + seed_of
    run_keys = trandom.split(trandom.keys(cell.seeds).to(dev),
                             cell.iters)[seed_of]           # (G, N, 2)
    env = {k: v[stream_env] for k, v in fam.params.items()}
    params = {k: v.to(dev)[stream_env] for k, v in fleets.items()}
    fn = family_sampler_fn(T)
    tx_p = torch.full((G,), 0.5, device=dev)
    keep_p = torch.rand(G, m, device=dev)

    def draw_pass(b):
        ks = run_keys[:, :b]
        rngs = trandom.split(ks, m + 1)
        arand = trandom.bernoulli(rngs[:, :, m], tx_p.view(G, 1, 1),
                                  (m,)).float()
        keep = (trandom.bernoulli(trandom.fold_in(ks, 1),
                                  keep_p.unsqueeze(1), (m,)).float()
                if cell.channels else None)

        def per_step(t):
            return t.unsqueeze(1).expand((t.shape[0], b) + t.shape[1:]
                                         ).reshape((-1,) + t.shape[1:])
        eb = {k: per_step(v) for k, v in env.items()}
        pb = {k: per_step(v) for k, v in params.items()}
        phi_u, y_u = A1.steps_at_once(lambda r: fn(eb, pb, r),
                                      rngs[first][:, :, :m])
        return arand, keep, phi_u, y_u

    one = draw_pass(1)
    per_step = sum(t.numel() * t.element_size() for t in one if t is not None)
    arand, _, phi_u, y_u = one
    b = max(1, min(cell.iters, A1.DRAW_BYTES // per_step))
    phi_u, y_u, arand = phi_u[:, 0], y_u[:, 0], arand[:, 0].contiguous()
    phi, y = phi_u[inv], y_u[inv]
    w = torch.zeros(G, cell.states, device=dev)
    terms = ProblemTerms(*(t[env_of] for t in fam.terms))
    grads = vfa.stochastic_gradient(w.unsqueeze(1), phi, y)
    gj = terms.grad(w)
    ctl = torch.stack([torch.full((G,), 1e-3, device=dev),
                       mode_of.float()], -1).contiguous()
    stages = {
        "gather_to_runs": lambda: (phi_u[inv], y_u[inv]),
        "stochastic_gradients": lambda: vfa.stochastic_gradient(
            w.unsqueeze(1), phi, y),
        "grad_j": lambda: terms.grad(w),
        "megastep_kernel": lambda: K.megastep_call(
            phi, grads, w, ctl, arand, gj, terms.phi_matrix, eps=eps),
    }
    if cell.channels:
        # the channel's own per-step work: each run's stale-ring read and
        # write (its keep mask is drawn in the pass)
        ring = w.unsqueeze(1).repeat(1, 9, 1)
        lag = torch.randint(0, 9, (G,), device=dev)
        stages.update(
            stale_ring_read=lambda: ring[run, lag],
            stale_ring_write=lambda: ring.__setitem__((slice(None), 3), w))
    pass_ms = time_ms(lambda: draw_pass(b), reps=5, warmup=1)
    out = {"key_only_draws_per_step": pass_ms / b}
    out.update({name: time_ms(stage, reps=10)
                for name, stage in stages.items()})
    out["sum_ms"] = sum(out.values())
    out.update(key_only_draws_pass_ms=pass_ms, steps_per_pass=b)
    return out


# ---------------------------------------------------------------------------
# Phase 3b: the degraded-edge study through the channel, the resumable
# runtime and the store
# ---------------------------------------------------------------------------


def check_launches(label, counts, expected):
    """Every kernel's launches in one main-path run equal ``expected``
    (kernels it leaves out: none)."""
    want = {k: expected.get(k, 0) for k in counts}
    check(counts == want, f"{label}: launches {counts}, expected {want}")


def edge_inputs(dev, cell):
    import numpy as np
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import (family_sampler_fn, garnet_env_family,
                                  garnet_fleet_sets)
    w0 = np.zeros(cell.states, np.float32)
    envs, fam = garnet_env_family(cell.envs, num_states=cell.states,
                                  device=dev)
    fleets = garnet_fleet_sets(envs, w0, cell.agents, num_junk=cell.junk)
    return dict(sampler=ParamSampler(family_sampler_fn(cell.samples), None),
                w0=w0, env_sets=fam, fleet_sets=fleets)


def edge_spec(cell, channels, **kw):
    from repro_torch.core.channel import ChannelSpec
    from repro_torch.experiments import SweepSpec
    return SweepSpec(
        modes=cell.modes, lambdas=cell.lambdas, seeds=cell.seeds,
        rhos=cell.rhos, eps=cell.eps, num_iterations=cell.iters,
        num_agents=cell.agents,
        channel_sets=(None if channels is None else
                      tuple(ChannelSpec(*c) for _, c in channels)), **kw)


def timed(dev, fn):
    """(result, wall s, launches, peak bytes) of one main-path run."""
    import torch
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_all_launches()                   # the chaos sweeps start here
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = all_launches()                # ... and ends here
    peak = (int(torch.cuda.max_memory_allocated()) if dev.type == "cuda"
            else None)
    return out, wall, counts, peak


def per_channel_rates(res, labels):
    """comm_rate and delivered_rate means per channel (axis 1)."""
    tr = res.trace
    dims = tuple(d for d in range(tr.delivered_rate.dim()) if d != 1)
    return {l: dict(comm_rate_mean=float(c), delivered_rate_mean=float(d))
            for l, c, d in zip(labels, tr.comm_rate.mean(dim=dims),
                               tr.delivered_rate.mean(dim=dims))}


def bitwise_equal(a, b, squeeze=None):
    """Every trace field of ``a`` equals ``b``'s bit for bit; ``squeeze``
    drops that axis of ``b`` (the one-row channel axis)."""
    import torch
    for name, x in a.trace._asdict().items():
        y = getattr(b.trace, name)
        if x is None:
            if y is not None and not name.startswith("delivered"):
                return False
            continue
        if squeeze is not None:
            y = y.squeeze(squeeze)
        if x.dtype != y.dtype or not torch.equal(x, y):
            return False
    return True


def degraded_edge_phase(dev, cell, store_root):
    """The degraded-edge study (benchmarks/degraded_edge.py) at its own
    scale: four backend pairs against plain torch, clean channel against
    none, crash-resume of the resumable runtime, and a store reload.  The
    study's store goes to ``store_root``, kept for the sweep service."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.algorithm1 import TraceSpec
    from repro_torch.experiments import (SweepStore, run_sweep,
                                         run_sweep_resumable, sweep_or_load)
    from repro_torch.experiments.sweep import SweepResult

    inp = edge_inputs(dev, cell)
    labels = [l for l, _ in cell.channels]
    delay_free = [i for i, (_, c) in enumerate(cell.channels) if c[1] == 0]
    N, G = cell.iters, cell.runs
    lines, launches = [], {}

    def sweep_line(label, runs, wall, counts, peak, **extra):
        return dict(cell=cell.name, sweep=label, runs=runs,
                    agents=cell.agents, samples=cell.samples,
                    states=cell.states, iterations=N, eps=cell.eps,
                    channels=labels, wall_s=wall,
                    run_agent_steps_per_s=runs * cell.agents * N / wall,
                    peak_mem_bytes=peak, launches=counts, **extra)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- four ways against the plain-torch oracle, every channel
    results = {}
    for step, gain in (("reference", "reference"), ("reference", "kernel"),
                       ("fused", "kernel"), ("megastep", "kernel")):
        chans = ([cell.channels[i] for i in delay_free] if step == "megastep"
                 else list(cell.channels))
        spec = edge_spec(cell, chans, step_backend=step, gain_backend=gain,
                         trace=TraceSpec(alphas=True, gains=True))
        res, wall, counts, peak = timed(dev, lambda: run_sweep(
            spec, inp["sampler"], inp["w0"], env_sets=inp["env_sets"],
            fleet_sets=inp["fleet_sets"], device=dev))
        label = f"{cell.name} {step}/{gain}"
        runs = G // len(cell.channels) * len(chans)
        if gain == "kernel":
            name, per_step = EXPECT[step]
            check_launches(label, counts, {name: per_step * N})
            add(counts)
        else:
            check_launches(label, counts, {})
        tr = res.trace
        check(tuple(tr.final_weights.shape)
              == (cell.envs, len(chans), len(cell.modes), len(cell.lambdas),
                  len(cell.rhos), len(cell.seeds), cell.states),
              f"{label}: final weights shape {tuple(tr.final_weights.shape)}")
        check(bool(torch.isfinite(tr.final_weights).all())
              and bool(torch.isfinite(res.j_final).all()),
              f"{label}: non-finite weights or J")
        check(bool((tr.delivered_counts <= tr.tx_counts).all()),
              f"{label}: more deliveries than attempts")
        results[step, gain] = (spec, res)
        lines.append(sweep_line(
            f"{step}+{gain}", runs, wall, counts, peak,
            per_channel=per_channel_rates(res, [l for l, _ in chans])))

    spec0, oracle = results["reference", "reference"]

    def thresholds(spec, res):
        grid = tuple(res.comm_rate.shape)
        return np.broadcast_to(
            spec.thresholds()[None, None, None, :, :, None, :],
            grid + (N,)).reshape(-1, N)

    def rows(res, idx):
        sel = torch.as_tensor(idx, device=res.comm_rate.device)
        trace = type(res.trace)(*(None if x is None else x.index_select(1, sel)
                                  for x in res.trace))
        return SweepResult(trace=trace, comm_rate=trace.comm_rate,
                           j_final=trace.j_final, axes=res.axes)

    for key, (spec, res) in results.items():
        if key == ("reference", "reference"):
            continue
        ref = rows(oracle, delay_free) if key[0] == "megastep" else oracle
        cmp = compare_sweeps(res, ref, thresholds(spec, res), cell)
        next(l for l in lines if l["sweep"] == "+".join(key)).update(cmp)
    lines[0].update(j_final_mean=float(oracle.j_final.mean()))

    # -- a clean channel is no channel, bit for bit, on the 1024-run grid;
    #    and chunks of RESUME_CHUNK // 4 runs give the unchunked bytes (the
    #    port's store leaves chunk_size out of its spec hash on that ground)
    clean_check = {}
    for step in ("reference", "fused", "megastep"):
        out = {}
        for name, chans, extra in (
                ("none", None, {}), ("clean", cell.channels[:1], {}),
                ("none_chunked", None, dict(chunk_size=RESUME_CHUNK // 4))):
            spec = edge_spec(cell, chans, step_backend=step,
                             gain_backend="kernel", trace="summary", **extra)
            res, wall, counts, _ = timed(dev, lambda: run_sweep(
                spec, inp["sampler"], inp["w0"], env_sets=inp["env_sets"],
                fleet_sets=inp["fleet_sets"], device=dev))
            name_k, per_step = EXPECT[step]
            chunks = -(-(G // len(cell.channels))
                       // extra.get("chunk_size", G))
            check_launches(f"{cell.name} {step} {name}", counts,
                           {name_k: per_step * N * chunks})
            add(counts)
            out[name] = (res, wall)
        none, clean = out["none"][0], out["clean"][0]
        check(bitwise_equal(none, clean, squeeze=1),
              f"{cell.name} {step}: a clean channel differs from none")
        check(bool(torch.equal(clean.trace.delivered_counts,
                               clean.trace.tx_counts)),
              f"{cell.name} {step}: a clean channel lost a transmission")
        check(bitwise_equal(none, out["none_chunked"][0]),
              f"{cell.name} {step}: chunked and unchunked runs differ")
        clean_check[step] = dict(
            clean_equals_none_bitwise=True,
            chunked_equals_unchunked_bitwise=True,
            wall_s={k: w for k, (_, w) in out.items()})
    lines.append(dict(cell=cell.name, phase="clean_vs_none",
                      runs=G // len(cell.channels), **clean_check))

    # -- resume: fused/kernel, summary, RESUME_CHUNK runs a segment; the
    #    walls alternate (run_sweep, resumable, resumed, resumable,
    #    run_sweep), since a host-bound sweep's wall varies run to run
    spec = edge_spec(cell, cell.channels, step_backend="fused",
                     gain_backend="kernel", trace="summary",
                     chunk_size=RESUME_CHUNK)
    segments = G // RESUME_CHUNK
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        kw = dict(env_sets=inp["env_sets"], fleet_sets=inp["fleet_sets"],
                  device=dev)
        walls = {"run_sweep": [], "resumable": []}

        def plain_run():
            res, wall, counts, _ = timed(dev, lambda: run_sweep(
                spec, inp["sampler"], inp["w0"], **kw))
            check_launches(f"{cell.name} run_sweep chunked", counts,
                           {"gain_family_stats": segments * N})
            add(counts)
            walls["run_sweep"].append(wall)
            return res

        def resumable_run(store_dir):
            res, wall, counts, peak = timed(dev, lambda: run_sweep_resumable(
                spec, inp["sampler"], inp["w0"], store_dir=store_dir, **kw))
            check_launches(f"{cell.name} resumable", counts,
                           {"gain_family_stats": segments * N})
            add(counts)
            walls["resumable"].append(wall)
            return res, peak

        plain = plain_run()
        store_dir = os.path.join(tmp, "chunks")
        full, peak = resumable_run(store_dir)
        chunks = sorted(f for f in os.listdir(store_dir)
                        if f.startswith("chunk_"))
        check(len(chunks) == segments,
              f"{cell.name}: {len(chunks)} chunk files, expected {segments}")
        chunk_bytes = [os.path.getsize(os.path.join(store_dir, f))
                       for f in chunks]
        for f in chunks[RESUME_KEEP:]:        # the crash: later chunks vanish
            os.remove(os.path.join(store_dir, f))
        events = []
        resumed, wall_resume, counts, _ = timed(dev, lambda: run_sweep_resumable(
            spec, inp["sampler"], inp["w0"], store_dir=store_dir,
            on_chunk=lambda i, n, restored: events.append(restored), **kw))
        check(events == [True] * RESUME_KEEP
              + [False] * (segments - RESUME_KEEP),
              f"{cell.name}: resume events {events}")
        check_launches(f"{cell.name} resumed", counts,
                       {"gain_family_stats": (segments - RESUME_KEEP) * N})
        add(counts)
        check(bitwise_equal(full, resumed),
              f"{cell.name}: the resumed sweep differs from the uninterrupted")
        check(bitwise_equal(full, plain),
              f"{cell.name}: the resumable sweep differs from run_sweep")
        again, _ = resumable_run(os.path.join(tmp, "chunks2"))
        check(bitwise_equal(full, again),
              f"{cell.name}: two resumable sweeps differ")
        plain_run()
        lines.append(sweep_line(
            "resume fused+kernel", G, walls["resumable"][0], None, peak,
            phase="resume", chunk_size=RESUME_CHUNK, segments=segments,
            resumable_wall_s=walls["resumable"],
            run_sweep_wall_s=walls["run_sweep"],
            resumed_wall_s=wall_resume,
            events=dict(restored=events.count(True),
                        computed=events.count(False)),
            chunk_bytes=chunk_bytes, resumed_bitwise=True,
            run_sweep_bitwise=True))

        # -- store-first: the study's own call, then a reload
        spec = edge_spec(cell, cell.channels, step_backend="fused",
                         gain_backend="kernel", trace="summary")
        store = SweepStore(store_root)
        extra = {"figure": "degraded_edge", "channels": labels}
        first, wall_first, counts, _ = timed(dev, lambda: sweep_or_load(
            store, spec, inp["sampler"], inp["w0"], extra=extra, **kw))
        check_launches(f"{cell.name} sweep_or_load", counts,
                       {"gain_family_stats": N})
        add(counts)
        again, wall_again, counts, _ = timed(dev, lambda: sweep_or_load(
            store, spec, inp["sampler"], inp["w0"], extra=extra, **kw))
        check_launches(f"{cell.name} sweep_or_load reload", counts, {})
        check(bitwise_equal(first, again),
              f"{cell.name}: the reloaded entry differs")
        check(bitwise_equal(first, plain),
              f"{cell.name}: the unchunked stored sweep differs from the "
              "chunked run")
        lines.append(dict(cell=cell.name, phase="store", runs=G,
                          compute_wall_s=wall_first, reload_wall_s=wall_again,
                          reload_launches=counts, reload_bitwise=True,
                          unchunked_equals_chunked_bitwise=True,
                          per_channel=per_channel_rates(first, labels),
                          entry_bytes=sum(
                              os.path.getsize(os.path.join(r, f))
                              for r, _, fs in os.walk(store.root)
                              for f in fs)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    mega = next(l for l in lines if l.get("sweep") == "megastep+kernel")
    lines.append({"cell": cell.name, "step_breakdown_ms": dict(
        step_breakdown(dev, cell, inp["env_sets"], inp["fleet_sets"],
                       cell.eps),
        sweep_step_ms=mega["wall_s"] / N * 1e3)})
    return lines, launches


# ---------------------------------------------------------------------------
# Phase 3c: Fig. 3, the TD(0) linear-speedup study, the Markov runtime and
# channel, value iteration and Q-learning
# ---------------------------------------------------------------------------

# benchmarks/fig3_continuous.py: N, T and its panels (2 agents at three
# lambdas in one sweep, 10 agents at one in another); eps = 0.9 x max
# stable, rho = min(min_rho(eps) x 1.0001, 0.9995)
FIG3_ITERS, FIG3_SAMPLES = 1500, 1000
FIG3_SWEEPS = ((2, (("left_infrequent", 1e-1), ("middle_frequent", 1e-4),
                    ("right_2agents", 1e-2))),
               (10, (("right_10agents", 1e-2),)))
# FIG3_JAX (the panels under JAX 0.9.0), FIG3_COMMITTED (the committed
# fig3.json, shown only) and FIG3_TOL (the bounds and their reason) live
# with the study, benchmarks/torch_fig3_continuous.py, imported above

# TD_STUDY (benchmarks/td_speedup.py's full scale and settings), TD_JAX
# (its tail errors and comm rates under JAX 0.9.0), TD_COMMITTED_SPEEDUPS
# (shown only) and TD_TOL live with the study,
# benchmarks/torch_td_speedup.py, imported above

# the backend parity, runtime and channel runs: m = 64 with N cut to this
TD_CUT_ITERS = 1000
TD_TRACE_ITERS = 200      # the profiled fused sweep's steps
TD_RESUME_CHUNK = 12      # 36 runs: 3 segments
TD_RESUME_KEEP = 1

# tests/test_sweep.py:325-345 and tests/test_qlearning.py:53: 40 outer x
# 200 inner, practical, 2 agents, the discounted 5x5 gridworld
VI_OUTER, VI_INNER = 40, 200


def as_summary(res):
    """A full-trace SweepResult as the summary fields compare_sweeps reads."""
    from repro_torch.core.algorithm1 import SummaryTrace
    from repro_torch.experiments.sweep import SweepResult
    tr = res.trace
    s = SummaryTrace(final_weights=tr.weights[..., -1, :],
                     comm_rate=tr.comm_rate, tx_counts=tr.alphas.sum(-2),
                     gain_mean=tr.gains.mean(-2), gain_min=tr.gains.amin(-2),
                     gain_max=tr.gains.amax(-2), j_final=res.j_final,
                     j_trajectory=None, alphas=tr.alphas, gains=tr.gains)
    return SweepResult(trace=s, comm_rate=s.comm_rate, j_final=res.j_final,
                       axes=res.axes)


def grid_thresholds(spec, res):
    """lambda_k of every flattened run of ``res`` (one lambda axis)."""
    import numpy as np
    thr = spec.thresholds()                       # (L, R, N)
    lam_axis = res.axes.index("lam")
    shape = tuple(res.comm_rate.shape)
    lam_of = np.indices(shape)[lam_axis].reshape(-1)
    return thr[lam_of, 0]


def pairs_against_plain(dev, label, run, sweeps, iters):
    """``run(step, gain)`` (``sweeps`` sweeps of ``iters`` steps) on plain
    torch and the three kernel backends: (results, lines, launches), each
    kernel run's launches checked."""
    results, lines, launches = {}, [], {}
    for step, gain in (("reference", "reference"), ("reference", "kernel"),
                       ("fused", "kernel"), ("megastep", "kernel")):
        out, wall, counts, peak = timed(dev, lambda: run(step, gain))
        if gain == "kernel":
            name, per_step = EXPECT[step]
            check_launches(f"{label} {step}/{gain}", counts,
                           {name: per_step * iters * sweeps})
            launches[name] = launches.get(name, 0) + counts[name]
        else:
            check_launches(f"{label} {step}/{gain}", counts, {})
        results[step, gain] = out
        lines.append(dict(sweep=f"{step}+{gain}", wall_s=wall,
                          peak_mem_bytes=peak, launches=counts))
    return results, lines, launches


def fig3_phase(dev):
    """Fig. 3 (benchmarks/fig3_continuous.py) at its own scale: both
    sweeps on plain torch and the three kernel backends, each backend
    against plain torch, the panels' numbers against JAX 0.9.0's."""
    import numpy as np
    import torch
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.envs import LinearSystem
    from repro_torch.experiments import SweepSpec, run_sweep

    ls = LinearSystem()
    prob = ls.vfa_problem(np.zeros(6))
    eps = 0.9 * prob.max_stable_stepsize()
    rho = min(prob.min_rho(eps) * 1.0001, 0.9995)
    wstar = prob.optimum().to(dev)
    w0 = np.zeros(6, np.float32)
    N = FIG3_ITERS

    def spec(agents, panels, step, gain):
        return SweepSpec(modes=("practical",),
                         lambdas=tuple(l for _, l in panels), seeds=(0,),
                         rhos=(rho,), eps=eps, num_iterations=N,
                         num_agents=agents, tag=f"fig3-{agents}agents",
                         step_backend=step, gain_backend=gain)

    def run(step, gain):
        return [run_sweep(spec(a, p, step, gain), ParamSampler(
                    ls.sampler_fn(FIG3_SAMPLES), ls.agent_params(w0, a)),
                    w0, problem=prob, device=dev)
                for a, p in FIG3_SWEEPS]

    results, lines, launches = pairs_against_plain(
        dev, "fig3", run, len(FIG3_SWEEPS), N)
    oracle = results["reference", "reference"]
    for key, res in results.items():
        if key == ("reference", "reference"):
            continue
        cmp = {}
        for (agents, panels), got, ref in zip(FIG3_SWEEPS, res, oracle):
            cell = Cell(f"fig3-{agents}agents", 1, 6, agents, 0,
                        FIG3_SAMPLES, N, ("practical",),
                        tuple(l for _, l in panels), (rho,), (0,), eps)
            s = spec(agents, panels, *key)
            cmp[f"{agents}agents"] = compare_sweeps(
                as_summary(got), as_summary(ref), grid_thresholds(s, got),
                cell)["vs_plain"]
        next(l for l in lines if l["sweep"] == "+".join(key)).update(
            vs_plain=cmp)

    def panels_of(res_pair):
        out = {}
        for (agents, panels), res in zip(FIG3_SWEEPS, res_pair):
            tr = res.trace
            for li, (name, lam) in enumerate(panels):
                a = tr.alphas[0, li, 0, 0].mean(-1)            # (N,)
                w = tr.weights[0, li, 0, 0]                    # (N+1, 6)
                first = int(torch.argmax((a > 0).int())) if a.max() > 0 else N
                out[name] = dict(
                    lam=lam, agents=agents,
                    comm_rate=float(tr.comm_rate[0, li, 0, 0]),
                    first_tx_iter=first,
                    early_rate=float(a[: N // 4].mean()),
                    late_rate=float(a[3 * N // 4:].mean()),
                    J_final=float(res.j_final[0, li, 0, 0]),
                    w_err_quarterly=[
                        float(torch.linalg.vector_norm(w[k] - wstar))
                        for k in (0, N // 4, N // 2, 3 * N // 4, N)])
        return out

    panels = panels_of(results["megastep", "kernel"])
    worst = dict(comm_rate=0.0, J_final_rel=0.0, w_err=0.0)
    for name, got in panels.items():
        want = FIG3_JAX[name]
        d = panel_gaps(got, want)
        for k, v in d.items():
            worst[k] = max(worst[k], v)
        check(got["first_tx_iter"] == want["first_tx_iter"]
              and all(v <= FIG3_TOL[k] for k, v in d.items()),
              f"fig3 {name}: {got} differs from JAX 0.9.0's {want} by {d}")
        got.update(jax_0_9_0=want, committed_json=FIG3_COMMITTED[name])
    lines.append(dict(cell="fig3", panels=panels, eps=eps, rho=rho,
                      panels_from="megastep+kernel",
                      vs_jax_0_9_0=dict(worst=worst, tolerance=FIG3_TOL)))
    for l in lines:
        l.setdefault("cell", "fig3")
    return lines, launches


def td_inputs(dev, m):
    import numpy as np
    from repro_torch.core.algorithm1 import ParamSampler
    from repro_torch.core.td import (td_env_family, td_family_sampler_fn,
                                     td_init_states)
    s = TD_STUDY
    envs, fam = td_env_family(s["envs"], num_states=s["states"],
                              gamma=s["gamma"], device=dev)
    w0 = np.zeros(s["states"], np.float32)
    params = envs[0].agent_params(w0, m, noise_scale=s["noise_scale"])
    return dict(sampler=ParamSampler(td_family_sampler_fn(s["samples"]),
                                     params),
                w0=w0, env_sets=fam, state_init_fn=td_init_states)


def td_spec(m, iters, **kw):
    from repro_torch.experiments import SweepSpec
    s = TD_STUDY
    return SweepSpec(modes=TD_MODES, lambdas=(s["lam"],), rhos=(s["rho"],),
                     seeds=s["seeds"], eps=s["eps"], num_iterations=iters,
                     num_agents=m, sampling="markov", **kw)


def td_cell(m, iters, name):
    s = TD_STUDY
    return Cell(name, s["envs"], s["states"], m, 0, s["samples"], iters,
                TD_MODES, (s["lam"],), (s["rho"],), s["seeds"], s["eps"])


def td_speedup_phase(dev, store_root):
    """The TD(0) linear-speedup study (benchmarks/td_speedup.py) at its
    full scale on the fused backend, through the study's own store-first
    call (into ``store_root``, kept for the sweep service); then the
    backend parity at m = 64 with N cut to TD_CUT_ITERS and the step's
    stages with the walk apart."""
    import torch
    from repro_torch.core.algorithm1 import TraceSpec
    from repro_torch.experiments import SweepStore, run_sweep, sweep_or_load

    s = TD_STUDY
    N = s["iters"]
    lines, launches, tail, comm, walls = [], {}, {}, {}, {}
    store = SweepStore(store_root)
    for m in s["agents"]:
        inp = td_inputs(dev, m)
        spec = td_spec(m, N, trace=TraceSpec(j_trajectory=True),
                       step_backend="fused", gain_backend="kernel")
        res, wall, counts, peak = timed(dev, lambda: sweep_or_load(
            store, spec, inp["sampler"], inp["w0"],
            env_sets=inp["env_sets"], state_init_fn=inp["state_init_fn"],
            extra={"figure": "td_speedup", "m": m, "gamma": s["gamma"],
                   "noise_scale": s["noise_scale"],
                   "tail_frac": s["tail_frac"]}, device=dev))
        check_launches(f"td-speedup m={m}", counts,
                       {"gain_family_stats": N})
        launches["gain_family_stats"] = (
            launches.get("gain_family_stats", 0) + counts["gain_family_stats"])
        jt = res.trace.j_trajectory.double()      # (E, M, L, R, S, N)
        check(tuple(jt.shape) == (s["envs"], 2, 1, 1, len(s["seeds"]), N)
              and bool(torch.isfinite(jt).all()),
              f"td-speedup m={m}: j_trajectory {tuple(jt.shape)}")
        n_tail = max(1, int(round(s["tail_frac"] * N)))
        t = jt[..., N - n_tail:].mean(-1)
        for mi, mode in enumerate(TD_MODES):
            tail.setdefault(mode, []).append(float(t[:, mi].mean()))
            comm.setdefault(mode, []).append(
                float(res.comm_rate[:, mi].mean()))
        walls[m] = dict(wall_s=wall, peak_mem_bytes=peak,
                        step_ms=wall / N * 1e3,
                        run_agent_steps_per_s=(
                            res.comm_rate.numel() * m * N / wall))
    rows, worst = {}, dict.fromkeys(TD_MODES, 0.0)
    for mode in TD_MODES:
        base = tail[mode][0]
        rows[mode] = []
        for i, m in enumerate(s["agents"]):
            want = TD_JAX[m][mode]
            rel = abs(tail[mode][i] / want - 1)
            worst[mode] = max(worst[mode], rel)
            check(rel <= TD_TOL[mode], f"td-speedup {mode} m={m}: tail error "
                  f"{tail[mode][i]:.6g}, JAX 0.9.0 {want:.6g} ({rel:.3g})")
            rows[mode].append(dict(
                m=m, tail_error=tail[mode][i], error_x_m=tail[mode][i] * m,
                speedup_vs_m1=base / tail[mode][i], comm_rate=comm[mode][i],
                jax_0_9_0=dict(tail_error=want, speedup_vs_m1=(
                    TD_JAX[1][mode] / want)),
                committed_speedup_vs_m1=TD_COMMITTED_SPEEDUPS[mode][i]))
    lines.append(dict(cell="td-speedup", sweep="fused+kernel", runs=36,
                      iterations=N, rows=rows, per_m=walls,
                      vs_jax_0_9_0=dict(worst_tail_rel=worst,
                                        tolerance=TD_TOL,
                                        comm_rate_theoretical=[
                                            TD_JAX[m]["comm_theoretical"]
                                            for m in s["agents"]])))

    # -- every backend against plain torch at m = 64, N cut
    m, Nc = s["agents"][-1], TD_CUT_ITERS
    inp = td_inputs(dev, m)
    cell = td_cell(m, Nc, "td-speedup-m64")

    def run(step, gain):
        spec = td_spec(m, Nc, trace=TraceSpec(alphas=True, gains=True),
                       step_backend=step, gain_backend=gain)
        return spec, run_sweep(spec, inp["sampler"], inp["w0"],
                               env_sets=inp["env_sets"],
                               state_init_fn=inp["state_init_fn"], device=dev)

    results, plines, pl = pairs_against_plain(dev, cell.name, run, 1, Nc)
    for k, v in pl.items():
        launches[k] = launches.get(k, 0) + v
    _, oracle = results["reference", "reference"]
    for key, (spec, res) in results.items():
        if key == ("reference", "reference"):
            continue
        next(l for l in plines if l["sweep"] == "+".join(key)).update(
            compare_sweeps(res, oracle, grid_thresholds(spec, res), cell))
    for l in plines:
        l.update(cell=cell.name, runs=cell.runs, agents=m, iterations=Nc,
                 reduced=dict(iterations=[N, Nc]),
                 run_agent_steps_per_s=cell.runs * m * Nc / l["wall_s"])
    lines += plines
    fused = next(l for l in plines if l["sweep"] == "fused+kernel")
    # the device's busy and idle time over a fused sweep of TD_TRACE_ITERS
    # steps, from a torch.profiler trace (its launches are not counted)
    spec = td_spec(m, TD_TRACE_ITERS, trace="summary", step_backend="fused",
                   gain_backend="kernel")
    trace = prefill_breakdown(dev, lambda _: run_sweep(
        spec, inp["sampler"], inp["w0"], env_sets=inp["env_sets"],
        state_init_fn=inp["state_init_fn"], device=dev), None,
        ("family_stats_kernel",))
    lines.append({"cell": cell.name, "step_breakdown_ms": dict(
        td_step_breakdown(dev, inp, m),
        sweep_step_ms=fused["wall_s"] / Nc * 1e3),
        "device_trace": dict(trace, iterations=TD_TRACE_ITERS)})
    return lines, launches


def td_step_breakdown(dev, inp, m):
    """CUDA-event times of one fused+kernel TD step's stages at m agents,
    as the engine runs them: one pass of key-only draws (the step keys'
    split, the random-mode draw and the walk's threefry draws, for as many
    steps as DRAW_BYTES holds, reported per pass and per step), then per
    step the T-step walk on the 18 distinct streams, the per-run targets,
    the gradients, grad J, the fused gains and the trigger and update."""
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import algorithm1 as A1
    from repro_torch.core import gain_dispatch, server, vfa
    from repro_torch.core.algorithm1 import MODE_IDS, ProblemTerms
    from repro_torch.core.td import td_init_states
    from repro_torch.core.trigger import should_transmit

    s = TD_STUDY
    fam, fn = inp["env_sets"], inp["sampler"].fn
    E, S, nm = s["envs"], len(s["seeds"]), len(TD_MODES)
    G, U = E * nm * S, E * S
    run = torch.arange(G, device=dev)
    env_of, seed_of = run // (nm * S), run % S
    inv = env_of * S + seed_of
    stream_env = torch.arange(E, device=dev).repeat_interleave(S)
    stream_seed = torch.arange(S, device=dev).repeat(E)
    first = stream_env * (nm * S) + stream_seed     # a stream's first run
    env = {k: v[stream_env] for k, v in fam.params.items()}
    params = {k: torch.as_tensor(v).to(dev).expand((U,) + v.shape)
              for k, v in inp["sampler"].params.items()}
    keys = trandom.keys(s["seeds"]).to(dev)
    step_keys = trandom.split(keys[seed_of], s["iters"])           # (G, N, 2)
    state = td_init_states(params, trandom.fold_in(
        keys[stream_seed], A1.SAMPLER_STATE_FOLD))
    tx_p = torch.full((G,), 0.5, device=dev)

    def key_pass(b):
        ks = step_keys[:, :b]
        rngs = trandom.split(ks, m + 1)
        arand = trandom.bernoulli(rngs[:, :, m], tx_p.view(G, 1, 1),
                                  (m,)).float()
        return arand, fn.draw(env, rngs[first][:, :, :m])

    arand1, draws1 = key_pass(1)
    per_step = sum(t.numel() * t.element_size() for t in (arand1, *draws1))
    b = max(1, min(s["iters"], A1.DRAW_BYTES // per_step))
    d0 = tuple(x[:, 0] for x in draws1)
    st, walk = fn.walk(env, params, state, d0)
    w = torch.zeros(G, s["states"], device=dev)
    phi, y = walk.to_runs(lambda x: x[inv]).batch(w)
    terms = ProblemTerms(*(t[env_of] for t in fam.terms))
    grads = vfa.stochastic_gradient(w.unsqueeze(1), phi, y)
    gj = terms.grad(w)
    modes = torch.tensor([MODE_IDS[x] for x in TD_MODES],
                         device=dev)[run // S % nm]
    gains = gain_dispatch.mode_gains(modes, grads, phi, s["eps"], gj,
                                     terms.phi_matrix, backend="kernel",
                                     step_backend="fused")
    thr = torch.full((G, 1), 1e-3, device=dev)

    def trigger_and_update():
        gate = should_transmit(gains, thr)
        alphas = gain_dispatch.select_alphas(modes, gate, arand1[:, 0])
        return server.server_update(w, grads, alphas, s["eps"])

    pass_ms = time_ms(lambda: key_pass(b), reps=5, warmup=1)
    stages = {
        "walk": lambda: fn.walk(env, params, state, d0),
        "targets_to_runs": lambda: walk.to_runs(lambda x: x[inv]).batch(w),
        "stochastic_gradients": lambda: vfa.stochastic_gradient(
            w.unsqueeze(1), phi, y),
        "grad_j": lambda: terms.grad(w),
        "fused_gains": lambda: gain_dispatch.mode_gains(
            modes, grads, phi, s["eps"], gj, terms.phi_matrix,
            backend="kernel", step_backend="fused"),
        "trigger_and_update": trigger_and_update,
    }
    out = {"key_only_draws_per_step": pass_ms / b}
    out.update({k: time_ms(f, reps=10) for k, f in stages.items()})
    out["sum_ms"] = sum(out.values())
    out.update(key_only_draws_pass_ms=pass_ms, steps_per_pass=b,
               distinct_streams=U, runs=G)
    return out


# ---------------------------------------------------------------------------
# Phase 3d: the sweep service over the card's own stores
# ---------------------------------------------------------------------------

# a budget vector and the batch the service is asked, and how often the
# warm GET and the batch round trip are timed
SERVICE_BUDGETS = (0.01, 0.05, 0.1, 0.2, 0.5, 0.9)
SERVICE_GETS = 200
SERVICE_BATCHES = 20
# the chaos cells of benchmarks/torch_chaos.py run here, at its smoke
# scale: one in this process in raise mode, one as a hard-crash child
SERVICE_RAISE_CELL = "ckpt.write:torn:1,ckpt.write:crash_after:2"
SERVICE_CRASH_CELL = "runtime.unlock:crash_before:1"
# The report's td_speedup speedups against td_speedup_phase's: both are
# float64 means of the same stored float32 J trajectories, summed in two
# orders (numpy on the host, torch on the card).
SERVICE_TD_RTOL = 1e-12


def _read_tree(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def _json_roundtrip(obj):
    return json.loads(json.dumps(obj))


def _service_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_TORCH_FAULTS", None)
    return env


def _report_checks(service_root, roots, lines):
    """Two renderings of each store, byte for byte; the artifacts' rates
    and speedups against the phases that made the stores."""
    from repro_torch.experiments import SweepStore, generate_report
    out, arts = {}, {}
    for name, root in roots.items():
        trees = []
        for k in range(2):
            d = os.path.join(service_root, f"report-{name}-{k}")
            index = generate_report(SweepStore(root), d)
            trees.append(_read_tree(d))
        check(trees[0] == trees[1],
              f"sweep-service: two renderings of the {name} store differ")
        check([a["figure"] for a in index["artifacts"]] == [name],
              f"sweep-service: {name} store rendered "
              f"{[a['figure'] for a in index['artifacts']]}")
        art = json.loads(trees[0][index["artifacts"][0]["json"]])
        arts[name] = art
        out[name] = dict(artifacts=len(index["artifacts"]),
                         rows=len(art["rows"]), bytes=sum(
                             len(b) for b in trees[0].values()),
                         byte_identical=True)

    # degraded_edge: each channel's rows average to the phase's own
    # per-channel means (float32 sums in two orders: within RATE_TOL)
    store_line = next(l for l in lines if l.get("cell") == DEGRADED_EDGE.name
                      and l.get("phase") == "store")
    worst = 0.0
    for ch, want in store_line["per_channel"].items():
        rows = [r for r in arts["degraded_edge"]["rows"] if r["channel"] == ch]
        check(rows, f"sweep-service: no degraded_edge rows for {ch}")
        for key in ("delivered_rate", "comm_rate"):
            got = sum(r[key] for r in rows) / len(rows)
            err = abs(got - want[key + "_mean"])
            worst = max(worst, err)
            check(err <= RATE_TOL, f"sweep-service: degraded_edge {ch} "
                  f"{key} {got} against the phase's {want[key + '_mean']}")
    out["degraded_edge"]["per_channel_max_abs_err"] = worst

    # td_speedup: the artifact's speedups are the phase's
    td_line = next(l for l in lines if l.get("cell") == "td-speedup")
    worst = 0.0
    for mode, want_rows in td_line["rows"].items():
        for w in want_rows:
            (r,) = [r for r in arts["td_speedup"]["rows"]
                    if r["mode"] == mode and r["m"] == w["m"]]
            for key in ("speedup_vs_m1", "tail_error"):
                rel = abs(r[key] / w[key] - 1)
                worst = max(worst, rel)
                check(rel <= SERVICE_TD_RTOL, f"sweep-service: td_speedup "
                      f"{mode} m={w['m']} {key} {r[key]} against the "
                      f"phase's {w[key]}")
    out["td_speedup"]["speedup_max_rel_err"] = worst
    out["td_speedup"]["tolerance"] = SERVICE_TD_RTOL
    out["degraded_edge"]["tolerance"] = RATE_TOL
    return out


def _serving_checks(roots):
    """Both roots behind one server; every endpoint over one keep-alive
    client, each body equal to the port's query functions exactly; the
    warm GET's p50 and a batch's round trip."""
    import threading
    from http.server import ThreadingHTTPServer
    from repro_torch.experiments import SweepStore
    from repro_torch.experiments import query as Q
    from repro_torch.experiments.client import QueryServiceClient
    from repro_torch.experiments.serve_sweeps import make_handler

    stores = [SweepStore(r) for r in roots.values()]
    entries = {h: s.get(h, verify=True) for s in stores for h in s.hashes()}
    edge_h = SweepStore(roots["degraded_edge"]).hashes()[0]
    td_hs = SweepStore(roots["td_speedup"]).hashes()
    edge = entries[edge_h]
    handler = make_handler(list(roots.values()), quiet=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    checked = 0
    try:
        with QueryServiceClient("127.0.0.1", httpd.server_address[1]) as c:
            def ask(name, want, **params):
                nonlocal checked
                st, body = c.get(name, **params)
                check(st == 200, f"sweep-service: {name} {params} answered "
                      f"{st}: {body}")
                check(body["torch_loaded"] is True,   # this process has it
                      f"sweep-service: {name} torch_loaded "
                      f"{body['torch_loaded']}")
                got = body["entries"] if name == "/sweeps" else body["result"]
                check(got == _json_roundtrip(want),
                      f"sweep-service: {name} {params} differs from the "
                      "port's query functions")
                checked += 1

            ask("/sweeps", [dict(m, store_root=s.root) for s in stores
                            for m in s.entries()])
            lam_mid = float((edge.lambdas[0] * edge.lambdas[-1]) ** 0.5)
            for h, sel in [(edge_h, {"channel": 3})] + [(h, None)
                                                        for h in td_hs]:
                kw = {f"sel_{k}": v for k, v in (sel or {}).items()}
                e = entries[h]
                for mode in e.modes:
                    curve = Q.tradeoff_curve(e, mode=mode, select=sel)
                    ask("best_lambda", {"results": Q.best_lambda_batch(
                        curve, SERVICE_BUDGETS)}, hash=h, mode=mode,
                        budget=",".join(map(str, SERVICE_BUDGETS)), **kw)
                    ask("best_lambda", Q.best_lambda(curve, 0.2), hash=h,
                        mode=mode, budget=0.2, **kw)
                    lam = lam_mid if h == edge_h else e.lambdas[0]
                    ask("tradeoff", Q.tradeoff_at(curve, lam), hash=h,
                        mode=mode, lam=lam, **kw)
                    ask("pareto", {"front": Q.pareto_front(curve)}, hash=h,
                        mode=mode, **kw)
                    ask("curve", {"rows": curve.as_rows()}, hash=h,
                        mode=mode, **kw)

            curve = Q.tradeoff_curve(edge, select={"channel": 3})
            batch = [{"query": "best_lambda", "hash": edge_h,
                      "budget": b, "sel_channel": 3}
                     for b in SERVICE_BUDGETS] + [
                     {"query": "pareto", "hash": edge_h, "sel_channel": 3}]
            want = [Q.best_lambda(curve, b) for b in SERVICE_BUDGETS] + [
                {"front": Q.pareto_front(curve)}]
            st, body = c.batch(batch)
            check(st == 200 and body["count"] == len(batch),
                  f"sweep-service: batch answered {st}")
            check([r["result"] for r in body["results"]]
                  == _json_roundtrip(want),
                  "sweep-service: the batch differs from the port's query "
                  "functions")
            checked += 1

            get_ms, batch_ms = [], []
            for _ in range(SERVICE_GETS):
                t0 = time.perf_counter()
                st, _ = c.get("best_lambda", hash=edge_h, budget=0.2,
                              sel_channel=3)
                get_ms.append((time.perf_counter() - t0) * 1e3)
                check(st == 200, f"sweep-service: timed GET answered {st}")
            for _ in range(SERVICE_BATCHES):
                t0 = time.perf_counter()
                st, _ = c.batch(batch)
                batch_ms.append((time.perf_counter() - t0) * 1e3)
                check(st == 200, f"sweep-service: timed batch answered {st}")
            stats = dict(c.stats)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)
    check(stats["transient_retries"] == 0 and stats["response_errors"] == 0,
          f"sweep-service: client counters {stats}")
    return dict(roots=len(roots), entries=len(entries),
                bodies_equal=checked, client=stats,
                get_p50_ms=statistics.median(get_ms),
                get_p90_ms=statistics.quantiles(get_ms, n=10)[-1],
                gets=SERVICE_GETS, batch_queries=len(batch),
                batch_round_trip_ms=statistics.median(batch_ms),
                batches=SERVICE_BATCHES)


def _cli_checks(service_root, roots):
    """``serve_sweeps --once`` and the report CLI in subprocesses, each
    torch-free and each equal to this process's answer."""
    from repro_torch.experiments import SweepStore
    from repro_torch.experiments import query as Q
    edge = roots["degraded_edge"]
    entry = SweepStore(edge).get(SweepStore(edge).hashes()[0])
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.serve_sweeps", edge,
         "--once", "best_lambda?budget=0.2"], capture_output=True, text=True,
        env=_service_env(), cwd=REPO, timeout=120)
    once_s = time.perf_counter() - t0
    check(r.returncode == 0, f"sweep-service: --once failed: {r.stderr}")
    body = json.loads(r.stdout)
    check(body["torch_loaded"] is False,
          "sweep-service: serve_sweeps --once imported torch")
    check(body["result"] == _json_roundtrip(
        Q.best_lambda(Q.tradeoff_curve(entry), 0.2)),
          "sweep-service: --once differs from the port's best_lambda")
    out = os.path.join(service_root, "report-cli")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments.report",
         roots["td_speedup"], "--out", out], capture_output=True, text=True,
        env=_service_env(), cwd=REPO, timeout=120)
    report_s = time.perf_counter() - t0
    check(r.returncode == 0, f"sweep-service: report CLI failed: {r.stderr}")
    check(json.loads(r.stdout)["torch_loaded"] is False,
          "sweep-service: the report CLI imported torch")
    # index.json names its store and process; the artifacts are the bytes
    got, want = (_read_tree(d) for d in (out, os.path.join(
        service_root, "report-td_speedup-0")))
    check([json.loads(t.pop("index.json"))["artifacts"] for t in (got, want)]
          == [json.loads(r.stdout)["artifacts"]] * 2 and got == want,
          "sweep-service: the report CLI's artifacts differ")
    return dict(once_torch_loaded=False, once_s=once_s,
                report_cli_torch_loaded=False, report_cli_s=report_s)


def _chaos_checks(dev, service_root):
    """Two cells of benchmarks/torch_chaos.py on the card: a raise-mode
    torn write plus crash in this process, and a hard crash (os._exit) of
    a child at the lock's release, recovered here; each recovered entry
    equals a clean run's bit for bit."""
    from benchmarks import torch_chaos as C
    device = str(dev)
    key = C.cell_hash(True, "sweep")

    def digest(root):
        return C.entry_digest(os.path.join(root, "store"), key)

    sync(dev)
    reset_all_launches()                   # the chaos sweeps start here
    clean = os.path.join(service_root, "chaos-clean")
    check(not C.in_process("sweep", clean, True, device),
          "sweep-service: the clean chaos run crashed")
    want = digest(clean)
    raised = os.path.join(service_root, "chaos-raise")
    check(C.in_process("sweep", raised, True, device, SERVICE_RAISE_CELL),
          f"sweep-service: {SERVICE_RAISE_CELL} did not crash")
    check(not C.in_process("sweep", raised, True, device),
          "sweep-service: the raise-mode recovery crashed")
    sync(dev)
    check(digest(raised) == want,
          "sweep-service: the raise-mode cell did not recover bitwise")
    quarantined = C.count_quarantined(raised)
    check(quarantined >= 1,
          "sweep-service: the torn chunk was not quarantined")
    crashed = os.path.join(service_root, "chaos-crash")
    t0 = time.perf_counter()
    rc, _, out = C.spawn("sweep", crashed, True, device, SERVICE_CRASH_CELL)
    child_s = time.perf_counter() - t0
    check(rc == C.faults.CRASH_EXIT,
          f"sweep-service: {SERVICE_CRASH_CELL} child exited {rc}: {out}")
    check(os.path.exists(os.path.join(crashed, "chunks", "INCOMPLETE")),
          "sweep-service: the crashed child left no resume lock")
    t0 = time.perf_counter()
    check(not C.in_process("sweep", crashed, True, device),
          "sweep-service: the hard-crash recovery crashed")
    sync(dev)
    recovery_s = time.perf_counter() - t0
    counts = all_launches()                # ... and ends here
    check(digest(crashed) == want,
          "sweep-service: the hard-crash cell did not recover bitwise")
    check(counts.get("megastep", 0) > 0,
          f"sweep-service: the chaos sweeps launched {counts}")
    return dict(cells=[dict(faults=SERVICE_RAISE_CELL, mode="raise",
                            crashed=True, recovered_bitwise=True,
                            quarantined=quarantined),
                       dict(faults=SERVICE_CRASH_CELL, mode="exit",
                            faulted_rc=rc, child_s=child_s,
                            recovery_s=recovery_s, recovered_bitwise=True)],
                scale=C._scale(True), launches=counts)


def sweep_service_phase(dev, service_root, lines):
    """The sweep service (query, report, registry, serve_sweeps, client)
    over the degraded-edge and td-speedup phases' own stores, then two
    chaos cells on the card.  The chaos sweeps run at the benchmark's toy
    shape, so their launches stand in this phase's line only and stay out
    of the kernels line, whose rows are timed at the studies' shapes."""
    roots = {name: os.path.join(service_root, name)
             for name in ("degraded_edge", "td_speedup")}
    t0 = time.perf_counter()
    report = _report_checks(service_root, roots, lines)
    report_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving = _serving_checks(roots)
    serving_s = time.perf_counter() - t0
    cli = _cli_checks(service_root, roots)
    t0 = time.perf_counter()
    chaos = _chaos_checks(dev, service_root)
    chaos_s = time.perf_counter() - t0
    return [dict(cell="sweep-service", report=report, report_s=report_s,
                 serving=serving, serving_s=serving_s, cli=cli, chaos=chaos,
                 chaos_s=chaos_s)], {}


# benchmarks/torch_run.py's suites that this phase runs at smoke scale:
# the paper's studies, the report regeneration, and the engine, kernel and
# service suites (chaos runs two cells in the sweep-service phase)
STUDY_SUITES = ("fig2", "fig3", "theorem1", "agents_scaling",
                "heterogeneity", "degraded_edge", "td_speedup",
                "comm_savings", "report_regen", "sweep_step", "kernels",
                "sweep_scaling", "resume_query", "serve_load")


def studies_phase(dev):
    """Every study of benchmarks/torch_run.py's suite table at smoke scale
    on the card, its rows written to a temporary out-dir as ``torch_run
    --smoke --out-dir`` writes them, each held to the reference's schema
    (``gate``) and its headline numbers to JAX 0.9.0's (``fidelity``).
    The studies run the gain kernels at toy shapes, so their launches
    stand in this phase's line only, not in the kernels line."""
    import shutil
    import tempfile
    from benchmarks import torch_run
    from benchmarks.common import save_rows

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_studies_")
    per_suite = {}
    try:
        sync(dev)
        reset_all_launches()               # the studies start here
        for name in STUDY_SUITES:
            t0 = time.perf_counter()
            rows, violations, misses, ties = torch_run.run_suite(
                name, True, None, str(dev))
            check(not violations and not misses,
                  f"studies {name}: {violations + misses}")
            save_rows(name, rows, out_dir=out_dir)
            per_suite[name] = dict(seconds=time.perf_counter() - t0,
                                   rows=len(rows),
                                   ties=[list(map(str, t)) for t in ties])
        sync(dev)
        counts = all_launches()            # ... and end here
        written = sorted(os.listdir(out_dir))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    check(written == sorted(f"{n}.json" for n in STUDY_SUITES),
          f"studies: rows written {written}")
    check(counts.get("megastep", 0) > 0
          and counts.get("gain_family_stats", 0) > 0,
          f"studies: the gain kernels did not run: {counts}")
    return [dict(cell="studies", smoke=True, suites=per_suite,
                 launches=counts)], {}


# examples/torch_*.py, each run through its main() at its own defaults;
# the ones that write a store get a throwaway root
EXAMPLES = ("torch_quickstart", "torch_serve_batched", "torch_sweep_queries",
            "torch_heterogeneity_report", "torch_federated_lm_training",
            "torch_train_100m")
EXAMPLES_WITH_ROOT = ("torch_sweep_queries", "torch_heterogeneity_report")


def examples_phase(dev):
    """Each of the port's six examples through its ``main`` on the card,
    in this process, at its own defaults (the store-writing ones under a
    throwaway ``--root``), with the launch counts reset just before and
    read after; each must return its headline numbers, finite.  Their
    toy-shape launches stand in this phase's line only; what they print
    goes to standard error."""
    import contextlib
    import importlib
    import math
    import shutil
    import tempfile

    sys.path.insert(0, os.path.join(REPO, "examples"))
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    per_example = {}
    try:
        sync(dev)
        reset_all_launches()               # the examples start here
        for name in EXAMPLES:
            mod = importlib.import_module(name)
            argv = ["--device", str(dev)]
            if name in EXAMPLES_WITH_ROOT:
                argv += ["--root", os.path.join(root, name)]
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):   # their prints
                out = mod.main(argv)
            sync(dev)
            per_example[name] = dict(seconds=time.perf_counter() - t0)
            if name == "torch_train_100m":
                per_example[name].update(params=out["params"],
                                         history=out["history"])
        sync(dev)
        counts = all_launches()            # ... and end here
    finally:
        shutil.rmtree(root, ignore_errors=True)
        sys.path.remove(os.path.join(REPO, "examples"))
    losses = [h["loss"] for h in per_example["torch_train_100m"]["history"]]
    check(all(math.isfinite(x) for x in losses),
          f"examples: torch_train_100m's losses {losses}")
    check(counts.get("megastep", 0) > 0,
          f"examples: quickstart's sweeps launched no megastep: {counts}")
    return [dict(cell="examples", examples=per_example, launches=counts)], {}


def td_runtime_channel_phase(dev):
    """Markov sampling through the resumable runtime and the lossy channel
    at m = 64, N cut to TD_CUT_ITERS (tests/test_td.py:212 and :238 at the
    study's size): resume bitwise, clean channel = none bitwise on every
    kernel backend, loss 30 % on fused against plain torch."""
    import shutil
    import tempfile
    from repro_torch.core.algorithm1 import TraceSpec
    from repro_torch.experiments import run_sweep, run_sweep_resumable

    s = TD_STUDY
    m, N = s["agents"][-1], TD_CUT_ITERS
    inp = td_inputs(dev, m)
    kw = dict(env_sets=inp["env_sets"], state_init_fn=inp["state_init_fn"],
              device=dev)
    name = "td-markov-m64"
    lines, launches = [], {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- resume: fused/kernel, summary, 3 segments of 12 runs
    spec = td_spec(m, N, trace="summary", step_backend="fused",
                   gain_backend="kernel", chunk_size=TD_RESUME_CHUNK)
    segments = td_cell(m, N, name).runs // TD_RESUME_CHUNK
    tmp = tempfile.mkdtemp(prefix="chip_smoke_td_resume_")
    try:
        plain, wall_plain, counts, _ = timed(dev, lambda: run_sweep(
            spec, inp["sampler"], inp["w0"], **kw))
        check_launches(f"{name} run_sweep chunked", counts,
                       {"gain_family_stats": segments * N})
        add(counts)
        d = os.path.join(tmp, "chunks")
        full, wall_full, counts, _ = timed(dev, lambda: run_sweep_resumable(
            spec, inp["sampler"], inp["w0"], store_dir=d, **kw))
        check_launches(f"{name} resumable", counts,
                       {"gain_family_stats": segments * N})
        add(counts)
        chunks = sorted(f for f in os.listdir(d) if f.startswith("chunk_"))
        check(len(chunks) == segments, f"{name}: {len(chunks)} chunks")
        for f in chunks[TD_RESUME_KEEP:]:
            os.remove(os.path.join(d, f))
        events = []
        resumed, wall_resumed, counts, _ = timed(dev, lambda: run_sweep_resumable(
            spec, inp["sampler"], inp["w0"], store_dir=d,
            on_chunk=lambda i, n, restored: events.append(restored), **kw))
        check(events == [True] * TD_RESUME_KEEP
              + [False] * (segments - TD_RESUME_KEEP),
              f"{name}: resume events {events}")
        check_launches(f"{name} resumed", counts, {
            "gain_family_stats": (segments - TD_RESUME_KEEP) * N})
        add(counts)
        check(bitwise_equal(full, resumed),
              f"{name}: the resumed sweep differs from the uninterrupted")
        check(bitwise_equal(full, plain),
              f"{name}: the resumable sweep differs from run_sweep")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines.append(dict(cell=name, phase="resume", runs=36, iterations=N,
                      chunk_size=TD_RESUME_CHUNK, segments=segments,
                      run_sweep_wall_s=wall_plain, resumable_wall_s=wall_full,
                      resumed_wall_s=wall_resumed,
                      events=dict(restored=events.count(True),
                                  computed=events.count(False)),
                      resumed_bitwise=True, run_sweep_bitwise=True,
                      reduced=dict(iterations=[s["iters"], N])))

    # -- a clean channel is no channel, bit for bit, on every kernel backend
    clean = {}
    for step in ("reference", "fused", "megastep"):
        out = {}
        for label, chans in (("none", None), ("clean", ((0.0, 0, 0),))):
            spec = td_spec(m, N, trace="summary", step_backend=step,
                           gain_backend="kernel", channel_sets=chans)
            res, wall, counts, _ = timed(dev, lambda: run_sweep(
                spec, inp["sampler"], inp["w0"], **kw))
            k, per_step = EXPECT[step]
            check_launches(f"{name} {step} {label}", counts,
                           {k: per_step * N})
            add(counts)
            out[label] = (res, wall)
        check(bitwise_equal(out["none"][0], out["clean"][0], squeeze=1),
              f"{name} {step}: a clean channel differs from none")
        clean[step] = dict(clean_equals_none_bitwise=True,
                           wall_s={k: w for k, (_, w) in out.items()})
    lines.append(dict(cell=name, phase="clean_vs_none", runs=36,
                      iterations=N, **clean))

    # -- loss 30 % on fused against plain torch
    cell = td_cell(m, N, name)._replace(channels=(("loss30", (0.3, 0, 0)),))
    res_l = {}
    for step, gain in (("reference", "reference"), ("fused", "kernel")):
        spec = td_spec(m, N, trace=TraceSpec(alphas=True, gains=True),
                       step_backend=step, gain_backend=gain,
                       channel_sets=((0.3, 0, 0),))
        res, wall, counts, _ = timed(dev, lambda: run_sweep(
            spec, inp["sampler"], inp["w0"], **kw))
        check_launches(f"{name} loss30 {step}/{gain}", counts,
                       {"gain_family_stats": N} if gain == "kernel" else {})
        add(counts)
        res_l[step] = (spec, res, wall)
    spec, got, wall = res_l["fused"]
    cmp = compare_sweeps(got, res_l["reference"][1],
                         grid_thresholds(spec, got), cell)
    lines.append(dict(cell=name, phase="loss30", sweep="fused+kernel",
                      runs=36, iterations=N, wall_s=wall,
                      comm_rate_mean=float(got.comm_rate.mean()),
                      delivered_rate_mean=float(
                          got.trace.delivered_rate.mean()), **cmp))
    return lines, launches


def value_iteration_phase(dev):
    """Algorithm 1's outer loop on a kernel backend against plain torch:
    run_value_iteration_scan on the discounted gridworld
    (tests/test_sweep.py:325-345, megastep) and Q-learning's
    run_value_iteration (tests/test_qlearning.py:53, reference step
    backend, gain_matvec), each held to the reference tests' bounds."""
    import numpy as np
    import torch
    from repro_torch import random as trandom
    from repro_torch.core import qlearning as Q
    from repro_torch.core.algorithm1 import (GatedSGDConfig,
                                             run_value_iteration,
                                             run_value_iteration_scan)
    from repro_torch.core.trigger import TriggerConfig
    from repro_torch.envs import GridWorld

    gw = GridWorld(gamma=0.9)
    lines, launches = [], {}

    def hold(label, got, ref, trig):
        """Each outer step's decisions exact (a tie, reported, ends the
        comparison) and weights within WEIGHT_TOL."""
        thr = trig.schedule().to(dev)
        w_rel, ties, compared = 0.0, 0, 0
        for i, (g, r) in enumerate(zip(got, ref)):
            diff = g.alphas != r.alphas                 # (N, m)
            if bool(diff.any()):
                k = int(torch.nonzero(diff.any(-1))[0])
                scale = float(r.gains.abs().max()) + 1.0
                margin = float(((r.gains[k][diff[k]] + thr[k]).abs()
                                / scale).max())
                check(margin <= WEIGHT_TOL,
                      f"{label} outer {i} step {k}: decision differs, "
                      f"margin {margin:.3g}")
                ties += 1
                break
            w_rel = max(w_rel, rel_err(g.weights, r.weights)[0])
            compared += 1
        check(w_rel <= WEIGHT_TOL, f"{label}: weights differ by {w_rel:.3g}")
        return dict(weights_max_rel=w_rel, outer_steps_compared=compared,
                    tie_stops=ties)

    # -- value iteration, scan form, megastep
    prob0 = gw.vfa_problem(np.zeros(gw.num_states))
    trig = TriggerConfig(lam=1e-4, rho=prob0.min_rho(0.5) * 1.0001,
                         num_iterations=VI_INNER)
    v_true = gw.exact_value()
    out = {}
    for step, gain in (("megastep", "kernel"), ("reference", "reference")):
        cfg = GatedSGDConfig(trigger=trig, eps=0.5, num_agents=2,
                             mode="practical", step_backend=step,
                             gain_backend=gain)
        (w, traces), wall, counts, _ = timed(dev, lambda: run_value_iteration_scan(
            trandom.key(0), torch.zeros(25), gw.sampler_fn(20),
            lambda v: gw.agent_params(v, 2), cfg, VI_OUTER,
            terms_for_v=gw.problem_terms, device=dev))
        check_launches(f"value-iteration {step}/{gain}", counts,
                       {"megastep": 2 * VI_OUTER * VI_INNER}
                       if gain == "kernel" else {})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        err = float(np.abs(w.cpu().numpy() - v_true).max())
        bound = 0.15 * float(np.abs(v_true).max())
        check(err < bound and bool(((traces.comm_rate >= 0)
                                    & (traces.comm_rate <= 1)).all()),
              f"value-iteration {step}/{gain}: error {err:.4g} over {bound:.4g}")
        out[step] = (traces, dict(wall_s=wall, error_vs_v_pi=err,
                                  bound=bound, launches=counts,
                                  comm_rate_mean=float(
                                      traces.comm_rate.mean())))
    split = lambda tr: [type(tr)(*(None if x is None else x[i] for x in tr))  # noqa: E731
                        for i in range(VI_OUTER)]
    lines.append(dict(cell="value-iteration-gridworld",
                      outer=VI_OUTER, inner=VI_INNER, samples=20,
                      kernel=dict(out["megastep"][1], sweep="megastep+kernel"),
                      plain=dict(out["reference"][1],
                                 sweep="reference+reference"),
                      vs_plain=hold("value-iteration",
                                    split(out["megastep"][0]),
                                    split(out["reference"][0]), trig)))

    # -- Q-learning, loop form, reference step backend (gain_matvec)
    n = Q.q_dimension(gw)
    trig = TriggerConfig(lam=1e-4, rho=min(Q.q_problem(gw, np.zeros(n))
                                           .min_rho(12.0) * 1.0001, 0.9999),
                         num_iterations=VI_INNER)
    q_true = Q.exact_q(gw)
    out = {}
    for step, gain in (("reference", "kernel"), ("reference", "reference")):
        cfg = GatedSGDConfig(trigger=trig, eps=12.0, num_agents=2,
                             mode="practical", step_backend=step,
                             gain_backend=gain)
        (w, traces), wall, counts, _ = timed(dev, lambda: run_value_iteration(
            trandom.key(0), torch.zeros(n),
            lambda qw: Q.make_q_sampler(gw, qw, 60), cfg, VI_OUTER,
            device=dev))
        check_launches(f"q-learning {step}/{gain}", counts,
                       {"gain_matvec": VI_OUTER * VI_INNER}
                       if gain == "kernel" else {})
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        err = float(np.abs(w.cpu().numpy() - q_true).max())
        bound = 0.2 * float(np.abs(q_true).max())
        rates = [float(t.comm_rate) for t in traces]
        check(err < bound and all(0 <= r <= 1 for r in rates)
              and any(r < 1 for r in rates),
              f"q-learning {step}/{gain}: error {err:.4g} over {bound:.4g}, "
              f"rates {rates}")
        out[gain] = (traces, dict(wall_s=wall, error_vs_q_pi=err,
                                  bound=bound, launches=counts,
                                  comm_rate_mean=float(np.mean(rates))))
    lines.append(dict(cell="q-learning-gridworld", outer=VI_OUTER,
                      inner=VI_INNER, samples=60,
                      kernel=dict(out["kernel"][1], sweep="reference+kernel"),
                      plain=dict(out["reference"][1],
                                 sweep="reference+reference"),
                      vs_plain=hold("q-learning", out["kernel"][0],
                                    out["reference"][0], trig)))
    return lines, launches


# ---------------------------------------------------------------------------
# Phase 4: the LM substrate's kernels (flash attention, SSD chunk tile)
# ---------------------------------------------------------------------------

# tests/test_kernels.py:175-181 (flash), :196 (SSD tile), :213 (ssd_chunked)
FLASH_CASES = (
    dict(B=2, L=64, H=4, KVH=4, D=32, causal=True, window=0),
    dict(B=1, L=128, H=8, KVH=2, D=64, causal=True, window=0),
    dict(B=2, L=100, H=4, KVH=1, D=16, causal=True, window=32),
    dict(B=1, L=96, H=2, KVH=2, D=128, causal=False, window=0),
    dict(B=1, L=160, H=2, KVH=1, D=64, causal=True, window=64),
)
FLASH_TOL = {"float32": 3e-4, "bfloat16": 3e-2}
# the port's kernel suite's flash row (benchmarks/torch_kernels_bench.py):
# float32, the flash_kernel route, timed beside SDPA in float32
FLASH_SUITE = dict(B=1, L=512, H=4, KVH=2, D=64, causal=True, window=0)
# The tensor-core route's bf16 output against the reference computed in
# float32 on the same (bf16-valued) inputs, in bf16 ulps (``bf16_ulps``):
# rounding the float32 result to bf16 costs at most half an ulp, so a
# kernel that keeps float32 P's accuracy reads about 0.5 and one that
# rounds P to a single bf16 reads well above 1 (PERF.md section 6).
FLASH_ULP_LIMIT = 1.0
# The float32 kind of the tensor-core route (three bf16 pieces of each
# operand) against flash_kernel (float32 CUDA cores) on the same inputs:
# its max abs distance from the reference computed in float64 may be at
# most this multiple of flash_kernel's (``f32_vs_flash_kernel``).
F32_VS_FLASH_KERNEL = 2.0
SSD_TILE_CASE = dict(B=2, nc=3, Q=32, H=4, P=16, N=8)
SSD_TILE_TOL = 1e-4
SSD_CHUNKED_CASES = ((64, 32), (200, 64), (128, 128))
SSD_CHUNKED_TOL = 2e-4
# The slice's shapes: yi-6b prefill attention at B=1, L=8192 (32 query
# heads, 4 kv heads, d=128) and the mamba2-370m prefill tile at B=4,
# L=8192 (64 chunks of Q=128, 32 heads of P=64, N=128).
FLASH_SLICE = dict(B=1, L=8192, H=32, KVH=4, D=128, causal=True, window=0)
SSD_SLICE = dict(B=4, nc=64, Q=128, H=32, P=64, N=128)
# Tile cases beside the slice that the tensor-core route takes: a partial
# head group (12 heads = 8 + 4), Q = 64 with P = 128 and N = 64, and
# Q = N = P = 128 (bf16: w dtx after y, "two-phase"; float32 B/C: the
# float32 route, whose pieces do not fit a block).
SSD_TILE_SHAPES = (dict(B=1, nc=3, Q=128, H=12, P=64, N=128),
                   dict(B=1, nc=2, Q=64, H=3, P=128, N=64),
                   dict(B=1, nc=2, Q=128, H=3, P=128, N=128))
# ssd_chunked at the slice's widths with a padded last chunk (1000 = 7 x
# 128 + 104), and at the slice itself
SSD_CHUNKED_WIDE = (dict(B=1, L=1000, H=32, P=64, N=128),
                    dict(B=4, L=8192, H=32, P=64, N=128))
# A bf16 output (the state pass's in the bf16 model, and ssd_chunked's on
# bf16 inputs) against the float32 reference on the same inputs, in bf16
# ulps (``bf16_ulps``): rounding a float32-accurate result costs half an ulp.
SSD_ULP_LIMIT = 1.0
# Head dim 96 on both flash routes: the reference-style cases (GQA causal,
# a ragged length under a window) and phi3-mini's prefill attention (3072 /
# 32 heads, 32 kv heads) at B=1, L=8192.
FLASH_D96_CASES = (
    dict(B=1, L=128, H=4, KVH=2, D=96, causal=True, window=0),
    dict(B=2, L=100, H=2, KVH=2, D=96, causal=True, window=48),
)
FLASH_SLICE_D96 = dict(B=1, L=8192, H=32, KVH=32, D=96, causal=True, window=0)
# The other serving cells' attention at their main-path shapes, in bf16 as
# the main path runs it: olmoe's prefill (B=4, 16 query and kv heads) and
# jamba's attention layer (32 query heads, 8 kv heads), d=128.
FLASH_MAIN_PATH = (dict(B=4, L=8192, H=16, KVH=16, D=128, causal=True, window=0),
                   dict(B=1, L=8192, H=32, KVH=8, D=128, causal=True, window=0),
                   # internvl2-2b's prefill: 256 patches + 7936 tokens
                   dict(B=4, L=8192, H=16, KVH=8, D=128, causal=True, window=0))
# Lk != Lq (key "Lk"; without it Lk = L): query row i and key j both count
# from 0, key j visible iff j < Lk, (causal) j <= i, (window w) j > i - w.
# Lq below and above Lk, causal and not, GQA, ragged Lk, a window under
# which every row sees a key (the contract leaves rows that see none out),
# and Lq = 4 over seamless-m4t-medium's 1024 frames (decode-vs-prefill's
# prefill at t = 3), on both routes (float32: flash_kernel; bf16 at d 64
# and 128: flash_wgmma_kernel).
FLASH_CROSS_CASES = (
    dict(B=2, L=100, Lk=300, H=4, KVH=2, D=64, causal=False, window=0),
    dict(B=1, L=260, Lk=130, H=4, KVH=4, D=128, causal=False, window=0),
    dict(B=1, L=96, Lk=200, H=4, KVH=1, D=64, causal=True, window=0),
    dict(B=2, L=300, Lk=150, H=2, KVH=2, D=128, causal=True, window=0),
    dict(B=1, L=200, Lk=160, H=4, KVH=2, D=64, causal=True, window=64),
    dict(B=2, L=4, Lk=1024, H=16, KVH=16, D=64, causal=False, window=0),
)
# seamless-m4t-medium's prefill attention at B=4 (16 query and kv heads,
# d=64): the cross-attention (8192 decoder tokens over 1024 frames, no
# mask), the decoder's causal self-attention at 8192 and the encoder's
# bidirectional self-attention over the 1024 frames
FLASH_CROSS_SLICE = dict(B=4, L=8192, Lk=1024, H=16, KVH=16, D=64,
                         causal=False, window=0)
FLASH_SLICE_D64 = dict(B=4, L=8192, H=16, KVH=16, D=64, causal=True, window=0)
FLASH_ENCODER_D64 = dict(B=4, L=1024, H=16, KVH=16, D=64, causal=False,
                         window=0)
# jamba's SSM at B=1, L=8192: 64 chunks of Q=128, 128 heads of P=64, N=16
# (d_inner 8192).  The tile takes its narrow tensor-core route there
# (ssd_chunk_wgmma_n16_kernel: B and C in one swizzle atom, an M-64 state
# product), the pass its tensor-core one (one k16 step of C . h).
JAMBA_SSD_SLICE = dict(B=1, nc=64, Q=128, H=128, P=64, N=16)
JAMBA_SSD_SMALL = dict(B=1, nc=3, Q=128, H=12, P=64, N=16)
JAMBA_SSD_CHUNKED = (dict(B=1, L=1000, H=128, P=64, N=16),
                     dict(B=1, L=8192, H=128, P=64, N=16))


def _randn(gen, shape):
    import torch
    return torch.randn(*shape, generator=gen)


def _flash_inputs(gen, dev, c, dtype):
    lk = c.get("Lk", c["L"])
    return tuple(_randn(gen, (c["B"], length, heads, c["D"])).to(dtype).to(dev)
                 for length, heads in ((c["L"], c["H"]), (lk, c["KVH"]),
                                       (lk, c["KVH"])))


def _ssd_inputs(gen, dev, c, bc_dtype):
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    dtx = _randn(gen, (B, nc, Q, H, P)).to(dev)
    cum = (-_randn(gen, (B, nc, Q, H)).abs().cumsum(dim=2) * 0.1).to(dev)
    bm = _randn(gen, (B, nc, Q, N)).to(bc_dtype).to(dev)
    cm = _randn(gen, (B, nc, Q, N)).to(bc_dtype).to(dev)
    return dtx, cum, bm, cm


def _chunked_inputs(gen, dev, c, dt):
    """ssd_chunked's inputs at (B, L, H, P, N): xh, B and C in ``dt``."""
    B, L, H, P, N = (c[k] for k in ("B", "L", "H", "P", "N"))
    xh = _randn(gen, (B, L, H, P)).to(dt).to(dev)
    dt_ = (_randn(gen, (B, L, H)).abs() * 0.1).to(dev)
    a = -_randn(gen, (H,)).abs().to(dev)
    bm = _randn(gen, (B, L, N)).to(dt).to(dev)
    cm = _randn(gen, (B, L, N)).to(dt).to(dev)
    return xh, dt_, a, bm, cm


def bf16_ulps(got, want, mantissa=7, min_exp=-126):
    """max |got - want| in bf16 ulps of |want| (``want`` in float32, (..., L,
    heads, d)).  |want| is floored at 1/16 of its row's rms over the head
    dim, so an element that cancels to near zero is measured on its row's
    scale.  A row of fewer than 8 elements is too short to give a scale (at
    d 1 its rms is the element itself), so there the rms is over every row
    of its head (and batch row).  With ``mantissa`` and ``min_exp`` another
    format's ulps (``f16_ulps``)."""
    import torch
    want = want.float()
    dims = (-1,) if want.shape[-1] >= 8 or want.dim() < 3 else (-3, -1)
    rms = want.pow(2).mean(dims, keepdim=True).sqrt()
    scale = torch.maximum(want.abs(), rms / 16).clamp_min(1e-30)
    exp = torch.floor(torch.log2(scale)).clamp_min(min_exp)
    ulp = torch.exp2(exp - mantissa)
    return float(((got.float() - want).abs() / ulp).max())


def f16_ulps(got, want):
    """``bf16_ulps`` in float16 ulps: 10 mantissa bits, subnormal below
    2^-14 (ulp 2^-24)."""
    return bf16_ulps(got, want, mantissa=10, min_exp=-14)


def flash_work(c, itemsize):
    """Bytes (q, k, v read once, o written once) and operations (two
    products over the visible (query, key) pairs; the slices this bounds
    have no window)."""
    B, L, H, KVH, D = (c[k] for k in ("B", "L", "H", "KVH", "D"))
    lk = c.get("Lk", L)
    if c["causal"]:   # row i sees min(i + 1, Lk) keys
        m = min(L, lk)
        pairs = m * (m + 1) // 2 + (L - m) * lk
    else:
        pairs = L * lk
    return (itemsize * (2 * B * L * H * D + 2 * B * lk * KVH * D),
            4 * B * H * pairs * D)


def flash_f32_bounds(c):
    """The float32 kind's bounds at shape ``c``: float32 q, k, v and o
    against the six bf16 piece products of each product on the tensor
    cores (``bound_ms``, the kernel's least time) and against the
    function's float32 operations on CUDA cores (``cuda_core_bound_ms``,
    flash_kernel's)."""
    moved, ops = flash_work(c, 4)
    b_ms, b_by = bound(moved, 6 * ops, PEAK_BF16_FLOPS)
    return dict(bound_ms=b_ms, bound_by=b_by,
                bound_is="six bf16 piece products at 989 TFLOP/s",
                cuda_core_bound_ms=bound(moved, ops)[0])


def flash_ref64(q, k, v, causal=True, window=0, rows=2048):
    """The reference's attention in float64, one batch row, head and block
    of ``rows`` query rows at a time (a whole head's float64 scores are
    0.5 GB at 8192 x 8192)."""
    import torch
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    kp = torch.arange(Lk, device=q.device)[None, :]
    for b in range(B):
        for h in range(H):
            kk = k[b, :, h // (H // KVH)].double()
            vv = v[b, :, h // (H // KVH)].double()
            for i0 in range(0, Lq, rows):
                s = (q[b, i0:i0 + rows, h].double() @ kk.T) * D**-0.5
                qp = torch.arange(i0, i0 + s.shape[0], device=q.device)[:, None]
                vis = torch.ones_like(s, dtype=torch.bool)
                if causal:
                    vis &= kp <= qp
                if window > 0:
                    vis &= kp > qp - window
                s = torch.where(vis, s, torch.full_like(s, -1e30))
                out[b, i0:i0 + rows, h] = torch.softmax(s, dim=-1) @ vv
    return out


def f32_log():
    """The float32 kind's log, with flash_kernel's nested in it as its
    CUDA-core route (``f32_vs_flash_kernel``)."""
    from repro_torch.kernels import flash_attention as FA
    log = KernelLog()
    simt = log.nested["cuda_core_route"] = KernelLog()
    simt.extra.update(
        kernel=FA.SIMT.kernel, routes=[FA.SIMT.counter, FA.PADDED.counter],
        tolerance=dict(float32=FLASH_TOL["float32"]),
        note="flash_kernel forced on every float32 case of the float32 kind "
             "and on its own at float32 inputs off 16-byte boundaries, each "
             "against the plain version and repeated bitwise")
    return log


def f32_vs_flash_kernel(log, label, got, q, k, v, kw):
    """flash_kernel forced on the float32 kind's inputs: held against the
    plain version at ``FLASH_TOL`` and repeated bitwise (into ``log``'s
    nested ``cuda_core_route``), then both outputs against the reference in
    float64: the kind's ``got`` may lie at most ``F32_VS_FLASH_KERNEL``
    times as far (max abs) as flash_kernel's.  Both distances and the
    seconds these checks take go into ``log``'s ``float64_distance``."""
    from repro_torch.kernels import flash_attention as FA
    t0 = time.perf_counter()
    r = FA.flash_kernel_route(q.shape[-1])
    simt = log.nested["cuda_core_route"]
    label_fk = f"{label} (flash_kernel forced)"
    fn = lambda: FA.flash_attention(q, k, v, force=FA.SIMT, **kw)  # noqa: E731
    fk = _launched(FA, label_fk, {r.counter: 1}, fn)
    _flash_check(simt, label_fk, fk, q, k, v, kw, FLASH_TOL["float32"])
    simt.repeat(label_fk, fn)
    simt.cases += 1
    want = flash_ref64(q, k, v, **kw)
    d_new = float((got.double() - want).abs().max())
    d_fk = float((fk.double() - want).abs().max())
    del want, fk
    dist = log.extra.setdefault("float64_distance", dict(
        limit=F32_VS_FLASH_KERNEL, worst_ratio=0.0, seconds=0.0,
        cases={}, note="[the float32 kind, flash_kernel forced]: max abs "
                       "distance from the reference in float64; seconds: "
                       "flash_kernel's checks and the float64 references"))
    dist["cases"][label] = [d_new, d_fk]
    dist["worst_ratio"] = max(dist["worst_ratio"], d_new / max(d_fk, 1e-30))
    check(d_new <= F32_VS_FLASH_KERNEL * d_fk,
          f"{label}: {d_new:.3g} from the float64 reference, flash_kernel "
          f"{d_fk:.3g} (limit {F32_VS_FLASH_KERNEL}x)")
    dist["seconds"] += time.perf_counter() - t0


def f32_timing(c, q, k, v, kw, reps=5):
    """The float32 kind, flash_kernel forced and
    scaled_dot_product_attention in float32 (none under a window) on the
    same inputs at shape ``c``, timed (median of ``reps``), with both
    bounds (``flash_f32_bounds``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=kw["causal"], enable_gqa=True)
    return dict(ms=time_ms(lambda: FA.flash_attention(q, k, v, **kw),
                           reps=reps, warmup=1),
                flash_kernel_ms=time_ms(lambda: FA.flash_attention(
                    q, k, v, force=FA.SIMT, **kw), reps=3, warmup=1),
                library_ms=(time_ms(sdpa, reps=reps, warmup=1)
                            if not kw["window"] else None),
                **flash_f32_bounds(c))


def ssd_work(c, bc_itemsize, x_itemsize=None):
    """Bytes (dtx, cum, B, C read once; y, states written once) and the
    function's float32 operations: C B^T once per chunk and y per head on
    the pairs the decay lets through (j <= i, as ``ssd_tensor_core_ops``
    counts them), the state per head.  With ``x_itemsize`` the tile forms
    dt x on load: it reads x in that size and float32 dt in place of
    dtx."""
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    chunks = B * nc
    pairs = Q * (Q + 1) // 2
    x_in = (4 * Q * H * P if x_itemsize is None
            else x_itemsize * Q * H * P + 4 * Q * H)
    moved = (chunks * (x_in + 4 * (Q * H * P + Q * H + H * N * P))
             + bc_itemsize * 2 * chunks * Q * N)
    return moved, chunks * (2 * pairs * N + H * (2 * pairs * P + 2 * N * Q * P))


def ssd_tensor_core_ops(c, bc_itemsize):
    """Tensor-core operations of ssd_chunk_wgmma_kernel's bf16 pieces on
    the pairs the decay lets through (j <= i): C B^T (six products of three
    pieces for float32 B/C, one for bf16), y (six) and the state (six, or
    three with bf16 B)."""
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    pairs = Q * (Q + 1) // 2
    bc_products = 6 if bc_itemsize == 4 else 1
    state_products = 6 if bc_itemsize == 4 else 3
    return B * nc * (bc_products * 2 * pairs * N
                     + H * (6 * 2 * pairs * P + state_products * 2 * N * Q * P))


def ssd_state_pass_work(c, c_itemsize, y_itemsize, length=None):
    """Bytes (y_intra, the states, cum, C read once; y and the final state
    written once) and float32 operations (C . h per chunk, the combine and
    the state update) of the inter-chunk pass, as ssd_state_pass_kernel
    computes them on CUDA cores."""
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    L = nc * Q if length is None else length
    moved = (4 * (B * nc * Q * H * P + B * nc * H * N * P + B * nc * Q * H
                  + B * H * N * P)
             + c_itemsize * B * nc * Q * N + y_itemsize * B * L * H * P)
    ops = 2 * B * nc * H * (Q * N * P + N * P + Q * P)
    return moved, ops


def ssd_state_pass_tc_bound(c, c_itemsize, y_itemsize):
    """(bound ms, bound_by, tensor-core operations) of
    ssd_state_pass_wgmma_kernel: the same bytes, C . h as its bf16-piece
    products on the tensor cores (two with bf16 C, six with float32 C) and
    the combine and state update in float32 on CUDA cores."""
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    moved, _ = ssd_state_pass_work(c, c_itemsize, y_itemsize)
    products = 6 if c_itemsize == 4 else 2
    tc_ops = products * 2 * B * nc * H * Q * N * P
    t_ops = (tc_ops / PEAK_BF16_FLOPS
             + 2 * B * nc * H * (N * P + Q * P) / PEAK_F32_FLOPS) * 1e3
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            tc_ops)


def empty_cache(dev):
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def lm_kernel_phase(dev):
    """Flash attention and the SSD tile against their plain versions: the
    reference's test cases at their tolerances and the slice's shapes in
    float32 and bf16 (flash also at the other serving cells' shapes in
    bf16, ``FLASH_MAIN_PATH``, at head dim 96, and with Lk != Lq and head
    dim 64 for seamless-m4t-medium, ``flash_cross_phase``), a bitwise
    repeat of every launch, and timings of kernel, plain version and
    (flash) scaled_dot_product_attention.  Flash's float32 cases take the
    tensor cores' float32 kind (the ``flash_attention_wgmma_f32`` record),
    each held against flash_kernel forced on the same inputs in float64
    (``f32_vs_flash_kernel``) and timed beside it at the slices
    (``f32_timing``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(2)
    logs = {"flash_attention": KernelLog(), "ssd_chunk_tiles": KernelLog(),
            "ssd_state_pass": KernelLog(),
            "flash_attention_wgmma_f32": f32_log()}
    timings = {}

    # the flash_attention record is the tensor-core route's (the main path's);
    # its float32 kind (the float32 checks' route) is held and timed beside it
    lf, f32 = logs["flash_attention"], logs["flash_attention_wgmma_f32"]
    lf.extra["bf16_ulp_check"] = dict(max_ulps=0.0, cases=0,
                                      limit=FLASH_ULP_LIMIT)
    for c in FLASH_CASES + (FLASH_SLICE,):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(gen, dev, c, dt)
            kw = dict(causal=c["causal"], window=c["window"])
            tol = FLASH_TOL[str(dt).split(".")[-1]]
            label = f"flash {c} {dt}"
            # bf16 at d 64 and 128 on the main paths' tensor-core route, at
            # d 16 and 32 on its padded one; float32 on its float32 kind
            route = (FA.WGMMA_F32 if dt == torch.float32 else
                     FA.WGMMA if c["D"] in (64, 128) else FA.WGMMA_PADDED)
            check(route is FA.route(dt, c["D"]),
                  f"{label}: route {FA.route(dt, c['D'])}, expected {route}")
            log = f32 if route is FA.WGMMA_F32 else lf
            FA.reset_launches()
            got = FA.flash_attention(q, k, v, **kw)
            check(FA.LAUNCHES[route.counter] == 1
                  and sum(FA.LAUNCHES.values()) == 1,
                  f"{label}: launches {FA.LAUNCHES}, expected one {route.kernel}")
            _flash_check(log, label, got, q, k, v, kw, tol)
            log.repeat(label, lambda: FA.flash_attention(q, k, v, **kw))
            log.cases += 1
            if route is FA.WGMMA_F32:
                f32_vs_flash_kernel(f32, label, got, q, k, v, kw)
            del got
            if c is FLASH_SLICE and dt == torch.float32:
                f32_time = f32_timing(c, q, k, v, kw)
                timings["flash_attention_wgmma_f32"] = dict(
                    {key: f32_time[key] for key in ("ms", "library_ms",
                                                    "bound_ms", "bound_by")},
                    plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v),
                                     reps=3, warmup=1))
    lf.extra["float32_route"] = dict(
        kernel=FA.WGMMA_F32.kernel, route=FA.WGMMA_F32.counter,
        record="flash_attention_wgmma_f32", slice_dtype="float32",
        **f32_time, kernel_suite=flash_suite_timing(dev, f32))
    f32.extra.update(kernel=FA.WGMMA_F32.kernel, timed_at=dict(FLASH_SLICE),
                     flash_kernel_ms=f32_time["flash_kernel_ms"],
                     cuda_core_bound_ms=f32_time["cuda_core_bound_ms"],
                     bound_is=f32_time["bound_is"])
    # timed at the slice shape in the serving cells' dtype (bf16, last above)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    lf.close("flash slice vs scaled_dot_product_attention",
             FA.flash_attention(q, k, v), sdpa().transpose(1, 2),
             FLASH_TOL["bfloat16"])
    b_ms, b_by = bound(*flash_work(FLASH_SLICE, 2), PEAK_BF16_FLOPS)
    timings["flash_attention"] = dict(
        ms=time_ms(lambda: FA.flash_attention(q, k, v), reps=10),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=5,
                         warmup=1),
        library_ms=time_ms(sdpa, reps=10), bound_ms=b_ms, bound_by=b_by)
    del q, k, v
    empty_cache(dev)
    # the other serving cells' shapes, against the float32 reference one
    # batch row at a time (its (H, L, L) scores are 4.3 GB a row at olmoe's)
    for c in FLASH_MAIN_PATH:
        q, k, v = _flash_inputs(gen, dev, c, torch.bfloat16)
        label = f"flash {c} bf16 (a serving cell's shape)"
        FA.reset_launches()
        got = FA.flash_attention(q, k, v, causal=True)
        check(FA.LAUNCHES[FA.WGMMA.counter] == 1
              and sum(FA.LAUNCHES.values()) == 1,
              f"{label}: launches {FA.LAUNCHES}, expected one {FA.WGMMA.kernel}")
        _flash_check(lf, label, got, q, k, v, dict(causal=True),
                     FLASH_TOL["bfloat16"], rows=True)
        lf.repeat(label, lambda: FA.flash_attention(q, k, v, causal=True))
        lf.cases += 1
        del q, k, v, got
        empty_cache(dev)

    flash_d96_phase(dev, gen, logs, timings)
    flash_cross_phase(dev, gen, logs, timings)
    ssd_tile_phase(dev, gen, logs, timings)
    ssd_pass_phase(dev, gen, logs, timings)
    ssd_chunked_phase(dev, gen, logs)
    jamba_ssd_phase(dev, gen, logs, timings)
    return logs, timings


def flash_suite_timing(dev, f32):
    """The float32 kind at the kernel suite's shape, FLASH_SUITE, against
    its plain version at FLASH_TOL and flash_kernel in float64 (into the
    float32 kind's log ``f32``), and timed beside flash_kernel, the plain
    version and scaled_dot_product_attention in float32, with both
    bounds."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    c = FLASH_SUITE
    q, k, v = _flash_inputs(torch.Generator().manual_seed(8), dev, c,
                            torch.float32)
    kw = dict(causal=True, window=0)
    r = FA.cuda_route(q, k, v)
    check(r is FA.WGMMA_F32, f"flash kernel suite: route {r}")
    got = _launched(FA, "flash kernel suite", {r.counter: 1},
                    lambda: FA.flash_attention(q, k, v))
    err = rel_err(got, ref.flash_attention_ref(q, k, v))[0]
    check(err <= FLASH_TOL["float32"], f"flash kernel suite: error {err:.3g}")
    f32_vs_flash_kernel(f32, f"flash kernel suite {c}", got, q, k, v, kw)
    return dict(shape=c, dtype="float32", kernel=r.kernel, route=r.counter,
                max_rel_err=err, **f32_timing(c, q, k, v, kw, reps=20),
                plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v)))


def flash_d96_phase(dev, gen, logs, timings):
    """Head dim 96 on both routes (the ``flash_attention_d96`` record: the
    tensor-core route, ``flash_wgmma_kernel`` in tiles padded to 128
    columns; its float32 kind nested as its float32 route, the cases in
    the ``flash_attention_wgmma_f32`` record):
    ``FLASH_D96_CASES`` and phi3-mini's prefill slice in float32 and bf16
    at ``FLASH_TOL``, the tensor-core cases within ``FLASH_ULP_LIMIT`` of
    the float32 reference, a bitwise repeat of each, each case's launch
    checked, and the slice's times beside ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    lf = logs["flash_attention_d96"] = KernelLog()
    f32 = logs["flash_attention_wgmma_f32"]
    lf.extra["bf16_ulp_check"] = dict(max_ulps=0.0, cases=0,
                                      limit=FLASH_ULP_LIMIT)
    for c in FLASH_D96_CASES + (FLASH_SLICE_D96,):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(gen, dev, c, dt)
            kw = dict(causal=c["causal"], window=c["window"])
            tol = FLASH_TOL[str(dt).split(".")[-1]]
            route = FA.route(dt, c["D"])
            check(route is (FA.WGMMA if dt == torch.bfloat16
                            else FA.WGMMA_F32),
                  f"flash d96 {dt}: route {route.counter}")
            label = f"flash {c} {dt} ({route.counter})"
            log = lf if route is FA.WGMMA else f32
            FA.reset_launches()
            got = FA.flash_attention(q, k, v, **kw)
            check(FA.LAUNCHES[route.counter] == 1
                  and sum(FA.LAUNCHES.values()) == 1,
                  f"{label}: launches {FA.LAUNCHES}, expected one {route.kernel}")
            _flash_check(log, label, got, q, k, v, kw, tol)
            log.repeat(label, lambda: FA.flash_attention(q, k, v, **kw))
            log.cases += 1
            if route is FA.WGMMA_F32:
                f32_vs_flash_kernel(f32, label, got, q, k, v, kw)
            del got
            if c is FLASH_SLICE_D96 and dt == torch.float32:
                f32_time = f32_timing(c, q, k, v, kw)
            if c is not FLASH_SLICE_D96 or dt == torch.float32:
                del q, k, v
    from repro_torch.kernels import build
    lib = build.load()
    lf.extra.update(
        kernel=FA.WGMMA.kernel, head_dim=96,
        design="TMA boxes of 64 columns over the 96-wide tensor maps, tiles "
               "padded to 128 columns (TMA fills 96-127 with zeros); Q K^T "
               "over 96, P V at n128 with the last 32 columns never stored",
        dynamic_smem_bytes=lib.flash_attention_wgmma_smem_bytes(96),
        float32_route=dict(
            kernel=FA.WGMMA_F32.kernel, route=FA.WGMMA_F32.counter,
            record="flash_attention_wgmma_f32", slice_dtype="float32",
            **f32_time))
    # timed at phi3-mini's slice in bf16 (the serving cells' dtype)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True)
    lf.close("flash d96 slice vs scaled_dot_product_attention",
             FA.flash_attention(q, k, v), sdpa().transpose(1, 2),
             FLASH_TOL["bfloat16"])
    moved, ops = flash_work(FLASH_SLICE_D96, 2)
    b_ms, b_by = bound(moved, ops, PEAK_BF16_FLOPS)
    # the kernel's own tensor-core products: Q K^T at 96 columns, P V as a
    # hi/lo pair at n128
    lf.extra["tensor_core_ops"] = ops // 2 * (96 + 2 * 128) // 96
    timings["flash_attention_d96"] = dict(
        ms=time_ms(lambda: FA.flash_attention(q, k, v), reps=10),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v), reps=5,
                         warmup=1),
        library_ms=time_ms(sdpa, reps=10), bound_ms=b_ms, bound_by=b_by)
    del q, k, v
    empty_cache(dev)


def _flash_check(log, label, got, q, k, v, kw, tol, rows=False):
    """A flash kernel's output ``got`` against the plain version on the
    same inputs at ``tol`` (with ``rows``, against the float32 reference
    computed one batch row at a time and rounded to q's dtype) and, where
    ``log`` keeps a ``bf16_ulp_check`` (bf16 outputs of a tensor-core
    route) or an ``f16_ulp_check`` (float16 outputs), within
    ``FLASH_ULP_LIMIT`` ulps of that format from the float32 reference."""
    import torch
    from repro_torch.kernels import ref

    def plain(*xs):
        if not rows:
            return ref.flash_attention_ref(*xs, **kw)
        return torch.cat([ref.flash_attention_ref(*(x[b:b + 1] for x in xs),
                                                  **kw)
                          for b in range(xs[0].shape[0])])
    f16 = q.dtype == torch.float16
    ulp_check = log.extra.get("f16_ulp_check" if f16 else "bf16_ulp_check")
    if q.dtype == torch.float32:
        ulp_check = None
    want32 = None
    if rows or ulp_check is not None:
        want32 = plain(q.float(), k.float(), v.float())
    log.close(label, got, want32.to(q.dtype) if rows else plain(q, k, v), tol)
    if ulp_check is not None:
        ulps = (f16_ulps if f16 else bf16_ulps)(got, want32)
        check(ulps <= FLASH_ULP_LIMIT, f"{label}: {ulps:.3f} "
              f"{'float16' if f16 else 'bf16'} ulps from the float32 "
              f"reference, limit {FLASH_ULP_LIMIT}")
        ulp_check["max_ulps"] = max(ulp_check["max_ulps"], ulps)
        ulp_check["cases"] += 1


def flash_cross_phase(dev, gen, logs, timings):
    """Lk != Lq and head dim 64 on both flash routes, for
    seamless-m4t-medium's prefill.  ``FLASH_CROSS_CASES`` in float32 and
    bf16 at ``FLASH_TOL`` (bf16 also within ``FLASH_ULP_LIMIT`` of the
    float32 reference), each launch's route checked, a bitwise repeat of
    each; then its three attention shapes in bf16 against the float32
    reference, one batch row at a time: the cross-attention
    (``flash_attention_cross``: Lq 8192 over Lk 1024, also in float32 on
    the float32 kind, the float32 checks' route, timed beside
    ``flash_kernel``), the decoder's causal and
    the encoder's bidirectional self-attention (``flash_attention_d64``).
    The cross-attention and the decoder's self-attention are timed beside
    the plain version (one batch row at a time: a whole batch's float32
    scores are 17 GB at 8192 x 8192) and ``scaled_dot_product_attention``
    on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    cross = logs["flash_attention_cross"] = KernelLog()
    d64 = logs["flash_attention_d64"] = KernelLog()
    f32 = logs["flash_attention_wgmma_f32"]
    for lf in (cross, d64):
        lf.extra["bf16_ulp_check"] = dict(max_ulps=0.0, cases=0,
                                          limit=FLASH_ULP_LIMIT)

    def run(log, label, c, dt, rows=False):
        q, k, v = _flash_inputs(gen, dev, c, dt)
        kw = dict(causal=c["causal"], window=c["window"])
        route = FA.route(dt, c["D"])
        check(route is (FA.WGMMA if dt == torch.bfloat16 else FA.WGMMA_F32),
              f"{label}: route {route.counter}")
        log = log if route is FA.WGMMA else f32
        label = f"{label} {c} {dt} ({route.counter})"
        FA.reset_launches()
        got = FA.flash_attention(q, k, v, **kw)
        check(FA.LAUNCHES[route.counter] == 1
              and sum(FA.LAUNCHES.values()) == 1,
              f"{label}: launches {FA.LAUNCHES}, expected one {route.kernel}")
        _flash_check(log, label, got, q, k, v, kw,
                     FLASH_TOL[str(dt).split(".")[-1]], rows)
        log.repeat(label, lambda: FA.flash_attention(q, k, v, **kw))
        log.cases += 1
        if route is FA.WGMMA_F32:
            f32_vs_flash_kernel(f32, label, got, q, k, v, kw)
        return q, k, v

    for c in FLASH_CROSS_CASES:
        for dt in (torch.float32, torch.bfloat16):
            run(cross, "flash Lk != Lq", c, dt)
    q, k, v = run(cross, "flash cross slice", FLASH_CROSS_SLICE,
                  torch.float32, rows=True)
    f32_time = f32_timing(FLASH_CROSS_SLICE, q, k, v,
                          dict(causal=False, window=0))
    del q, k, v
    empty_cache(dev)
    cross.extra.update(
        kernel=FA.WGMMA.kernel, head_dim=64,
        design="the K and V tensor maps span Lk, so TMA zero-fills the last "
               "K/V tile past Lk within its batch row; the Q map and the grid "
               "span Lq; keys visible iff j < Lk (and the causal and window "
               "masks from 0 on both sides)",
        float32_route=dict(
            kernel=FA.WGMMA_F32.kernel, route=FA.WGMMA_F32.counter,
            record="flash_attention_wgmma_f32", slice_dtype="float32",
            **f32_time))
    d64.extra.update(kernel=FA.WGMMA.kernel, head_dim=64)

    def sdpa_fn(q, k, v, causal):
        return lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal)

    for name, log, c in (("flash_attention_cross", cross, FLASH_CROSS_SLICE),
                         ("flash_attention_d64", d64, FLASH_SLICE_D64)):
        q, k, v = run(log, name, c, torch.bfloat16, rows=True)
        causal = c["causal"]
        sdpa = sdpa_fn(q, k, v, causal)
        log.close(f"{name} slice vs scaled_dot_product_attention",
                  FA.flash_attention(q, k, v, causal=causal),
                  sdpa().transpose(1, 2), FLASH_TOL["bfloat16"])
        b_ms, b_by = bound(*flash_work(c, 2), PEAK_BF16_FLOPS)
        rows = lambda: [ref.flash_attention_ref(  # noqa: E731
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=causal)
            for b in range(c["B"])]
        timings[name] = dict(
            ms=time_ms(lambda: FA.flash_attention(q, k, v, causal=causal),
                       reps=10),
            plain_ms=time_ms(rows, reps=3, warmup=1),
            library_ms=time_ms(sdpa, reps=10), bound_ms=b_ms, bound_by=b_by)
        log.extra.update(timed_shape=dict(c),
                         plain_ms_is="the plain version one batch row at a "
                                     "time, summed")
        del q, k, v
        empty_cache(dev)
    run(d64, "flash encoder", FLASH_ENCODER_D64, torch.bfloat16, rows=True)
    empty_cache(dev)


def jamba_ssd_phase(dev, gen, logs, timings):
    """The SSD at jamba's state width N 16, where the main path runs the
    narrow tensor-core tile (``ssd_chunk_tiles_n16`` record) and the
    tensor-core pass with a single k16 step (``ssd_state_pass_n16``
    record): the tile alone at ``JAMBA_SSD_SMALL`` (a partial head group)
    and ``JAMBA_SSD_SLICE``, with dtx and with dt x formed on load, the pass
    alone at the slice, the whole ``ssd_chunked`` at ``JAMBA_SSD_CHUNKED``,
    each in float32 and bf16 against its plain version, each launch checked
    and repeated bitwise, and the times: at the slice the tile, its dt x on
    load form and ``ssd_chunk_kernel`` asked for at the same shape (nested
    in the record as ``cuda_core_route``), each with its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import ssm

    f32, bf16 = torch.float32, torch.bfloat16
    lt = logs["ssd_chunk_tiles_n16"] = KernelLog()
    lp = logs["ssd_state_pass_n16"] = KernelLog()
    simt = KernelLog()
    c = JAMBA_SSD_SLICE
    # the tile alone
    for shape in (JAMBA_SSD_SMALL, c):
        for dt in (f32, bf16):
            dtx, cum, bm, cm = _ssd_inputs(gen, dev, shape, dt)
            xh, dts = dtx.to(dt), dtx[..., 0].abs() * 0.1
            r = SS.route(shape["Q"], shape["N"], shape["P"], dt)
            check(r is SS.WGMMA_N16, f"jamba ssd tile {shape} {dt}: {r.kernel}")
            label = f"ssd tile {shape} {dt} ({r.kernel})"
            run = lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm)
            run_xdt = lambda: SS.ssd_chunk_tiles_xdt(xh, dts, cum, bm, cm)
            for name, fn, want_dtx in (
                    (label, run, dtx),
                    (label + " dtx on load", run_xdt,
                     dts[..., None] * xh.float())):
                y, st = _ssd_launch(name, {r.counter: 1}, fn)
                yr, sr = ref.ssd_chunk_ref(want_dtx, cum, bm, cm)
                lt.close(name + " y", y, yr, SSD_TILE_TOL)
                lt.close(name + " state", st, sr, SSD_TILE_TOL)
                lt.repeat(name, fn)
                lt.cases += 1
                del y, st, yr, sr, want_dtx
            if shape is c and dt == bf16:
                # ssd_chunk_kernel at the same shape, held and timed beside
                name = f"ssd tile {c} {dt} ({SS.SIMT.kernel})"
                run_simt = lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm,
                                                      force=SS.SIMT)
                y, st = _ssd_launch(name, {SS.SIMT.counter: 1}, run_simt)
                yr, sr = ref.ssd_chunk_ref(dtx, cum, bm, cm)
                simt.close(name + " y", y, yr, SSD_TILE_TOL)
                simt.close(name + " state", st, sr, SSD_TILE_TOL)
                simt.repeat(name, run_simt)
                simt.cases += 1
                del y, st, yr, sr
                # the card does these bf16 products on its tensor cores, so
                # that is the bound of both kernels; ssd_chunk_kernel's own
                # float32 CUDA-core rate sits beside it
                moved, f32_ops = ssd_work(c, 2)
                tc_ops = ssd_tensor_core_ops(c, 2)
                b_ms, b_by = bound(moved, tc_ops, PEAK_BF16_FLOPS)
                lt.extra.update(
                    kernel=SS.WGMMA_N16.kernel, shape=dict(c),
                    tensor_core_ops=tc_ops,
                    dtx_on_load_ms=time_ms(run_xdt, reps=10),
                    dtx_on_load_bound_ms=bound(ssd_work(c, 2, x_itemsize=2)[0],
                                               tc_ops, PEAK_BF16_FLOPS)[0],
                    cuda_core_route=dict(
                        kernel=SS.SIMT.kernel, cases=simt.cases,
                        max_abs_err=simt.max_abs, max_rel_err=simt.max_rel,
                        repeat_bitwise=simt.repeat_bitwise,
                        ms=time_ms(run_simt, reps=10), bound_ms=b_ms,
                        bound_by=b_by,
                        bound_f32_cuda_cores_ms=bound(moved, f32_ops)[0]))
                timings["ssd_chunk_tiles_n16"] = dict(
                    ms=time_ms(run, reps=10),
                    plain_ms=time_ms(lambda: ref.ssd_chunk_ref(
                        dtx, cum, bm, cm), reps=5, warmup=1),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)
            del dtx, cum, bm, cm, xh, dts
    empty_cache(dev)
    # the pass alone
    y_intra, states, cum, c32 = _pass_inputs(gen, dev, c)
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    ulps = lp.extra["bf16_ulp_check"] = dict(max_ulps=0.0, cases=0,
                                             limit=SSD_ULP_LIMIT)
    for dt, cut in ((f32, 0), (f32, 24), (bf16, 0), (bf16, 24)):
        length, cm = nc * Q - cut, c32.to(dt)
        r = SS.state_pass_route(Q, N, P, dt)
        check(r == SS.STATE_PASS_WGMMA, f"jamba pass {dt}: {r.kernel}")
        label = f"ssd state pass {c} {dt} length {length} ({r.kernel})"
        run = lambda: SS.ssd_state_pass(y_intra, states, cum, cm, length, dt)
        y, h = _ssd_launch(label, {r.counter: 1}, run)
        yr, hr = ref.ssd_state_pass_ref(y_intra, states, cum, cm, length, f32)
        check(tuple(y.shape) == (B, length, H, P) and y.dtype == dt,
              f"{label}: y {tuple(y.shape)} {y.dtype}")
        lp.close(label + " state", h, hr, SSD_CHUNKED_TOL)
        if dt == f32:
            lp.close(label + " y", y, yr, SSD_CHUNKED_TOL)
        else:
            u = bf16_ulps(y, yr)
            check(u <= SSD_ULP_LIMIT, f"{label}: {u:.3f} bf16 ulps from the "
                  f"float32 reference, limit {SSD_ULP_LIMIT}")
            ulps["max_ulps"] = max(ulps["max_ulps"], u)
            ulps["cases"] += 1
        lp.repeat(label, run)
        lp.cases += 1
        del y, h, yr, hr
    cm, length = c32.bfloat16(), nc * Q
    del c32
    timed = lambda route: time_ms(lambda: SS.ssd_state_pass(
        y_intra, states, cum, cm, length, bf16, route=route), reps=10)
    b_ms, b_by, tc_ops = ssd_state_pass_tc_bound(c, 2, 2)
    simt_ms, simt_by = bound(*ssd_state_pass_work(c, 2, 2))
    lp.extra.update(kernel=SS.STATE_PASS_WGMMA.kernel, shape=dict(c),
                    tensor_core_ops=tc_ops,
                    cuda_core_route=dict(kernel=SS.STATE_PASS_SIMT.kernel,
                                         ms=timed(SS.STATE_PASS_SIMT),
                                         bound_ms=simt_ms, bound_by=simt_by))
    timings["ssd_state_pass_n16"] = dict(
        ms=timed(None),
        plain_ms=time_ms(lambda: ref.ssd_state_pass_ref(
            y_intra, states, cum, cm, length, bf16), reps=5, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del y_intra, states, cum, cm
    empty_cache(dev)
    # the whole ssd_chunked: tile + pass
    worst = 0.0
    for shape in JAMBA_SSD_CHUNKED:
        for dt in (f32, bf16):
            xh, dt_, a, bm, cm = _chunked_inputs(gen, dev, shape, dt)
            label = f"ssd_chunked {shape} chunk=128 {dt}"
            run = lambda: SS.ssd_chunked(xh, dt_, a, bm, cm, chunk=128)
            y1, h1 = _ssd_launch(label, {SS.WGMMA_N16.counter: 1,
                                         SS.STATE_PASS_WGMMA.counter: 1}, run)
            y2, h2 = ssm.ssd_chunked(xh.float(), dt_, a, bm.float(), cm.float(),
                                     chunk=128)
            check(y1.dtype == dt, f"{label}: y dtype {y1.dtype}")
            lp.close(label + " state", h1, h2, SSD_CHUNKED_TOL)
            if dt == f32:
                lp.close(label + " y", y1, y2, SSD_CHUNKED_TOL)
            else:
                u = bf16_ulps(y1, y2)
                check(u <= SSD_ULP_LIMIT, f"{label}: {u:.3f} bf16 ulps from "
                      f"the float32 plain path, limit {SSD_ULP_LIMIT}")
                worst = max(worst, u)
            lp.repeat(label, run)
            lp.cases += 1
            if shape is JAMBA_SSD_CHUNKED[-1] and dt == bf16:
                lt.extra["ssd_chunked_slice"] = dict(
                    dtype="bfloat16", shape=dict(shape),
                    ms=time_ms(run, reps=10),
                    plain_ms=time_ms(lambda: ssm.ssd_chunked(
                        xh, dt_, a, bm, cm, chunk=128), reps=3, warmup=1))
            del xh, dt_, bm, cm, y1, h1, y2, h2
            empty_cache(dev)
    lt.extra["ssd_chunked_bf16_ulps"] = worst


def _ssd_launch(label, counter, fn):
    """``fn()`` with the SSD launch counts reset; check that exactly the
    launches ``counter`` names ({key: count}) ran."""
    from repro_torch.kernels import ssd_scan as SS
    SS.reset_launches()
    out = fn()
    want = {k: counter.get(k, 0) for k in SS.LAUNCHES}
    check(dict(SS.LAUNCHES) == want,
          f"{label}: launches {SS.LAUNCHES}, expected {want}")
    return out


def ssd_tile_phase(dev, gen, logs, timings):
    """The tile on both routes: the reference's case (float32 route), the
    slice and ``SSD_TILE_SHAPES`` in float32 and bf16 B/C at
    ``SSD_TILE_TOL``, the tensor-core cases also with dtx formed on load
    (``ssd_chunk_tiles_xdt``, the main path's entry), a bitwise repeat of
    each, and the slice's times."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS

    lt, simt = logs["ssd_chunk_tiles"], KernelLog()
    cases = [(SSD_TILE_CASE, torch.float32)] + [
        (c, dt) for c in (SSD_SLICE,) + SSD_TILE_SHAPES
        for dt in (torch.float32, torch.bfloat16)]
    for c, dt in cases:
        dtx, cum, bm, cm = _ssd_inputs(gen, dev, c, dt)
        r = SS.route(c["Q"], c["N"], c["P"], dt)
        log = lt if r is SS.WGMMA else simt
        label = f"ssd tile {c} {dt} ({r.kernel})"
        y, st = _ssd_launch(label, {r.counter: 1},
                            lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm))
        yr, sr = ref.ssd_chunk_ref(dtx, cum, bm, cm)
        log.close(label + " y", y, yr, SSD_TILE_TOL)
        log.close(label + " state", st, sr, SSD_TILE_TOL)
        log.repeat(label, lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm))
        log.cases += 1
        del y, st, yr, sr
        if r is SS.WGMMA:      # and with dtx = dt xh formed on load
            xh, dts = dtx.to(dt), dtx[..., 0].abs() * 0.1
            dtx2 = dts[..., None] * xh.float()
            label += " dtx on load"
            run = lambda: SS.ssd_chunk_tiles_xdt(xh, dts, cum, bm, cm)
            y, st = _ssd_launch(label, {r.counter: 1}, run)
            yr, sr = ref.ssd_chunk_ref(dtx2, cum, bm, cm)
            log.close(label + " y", y, yr, SSD_TILE_TOL)
            log.close(label + " state", st, sr, SSD_TILE_TOL)
            log.repeat(label, run)
            log.cases += 1
            del xh, dts, dtx2, y, st, yr, sr
    check(all(SS.route(*(SSD_SLICE[k] for k in "QNP"), dt) is SS.WGMMA
              for dt in (torch.float32, torch.bfloat16)),
          "ssd tile: the slice does not take the tensor-core route")
    # timed at the slice shape with bf16 B and C, as the bf16 model gives them
    dtx, cum, bm, cm = _ssd_inputs(gen, dev, SSD_SLICE, torch.bfloat16)
    moved, f32_ops = ssd_work(SSD_SLICE, 2)
    b_ms, b_by = bound(moved, ssd_tensor_core_ops(SSD_SLICE, 2),
                       PEAK_BF16_FLOPS)
    lt.extra.update(
        kernel=SS.WGMMA.kernel,
        bound_f32_cuda_cores_ms=bound(moved, f32_ops)[0],
        tensor_core_ops=ssd_tensor_core_ops(SSD_SLICE, 2),
        float32_route=dict(kernel=SS.SIMT.kernel, cases=simt.cases,
                           max_abs_err=simt.max_abs, max_rel_err=simt.max_rel,
                           repeat_bitwise=simt.repeat_bitwise))
    xh, dts = dtx.bfloat16(), dtx[..., 0].abs() * 0.1
    lt.extra["dtx_on_load_ms"] = time_ms(
        lambda: SS.ssd_chunk_tiles_xdt(xh, dts, cum, bm, cm), reps=10)
    del xh, dts
    timings["ssd_chunk_tiles"] = dict(
        ms=time_ms(lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm), reps=10),
        plain_ms=time_ms(lambda: ref.ssd_chunk_ref(dtx, cum, bm, cm), reps=5,
                         warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del dtx, cum, bm, cm
    empty_cache(dev)


def _pass_inputs(gen, dev, c):
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    y_intra = _randn(gen, (B, nc, Q, H, P)).to(dev)
    states = _randn(gen, (B, nc, H, N, P)).to(dev)
    cum = (-_randn(gen, (B, nc, Q, H)).abs().cumsum(dim=2) * 0.1).to(dev)
    c32 = _randn(gen, (B, nc, Q, N)).to(dev)
    return y_intra, states, cum, c32


def ssd_pass_phase(dev, gen, logs, timings):
    """The inter-chunk pass alone on both routes: at the slice on the
    tensor cores, float32 C and output at ``SSD_CHUNKED_TOL`` (full and a
    padded length) and bf16 C and output within ``SSD_ULP_LIMIT`` bf16 ulps
    of the float32 reference; the reference's small case on the CUDA-core
    route; the CUDA-core kernel also at the slice in bf16 (asked for by
    route); a bitwise repeat of each, and both routes' times at the slice
    in bf16, the CUDA-core kernel's nested in the pass's record."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS

    lp, simt = logs["ssd_state_pass"], KernelLog()
    ulps = lp.extra["bf16_ulp_check"] = dict(max_ulps=0.0, cases=0,
                                             limit=SSD_ULP_LIMIT)
    f32, bf16 = torch.float32, torch.bfloat16
    # per shape: (dtype of C and y, rows cut from the last chunk, route forced)
    for c, runs in ((SSD_SLICE, ((f32, 0, None), (f32, 24, None),
                                 (bf16, 0, None), (bf16, 0, SS.STATE_PASS_SIMT))),
                    (SSD_TILE_CASE, ((f32, 5, None),))):
        y_intra, states, cum, c32 = _pass_inputs(gen, dev, c)
        B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
        for dt, cut, force in runs:
            length, cm = nc * Q - cut, c32.to(dt)
            r = force or SS.state_pass_route(Q, N, P, dt)
            log = lp if r == SS.STATE_PASS_WGMMA else simt
            label = f"ssd state pass {c} {dt} length {length} ({r.kernel})"
            run = lambda: SS.ssd_state_pass(y_intra, states, cum, cm, length,
                                            dt, route=force)
            y, h = _ssd_launch(label, {r.counter: 1}, run)
            yr, hr = ref.ssd_state_pass_ref(y_intra, states, cum, cm, length,
                                            f32)
            check(tuple(y.shape) == (B, length, H, P) and y.dtype == dt,
                  f"{label}: y {tuple(y.shape)} {y.dtype}")
            log.close(label + " state", h, hr, SSD_CHUNKED_TOL)
            if dt == f32:
                log.close(label + " y", y, yr, SSD_CHUNKED_TOL)
            else:
                u = bf16_ulps(y, yr)
                check(u <= SSD_ULP_LIMIT, f"{label}: {u:.3f} bf16 ulps from "
                      f"the float32 reference, limit {SSD_ULP_LIMIT}")
                if log is lp:
                    ulps["max_ulps"] = max(ulps["max_ulps"], u)
                    ulps["cases"] += 1
            log.repeat(label, run)
            log.cases += 1
            del y, h, yr, hr
        del y_intra, states, cum, c32
        empty_cache(dev)
    check(all(SS.state_pass_route(*(SSD_SLICE[k] for k in "QNP"), dt)
              == SS.STATE_PASS_WGMMA for dt in (f32, bf16)),
          "ssd state pass: the slice does not take the tensor-core route")
    # timed at the slice with bf16 C and output, as the bf16 model runs it
    c = SSD_SLICE
    y_intra, states, cum, c32 = _pass_inputs(gen, dev, c)
    cm, length = c32.bfloat16(), c["nc"] * c["Q"]
    timed = lambda route, cmat=cm, dt=bf16: time_ms(lambda: SS.ssd_state_pass(
        y_intra, states, cum, cmat, length, dt, route=route), reps=10)
    b_ms, b_by, tc_ops = ssd_state_pass_tc_bound(c, 2, 2)
    simt_ms, simt_by = bound(*ssd_state_pass_work(c, 2, 2))
    # float32 C and output (the float32 model's checks): both routes' times
    f32_ms = {r.kernel: timed(r, c32, f32)
              for r in (SS.STATE_PASS_WGMMA, SS.STATE_PASS_SIMT)}
    del c32
    lp.extra.update(
        kernel=SS.STATE_PASS_WGMMA.kernel, tensor_core_ops=tc_ops,
        bound_f32_cuda_cores_ms=simt_ms,
        float32_c_ms=f32_ms[SS.STATE_PASS_WGMMA.kernel],
        float32_c_bound_ms=ssd_state_pass_tc_bound(c, 4, 4)[0],
        cuda_core_route=dict(
            kernel=SS.STATE_PASS_SIMT.kernel, cases=simt.cases,
            max_abs_err=simt.max_abs, max_rel_err=simt.max_rel,
            repeat_bitwise=simt.repeat_bitwise,
            ms=timed(SS.STATE_PASS_SIMT), bound_ms=simt_ms,
            bound_by=simt_by,
            float32_c_ms=f32_ms[SS.STATE_PASS_SIMT.kernel]))
    timings["ssd_state_pass"] = dict(
        ms=timed(None),
        plain_ms=time_ms(lambda: ref.ssd_state_pass_ref(
            y_intra, states, cum, cm, length, bf16), reps=5, warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del y_intra, states, cum, cm
    empty_cache(dev)


def ssd_chunked_phase(dev, gen, logs):
    """The whole ``ssd_chunked`` (tile + state pass, two launches a call)
    against the plain chunked SSD: the reference's cases at
    ``SSD_CHUNKED_TOL``, and ``SSD_CHUNKED_WIDE`` in float32 (at that
    tolerance) and bf16 (within ``SSD_ULP_LIMIT`` of the plain path in
    float32 on the same bf16 values); the slice's times go into the tile's
    record."""
    import torch
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import ssm

    lt, lp = logs["ssd_chunk_tiles"], logs["ssd_state_pass"]
    cases = [(dict(B=2, L=L, H=4, P=16, N=8), chunk, torch.float32)
             for L, chunk in SSD_CHUNKED_CASES]
    cases += [(c, 128, dt) for c in SSD_CHUNKED_WIDE
              for dt in (torch.float32, torch.bfloat16)]
    ulps = 0.0
    for c, chunk, dt in cases:
        L, P, N = c["L"], c["P"], c["N"]
        xh, dt_, a, bm, cm = _chunked_inputs(gen, dev, c, dt)
        Q = min(chunk, L)
        tile = SS.route(Q, N, P, dt)
        sp = SS.state_pass_route(Q, N, P, dt)
        label = (f"ssd_chunked {c} chunk={chunk} {dt} ({tile.kernel}, "
                 f"{sp.kernel})")
        run = lambda: SS.ssd_chunked(xh, dt_, a, bm, cm, chunk=chunk)
        y1, h1 = _ssd_launch(label, {tile.counter: 1, sp.counter: 1}, run)
        y2, h2 = ssm.ssd_chunked(xh.float(), dt_, a, bm.float(), cm.float(),
                                 chunk=chunk)
        check(y1.dtype == dt, f"{label}: y dtype {y1.dtype}")
        lp.close(label + " state", h1, h2, SSD_CHUNKED_TOL)
        if dt == torch.float32:
            lp.close(label + " y", y1, y2, SSD_CHUNKED_TOL)
        else:
            u = bf16_ulps(y1, y2)
            check(u <= SSD_ULP_LIMIT, f"{label}: {u:.3f} bf16 ulps from the "
                  f"float32 plain path, limit {SSD_ULP_LIMIT}")
            ulps = max(ulps, u)
        lp.repeat(label, run)
        lp.cases += 1
        if c is SSD_CHUNKED_WIDE[-1] and dt == torch.bfloat16:
            lt.extra["ssd_chunked_slice"] = dict(
                dtype="bfloat16",
                ms=time_ms(run, reps=10),
                plain_ms=time_ms(lambda: ssm.ssd_chunked(
                    xh, dt_, a, bm, cm, chunk=chunk), reps=3, warmup=1))
        del xh, dt_, bm, cm, y1, h1, y2, h2
        empty_cache(dev)
    lt.extra["ssd_chunked_bf16_ulps"] = ulps


# ---------------------------------------------------------------------------
# Phase 4b: the reference kernels' whole contracts (routes no main path runs)
# ---------------------------------------------------------------------------

CONTRACT_F16_TOL = 3e-3     # float16 outputs, rtol = atol
# flash at head dims no config has, in each dtype: causal, windowed and
# Lk != Lq (full, every row sees a key), GQA 4 over 2
FLASH_CONTRACT_DIMS = (1, 8, 40, 80, 200, 256, 320)
FLASH_CONTRACT_MASKS = (dict(L=70, causal=True, window=0),
                        dict(L=70, causal=True, window=16),
                        dict(L=70, Lk=40, causal=False, window=0))
# published attention shapes on the routes no main path runs: yi-6b's in
# float16 (32 heads over 4, d 128), phi-2's d 80 (32 heads, bf16 and
# float32: on a 16-byte boundary the tensor cores' float32 kind, one
# element off flash_kernel), gemma-7b's d 256 (16 heads), and d 40 / 320 / 512 at 1 x 512
# with 4 heads over 2; the tensor cores take the 16-bit ones through TMA,
# and yi-6b's float16 and gemma-7b's shape also run off 16-byte boundaries
# on the loaded route, beside a d 100 bf16 slice (1 x 2048, 32 heads: no
# published config has d 100; a row stride TMA cannot take).  Past 256,
# d 512 bf16 also at 1 x 8192, 8 heads over 8 (no published config), which
# gives flash_wide_kernel enough blocks to fill the card.  (label, shape,
# dtype, element offset from a 16-byte boundary)
FLASH_CONTRACT_SLICES = (
    ("yi-6b float16", dict(FLASH_SLICE), "float16", 0),
    ("phi-2 d80", dict(B=1, L=2048, H=32, KVH=32, D=80, causal=True,
                       window=0), "bfloat16", 0),
    ("phi-2 d80 float32", dict(B=1, L=2048, H=32, KVH=32, D=80, causal=True,
                               window=0), "float32", 0),
    ("phi-2 d80 float32 unaligned", dict(B=1, L=2048, H=32, KVH=32, D=80,
                                         causal=True, window=0), "float32",
     1),
    ("gemma-7b d256", dict(B=1, L=8192, H=16, KVH=16, D=256, causal=True,
                           window=0), "bfloat16", 0),
    ("d40 windowed", dict(B=1, L=512, H=4, KVH=2, D=40, causal=True,
                          window=128), "float16", 0),
    ("d320", dict(B=1, L=512, H=4, KVH=2, D=320, causal=True, window=0),
     "float32", 0),
    ("d512", dict(B=1, L=512, H=4, KVH=2, D=512, causal=True, window=0),
     "bfloat16", 0),
    ("d512 1x8192", dict(B=1, L=8192, H=8, KVH=8, D=512, causal=True,
                         window=0), "bfloat16", 0),
    ("yi-6b float16 unaligned", dict(FLASH_SLICE), "float16", 1),
    ("gemma-7b d256 unaligned", dict(B=1, L=8192, H=16, KVH=16, D=256,
                                     causal=True, window=0), "bfloat16", 1),
    ("d100", dict(B=1, L=2048, H=32, KVH=32, D=100, causal=True, window=0),
     "bfloat16", 0))
# the slice each route's record is timed at
FLASH_CONTRACT_TIMED = {"flash_attention_wgmma_f16": "yi-6b float16",
                        "flash_attention_wgmma_padded": "gemma-7b d256",
                        "flash_attention_wgmma_loaded":
                            "yi-6b float16 unaligned",
                        "flash_attention_padded":
                            "phi-2 d80 float32 unaligned",
                        "flash_attention_wide": "d512"}
# 16-bit inputs TMA cannot read, on the loaded route: q, k and v 1, 3, 4 or
# 7 elements off a 16-byte boundary, alike and each its own, and head dims
# whose rows are not 16-byte multiples (1, 20, 100; on boundaries and
# off); float32 one element off a boundary at d 64 and 128, on
# flash_kernel.  (head dim, dtype, element offsets of q, k, v)
FLASH_CONTRACT_UNALIGNED = (
    (16, "float16", (1, 1, 1)), (64, "float16", (3, 3, 3)),
    (128, "float16", (4, 4, 4)), (72, "bfloat16", (7, 7, 7)),
    (200, "float16", (1, 1, 1)), (256, "bfloat16", (3, 0, 5)),
    (128, "bfloat16", (0, 7, 0)), (64, "bfloat16", (0, 0, 4)),
    (96, "float16", (1, 3, 0)), (1, "bfloat16", (0, 0, 0)),
    (1, "float16", (3, 3, 3)), (20, "bfloat16", (0, 0, 0)),
    (20, "float16", (7, 1, 4)), (100, "bfloat16", (0, 0, 0)),
    (100, "float16", (4, 4, 4)), (64, "float32", (1, 1, 1)),
    (128, "float32", (0, 1, 0)))
# q, k, v of mixed dtypes (each cast to float32; a float32 q as it is)
FLASH_CONTRACT_MIXED = (("bfloat16", "float32", "float32"),
                        ("float16", "float32", "float32"),
                        ("float32", "bfloat16", "bfloat16"))
# the SSD tile at widths past 128, ragged P and N, in each dtype of B/C,
# and a chunk of 520 (the generic tile's G in three windows of 256)
SSD_CONTRACT_TILES = ((256, 192, 6), (256, 128, 64), (96, 256, 130),
                      (32, 6, 3), (520, 40, 72))
# ssd_chunked on the generic routes: mamba2-370m's mixer widths (32 heads
# of P 64, N 128) at 1 x 8192 with mamba_ssm's default chunk 256 in bf16
# and with chunk 128 in float16, N 256, and P 6 / N 6 at 1 x 1000
SSD_CONTRACT_CHUNKED = (
    ("mamba2 chunk256 bf16", dict(B=1, L=8192, H=32, P=64, N=128), 256,
     "bfloat16"),
    ("mamba2 chunk128 float16", dict(B=1, L=8192, H=32, P=64, N=128), 128,
     "float16"),
    ("N256 float32", dict(B=1, L=1000, H=8, P=64, N=256), 128, "float32"),
    ("P6 N6 float32", dict(B=1, L=1000, H=8, P=6, N=6), 128, "float32"))
# the generic tile and pass timed at mamba2's chunk-256 shape, bf16 B/C
SSD_CONTRACT_SLICE = dict(B=1, nc=32, Q=256, H=32, P=64, N=128)
# shapes the fixed-shape CUDA-core kernels take, where both they and the
# generic ones run (equal bitwise) and are timed side by side: the
# reference's case, the port's kernel suite's (its ssd row takes
# ssd_chunk_kernel), mamba2's slice and jamba's (B/C dtype)
SSD_FIXED_VS_GENERIC = (
    ("reference case", SSD_TILE_CASE, "float32"),
    ("kernel suite", dict(B=2, nc=4, Q=128, H=4, P=64, N=32), "float32"),
    ("mamba2 slice", SSD_SLICE, "bfloat16"),
    ("jamba slice", JAMBA_SSD_SLICE, "bfloat16"))
# the gain kernels in float16 at Fig. 3's shapes and the kernel suite's
GAIN_CONTRACT_SHAPES = (SLICE_SHAPES[0], SLICE_SHAPES[1], FAMILY_SUITE)
MEGASTEP_MANY = (1, 16384, 4, 8)    # megastep past 4,096 agents (a chunk)


def _launched(mod, label, want, fn):
    """``fn()`` with ``mod``'s launch counts reset; check that exactly the
    launches ``want`` ({counter: count}) ran."""
    mod.reset_launches()
    out = fn()
    got = {k: v for k, v in mod.LAUNCHES.items() if v}
    check(got == want, f"{label}: launches {got}, expected {want}")
    return out


def _dtype(name):
    import torch
    return getattr(torch, name)


def _offset_copy(x, offset):
    """``x`` copied to a contiguous tensor ``offset`` elements past a
    16-byte boundary (offset 0: ``x`` itself, a fresh allocation's)."""
    if not offset:
        return x
    import torch
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    out = flat[offset:].view(x.shape)
    out.copy_(x)
    return out


def flash_contract_phase(dev, gen, logs, timings, f32):
    """The flash routes no main path runs (``flash_wgmma_kernel`` on float16,
    on bf16 at other head dims, loaded by its own producer on 16-bit inputs
    TMA cannot read, and in its float32 kind; ``flash_kernel`` at a padded
    width in float32; ``flash_wide_kernel`` past 256) at
    ``FLASH_CONTRACT_DIMS`` x dtypes x
    masks, 16-bit inputs off 16-byte boundaries or at head dims that are
    not multiples of 8 (``FLASH_CONTRACT_UNALIGNED``) and q, k, v of mixed
    dtypes, then ``FLASH_CONTRACT_SLICES``: each against its plain version
    (float32 3e-4, bf16 3e-2, float16 ``CONTRACT_F16_TOL``; 16-bit outputs
    of the tensor cores within ``FLASH_ULP_LIMIT`` ulps of the float32
    reference), repeated bitwise, its route's one launch checked, and
    timed beside the plain version and ``scaled_dot_product_attention``
    (median of 5).  Off a boundary at a head dim that is a multiple of 8,
    the loaded route's output must equal TMA's on the same values bit for
    bit (``bitwise_vs_tma``).  Float32 outputs of the float32 kind are held
    against flash_kernel forced on the same inputs in float64
    (``f32_vs_flash_kernel``), and its slices timed beside it; its cases,
    flash_kernel's on float32 off a boundary and the mixed dtypes' go into
    the lm phase's log of the kind, ``f32``, and the logs nested in it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    tol = dict(FLASH_TOL, float16=CONTRACT_F16_TOL)
    names = {FA.WGMMA_F16: "flash_attention_wgmma_f16",
             FA.WGMMA_PADDED: "flash_attention_wgmma_padded",
             FA.WGMMA_LOADED: "flash_attention_wgmma_loaded",
             FA.WGMMA_F32: "flash_attention_wgmma_f32",
             FA.PADDED: "flash_attention_padded",
             FA.WIDE: "flash_attention_wide"}
    flogs = {n: KernelLog() for n in names.values()}
    flogs["flash_attention_wgmma_f32"] = f32
    # flash_kernel at its own widths (float32 off a 16-byte boundary) is the
    # float32 kind's nested CUDA-core route
    route_log = {r: flogs[n] for r, n in names.items()}
    route_log[FA.SIMT] = f32.nested["cuda_core_route"]
    # float16 outputs on every route that takes float16, bf16 ones on the
    # tensor cores' routes
    ulp_checks = {"flash_attention_wgmma_f16": ("f16",),
                  "flash_attention_wgmma_padded": ("bf16",),
                  "flash_attention_wgmma_loaded": ("f16", "bf16"),
                  "flash_attention_wide": ("f16",)}
    for name, kinds in ulp_checks.items():
        for kind in kinds:
            flogs[name].extra[kind + "_ulp_check"] = dict(
                max_ulps=0.0, cases=0, limit=FLASH_ULP_LIMIT)
    loaded = flogs["flash_attention_wgmma_loaded"]
    loaded.extra["bitwise_vs_tma"] = dict(cases=0, equal=True)
    mixed = f32.nested["mixed_dtypes"] = KernelLog()
    mixed.extra["note"] = ("q, k, v of mixed dtypes cast to float32 (fresh, "
                           "on 16-byte boundaries; a float32 input as it "
                           "is): the float32 route of the head dim")

    def run(label, c, dts, log, offsets=(0, 0, 0)):
        q, k, v = _flash_inputs(gen, dev, c, torch.float32)
        q, k, v = (_offset_copy(x.to(_dtype(d)), o)
                   for x, d, o in zip((q, k, v), dts, offsets))
        kw = dict(causal=c["causal"], window=c["window"])
        r = FA.cuda_route(q, k, v)
        label = f"{label} {dts} ({r.kernel}, {r.counter})"
        fn = lambda: FA.flash_attention(q, k, v, **kw)
        got = _launched(FA, label, {r.counter: 1}, fn)
        check(got.dtype == q.dtype, f"{label}: output dtype {got.dtype}")
        _flash_check(log, label, got, q, k, v, kw, tol[dts[0]])
        log.repeat(label, fn)
        log.cases += 1
        if r is FA.WGMMA_F32 and got.dtype == torch.float32:
            f32_vs_flash_kernel(f32, label, got, q, k, v, kw)
        if r is FA.WGMMA_LOADED and c["D"] % FA.WGMMA_DIM_STEP == 0:
            aligned = [x.clone() for x in (q, k, v)]
            check(FA.cuda_route(*aligned) in FA.TENSOR_CORE_ROUTES[:3],
                  f"{label}: the aligned copy does not take TMA's route")
            same = torch.equal(got, FA.flash_attention(*aligned, **kw))
            check(same, f"{label}: differs from TMA's route on the same "
                        "values on 16-byte boundaries")
            loaded.extra["bitwise_vs_tma"]["cases"] += 1
        return r, (q, k, v, kw)

    grid = [(D, d, (0, 0, 0)) for D in FLASH_CONTRACT_DIMS
            for d in ("float32", "bfloat16", "float16")]
    grid += [(D, "float16", (0, 0, 0)) for D in FA.HEAD_DIMS]
    grid += list(FLASH_CONTRACT_UNALIGNED)
    for D, d, offsets in grid:
        for m in FLASH_CONTRACT_MASKS:
            c = dict(B=1, H=4, KVH=2, D=D, **m)
            r = FA.route(_dtype(d), D, aligned=not any(offsets))
            run(f"flash contract {c} offsets {offsets}", c, (d,) * 3,
                route_log[r], offsets)
    for D in (40, 128):
        c = dict(B=1, H=4, KVH=2, D=D, **FLASH_CONTRACT_MASKS[1])
        for dts in FLASH_CONTRACT_MIXED:
            run(f"flash mixed {c}", c, dts, mixed)
    slices = {}
    for label, c, d, offset in FLASH_CONTRACT_SLICES:
        r = FA.route(_dtype(d), c["D"], aligned=not offset)
        check(r in names, f"{label}: route {r} is not a contract route")
        _, (q, k, v, kw) = run(f"flash slice {label}", c, (d,) * 3,
                               route_log[r], (offset,) * 3)
        itemsize = q.element_size()
        peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
        b_ms, b_by = bound(*flash_work(c, itemsize), peak)
        # SDPA on copies on 16-byte boundaries: its float32 kernel faults
        # (misaligned address) on inputs 4 bytes off one
        qa, ka, va = ((x.clone() for x in (q, k, v)) if offset
                      else (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
            is_causal=kw["causal"], enable_gqa=True)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                           reps=5, warmup=1)
        if r is FA.WGMMA_F32:
            t = dict(f32_timing(c, q, k, v, kw), plain_ms=plain_ms)
        else:
            t = dict(ms=time_ms(lambda: FA.flash_attention(q, k, v, **kw),
                                reps=5, warmup=1),
                     plain_ms=plain_ms,
                     library_ms=(time_ms(sdpa, reps=5, warmup=1)
                                 if not kw["window"] else None),
                     bound_ms=b_ms, bound_by=b_by)
        slices[label] = dict(t, shape=c, dtype=d, offset=offset,
                             kernel=r.kernel, route=r.counter,
                             library_inputs="aligned copies" if offset
                             else "the same tensors")
        for name, want in FLASH_CONTRACT_TIMED.items():
            if want == label:
                timings[name] = {k: t[k] for k in ("ms", "plain_ms",
                                                   "library_ms", "bound_ms",
                                                   "bound_by")}
        del q, k, v, qa, ka, va
        empty_cache(dev)
    for r, name in names.items():
        logs[name] = flogs[name]
        flogs[name].extra.update(
            kernel=r.kernel,
            slices={k: s for k, s in slices.items() if s["route"] == r.counter})


def ssd_contract_phase(dev, gen, logs, timings):
    """The SSD routes no main path runs: the generic tile at
    ``SSD_CONTRACT_TILES`` in float32, bf16 and float16 B/C (and B, C of
    mixed dtypes) at ``SSD_TILE_TOL``; the generic tile and pass forced at
    ``SSD_FIXED_VS_GENERIC``, bitwise equal to ``ssd_chunk_kernel`` and
    ``ssd_state_pass_kernel`` and timed beside them; ``ssd_chunked`` at
    ``SSD_CONTRACT_CHUNKED`` against the plain chunked SSD (float32
    ``SSD_CHUNKED_TOL``, bf16 within ``SSD_ULP_LIMIT`` of float32, float16
    ``CONTRACT_F16_TOL``), the generic pass on inputs off 16-byte
    boundaries; the generic tile and pass timed at ``SSD_CONTRACT_SLICE``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.models import ssm

    lt = logs["ssd_chunk_tiles_generic"] = KernelLog()
    lp = logs["ssd_state_pass_generic"] = KernelLog()
    other = KernelLog()       # cases on the fixed-shape CUDA-core route

    for Q, N, P in SSD_CONTRACT_TILES:
        c = dict(B=1, nc=2, Q=Q, H=3, P=P, N=N)
        for dts in (("float32",) * 2, ("bfloat16",) * 2, ("float16",) * 2,
                    ("bfloat16", "float32")):
            dtx, cum, bm, cm = _ssd_inputs(gen, dev, c, torch.float32)
            bm, cm = bm.to(_dtype(dts[0])), cm.to(_dtype(dts[1]))
            r = SS.cuda_route(dtx, cum, bm, cm)
            log = lt if r == SS.GENERIC else other
            label = f"ssd contract tile {c} {dts} ({r.kernel})"
            fn = lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm)
            y, st = _launched(SS, label, {r.counter: 1}, fn)
            yr, sr = ref.ssd_chunk_ref(dtx, cum, bm, cm)
            log.close(label + " y", y, yr, SSD_TILE_TOL)
            log.close(label + " state", st, sr, SSD_TILE_TOL)
            log.repeat(label, fn)
            log.cases += 1
    # where the fixed-shape CUDA-core kernels run, the generic ones give
    # their bits; both timed
    both = lt.extra["fixed_vs_generic"] = {}
    for label, c, d in SSD_FIXED_VS_GENERIC:
        dt = _dtype(d)
        dtx, cum, bm, cm = _ssd_inputs(gen, dev, c, dt)
        length = c["nc"] * c["Q"] - 5
        row = both[label] = dict(shape=dict(c), dtype=d)
        outs = {}
        for r in (SS.SIMT, SS.GENERIC):
            fn = lambda r=r: SS.ssd_chunk_tiles(dtx, cum, bm, cm, force=r)
            outs[r] = _launched(SS, f"ssd {label} tile {r.kernel}",
                                {r.counter: 1}, fn)
            row[r.kernel + "_ms"] = time_ms(fn, reps=10)
        check(all(torch.equal(x, y) for x, y in zip(*outs.values())),
              f"ssd {label}: the generic tile differs from ssd_chunk_kernel")
        y_intra, states = outs[SS.SIMT]
        del outs
        passes = {}
        for r in (SS.STATE_PASS_SIMT, SS.STATE_PASS_GENERIC):
            fn = lambda r=r: SS.ssd_state_pass(y_intra, states, cum, cm,
                                               length, dt, route=r)
            passes[r] = _launched(SS, f"ssd {label} pass {r.kernel}",
                                  {r.counter: 1}, fn)
            row[r.kernel + "_ms"] = time_ms(fn, reps=10)
        check(all(torch.equal(x, y) for x, y in zip(*passes.values())),
              f"ssd {label}: the generic pass differs from "
              "ssd_state_pass_kernel")
        row["bitwise_equal"] = True
        del dtx, cum, bm, cm, y_intra, states, passes
        empty_cache(dev)

    chunked = {}
    for label, c, chunk, d in SSD_CONTRACT_CHUNKED:
        dt = _dtype(d)
        xh, dt_, a, bm, cm = _chunked_inputs(gen, dev, c, dt)
        Q = min(chunk, c["L"])
        tile = SS.route(Q, c["N"], c["P"], dt)
        sp = SS.state_pass_route(Q, c["N"], c["P"], dt, dt)
        check(SS.GENERIC in (tile,) or sp == SS.STATE_PASS_GENERIC,
              f"{label}: takes no generic route ({tile}, {sp})")
        label = f"ssd contract chunked {label} ({tile.kernel}, {sp.kernel})"
        run = lambda: SS.ssd_chunked(xh, dt_, a, bm, cm, chunk=chunk)
        y1, h1 = _launched(SS, label, {tile.counter: 1, sp.counter: 1}, run)
        y2, h2 = ssm.ssd_chunked(xh.float(), dt_, a, bm.float(), cm.float(),
                                 chunk=chunk)
        check(y1.dtype == dt, f"{label}: y dtype {y1.dtype}")
        lp.close(label + " state", h1, h2, SSD_CHUNKED_TOL)
        if d == "bfloat16":
            u = bf16_ulps(y1, y2)
            check(u <= SSD_ULP_LIMIT, f"{label}: {u:.3f} bf16 ulps from the "
                  f"float32 plain path, limit {SSD_ULP_LIMIT}")
            lp.extra["bf16_ulps"] = max(lp.extra.get("bf16_ulps", 0.0), u)
        else:
            lp.close(label + " y", y1, y2, SSD_CHUNKED_TOL if d == "float32"
                     else CONTRACT_F16_TOL)
        lp.repeat(label, run)
        lp.cases += 1
        if c["L"] >= 8192:
            chunked[label] = dict(
                chunk=chunk, dtype=d, ms=time_ms(run, reps=5, warmup=1),
                plain_ms=time_ms(lambda: ssm.ssd_chunked(
                    xh, dt_, a, bm, cm, chunk=chunk), reps=5, warmup=1))
        del xh, dt_, bm, cm, y1, h1, y2, h2
        empty_cache(dev)
    lt.extra["ssd_chunked"] = chunked

    # the generic pass on inputs 4 bytes past a 16-byte boundary
    c = SSD_TILE_CASE
    y_intra, states, cum, cmat = _pass_inputs(gen, dev, c)
    L = c["nc"] * c["Q"] - 5
    flat = torch.empty(cmat.numel() + 1, device=dev)
    odd = flat[1:].view(cmat.shape)
    odd.copy_(cmat)
    check(SS.state_pass_route(c["Q"], c["N"], c["P"], odd.dtype,
                              aligned=False) == SS.STATE_PASS_GENERIC,
          "ssd pass: unaligned C does not take the generic route")
    got = _launched(SS, "ssd pass unaligned", {SS.STATE_PASS_GENERIC.counter:
                                              1},
                    lambda: SS.ssd_state_pass(y_intra, states, cum, odd, L,
                                              torch.float16))
    want = ref.ssd_state_pass_ref(y_intra, states, cum, cmat, L,
                                  torch.float16)
    lp.close("ssd pass unaligned float16 y", got[0], want[0],
             CONTRACT_F16_TOL)
    lp.close("ssd pass unaligned state", got[1], want[1], SSD_CHUNKED_TOL)
    lp.cases += 1
    del y_intra, states, cum, cmat, flat, odd
    lt.extra["ssd_chunk_kernel_cases"] = dict(
        cases=other.cases, max_abs_err=other.max_abs,
        max_rel_err=other.max_rel, repeat_bitwise=other.repeat_bitwise,
        note="float32 and mixed B/C at (32, 6, 3): ssd_chunk_kernel")

    # timed at mamba2's chunk-256 shape with bf16 B/C (and a bf16 output)
    s = SSD_CONTRACT_SLICE
    dtx, cum, bm, cm = _ssd_inputs(gen, dev, s, torch.bfloat16)
    check(SS.cuda_route(dtx, cum, bm, cm) == SS.GENERIC,
          "ssd contract slice: not the generic tile")
    moved, ops = ssd_work(s, 2)
    b_ms, b_by = bound(moved, ops)
    timings["ssd_chunk_tiles_generic"] = dict(
        ms=time_ms(lambda: SS.ssd_chunk_tiles(dtx, cum, bm, cm), reps=5,
                   warmup=1),
        plain_ms=time_ms(lambda: ref.ssd_chunk_ref(dtx, cum, bm, cm), reps=5,
                         warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    y_intra, states = SS.ssd_chunk_tiles(dtx, cum, bm, cm)
    length = s["nc"] * s["Q"]
    route = SS.check_state_pass(y_intra, states, cum, cm, length,
                                torch.bfloat16)
    check(route == SS.STATE_PASS_GENERIC,
          f"ssd contract slice: the pass takes {route.kernel}")
    moved, ops = ssd_state_pass_work(s, 2, 2)
    b_ms, b_by = bound(moved, ops)
    timings["ssd_state_pass_generic"] = dict(
        ms=time_ms(lambda: SS.ssd_state_pass(y_intra, states, cum, cm, length,
                                             torch.bfloat16), reps=5,
                   warmup=1),
        plain_ms=time_ms(lambda: ref.ssd_state_pass_ref(
            y_intra, states, cum, cm, length, torch.bfloat16), reps=5,
            warmup=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    lt.extra.update(kernel=SS.GENERIC.kernel, timed_at=s, bc_dtype="bfloat16")
    lp.extra.update(kernel=SS.STATE_PASS_GENERIC.kernel, timed_at=s,
                    c_dtype="bfloat16", y_dtype="bfloat16")
    del dtx, cum, bm, cm, y_intra, states
    empty_cache(dev)


def gain_contract_phase(dev, logs, timings):
    """The gain kernels in float16 (their ``_f16`` counters) at
    ``GAIN_CONTRACT_SHAPES``, phi and g of mixed dtypes (the float32
    kernels, after an exact cast), and megastep past one chunk of
    gate_update_kernel's agents (``MEGASTEP_MANY``): against their plain
    versions at WEIGHT_TOL (gains of their terms' scale, decisions exact
    but for reported ties), repeated bitwise; float16 runs launched alone
    equal to their batch slices; each timed at the kernel suite's shape
    beside its plain version (and torch.matmul for the matvec)."""
    import torch
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(5)
    lv = logs["gain_matvec_f16"] = KernelLog()
    pair = {"gain_family_stats": KernelLog(), "megastep": KernelLog()}
    logs["gain_family_stats_f16"] = pair["gain_family_stats"]
    logs["megastep_f16"] = pair["megastep"]
    mixed = {"gain_family_stats": KernelLog(), "megastep": KernelLog()}
    mv_mixed = KernelLog()
    suite = None
    for label, shape, onehot in GAIN_CONTRACT_SHAPES:
        inp = family_inputs(dev, gen, shape, onehot)
        for dts, logs2, lvx in (((torch.float16,) * 2, pair, lv),
                                ((torch.bfloat16, torch.float32), mixed,
                                 mv_mixed),
                                ((torch.float16, torch.float32), mixed,
                                 mv_mixed)):
            x = dict(inp, phi=inp["phi"].to(dts[0]), g=inp["g"].to(dts[1]))
            x["stats"] = ref.gain_family_stats_ref(x["phi"], x["g"], x["gj"],
                                                   x["pm"])
            name = f"{label} {dts}"
            r = K.route("gain_family_stats", *dts)
            _launched(K, f"family {name}", {r.counter: 1},
                      lambda: K.gain_family_stats(x["phi"], x["g"], x["gj"],
                                                  x["pm"]))
            family_check(logs2, name, x)
            r = K.route("gain_matvec", *dts)
            fn = lambda: K.gain_matvec(x["phi"], x["g"])
            got = _launched(K, f"matvec {name}", {r.counter: 1}, fn)
            lvx.close(f"gain_matvec {name}", got,
                      ref.gain_matvec_ref(x["phi"], x["g"]), WEIGHT_TOL)
            lvx.close(f"practical_gain {name}",
                      K.practical_gain(x["phi"], x["g"], 0.5),
                      ref.practical_gain_ref(x["phi"], x["g"], 0.5),
                      WEIGHT_TOL,
                      gain_scale(x["stats"][..., :2], 0.5, shape[2]))
            lvx.repeat(f"gain_matvec {name}", fn)
            lvx.cases += 1
            if dts == (torch.float16,) * 2:
                pair["gain_family_stats"].extra.setdefault(
                    "runs_alone_bitwise", []).append(
                        [label, family_alone_check(pair, name, x),
                         family_alone_check(pair, name + " block_m 1", x,
                                            block_m=1)])
                if label == FAMILY_SUITE[0]:
                    suite = x
    # timed at the kernel suite's shape in float16
    phi, g = suite["phi"], suite["g"]
    R, m, T, n = phi.shape
    mv_bound = bound(nbytes(phi, g) + R * m * T * 4, 2 * R * m * T * n)
    timings["gain_matvec_f16"] = dict(
        ms=time_ms(lambda: K.gain_matvec(phi, g), reps=5, warmup=1),
        plain_ms=time_ms(lambda: ref.gain_matvec_ref(phi, g), reps=5,
                         warmup=1),
        library_ms=time_ms(lambda: torch.matmul(phi, g.unsqueeze(-1)),
                           reps=5, warmup=1),
        bound_ms=mv_bound[0], bound_by=mv_bound[1])
    t = family_timing(K, ref, suite)
    for name in ("gain_family_stats", "megastep"):
        timings[name + "_f16"] = dict(t[name], library_ms=None)
        logs[name + "_f16"].extra["timing"] = t[name]
    for name, log in (("gain_matvec_f16", mv_mixed),
                      ("gain_family_stats_f16", mixed["gain_family_stats"]),
                      ("megastep_f16", mixed["megastep"])):
        logs[name].extra.update(
            timed_at=list(phi.shape), dtype="float16",
            mixed_dtypes=dict(cases=log.cases, max_abs_err=log.max_abs,
                              max_rel_err=log.max_rel,
                              repeat_bitwise=log.repeat_bitwise,
                              tie_flips=log.tie_flips,
                              note="phi and g of mixed dtypes cast to "
                                   "float32: the float32 kernels"))
    del suite, phi, g
    # megastep past one chunk of agents, float32
    many = KernelLog()
    inp = family_inputs(dev, gen, MEGASTEP_MANY, False)
    _launched(K, "megastep many agents", {"megastep": 2},
              lambda: K.megastep_call(inp["phi"], inp["g"], inp["w"],
                                      inp["ctl"], inp["arand"], inp["gj"],
                                      inp["pm"], eps=0.5))
    family_check({"gain_family_stats": KernelLog(), "megastep": many},
                 f"megastep m={MEGASTEP_MANY[1]}", inp)
    mega = lambda: K.megastep_call(inp["phi"], inp["g"], inp["w"], inp["ctl"],
                                   inp["arand"], inp["gj"], inp["pm"],
                                   eps=0.5)
    logs["megastep_f16"].extra["many_agents"] = dict(
        shape=list(MEGASTEP_MANY), dtype="float32", cases=many.cases,
        max_abs_err=many.max_abs, max_rel_err=many.max_rel,
        tie_flips=many.tie_flips, repeat_bitwise=many.repeat_bitwise,
        ms=time_ms(mega, reps=5, warmup=1),
        plain_ms=time_ms(lambda: ref.megastep_ref(
            inp["phi"], inp["g"], inp["w"], inp["ctl"], inp["arand"],
            inp["gj"], inp["pm"], eps=0.5), reps=5, warmup=1))


def contract_phase(dev, f32):
    """Every route that takes what only the reference's contracts ask for
    (``flash_contract_phase``, ``ssd_contract_phase``,
    ``gain_contract_phase``): one record each, 0 launches on every main
    path; the float32 flash kind's cases join the lm phase's log of it,
    ``f32``.  Returns (logs, timings)."""
    import torch
    gen = torch.Generator().manual_seed(7)
    logs, timings = {}, {}
    flash_contract_phase(dev, gen, logs, timings, f32)
    ssd_contract_phase(dev, gen, logs, timings)
    gain_contract_phase(dev, logs, timings)
    return logs, timings


# ---------------------------------------------------------------------------
# Phase 5: the LM substrate's serving path at full width
# ---------------------------------------------------------------------------


class ServeCell(NamedTuple):
    """One serving configuration (PERF.md "Cells")."""

    name: str
    arch: str
    kernels: tuple         # the kernel records this cell's prefill runs
    counters: tuple        # their launch counters, in the same order
    per_prefill: tuple     # each counter's launches in one prefill call
    prefill_batch: int     # cut from prefill_32k's 32 (configs/base.py)
    prefill_len: int       # cut from prefill_32k's 32768
    serve_batch: int
    prompt_len: int
    gen_len: int
    layers: Optional[int] = None   # depth cut; None keeps the published depth
    check_len: Optional[int] = None   # float32 check's tokens; None: CHECK_LEN


SERVE_CELLS = (
    # per layer one tensor-core tile and one tensor-core state pass, never
    # a CUDA-core route (the sum of all counts is held to these two)
    ServeCell("serve-mamba2-370m", "mamba2-370m",
              ("ssd_chunk_tiles", "ssd_state_pass"),
              ("ssd_chunk_tiles_wgmma", "ssd_state_pass_wgmma"), (48, 48),
              4, 8192, 4, 64, 32),
    # bf16 prefill at head dim 128: the tensor-core route, never flash_kernel
    ServeCell("serve-yi-6b", "yi-6b", ("flash_attention",),
              ("flash_attention_wgmma",), (32,), 1, 8192, 4, 64, 32),
    # MoE at full width: 64 experts, top 8, d 128 attention in every layer
    ServeCell("serve-olmoe-1b-7b", "olmoe-1b-7b", ("flash_attention",),
              ("flash_attention_wgmma",), (16,), 4, 8192, 4, 64, 32),
    # head dim 96 on the tensor-core route
    ServeCell("serve-phi3-mini-3.8b", "phi3-mini-3.8b", ("flash_attention_d96",),
              ("flash_attention_wgmma",), (32,), 1, 8192, 4, 64, 32),
    # one super-block of the hybrid (the whole model needs ~104 GB in bf16):
    # one attention layer, seven mamba2 layers at N 16 (the narrow
    # tensor-core tile, the tensor-core pass; never a CUDA-core route), four
    # MoE MLPs of 16 experts and four dense ones
    ServeCell("serve-jamba-v0.1-52b-8l", "jamba-v0.1-52b",
              ("flash_attention", "ssd_chunk_tiles_n16", "ssd_state_pass_n16"),
              ("flash_attention_wgmma", "ssd_chunk_tiles_wgmma_n16",
               "ssd_state_pass_wgmma"), (1, 7, 7), 1, 8192, 4, 64, 32,
              layers=8),
    # a decoder behind 256 vision patches: 8192 positions = 256 patches +
    # 7936 tokens (input_specs.py:22-30), causal d 128, GQA 16/8; the
    # float32 check at 512 tokens behind the patches
    ServeCell("serve-internvl2-2b", "internvl2-2b", ("flash_attention",),
              ("flash_attention_wgmma",), (24,), 4, 8192, 4, 64, 32,
              check_len=512),
    # the encoder-decoder over its 1024 audio frames, 8192 decoder tokens:
    # a prefill launches the tensor-core route 36 times at d 64, 12
    # encoder (bidirectional, 1024 x 1024) and 12 decoder (causal, 8192)
    # self-attentions and 12 cross-attentions (Lq 8192 over Lk 1024); the
    # float32 check at 576 tokens over the frames: past 512, where the
    # plain decoder's self-attention takes chunked_attention (float32
    # scores, as the kernel's) and not reference_attention (scores rounded
    # to bf16 in the bf16 model), so that the bf16 check compares paths
    # that round at the same places
    ServeCell("serve-seamless-m4t-medium", "seamless-m4t-medium",
              ("flash_attention_d64", "flash_attention_cross"),
              ("flash_attention_wgmma", "flash_attention_wgmma"), (24, 12),
              4, 8192, 4, 64, 32, check_len=576),
)
# the CUDA-core routes of the serving kernels, which no serving cell's
# prefill launches
CUDA_CORE_KERNELS = ("flash_kernel", "ssd_chunk_kernel", "ssd_state_pass_kernel")
# cuBLAS's and CUTLASS's matrix-product kernels (nvjet: cuBLAS on Hopper)
MATMUL_KERNEL_WORDS = ("gemm", "nvjet", "xmma", "cutlass", "matmul")
# indexing, scatter and gather kernels: the MoE's dispatch and combine (and
# the embedding lookup), a part of the rest
INDEX_KERNEL_WORDS = ("index", "gather", "scatter", "scan", "sort")
PREFILL_CALLS = 3          # one warm-up, two timed
CHECK_LEN = 1024           # float32 full-width correctness prompt
CHECK_BATCH = 2
KERNEL_VS_PLAIN_TOL = 1e-4     # of the logits' max |value|, float32
DECODE_TOL = 2e-3              # rtol = atol, tests/test_models_smoke.py:67-103
# tests/test_models_smoke.py:73-77: decode equals prefill only where
# prefill drops nothing, so decode-vs-prefill runs MoE configs at this
# capacity factor (every other check keeps the published one)
DECODE_CAPACITY_FACTOR = 8.0
# A token whose k-th and (k+1)-th router probabilities lie this close
# (relative to the k-th) is a tie: float noise between two computations of
# the same model may swap its experts.  A flip of the expert set at a wider
# margin in the plain path is a fault.
ROUTING_TIE_MARGIN = 1e-5
REDUCED_LEN = 256          # reduced-archs prompt: beyond the reduced window 64
REDUCED_BATCH = 2


def _lm_kernels():
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ssd_scan as SS
    return K, FA, SS


def reset_all_launches():
    for mod in _lm_kernels():
        mod.reset_launches()


def all_launches():
    return {k: v for mod in _lm_kernels() for k, v in mod.LAUNCHES.items()}


class Routing:
    """Record the MoE routing of one forward and replay it in another.

    ``route`` picks each MoE layer's experts through the module-level
    ``repro_torch.models.moe.top_k_ids``, once a layer, in layer order.
    ``record()`` wraps it so that each call keeps its expert choices and
    the relative margin between its k-th and (k+1)-th probabilities;
    ``replay()`` makes the same calls of a second forward return the
    recorded experts (the gates are that forward's own probabilities at
    them) and counts, afresh for each replay, the tokens whose own top-k
    set differs from the recorded one, with the recorded margin.  A
    comparison under replay then measures what the kernels (or the dtype)
    change, and the flips (free routing) are reported beside it, layer by
    layer, without the cascade a flip would start in later layers."""

    def __init__(self):
        self.ids, self.margins = [], []
        self.flips = []                 # (call, margin) of each flipped token

    def _swap(self, fn):
        import contextlib
        from repro_torch.models import moe

        @contextlib.contextmanager
        def ctx():
            orig = moe.top_k_ids
            moe.top_k_ids = lambda probs, k: fn(orig, probs, k)
            try:
                yield self
            finally:
                moe.top_k_ids = orig
        return ctx()

    def record(self):
        import torch

        def fn(orig, probs, k):
            ids = orig(probs, k)
            self.ids.append(ids)
            if k < probs.shape[-1]:
                top = torch.topk(probs, k + 1, dim=-1).values
                self.margins.append((top[..., k - 1] - top[..., k])
                                    / top[..., k - 1])
            else:
                self.margins.append(torch.ones_like(probs[..., 0]))
            return ids
        return self._swap(fn)

    def replay(self):
        calls = iter(range(len(self.ids)))
        self.flips = []

        def fn(orig, probs, k):
            i = next(calls)
            want = self.ids[i]
            own = orig(probs, k)
            differ = (own.sort(-1).values != want.sort(-1).values).any(-1)
            for m in self.margins[i][differ].tolist():
                self.flips.append((i, m))
            return want
        return self._swap(fn)

    def report(self, label):
        """The flips' count and margins; fails on one wider than a tie."""
        margins = [m for _, m in self.flips]
        out = dict(moe_calls=len(self.ids), flips=len(margins),
                   flip_margins=sorted(margins, reverse=True)[:16],
                   flip_layers=sorted({i for i, _ in self.flips}),
                   tie_margin=ROUTING_TIE_MARGIN)
        check(all(m <= ROUTING_TIE_MARGIN for m in margins),
              f"{label}: routing flips at margins {out['flip_margins']}, "
              f"over the tie margin {ROUTING_TIE_MARGIN}")
        return out


def _all_logits(model, tokens, use_kernels, prefix=None):
    """(B, L, V) float32 logits of every position (a vision prefix's
    positions included; an encoder-decoder's decoder positions over the
    frames ``prefix``), through the kernels or through the plain
    versions."""
    import torch
    model.use_kernels = use_kernels
    try:
        with torch.inference_mode():
            hidden, _ = model.hidden_states(tokens, prefix)
            return (hidden @ model.head()).float()
    finally:
        model.use_kernels = True


def _prefix_emb(cfg, batch, gen, dev):
    """A frontend arch's (batch, num_prefix, frontend_dim) float32 patch or
    frame embeddings, 0.02 normal (launch/train.py's scale) from ``gen``;
    None for the other archs."""
    import torch
    if cfg.frontend == "none":
        return None
    return 0.02 * torch.randn((batch, cfg.num_prefix, cfg.frontend_dim),
                              generator=gen, device=dev)


def _text_len(cfg, positions):
    """Tokens of a prompt of ``positions`` positions: a vision arch's
    patches take the first num_prefix of them (input_specs.py:22-30)."""
    return positions - cfg.num_prefix if cfg.frontend == "vision" else positions


def flash_record(q, k):
    """The ``kernels`` record a flash call's shape belongs to."""
    if k.shape[1] != q.shape[1]:
        return "flash_attention_cross"
    d = q.shape[-1]
    return "flash_attention" if d == 128 else f"flash_attention_d{d}"


class FlashCensus:
    """Count the flash-attention kernel's launches by record
    (``flash_record``: head dim, Lk != Lq) while active: the wrapper's
    counters tell the routes apart, not the shapes.  It wraps
    ``repro_torch.kernels.flash_attention.flash_attention``, which the
    models look up at call time, and counts calls on CUDA tensors, each
    one launch."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from repro_torch.kernels import flash_attention as FA
        self._orig = orig = FA.flash_attention

        def counted(q, k, v, **kw):
            if q.is_cuda and q.numel():
                name = flash_record(q, k)
                self.calls[name] = self.calls.get(name, 0) + 1
            return orig(q, k, v, **kw)
        FA.flash_attention = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as FA
        FA.flash_attention = self._orig


def _serve_cfg(cell, **changes):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(cell.arch)
    if cell.layers is not None:
        changes["num_layers"] = cell.layers
    return dataclasses.replace(cfg, **changes)


def model_checks(dev, name, cfg, tokens, keep_plain=False, prefix=None):
    """Float32 checks of one model: kernel vs plain prefill at the last
    position (the kernel path replaying the plain path's MoE routing) with
    the free routing's flips reported, and decode vs prefill at t = 3 and
    L - 1 (MoE at ``DECODE_CAPACITY_FACTOR``).  A frontend arch's
    ``prefix`` goes into both prefills; decode takes none, so an
    encoder-decoder decodes over ``encode(prefix)`` and is held to
    prefills over the same frames, a vision decoder to prefills without
    its patches (tests/test_models_smoke.py:87-98).  Returns the line's
    fields, the plain logits of every position (with ``keep_plain``, else
    None) and the plain path's recorded routing."""
    import dataclasses
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import build_model

    model = build_model(cfg, dev, seed=0)
    prefill = build_prefill_step(model, cfg, dev)
    routing = Routing()
    with routing.record():
        plain = _all_logits(model, tokens, False, prefix)
    with routing.replay():
        kern = prefill(tokens, prefix)[0]
    scale = float(plain[:, -1].abs().max())
    kvp = float((kern - plain[:, -1]).abs().max())
    check(bool(torch.isfinite(kern).all()) and kvp <= KERNEL_VS_PLAIN_TOL * scale,
          f"{name} float32: kernel vs plain prefill differ by {kvp:.3g} "
          f"(max |logit| {scale:.3g}, tolerance {KERNEL_VS_PLAIN_TOL} of it)")
    out = dict(kernel_vs_plain_max_abs=kvp, max_abs_logit=scale)
    if cfg.is_moe:
        out["routing"] = routing.report(f"{name} float32")
        model.cfg = cfg = dataclasses.replace(
            cfg, capacity_factor=DECODE_CAPACITY_FACTOR)
        kern = prefill(tokens, prefix)[0]
        out["decode_capacity_factor"] = DECODE_CAPACITY_FACTOR
    if not keep_plain:
        del plain
        plain = None

    B, L = tokens.shape
    step, init_cache = build_serve_step(
        model, cfg, ShapeConfig("check", L, B, "decode"), dev)
    cache = init_cache()
    dec_prefix = prefix if cfg.is_encdec else None
    if dec_prefix is not None:
        with torch.inference_mode():
            cache["memory"] = model.encode(dec_prefix)
    decode_err = {}
    for t in range(L):
        logits, cache = step(cache, tokens[:, t], t)
        if t in (3, L - 1):
            want = (kern if t == L - 1 and dec_prefix is prefix
                    else prefill(tokens[:, :t + 1], dec_prefix)[0])
            err = float(((logits - want).abs()
                         / (DECODE_TOL + DECODE_TOL * want.abs())).max())
            check(err <= 1.0, f"{name} float32: decode at t={t} vs "
                  f"prefill is {err:.3g} of its {DECODE_TOL} tolerance")
            decode_err[str(t)] = float((logits - want).abs().max())
    out["decode_vs_prefill_max_abs"] = decode_err
    del model, prefill, step, cache
    empty_cache(dev)
    return out, plain, routing


def bf16_comparison(model, tokens, plain32, routing32, prefix=None):
    """Kernel vs plain prefill in bf16, over every position, beside the
    plain bf16 path's own distance from float32 (its yardstick).  Both bf16
    paths replay ``routing32``, the float32 plain path's MoE routing, so
    that the yardstick measures bf16 rounding alone and the comparison what
    the kernels change; the tokens whose bf16 routing would differ are
    reported."""
    with routing32.replay():
        plain = _all_logits(model, tokens, False, prefix)
    plain_flips = routing32.flips
    with routing32.replay():
        kern = _all_logits(model, tokens, True, prefix)
    kernel_flips = routing32.flips
    top1 = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float().mean())
    out = dict(kernel_vs_plain_max_abs=float((kern - plain).abs().max()),
               kernel_vs_plain_top1=top1(kern, plain),
               plain_vs_float32_max_abs=float((plain - plain32).abs().max()),
               plain_vs_float32_top1=top1(plain, plain32),
               max_abs_logit=float(plain.abs().max()))
    if routing32.ids:
        # bf16 noise is far coarser than float32's: the flips (against the
        # float32 routing, with its margins) are reported, not held to the
        # float32 tie margin
        out["routing"] = dict(
            moe_calls=len(routing32.ids), replayed="float32 plain path's",
            plain_flips=len(plain_flips), kernel_flips=len(kernel_flips),
            flip_margin_max=max((m for _, m in plain_flips + kernel_flips),
                                default=0.0))
    # both paths accumulate attention / the SSD in float32 and round to bf16
    # at the same places, so the kernel may move the bf16 model's logits no
    # further than bf16 itself moves them from the float32 model
    check(out["kernel_vs_plain_max_abs"] <= out["plain_vs_float32_max_abs"],
          f"bf16 kernel vs plain prefill {out['kernel_vs_plain_max_abs']:.3g} "
          f"exceeds bf16's own error {out['plain_vs_float32_max_abs']:.3g}")
    return out


def prefill_breakdown(dev, prefill, tokens, kernel_names, also=()):
    """Device time of one prefill (or any ``prefill(tokens)`` call: the TD
    phase traces a sweep) by kernel class from a torch.profiler trace (the
    ported kernels ``kernel_names``, together and each, matrix products,
    the rest, and of the rest the indexing kernels), the calls of each of
    ``kernel_names`` and ``also`` in the trace, and the device's idle
    share of the wall time; "not measured" if the trace has no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(tokens)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"kernel_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    index_ms = 0.0
    per_kernel = dict.fromkeys(kernel_names, 0.0)
    calls = dict.fromkeys(tuple(kernel_names) + tuple(also), 0)
    by_name = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0)) / 1e3
        name = evt.key.lower()
        by_name[evt.key[:80]] = by_name.get(evt.key[:80], 0.0) + ms
        for k in calls:
            if k in name:
                calls[k] += evt.count
        ported = [k for k in kernel_names if k in name]
        if ported:
            groups["kernel_ms"] += ms
            per_kernel[ported[0]] += ms
        elif any(w in name for w in MATMUL_KERNEL_WORDS):
            groups["matmul_ms"] += ms
        else:
            groups["other_ms"] += ms
            if any(w in name for w in INDEX_KERNEL_WORDS):
                index_ms += ms
    busy = sum(groups.values())
    if busy == 0:
        return {"device_time": "not measured", "wall_ms": wall_ms}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(groups, kernels_ms=per_kernel, kernel_calls=calls,
                device_busy_ms=busy,
                index_kernels_ms=index_ms, wall_ms=wall_ms,
                device_idle_share=max(0.0, 1 - busy / wall_ms),
                top_kernels_ms=dict(top))


def moe_stage_ms(dev, prefill, tokens):
    """The MoE layers' stages in one prefill, by CUDA events recorded around
    each call of ``route`` (router, softmax, top-k, slots), ``dispatch``
    (the slot table and the gather of tokens), ``expert_ffn`` (the batched
    expert products and the activation) and ``combine`` (the gather of the
    outputs and the gated sum), summed over the layers; the interval holds
    any device idle time inside a stage."""
    import torch
    from repro_torch.models import moe
    stages = ("route", "dispatch", "expert_ffn", "combine")
    events = {s: [] for s in stages}
    orig = {s: getattr(moe, s) for s in stages}

    def timed(stage):
        def fn(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig[stage](*a, **kw)
            e1.record()
            events[stage].append((e0, e1))
            return out
        return fn

    for s in stages:
        setattr(moe, s, timed(s))
    try:
        sync(dev)
        t0 = time.perf_counter()
        prefill(tokens)
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for s in stages:
            setattr(moe, s, orig[s])
    out = {f"{s}_ms": sum(a.elapsed_time(b) for a, b in events[s])
           for s in stages}
    out.update(calls=len(events["route"]), prefill_wall_ms=wall_ms)
    return out


def serve_phase(dev, cell):
    """One serving cell: the float32 full-width checks and the bf16
    comparison, then the main path — prefill at the cell's length (a
    frontend arch's behind its patches or over its frames) and ``serve``
    — with the launch counts reset just before and read after (the flash
    launches also by record, ``FlashCensus``), then one profiled prefill
    (and, for MoE, its stages by CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model

    cfg = _serve_cfg(cell)
    gen = torch.Generator(device=dev).manual_seed(1)
    check_len = cell.check_len or CHECK_LEN
    tokens = torch.randint(0, cfg.vocab_size, (CHECK_BATCH, check_len),
                           generator=gen, device=dev)
    prefix = _prefix_emb(cfg, CHECK_BATCH, gen, dev)
    # full width in float32 (the reference's contract, now with the kernel
    # on one side), keeping the plain logits and MoE routing for the bf16
    # check's yardstick
    f32, plain32, routing32 = model_checks(
        dev, cell.name, _serve_cfg(cell, dtype="float32"), tokens,
        keep_plain=True, prefix=prefix)

    model = build_model(cfg, dev, seed=0)   # bf16: the float32 draws, rounded
    prefill = build_prefill_step(model, cfg, dev)
    bf16 = bf16_comparison(model, tokens, plain32, routing32, prefix)
    del plain32, routing32
    empty_cache(dev)

    big = torch.randint(0, cfg.vocab_size,
                        (cell.prefill_batch, _text_len(cfg, cell.prefill_len)),
                        generator=gen, device=dev)
    big_prefix = _prefix_emb(cfg, cell.prefill_batch, gen, dev)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_all_launches()                           # the main path starts here
    times = []
    with FlashCensus() as census:
        for _ in range(PREFILL_CALLS):
            sync(dev)
            t0 = time.perf_counter()
            logits, _ = prefill(big, big_prefix)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        peak_prefill = (int(torch.cuda.max_memory_allocated())
                        if dev.type == "cuda" else None)
        check(tuple(logits.shape) == (cell.prefill_batch, cfg.padded_vocab)
              and bool(torch.isfinite(logits).all()),
              f"{cell.name}: prefill logits {tuple(logits.shape)} not finite")
        del model, prefill, logits                 # serve builds its own
        empty_cache(dev)
        res = serve(cfg, batch=cell.serve_batch, prompt_len=cell.prompt_len,
                    gen_len=cell.gen_len, seed=0, device=dev)
    counts = all_launches()                        # ... and ends here
    expect, per_record = {}, {}
    for rec, counter, n in zip(cell.kernels, cell.counters, cell.per_prefill):
        expect[counter] = expect.get(counter, 0) + n * PREFILL_CALLS
        per_record[rec] = n * PREFILL_CALLS
    for counter, n in expect.items():
        check(counts[counter] == n,
              f"{cell.name}: {counter} launched {counts[counter]} times, "
              f"expected {n} (per prefill call x prefill calls)")
    check(sum(counts.values()) == sum(expect.values()),
          f"{cell.name}: other kernels launched: {counts}")
    want_census = {k: n for k, n in per_record.items()
                   if k.startswith("flash_attention")}
    check(census.calls == want_census,
          f"{cell.name}: flash launches by record {census.calls}, expected "
          f"{want_census}")
    toks = res["tokens"]
    check(tuple(toks.shape) == (cell.serve_batch, cell.gen_len)
          and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all())
          and bool(torch.isfinite(res["logits"]).all()),
          f"{cell.name}: serve gave tokens {tuple(toks.shape)} or bad logits")
    peak = (int(torch.cuda.max_memory_allocated()) if dev.type == "cuda"
            else None)
    served = dict(batch=cell.serve_batch, prompt_len=cell.prompt_len,
                  gen_len=cell.gen_len, prompt_steps_s=res["prefill_s"],
                  decode_s=res["decode_s"],
                  decode_tokens_per_s=cell.serve_batch * cell.gen_len
                  / res["decode_s"])
    del res
    empty_cache(dev)
    model = build_model(cfg, dev, seed=0)
    prefill = build_prefill_step(model, cfg, dev)
    # the profiled prefill launched each of the cell's kernels its count a
    # prefill (summed over the records one kernel serves), and no CUDA-core
    # route: held by the wrappers' own counters, read around this one call;
    # the trace gives the times and must name no CUDA-core kernel
    want = dict.fromkeys(all_launches(), 0)
    by_name = dict.fromkeys(CUDA_CORE_KERNELS, 0)
    for rec, counter, n in zip(cell.kernels, cell.counters, cell.per_prefill):
        want[counter] += n
        name = RECORDS[rec].cuda_kernel
        by_name[name] = by_name.get(name, 0) + n
    names = tuple(k for k in by_name if k not in CUDA_CORE_KERNELS)
    sync(dev)
    reset_all_launches()
    breakdown = prefill_breakdown(dev, lambda t: prefill(t, big_prefix), big,
                                  names, also=CUDA_CORE_KERNELS)
    profiled = all_launches()
    check(profiled == want, f"{cell.name}: the profiled prefill launched "
          f"{profiled}, expected {want}")
    calls = breakdown.get("kernel_calls")
    check(calls is not None or dev.type != "cuda",
          f"{cell.name}: the profiled prefill's device time was not measured")
    if calls is not None:
        check(all(calls[k] == 0 for k in CUDA_CORE_KERNELS),
              f"{cell.name}: the profiled prefill ran a CUDA-core route: "
              f"{calls}")
        # reported, not held: whether the trace saw every launch
        breakdown["trace_calls_match_launches"] = calls == by_name
    breakdown["launches"] = {k: n for k, n in profiled.items() if n}
    if cfg.is_moe and dev.type == "cuda":
        breakdown["moe_stages_ms"] = moe_stage_ms(dev, prefill, big)
    del model, prefill
    empty_cache(dev)
    prefill_ms = statistics.median(times[1:])     # the first is the warm-up
    published = get_config(cell.arch).num_layers
    length = {"vision": f"prefill length {cell.prefill_len} ({cfg.num_prefix} "
                        f"patches + {_text_len(cfg, cell.prefill_len)} "
                        "tokens) of prefill_32k's 32768",
              "audio": f"prefill length {cell.prefill_len} decoder tokens "
                       f"(over the published {cfg.num_prefix} frames) of "
                       "prefill_32k's 32768"}
    line = dict(
        cell=cell.name, arch=cell.arch, dtype=cfg.dtype,
        layers=cfg.num_layers, d_model=cfg.d_model,
        reduced=[length.get(cfg.frontend, f"prefill length "
                            f"{cell.prefill_len} of prefill_32k's 32768"),
                 f"prefill batch {cell.prefill_batch} of prefill_32k's 32",
                 "random weights (seeded torch.Generator)"]
        + (["random patch / frame embeddings (0.02 normal, seeded), the "
            "stubbed frontend's output"] if prefix is not None else [])
        + ([f"depth {cfg.num_layers} of the published {published}"]
           if cell.layers is not None else []),
        prefill_batch=cell.prefill_batch, prefill_len=cell.prefill_len,
        prefill_ms=prefill_ms, prefill_ms_all=times,
        prefill_tokens_per_s=cell.prefill_batch * cell.prefill_len
        / (prefill_ms / 1e3),
        serve=served,
        peak_mem_bytes_prefill=peak_prefill, peak_mem_bytes=peak,
        launches=counts, expected_launches=expect,
        flash_launches_by_record=census.calls,
        float32_check=dict(f32, prompt=[CHECK_BATCH, check_len],
                           tolerance=dict(kernel_vs_plain=KERNEL_VS_PLAIN_TOL,
                                          decode_vs_prefill=DECODE_TOL)),
        bf16_check=bf16, prefill_breakdown=breakdown)
    if prefix is not None:
        line["prefix"] = dict(
            kind=cfg.frontend, prefill=list(big_prefix.shape),
            float32_check=list(prefix.shape),
            prefill_tokens=_text_len(cfg, cell.prefill_len))
    # the records' launches (a flash record's by its census), and every
    # counter by its own name (a record nests its other route's main-path
    # count)
    return line, dict(counts, **{k: census.calls.get(k, counts[c]) for k, c
                                 in zip(cell.kernels, cell.counters)})


def reduced_archs_phase(dev):
    """Every arch's reduced config (``reduced()``: 2 layers, d 256, 4
    experts, head dim 64, the sliding window cut to 64, 8 patches or frames
    of width 64) on the card in float32 (``model_checks``: kernel vs plain
    prefill with the routing replayed and its flips reported, decode vs
    prefill) at a 2 x 256 prompt (behind or over the frontend archs' 8
    prefix embeddings), longer than the window so that mixtral's window
    mask is live.  The
    kernels' launches are checks here, not a main path: they are reported
    and not counted in the ``kernels`` line."""
    import torch
    from repro_torch.configs import ARCH_NAMES, get_config
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for arch in ARCH_NAMES:
        cfg = get_config(arch).reduced()
        tokens = torch.randint(0, cfg.vocab_size, (REDUCED_BATCH, REDUCED_LEN),
                               generator=gen, device=dev)
        prefix = _prefix_emb(cfg, REDUCED_BATCH, gen, dev)
        reset_all_launches()
        fields, _, _ = model_checks(dev, f"{arch} reduced", cfg, tokens,
                                    prefix=prefix)
        fields["launches"] = {k: v for k, v in all_launches().items() if v}
        check(sum(fields["launches"].values()) > 0,
              f"{arch} reduced: no kernel launched")
        out[arch] = fields
    return dict(phase="reduced-archs", prompt=[REDUCED_BATCH, REDUCED_LEN],
                archs=out, tolerance=dict(kernel_vs_plain=KERNEL_VS_PLAIN_TOL,
                                          decode_vs_prefill=DECODE_TOL)), {}


# ---------------------------------------------------------------------------
# Phase 6: federated gain-gated training of the LM substrate
# ---------------------------------------------------------------------------


class TrainCell(NamedTuple):
    name: str
    arch: str
    layers: Optional[int]     # depth cut; None keeps the published depth
    agents: int
    global_batch: int
    seq_len: int
    steps: int
    lam: float


# launch/train.py's run: adamw on its cosine schedule, eps 1, the hvp gain;
# lambda 1e-3 is tests/test_system.py:24's.  mamba2-370m's depth is cut to
# 12 of 48 layers to keep the whole smoke well inside its time limit beside
# the serving cells (its step's time, the comm_savings study's and the
# profiled step's are linear in the depth).
TRAIN_CELLS = (
    TrainCell("train-mamba2-370m-12l", "mamba2-370m", 12, 8, 8, 1024, 20,
              1e-3),
    TrainCell("train-yi-6b-4l", "yi-6b", 4, 4, 8, 1024, 5, 1e-3),
)
TRAIN_LR = 3e-4
TRAIN_TIMING_REPS = 3
STAGE_AGENTS = 2          # agents timed eagerly stage by stage
# benchmarks/comm_savings.py:44-64 (sgd(0.1), 8 agents, 8 x 128 tokens,
# batches from key(1), FedConfig(eps=0.1, rho=0.995, horizon=30, hvp)),
# at mamba2-370m's full width where the study ran reduced
COMM_SAVINGS = dict(agents=8, global_batch=8, seq_len=128, steps=30, lr=0.1,
                    eps=0.1, rho=0.995, horizon=30,
                    lambdas=(0.0, 1.0, 30.0, 300.0), batch_seed=1)
# sha256 of the int32 tokens of the reference's make_lm_batch(
# SyntheticLMConfig(50280, 128, 8), jax.random.key(1), step), JAX 0.9.0 on
# the CPU: the study's first three batches
LM_TOKENS_JAX = {
    0: "a9311455b45c827bc8cf097a089eedea2d47a4ec255349f32c8306a2667f7b45",
    1: "8f62f5425e5ea39e931f0a8f73ff3f54104c8a56ff329ec08c36af3ce22a36d2",
    2: "8ab0e01177ee67f0644e2c79da40b574f20dc3a7af434bd0f7904662cb0246b4",
}
# the train step on the card against the port's own CPU run: reduced
# mamba2-370m in float32, 4 agents, 2 steps, a lambda that mixes
# decisions; sgd with momentum, since Adam's per-element normalisation
# turns summation-order noise on near-zero gradients into full-size
# updates (tests/test_torch_train.py)
TRAIN_PARITY = dict(agents=4, steps=2, seq_len=32, global_batch=8, lr=0.1,
                    momentum=0.9,
                    fed=dict(eps=1.0, lam=2.0, rho=0.9, horizon=4,
                             estimator="hvp"))
TRAIN_PARITY_TOL = 1e-5   # parameters (absolute), gains (of their scale)
# g^T H g against a float32 central difference of the gradient along the
# clipped g, at full width with the depth cut to 2 layers, float32
FD_CHECK = dict(layers=2, seq_len=1024, h=1e-3)
FD_TOL = 1e-3             # of |g^T H g| + ||g||^2


def _train_cfg(cell):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(cell.arch)
    if cell.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=cell.layers)
    return cfg


def token_digest(tokens):
    import hashlib
    import numpy as np
    arr = tokens.to("cpu").numpy().astype("<i4")
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def train_entry_run(dev, cell, cfg):
    """``launch.train``'s function, as its command line runs it, with a
    checkpoint written and then restored bitwise.  The kernel counts are
    set to 0 just before and read just after: the training path runs the
    plain path and launches none."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import restore
    from repro_torch.convert import state_dict_from_jax, tree_from_state_dict
    from repro_torch.launch.train import train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    path = os.path.join(tmp, "train.npz")
    logs = []
    try:
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_all_launches()                       # the main path starts here
        t0 = time.perf_counter()
        out = train(cfg, steps=cell.steps, seq_len=cell.seq_len,
                    global_batch=cell.global_batch, lr=TRAIN_LR, lam=cell.lam,
                    estimator="hvp", agents=cell.agents, log_every=1,
                    checkpoint=path, seed=0, device=dev, log=logs.append)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = all_launches()                    # ... and ends here
        peak = (int(torch.cuda.max_memory_allocated()) if dev.type == "cuda"
                else None)
        check(sum(counts.values()) == 0,
              f"{cell.name}: the training path launched kernels: {counts}")
        losses = [h["loss"] for h in out["history"]]
        check(len(losses) == cell.steps and all(map(math.isfinite, losses)),
              f"{cell.name}: losses {losses}")
        sd = out["model"].state_dict()
        tree, meta = restore(path, tree_from_state_dict(sd))
        back = state_dict_from_jax(tree)
        check(set(back) == set(sd) and meta["steps"] == cell.steps
              and all(torch.equal(back[k], v) for k, v in sd.items()),
              f"{cell.name}: the checkpoint did not restore bitwise")
        ck_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    walls = [h["wall_s"] for h in out["history"]]
    run = dict(steps=cell.steps, wall_s=wall, losses=losses,
               comm_rates=[h["comm_rate"] for h in out["history"]],
               grad_norms=[h["grad_norm"] for h in out["history"]],
               step_wall_s=[b - a for a, b in zip([0.0] + walls, walls)],
               peak_mem_bytes=peak, launches=counts,
               checkpoint=dict(bytes=ck_bytes, restored_bitwise=True),
               log_tail=logs[-2:])
    return out, run


def comm_savings_run(dev, cfg):
    """The reference's comm_savings study (benchmarks/comm_savings.py) at
    full width, plus one step at lambda 1e9, which must leave every
    parameter as it was, bit for bit."""
    import math
    import torch
    from repro_torch import random
    from repro_torch.core.fed_sgd import FedConfig, FedStats, tree_bytes
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import build_train_step, trainable_params
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    cs = COMM_SAVINGS
    lm = SyntheticLMConfig(cfg.vocab_size, cs["seq_len"], cs["global_batch"])
    key = random.key(cs["batch_seed"], dev)
    t0 = time.perf_counter()
    batches = [make_lm_batch(lm, key, s) for s in range(cs["steps"])]
    sync(dev)
    batch_s = time.perf_counter() - t0
    digests = {s: token_digest(batches[s]["tokens"]) for s in LM_TOKENS_JAX}
    check(digests == LM_TOKENS_JAX,
          f"LM batch tokens differ from JAX 0.9.0's: {digests}")
    model = build_model(cfg, dev, seed=0)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = sgd(cs["lr"])
    rows = []

    def run(lam, steps):
        model.load_state_dict(init)
        fed = FedConfig(eps=cs["eps"], lam=lam, rho=cs["rho"],
                        horizon=cs["horizon"], estimator="hvp")
        bundle = build_train_step(model, cfg, opt,
                                  fed_cfg=fed if lam > 0 else None,
                                  num_agents=cs["agents"], device=dev)
        params = trainable_params(model)
        st, fs = opt.init(params), FedStats.init(cs["agents"], dev)
        losses, ends = [], []
        sync(dev)
        t0 = time.perf_counter()
        for b in batches[:steps]:
            params, st, fs, m = bundle.step(params, st, fs, b)
            losses.append(m["loss"])
            if not ends:                     # the first step captures
                sync(dev)
                ends.append(time.perf_counter() - t0)
        sync(dev)
        return (params, fs, m, [float(x) for x in losses],
                time.perf_counter() - t0, ends[0])

    for lam in cs["lambdas"]:
        params, fs, m, losses, wall, first = run(lam, cs["steps"])
        rate = float(m["comm_rate"])
        gbytes = tree_bytes(params)
        check(all(map(math.isfinite, losses)),
              f"comm_savings lam={lam}: losses {losses}")
        rows.append(dict(lam=lam, comm_rate=rate, tx=float(fs.tx),
                         grad_bytes=gbytes,
                         bytes_per_step_full=gbytes * cs["agents"],
                         bytes_per_step_gated=gbytes * cs["agents"] * rate,
                         loss_first=losses[0], loss_last=losses[-1],
                         wall_s=wall, first_step_s=first,
                         step_ms=(wall - first) / (cs["steps"] - 1) * 1e3))
    check(rows[0]["lam"] == 0.0 and rows[0]["comm_rate"] == 1.0,
          f"comm_savings: lambda 0 gives comm rate {rows[0]['comm_rate']}")
    params, fs, m, _, _, _ = run(1e9, 1)
    frozen = all(torch.equal(params[k].detach(), init[k]) for k in init)
    check(frozen and float(m["comm_rate"]) == 0.0,
          "comm_savings: a step at lambda 1e9 moved the parameters")
    return dict(settings=dict(cs, lambdas=list(cs["lambdas"]),
                              estimator="hvp", grad_clip=1.0),
                batches_s=batch_s, token_digests_equal_jax=True,
                rows=rows, lambda_1e9_frozen_bitwise=True)


def train_parity_check(dev):
    """The train step on the card against the port's own run on the CPU:
    same weights and batches, reduced mamba2-370m in float32."""
    import torch
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.core.fed_sgd import FedConfig, FedStats
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import build_train_step, trainable_params
    from repro_torch.models import build_model
    from repro_torch.optim import sgd

    tp = TRAIN_PARITY
    cfg = get_config("mamba2-370m").reduced()
    fed = FedConfig(**tp["fed"])
    lm = SyntheticLMConfig(cfg.vocab_size, tp["seq_len"], tp["global_batch"])
    init = build_model(cfg, "cpu", seed=0).state_dict()
    runs = {}
    for where in ("cpu", dev):
        model = build_model(cfg, where, seed=0)
        model.load_state_dict(init)
        opt = sgd(tp["lr"], momentum=tp["momentum"])
        bundle = build_train_step(model, cfg, opt, fed_cfg=fed,
                                  num_agents=tp["agents"], device=where)
        params = trainable_params(model)
        st, fs = opt.init(params), FedStats.init(tp["agents"], where)
        key = random.key(1, where)
        steps = []
        for s in range(tp["steps"]):
            batch = make_lm_batch(lm, key, s)
            params, st, fs, m = bundle.step(params, st, fs, batch)
            steps.append(dict(        # copies: the CPU run's .cpu() aliases
                tokens=batch["tokens"].cpu().clone(),
                alpha=fs.last_alpha.cpu().clone(),
                gain=fs.last_gain.cpu().clone(),
                metrics={k: float(v) for k, v in m.items()},
                params={k: v.detach().cpu().clone()
                        for k, v in params.items()}))
        runs[str(where)] = steps
    cpu, gpu = runs["cpu"], runs[str(dev)]
    worst = dict(params=0.0, gain=0.0, metrics=0.0)
    for s, (a, b) in enumerate(zip(cpu, gpu)):
        check(torch.equal(a["tokens"], b["tokens"]),
              f"train parity: step {s} batches differ between devices")
        check(torch.equal(a["alpha"], b["alpha"]),
              f"train parity: step {s} decisions {a['alpha']} vs {b['alpha']}")
        scale = 1.0 + float(a["gain"].abs().max())
        worst["gain"] = max(worst["gain"],
                            float((a["gain"] - b["gain"]).abs().max()) / scale)
        worst["params"] = max(worst["params"], max(
            float((a["params"][k] - b["params"][k]).abs().max())
            for k in a["params"]))
        worst["metrics"] = max(worst["metrics"], max(
            abs(a["metrics"][k] - b["metrics"][k]) / max(abs(a["metrics"][k]), 1.0)
            for k in a["metrics"]))
    check(max(worst.values()) <= TRAIN_PARITY_TOL,
          f"train parity: card vs CPU {worst} > {TRAIN_PARITY_TOL}")
    alphas = torch.stack([s["alpha"] for s in cpu])
    check(0 < float(alphas.sum()) < alphas.numel(),
          f"train parity: no mix of decisions {alphas.tolist()}")
    return dict(settings=dict(tp, arch=cfg.name, dtype=cfg.dtype),
                decisions=alphas.tolist(), decisions_equal=True,
                max_err=worst, tolerance=TRAIN_PARITY_TOL)


def curvature_fd_check(dev):
    """g^T H g (the hvp estimator's reverse-over-reverse product, through
    per-block remat) against a float32 central difference of the gradient
    along the clipped g: mamba2-370m at full width, 2 layers, float32."""
    import dataclasses
    import torch
    from repro_torch import random
    from repro_torch.configs import get_config
    from repro_torch.core.fed_sgd import curvature_dot, make_grad_fn, tree_vdot
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import trainable_params
    from repro_torch.models import build_model
    from repro_torch.optim import clip_by_global_norm

    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              num_layers=FD_CHECK["layers"], dtype="float32")
    model = build_model(cfg, dev, seed=0)
    model.requires_grad_(True)
    p = trainable_params(model)
    batch = make_lm_batch(SyntheticLMConfig(cfg.vocab_size,
                                            FD_CHECK["seq_len"], 1),
                          random.key(1, dev), 0)
    grad_fn = make_grad_fn(lambda q: model.loss_fn(batch)[0])

    def grads():
        loss = model.loss_fn(batch)[0]
        return dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    raw = grads()
    with torch.no_grad():
        g, norm = clip_by_global_norm(raw, 1.0)
    ghg = float(curvature_dot(grad_fn, p, g))
    h = FD_CHECK["h"]
    with torch.no_grad():
        for k in p:
            p[k].add_(g[k], alpha=h)
    plus = grads()
    with torch.no_grad():
        for k in p:
            p[k].add_(g[k], alpha=-2 * h)
    minus = grads()
    with torch.no_grad():
        for k in p:
            p[k].add_(g[k], alpha=h)
    fd = float(tree_vdot(g, {k: (plus[k] - minus[k]) / (2 * h) for k in p}))
    gg = float(tree_vdot(g, g))
    err = abs(ghg - fd) / (abs(ghg) + gg)
    check(err <= FD_TOL, f"g^T H g {ghg} vs central difference {fd}: "
          f"{err} > {FD_TOL}")
    return dict(layers=cfg.num_layers, d_model=cfg.d_model, dtype=cfg.dtype,
                remat=cfg.remat, seq_len=FD_CHECK["seq_len"], h=h,
                grad_norm_preclip=float(norm), ghg=ghg, central_difference=fd,
                rel_err=err, tolerance=FD_TOL)


def _events(n):
    import torch
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def train_stage_ms(dev, model, cfg, cell, batch, fed_cfg):
    """The ``hvp`` step's stages run eagerly (no CUDA graph), by CUDA
    events: forward + backward (with the clip), curvature (the gain),
    aggregation (decision and masked sum), each the median over the first
    ``STAGE_AGENTS`` agents times the agent count, and the optimizer
    (update and apply).
    Mirrors ``build_train_step``'s agent loop; eager, so each stage's time
    is bound by its launches, which the graphed step replays without."""
    import torch
    from repro_torch.core.fed_sgd import GatedSum, local_gain
    from repro_torch.launch.steps import trainable_params
    from repro_torch.optim import adamw, apply_updates, clip_by_global_norm

    params = trainable_params(model)
    keys = list(params)
    opt = adamw(TRAIN_LR)
    st = opt.init(params)
    A = cell.agents
    b = cell.global_batch // A
    thr = fed_cfg.threshold(torch.zeros((), dtype=torch.int32, device=dev))
    acc = GatedSum(fed_cfg.agg_dtype)
    marks = []
    sync(dev)
    for i in range(min(A, STAGE_AGENTS)):
        ev = _events(4)
        ev[0].record()
        local = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        loss = model.loss_fn(local)[0]
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [params[k] for k in keys], create_graph=True)))
        with torch.no_grad():
            g, _ = clip_by_global_norm(grads, 1.0)
        ev[1].record()
        gain = local_gain(g, fed_cfg, grad_fn=lambda q: grads, params=params)
        ev[2].record()
        acc.add(g, (gain <= -thr).float())
        ev[3].record()
        marks.append(ev)
        del loss, grads, g, gain
    ev = _events(2)
    ev[0].record()
    with torch.no_grad():
        agg, _ = acc.mean()
        updates, st = opt.update(agg, st, params)
        new = apply_updates(params, updates)
        for k, p in params.items():
            p.copy_(new[k])
    ev[1].record()
    sync(dev)
    per_agent = {name: statistics.median(e[j].elapsed_time(e[j + 1])
                                         for e in marks)
                 for j, name in enumerate(("forward_backward", "curvature",
                                           "aggregation"))}
    out = {k: v * A for k, v in per_agent.items()}
    out["optimizer"] = ev[0].elapsed_time(ev[1])
    return out


def train_timings(dev, cell, cfg, out):
    """The entry run's own train step (``out`` from ``launch.train.train``:
    the graphed ``hvp`` step, already captured) timed by CUDA events
    (median), its peak memory and one profiled step; a graphed ``gnorm``
    step on the same model; the ``hvp`` step's stages run eagerly;
    tokens/s."""
    import torch
    from repro_torch import random
    from repro_torch.core.fed_sgd import FedConfig, FedStats
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import build_train_step, trainable_params
    from repro_torch.optim import adamw

    model = out["model"]
    batch = make_lm_batch(SyntheticLMConfig(cfg.vocab_size, cell.seq_len,
                                            cell.global_batch),
                          random.key(0, dev), cell.steps)
    state = [out["params"], out["opt_state"], out["fed_state"]]

    def hvp_step():
        state[:3] = out["bundle"].step(*state, batch)[:3]
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    hvp_ms = time_ms(hvp_step, reps=TRAIN_TIMING_REPS, warmup=0)
    peak = (int(torch.cuda.max_memory_allocated()) if dev.type == "cuda"
            else None)
    t0 = time.perf_counter()
    profile = prefill_breakdown(dev, lambda b: hvp_step(), batch, ())
    profile["seconds_with_processing"] = time.perf_counter() - t0
    del state
    out["opt_state"] = out["fed_state"] = None
    empty_cache(dev)

    fed = FedConfig(eps=1.0, lam=cell.lam, rho=0.999, horizon=cell.steps,
                    estimator="gnorm")
    opt = adamw(TRAIN_LR)
    bundle = build_train_step(model, cfg, opt, fed_cfg=fed,
                              num_agents=cell.agents, device=dev)
    params = trainable_params(model)
    gstate = [params, opt.init(params), FedStats.init(cell.agents, dev)]

    def gnorm_step():
        gstate[:3] = bundle.step(*gstate, batch)[:3]
    sync(dev)
    t0 = time.perf_counter()
    gnorm_step()                               # captures the agent's graph
    sync(dev)
    capture_s = time.perf_counter() - t0
    gnorm_ms = time_ms(gnorm_step, reps=TRAIN_TIMING_REPS, warmup=0)
    del gstate, bundle
    empty_cache(dev)
    stages = train_stage_ms(dev, model, cfg, cell, batch, FedConfig(
        eps=1.0, lam=cell.lam, rho=0.999, horizon=cell.steps))
    empty_cache(dev)
    tokens = cell.global_batch * cell.seq_len
    return dict(step_ms=hvp_ms, gnorm_step_ms=gnorm_ms,
                hvp_over_gnorm=hvp_ms / gnorm_ms,
                tokens_per_s=tokens / (hvp_ms / 1e3),
                gnorm_first_step_s_with_capture=capture_s,
                eager_stages_ms=stages,
                eager_step_ms=sum(stages.values()),
                stage_agents_timed=min(cell.agents, STAGE_AGENTS),
                peak_mem_bytes_step=peak, profile=profile)


def train_phase(dev, cell):
    """One training cell: ``launch.train``'s function on the cell (the
    main path, kernel counts 0 before and after), then for mamba2-370m the
    comm_savings study at full width, the card-vs-CPU parity of the step
    and the curvature check, then the timings."""
    cfg = _train_cfg(cell)
    out, run = train_entry_run(dev, cell, cfg)
    t0 = time.perf_counter()
    timings = train_timings(dev, cell, cfg, out)
    timings["seconds"] = time.perf_counter() - t0
    del out
    empty_cache(dev)
    line = dict(cell=cell.name, arch=cell.arch, dtype=cfg.dtype,
                layers=cfg.num_layers, d_model=cfg.d_model,
                vocab=cfg.vocab_size, agents=cell.agents,
                global_batch=cell.global_batch, seq_len=cell.seq_len,
                optimizer=f"adamw(cosine_schedule({TRAIN_LR}))",
                estimator="hvp", lam=cell.lam, remat=cfg.remat,
                reduced=["random weights (seeded torch.Generator)"]
                + ([f"depth {cfg.num_layers} of the published "
                    f"{_train_cfg(cell._replace(layers=None)).num_layers}"]
                   if cell.layers is not None else []),
                entry_run=run, timings=timings)
    if cell.arch == "mamba2-370m":
        check(run["losses"][-1] < run["losses"][0],
              f"{cell.name}: loss {run['losses'][0]} -> {run['losses'][-1]}")
        t0 = time.perf_counter()
        line["comm_savings"] = comm_savings_run(dev, cfg)
        line["comm_savings"]["reduced"] = [
            f"mamba2-370m at its published width (d 1024), depth "
            f"{cfg.num_layers} of 48; the study ran the reduced config",
            "random weights (seeded torch.Generator), not "
            "jax.random.key(0)'s"]
        line["comm_savings"]["seconds"] = time.perf_counter() - t0
        empty_cache(dev)
        line["parity_card_vs_cpu"] = train_parity_check(dev)
        line["curvature_vs_central_difference"] = curvature_fd_check(dev)
        empty_cache(dev)
    return line, {}


class Record(NamedTuple):
    """What a ``kernels`` record says of its kernel besides the numbers."""
    source: str             # the CUDA source, in the repo
    replaces: str           # file:line of the reference code it replaces
    tolerance: dict
    cuda_kernel: str = ""   # the kernel the main path launches, as a trace names it
    replaces_note: str = ""   # set where that code is not a Pallas kernel
    route_of: str = ""      # set for one route or shape of a recorded kernel
    main_path: bool = True  # False: a route no main path runs (launches 0)


CSRC = "src/repro_torch/kernels/csrc/"
_GAIN = dict(source=CSRC + "gain.cu",
             tolerance=dict(ragged=KERNEL_TOL, main_path=WEIGHT_TOL))
_FLASH = dict(source=CSRC + "flash_wgmma.cuh",
              replaces="src/repro/kernels/flash_attention.py:75",
              tolerance=dict(FLASH_TOL), cuda_kernel="flash_wgmma_kernel")
_TILE = dict(source=CSRC + "ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:53")
_PASS = dict(source=CSRC + "ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:133",
             tolerance=dict(chunked=SSD_CHUNKED_TOL, bf16_ulps=SSD_ULP_LIMIT),
             cuda_kernel="ssd_state_pass_wgmma_kernel",
             replaces_note="XLA code around the Pallas tile in "
                           "ssd_chunked_pallas (the inter-chunk lax.scan "
                           ":133-140 and the inter-chunk output term "
                           ":143-145), not a Pallas kernel")
RECORDS = {
    "gain_matvec": Record(replaces="src/repro/kernels/gain.py:144", **_GAIN),
    "gain_family_stats": Record(replaces="src/repro/kernels/gain.py:241",
                                **_GAIN),
    "megastep": Record(replaces="src/repro/kernels/gain.py:428", **_GAIN),
    "flash_attention": Record(**_FLASH),
    "flash_attention_d96": Record(
        **_FLASH, route_of="flash_attention's tensor-core route at head dim "
                           "96 (phi3-mini): flash_wgmma_kernel<__nv_bfloat16, "
                           "128> at d 96"),
    "flash_attention_d64": Record(
        **_FLASH, route_of="flash_attention's tensor-core route at head dim "
                           "64 with Lk = Lq (seamless-m4t-medium's encoder "
                           "and decoder self-attention): "
                           "flash_wgmma_kernel<__nv_bfloat16, 64>"),
    "flash_attention_cross": Record(
        **_FLASH, route_of="flash_attention's tensor-core route with Lk != "
                           "Lq (seamless-m4t-medium's cross-attention, 8192 "
                           "tokens over 1024 frames, d 64): "
                           "flash_wgmma_kernel<__nv_bfloat16, 64>"),
    "ssd_chunk_tiles": Record(**_TILE, tolerance=dict(tile=SSD_TILE_TOL),
                              cuda_kernel="ssd_chunk_wgmma_kernel"),
    "ssd_chunk_tiles_n16": Record(
        **_TILE, tolerance=dict(tile=SSD_TILE_TOL, chunked=SSD_CHUNKED_TOL,
                                bf16_ulps=SSD_ULP_LIMIT),
        cuda_kernel="ssd_chunk_wgmma_n16_kernel",
        route_of="ssd_chunk_tiles' tensor-core route at N 16 (jamba): "
                 "ssd_chunk_wgmma_n16_kernel"),
    "ssd_state_pass": Record(**_PASS),
    "ssd_state_pass_n16": Record(
        **_PASS, route_of="ssd_state_pass' tensor-core route at N 16 "
                          "(jamba): ssd_state_pass_wgmma_kernel"),
    # the reference kernels' contracts past the main paths (contract_phase):
    # each record's name is its route's launch counter
    "flash_attention_wgmma_f16": Record(
        **dict(_FLASH, tolerance=dict(float16=CONTRACT_F16_TOL,
                                      f16_ulps=FLASH_ULP_LIMIT),
               source=CSRC + "flash_wgmma.cuh"), main_path=False,
        route_of="flash_attention's tensor-core route on float16: "
                 "flash_wgmma_kernel<__half, W> at any head dim that is a "
                 "multiple of 8 up to 256, 16-byte-aligned inputs"),
    "flash_attention_wgmma_padded": Record(
        **dict(_FLASH, tolerance=dict(bfloat16=FLASH_TOL["bfloat16"],
                                      bf16_ulps=FLASH_ULP_LIMIT),
               source=CSRC + "flash_wgmma.cuh"), main_path=False,
        route_of="flash_attention's tensor-core route on bf16 at head dims "
                 "other than 64, 96 and 128 (multiples of 8 up to 256): "
                 "flash_wgmma_kernel<__nv_bfloat16, W> at the next width of "
                 "64, 128, 256, the head dim a run-time argument"),
    "flash_attention_wgmma_loaded": Record(
        **dict(_FLASH, tolerance=dict(bfloat16=FLASH_TOL["bfloat16"],
                                      float16=CONTRACT_F16_TOL,
                                      bf16_ulps=FLASH_ULP_LIMIT,
                                      f16_ulps=FLASH_ULP_LIMIT),
               source=CSRC + "flash_wgmma.cuh"), main_path=False,
        route_of="flash_attention's tensor-core route on 16-bit inputs TMA "
                 "cannot read (q, k or v off a 16-byte boundary, or a head "
                 "dim up to 256 that is not a multiple of 8): "
                 "flash_wgmma_kernel<E, W, true>, a producer warpgroup "
                 "loading each row's aligned 16-byte words into registers "
                 "(__ldg), funnel-shifting them and storing them into the "
                 "swizzled atoms (flash_loaded.cu)"),
    "flash_attention_wgmma_f32": Record(
        **dict(_FLASH, tolerance=dict(float32=FLASH_TOL["float32"],
                                      float64_vs_flash_kernel=
                                      F32_VS_FLASH_KERNEL)),
        main_path=False,
        route_of="flash_attention in float32 on 16-byte boundaries at head "
                 "dims that are multiples of 4 up to 128 (and q, k, v of "
                 "mixed dtypes, cast to float32): flash_wgmma_kernel<float, "
                 "W, true> (flash_f32.cu), a producer warpgroup splitting "
                 "each float32 row into three bf16 pieces, six piece "
                 "products a product on the tensor cores"),
    "flash_attention_padded": Record(
        **dict(_FLASH, tolerance=dict(FLASH_TOL, float16=CONTRACT_F16_TOL),
               cuda_kernel="flash_kernel", source=CSRC + "flash_simt.cuh"),
        main_path=False,
        route_of="flash_attention in float32 at head dims other than 16, "
                 "32, 64, 96, 128 up to 256 that the float32 kind does not "
                 "take (off a 16-byte boundary, not a multiple of 4, or "
                 "past 128): flash_kernel at the next width of 16, 32, 64, "
                 "96, 128, 256, the head dim a run-time argument"),
    "flash_attention_wide": Record(
        **dict(_FLASH, tolerance=dict(FLASH_TOL, float16=CONTRACT_F16_TOL),
               cuda_kernel="flash_wide_kernel",
               source=CSRC + "flash_simt.cuh"), main_path=False,
        route_of="flash_attention past head dim 256: flash_wide_kernel, "
                 "one block a (q tile, head) computing each score once, Q "
                 "resident, K and V streamed by cp.async"),
    "ssd_chunk_tiles_generic": Record(
        **dict(_TILE, source=CSRC + "ssd_generic.cu"),
        tolerance=dict(tile=SSD_TILE_TOL),
        cuda_kernel="ssd_chunk_generic_kernel", main_path=False,
        route_of="ssd_chunk_tiles past 128 or on float16 B/C: "
                 "ssd_chunk_generic_kernel"),
    "ssd_state_pass_generic": Record(
        **dict(_PASS, tolerance=dict(chunked=SSD_CHUNKED_TOL,
                                     bf16_ulps=SSD_ULP_LIMIT,
                                     float16=CONTRACT_F16_TOL),
               cuda_kernel="ssd_state_pass_generic_kernel",
               source=CSRC + "ssd_generic.cu"), main_path=False,
        route_of="ssd_state_pass on every shape, dtype and alignment the "
                 "fixed-shape passes refuse: ssd_state_pass_generic_kernel"),
    "gain_matvec_f16": Record(
        replaces="src/repro/kernels/gain.py:144", main_path=False,
        route_of="gain_matvec on float16 phi and g", **_GAIN),
    "gain_family_stats_f16": Record(
        replaces="src/repro/kernels/gain.py:241", main_path=False,
        route_of="gain_family_stats on float16 phi and g", **_GAIN),
    "megastep_f16": Record(
        replaces="src/repro/kernels/gain.py:428", main_path=False,
        route_of="megastep_call on float16 phi and g", **_GAIN),
}


def kernel_lines(logs, timings, launches):
    """One record per kernel: the ``kernels`` line of the output.
    ``launches`` sums the kernel's launches over every cell's main path
    (a record with ``main_path`` False, a route no main path runs, is
    named by its counter and must count 0).
    A log's ``extra`` fields join its record: the flash records nest their
    float32 route's times (the tensor cores' float32 kind, which the main
    path never launches, beside ``flash_kernel`` forced), the float32
    kind's record its nested logs (``KernelLog.nested``: flash_kernel's
    cases as its CUDA-core route, with main-path launches, and the mixed
    dtypes'), the flash record its bf16 ulp check; the SSD tile's nests its float32 route
    (``ssd_chunk_kernel``), its float32 CUDA-core bound and the whole
    ``ssd_chunked``'s times at the slice; the state pass's nests its
    CUDA-core route (``ssd_state_pass_kernel``: cases, time and bound at
    the slice, main-path launches) beside its CUDA-core bound and both
    routes' float32-C times, and the N 16 tile's its CUDA-core route
    (``ssd_chunk_kernel``: cases, time and bounds at jamba's slice,
    main-path launches) and its dt x on load time and bound; gain_matvec's
    counts the passes its checked cases took and keeps its alternating
    trials against torch.matmul.  A
    record that replaces no Pallas kernel says so in ``replaces_note``;
    a record of one route or shape of a kernel that has its own record
    (head dim 96, jamba's N 16) says which in ``route_of``."""
    kernels = []
    for name, counter in (("ssd_state_pass", "ssd_state_pass_simt"),
                          ("ssd_chunk_tiles_n16", "ssd_chunk_tiles_simt")):
        nested = logs[name].extra.get("cuda_core_route")
        if nested is not None:
            nested["launches"] = launches.get(counter, 0)
    f32 = logs.get("flash_attention_wgmma_f32")
    if f32 is not None:
        f32.nested["cuda_core_route"].extra["launches"] = sum(
            launches.get(c, 0) for c in ("flash_attention_simt",
                                         "flash_attention_padded"))
    for name, log in logs.items():
        t = timings[name]
        rec = RECORDS[name]
        kernels.append(dict(
            name=name, route="cuda", source=rec.source, replaces=rec.replaces,
            **{k: getattr(rec, k) for k in ("replaces_note", "route_of")
               if getattr(rec, k)},
            launches=launches.get(name, 0),
            max_abs_err=log.max_abs, max_rel_err=log.max_rel,
            tolerance=rec.tolerance,
            repeat_bitwise=log.repeat_bitwise,
            decision_tie_flips=log.tie_flips, cases=log.cases,
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            main_path=rec.main_path, **log.extra,
            **{k: n.summary() for k, n in log.nested.items()}))
    return kernels


def device_line():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"device": {"nvidia_smi": card, "name": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count(),
                     "torch": torch.__version__, "cuda": torch.version.cuda,
                     "python": sys.version.split()[0]}})


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeFailure("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_line()

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    made = build.build(force=True)
    lib = build.load()
    regs = [l.strip() for l in made.log.splitlines()
            if any(w in l for w in ("registers", "spill", "Compiling entry"))]
    # ptxas reports static shared memory only; the tensor-core kernels' and
    # the state pass's is dynamic, so their bytes per block (at the slices'
    # shapes for the SSD, bf16 B/C) and blocks per SM come from the library
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "nvcc_seconds": made.seconds,
                    "ptxas": regs,
                    "flash_wgmma_dynamic_smem_bytes": {
                        d: lib.flash_attention_wgmma_smem_bytes(d)
                        for d in (64, 96, 128, 256)},
                    "flash_wgmma_blocks_per_sm": {
                        d: lib.flash_attention_wgmma_blocks_per_sm(d)
                        for d in (64, 96, 128, 256)},
                    "flash_wgmma_f16_blocks_per_sm": {
                        d: lib.flash_wgmma_contract_blocks_per_sm(2, d)
                        for d in (64, 128, 256)},
                    "flash_wgmma_f32_dynamic_smem_bytes": {
                        d: lib.flash_wgmma_f32_smem_bytes(d)
                        for d in (64, 128)},
                    "flash_wgmma_f32_blocks_per_sm": {
                        d: lib.flash_wgmma_f32_blocks_per_sm(d)
                        for d in (64, 128)},
                    "ssd_chunk_wgmma_dynamic_smem_bytes":
                        lib.ssd_chunk_wgmma_smem_bytes(128, 128, 64, 1),
                    "ssd_chunk_wgmma_n16_dynamic_smem_bytes": {
                        "bf16_bc": lib.ssd_chunk_wgmma_smem_bytes(
                            128, 16, 64, 1),
                        "float32_bc": lib.ssd_chunk_wgmma_smem_bytes(
                            128, 16, 64, 0)},
                    "ssd_state_pass_dynamic_smem_bytes":
                        lib.ssd_state_pass_smem_bytes(128, 128, 1),
                    "ssd_state_pass_wgmma_dynamic_smem_bytes": {
                        "bf16_c": lib.ssd_state_pass_wgmma_smem_bytes(
                            128, 128, 1),
                        "float32_c": lib.ssd_state_pass_wgmma_smem_bytes(
                            128, 128, 0),
                        "bf16_c_n16": lib.ssd_state_pass_wgmma_smem_bytes(
                            128, 16, 1)},
                    "blocks_per_sm": {
                        "ssd_chunk_wgmma_kernel": lib.ssd_blocks_per_sm(0, 128),
                        "ssd_state_pass_kernel": lib.ssd_blocks_per_sm(1, 128),
                        "ssd_state_pass_wgmma_kernel":
                            lib.ssd_blocks_per_sm(2, 128),
                        "ssd_chunk_kernel_n16": lib.ssd_blocks_per_sm(3, 16),
                        "ssd_chunk_wgmma_n16_kernel":
                            lib.ssd_blocks_per_sm(4, 16),
                        "ssd_state_pass_wgmma_kernel_n16":
                            lib.ssd_blocks_per_sm(2, 16)}}})

    seconds = {}
    t0 = time.perf_counter()
    logs = kernel_phase(dev)
    timings = full_shape_phase(dev, logs)
    seconds["kernels"] = time.perf_counter() - t0
    lines, launches = [], {}

    def main_path(label, phase, *args):
        t0 = time.perf_counter()
        out, counts = phase(dev, *args)
        seconds[label] = time.perf_counter() - t0
        lines.extend(out if isinstance(out, list) else [out])
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    for cell in CELLS:
        main_path(cell.name, sweep_phase, cell)
    # the degraded-edge and td-speedup stores stay for the sweep service
    import shutil
    import tempfile
    service_root = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        main_path(DEGRADED_EDGE.name, degraded_edge_phase, DEGRADED_EDGE,
                  os.path.join(service_root, "degraded_edge"))
        main_path("fig3", fig3_phase)
        main_path("td-speedup", td_speedup_phase,
                  os.path.join(service_root, "td_speedup"))
        main_path("sweep-service", sweep_service_phase, service_root, lines)
    finally:
        shutil.rmtree(service_root, ignore_errors=True)
    main_path("td-markov-m64", td_runtime_channel_phase)
    main_path("value-iteration", value_iteration_phase)
    t0 = time.perf_counter()
    lm_logs, lm_timings = lm_kernel_phase(dev)
    seconds["lm-kernels"] = time.perf_counter() - t0
    logs.update(lm_logs)
    timings.update(lm_timings)
    t0 = time.perf_counter()
    c_logs, c_timings = contract_phase(dev, logs["flash_attention_wgmma_f32"])
    seconds["contract"] = time.perf_counter() - t0
    logs.update(c_logs)
    timings.update(c_timings)
    for cell in SERVE_CELLS:
        main_path(cell.name, serve_phase, cell)
    t0 = time.perf_counter()
    lines.append(reduced_archs_phase(dev)[0])   # checks, not a main path
    seconds["reduced-archs"] = time.perf_counter() - t0
    for cell in TRAIN_CELLS:
        main_path(cell.name, train_phase, cell)
    # after the serving cells: comm_savings and the LM examples capture
    # CUDA graphs, and the serving cells' profiled prefills keep the
    # process they were held in before
    main_path("studies", studies_phase)
    main_path("examples", examples_phase)
    lines.append({"phase_seconds": seconds})
    kernels = kernel_lines(logs, timings, launches)
    for k in kernels:
        if k["main_path"]:
            check(k["launches"] > 0, f"{k['name']} never ran on the main path")
        else:
            check(k["launches"] == 0, f"{k['name']} ran on a main path")
    emit({"kernels": kernels})
    for line in lines:
        emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
