"""Kernel microbenchmarks on the port: each hand-written CUDA kernel
against its plain-torch version at the reference's shapes
(``benchmarks/kernels_bench.py`` on ``repro_torch``).

Four rows, the reference's kinds and fields (``us_per_call``,
``gflop_per_call``, ``max_abs_err`` / ``max_rel_err``):

* ``kernel_gain`` — ``gain_matvec`` at T 4096 x n 2048;
* ``kernel_gain_family`` — ``gain_family_stats`` at m 64 x T 1024 x n 512;
* ``kernel_flash`` — ``flash_attention``, float32, B 1, L 512, H 4,
  KVH 2, D 64 (causal);
* ``kernel_ssd`` — ``ssd_chunk_tiles``, 2 x 4 chunks of Q 128, H 4, P 64,
  N 32.

Each row also carries the plain version's time on the same inputs
(``plain_us_per_call``), the route that ran (``route``: the CUDA kernel's
name, ``plain`` on the CPU), the error the gate holds (``max_scaled_err``)
and its ``tolerance``.  Walls are medians of ``trials`` trials of
``reps`` calls, the device synchronized before each clock read.

The reference commits no ``kernels.json``, so ``gate`` holds the rows to
their own stated bounds instead of a committed schema: the gain rows
within 1e-5 of their output's scale (the largest |plain| of each output
column), flash within 3e-4 and the SSD tile within 1e-4 of |plain| + 1
(the tolerances of ``tests/test_torch_flash_attention.py`` and
``tests/test_torch_ssd.py``).  On the CPU the wrappers run their plain
versions, so there the gate checks the schema and finite numbers.

Imports numpy, the stdlib and ``repro_torch`` only.
"""

from __future__ import annotations

import math

import numpy as np

from benchmarks import torch_common as common

GAIN_TOL = 1e-5      # of the output's scale
FLASH_TOL = 3e-4     # of |plain| + 1
SSD_TOL = 1e-4       # of |plain| + 1
TOLERANCE = {"kernel_gain": GAIN_TOL, "kernel_gain_family": GAIN_TOL,
             "kernel_flash": FLASH_TOL, "kernel_ssd": SSD_TOL}
FIELDS = ("bench", "shape", "us_per_call", "plain_us_per_call",
          "gflop_per_call", "route", "max_scaled_err", "tolerance", "device")


def _scale(smoke: bool) -> dict:
    if smoke:
        return dict(matvec=(256, 256), family=(8, 128, 64),
                    flash=(1, 256, 2, 1, 64), ssd=(1, 2, 64, 2, 32, 16),
                    reps=3, trials=3)
    return dict(matvec=(4096, 2048), family=(64, 1024, 512),
                flash=(1, 512, 4, 2, 64), ssd=(2, 4, 128, 4, 64, 32),
                reps=20, trials=5)


def _scaled(got, want) -> float:
    """max |got - want| / (|want| + 1), the reference tests' scale."""
    return float(((got - want).abs() / (want.abs() + 1.0)).max())


def _of_scale(got, want, columns: bool = False) -> float:
    """max |got - want| over the largest |want| (of each last-axis column
    with ``columns``: the family's statistics differ in size)."""
    a = want.abs()
    scale = (a.reshape(-1, a.shape[-1]).amax(0) if columns else a.max())
    return float(((got - want).abs() / scale.clamp_min(1e-30)).max())


def run(smoke: bool = False, device: str = "cuda") -> list[dict]:
    import torch
    from repro_torch import resolve_device
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import gain as kgain
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    label = common.device_label(dev.type)
    cfg = _scale(smoke)
    reps, trials = cfg["reps"], cfg["trials"]
    rng = np.random.default_rng(0)

    def t(shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dev)

    rows = []

    def row(bench, shape, kernel, plain, route, gflop, errs):
        got, us = common.median_wall_us(dev, kernel, reps, trials)
        want, plain_us = common.median_wall_us(dev, plain, reps, trials)
        out = dict(bench=bench, shape=shape, us_per_call=us,
                   plain_us_per_call=plain_us, gflop_per_call=gflop,
                   route=route if cuda else "plain",
                   tolerance=TOLERANCE[bench], device=label)
        out.update(errs(got, want))
        rows.append(out)

    # gain_matvec: the paper's O(Tn) agent-side computation
    T, n = cfg["matvec"]
    phi, g = t((T, n)), t((n,))
    vec = kgain.matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr())
    row("kernel_gain", f"T{T}xn{n}", lambda: kgain.gain_matvec(phi, g),
        lambda: ref.gain_matvec_ref(phi, g),
        f"matvec_gain_kernel ({'vector' if vec else 'generic'} pass)",
        2 * T * n / 1e9,
        lambda got, want: dict(max_abs_err=float((got - want).abs().max()),
                               max_scaled_err=_of_scale(got, want)))

    # gain_family_stats: the fused sweep step's one pass over (m, T, n)
    m, Tf, nf = cfg["family"]
    phi_b, g_b, gj, pm = t((m, Tf, nf)), t((m, nf)), t((nf,)), t((nf, nf))
    flops = 2 * m * Tf * nf + 2 * m * nf ** 2 + 6 * m * nf
    row("kernel_gain_family", f"m{m}xT{Tf}xn{nf}",
        lambda: kgain.gain_family_stats(phi_b, g_b, gj, pm),
        lambda: ref.gain_family_stats_ref(phi_b, g_b, gj, pm),
        "family_stats_kernel", flops / 1e9,
        lambda got, want: dict(max_rel_err=_scaled(got, want),
                               max_scaled_err=_of_scale(got, want, True)))

    # flash attention, float32 with grouped KV heads
    B, L, H, KVH, D = cfg["flash"]
    q, k, v = t((B, L, H, D)), t((B, L, KVH, D)), t((B, L, KVH, D))
    route = kflash.cuda_route(q, k, v).kernel if cuda else "plain"
    row("kernel_flash", f"B{B}L{L}H{H}D{D}",
        lambda: kflash.flash_attention(q, k, v),
        lambda: ref.flash_attention_ref(q, k, v), route,
        2 * 2 * B * H * L * L * D / 1e9,
        lambda got, want: dict(max_abs_err=float((got - want).abs().max()),
                               max_scaled_err=_scaled(got, want)))

    # the SSD intra-chunk tile
    Bc, nc, Q, Hh, P, N = cfg["ssd"]
    dtx = t((Bc, nc, Q, Hh, P))
    cum = torch.from_numpy((-np.abs(rng.normal(size=(Bc, nc, Q, Hh)))
                            .cumsum(2) * 0.1).astype(np.float32)).to(dev)
    bm, cm = t((Bc, nc, Q, N)), t((Bc, nc, Q, N))
    route = kssd.cuda_route(dtx, cum, bm, cm).kernel if cuda else "plain"
    flops = Bc * nc * Hh * (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P)

    def ssd_errs(got, want):
        return dict(max_abs_err=max(float((a - b).abs().max())
                                    for a, b in zip(got, want)),
                    max_scaled_err=max(_scaled(a, b)
                                       for a, b in zip(got, want)))
    row("kernel_ssd", f"Q{Q}H{Hh}P{P}N{N}",
        lambda: kssd.ssd_chunk_tiles(dtx, cum, bm, cm),
        lambda: ref.ssd_chunk_ref(dtx, cum, bm, cm), route, flops / 1e9,
        ssd_errs)
    return rows


def gate(rows: list[dict]) -> list[str]:
    """Each kernel row present once, with its fields, finite numbers and
    an error within its stated tolerance."""
    out = []
    by = {r.get("bench"): r for r in rows}
    if sorted(by) != sorted(TOLERANCE) or len(rows) != len(TOLERANCE):
        out.append(f"kernels: rows {sorted(r.get('bench') for r in rows)}, "
                   f"expected one each of {sorted(TOLERANCE)}")
    for bench, r in by.items():
        missing = [f for f in FIELDS if f not in r]
        if missing:
            out.append(f"kernels: {bench} lacks {missing}")
            continue
        err_field = ("max_rel_err" if bench == "kernel_gain_family"
                     else "max_abs_err")
        nums = [r[f] for f in ("us_per_call", "plain_us_per_call",
                               "gflop_per_call", "max_scaled_err")]
        if err_field not in r:
            out.append(f"kernels: {bench} lacks {err_field}")
        elif not all(isinstance(x, (int, float)) and math.isfinite(x)
                     and x >= 0 for x in nums + [r[err_field]]):
            out.append(f"kernels: {bench} has a non-finite or negative "
                       f"number: {r}")
        elif not r["max_scaled_err"] <= TOLERANCE.get(bench, 0.0):
            out.append(f"kernels: {bench} error {r['max_scaled_err']:.3g} "
                       f"exceeds {TOLERANCE[bench]}")
    return out
