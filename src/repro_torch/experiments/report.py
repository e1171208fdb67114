"""Store-backed figure and report regeneration, the port's own copy of
``repro/experiments/report.py``; torch-free.

The figure studies persist their sweeps to the append-only
``SweepStore`` (tagged ``extra={"figure": ...}``); this module turns a
*cold* store back into every figure-level artifact — fig2/fig3 tradeoff
tables, the Theorem 1 validation, comm-savings accounting, heterogeneity
frontiers, the degraded-edge and TD speedup studies — as JSON rows plus
a self-contained SVG chart per artifact, keyed by spec hash.  Like
``query.py`` it is plain numpy over arrays already on disk: no torch
import, no device, no recompute (tests/test_torch_report.py asserts
torch never enters the process, that two regenerations of the same store
are byte-identical, and that the reference's committed stores render to
the reference's committed artifacts byte for byte).

    PYTHONPATH=src python -m repro_torch.experiments.report STORE --out DIR

writes ``<figure>-<spec_hash16>.json`` / ``.svg`` per artifact plus an
``index.json`` manifest, and prints the index (with a ``torch_loaded``
field, mirroring ``serve_sweeps``) to stdout.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Optional

import numpy as np

from repro_torch.core.bound import theorem1_bound
from repro_torch.experiments.store import StoredSweep, SweepStore

_INDEX = "index.json"

# Okabe-Ito-ish fixed palette: series color is a pure function of series
# index, so regenerated SVGs are byte-stable.
_PALETTE = ("#1965b0", "#dc050c", "#4eb265", "#f7a600", "#882e72",
            "#207070", "#996633", "#555555")


def _fmt(v: float) -> str:
    """Deterministic short float formatting for SVG coordinates/labels."""
    return format(float(v), ".6g")


# --------------------------------------------------------------- SVG ------


def _spread(lo: float, hi: float, log: bool) -> tuple[float, float]:
    if log:
        lo, hi = max(lo, 1e-300), max(hi, 1e-300)
        if lo == hi:
            return lo / 2.0, hi * 2.0
        return lo, hi
    if lo == hi:
        pad = abs(lo) or 1.0
        return lo - 0.05 * pad, hi + 0.05 * pad
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def _pos(v: float, lo: float, hi: float, a: float, b: float,
         log: bool) -> float:
    if log:
        v, lo, hi = np.log(max(v, 1e-300)), np.log(lo), np.log(hi)
    t = (v - lo) / (hi - lo)
    return a + t * (b - a)


def _tick_values(lo: float, hi: float, log: bool) -> list[float]:
    if log:
        return [float(v) for v in
                np.exp(np.linspace(np.log(lo), np.log(hi), 4))]
    return [float(v) for v in np.linspace(lo, hi, 4)]


def svg_chart(series: list[dict], *, title: str, xlabel: str, ylabel: str,
              xlog: bool = False, ylog: bool = False,
              width: int = 640, height: int = 420) -> str:
    """A minimal, dependency-free line chart.

    ``series`` is a list of ``{"label", "x", "y"}`` dicts; colors follow
    the fixed palette by series index and every coordinate is formatted
    deterministically, so identical inputs yield identical bytes.
    Non-finite points (and non-positive ones on log axes) are dropped.
    """
    L, R, T, B = 72, 16, 34, 48
    pts = []
    for s in series:
        keep = [(float(x), float(y)) for x, y in zip(s["x"], s["y"])
                if np.isfinite(x) and np.isfinite(y)
                and (not xlog or x > 0) and (not ylog or y > 0)]
        pts.append(keep)
    allx = [x for p in pts for x, _ in p]
    ally = [y for p in pts for _, y in p]
    if not allx:
        allx, ally = [0.0, 1.0], [0.0, 1.0]
    xlo, xhi = _spread(min(allx), max(allx), xlog)
    ylo, yhi = _spread(min(ally), max(ally), ylog)

    def X(v):
        return _pos(v, xlo, xhi, L, width - R, xlog)

    def Y(v):
        return _pos(v, ylo, yhi, height - B, T, ylog)

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" viewBox="0 0 {width} {height}" '
           'font-family="Helvetica,Arial,sans-serif" font-size="11">',
           f'<rect width="{width}" height="{height}" fill="white"/>',
           f'<text x="{width // 2}" y="18" text-anchor="middle" '
           f'font-size="13">{title}</text>']
    # axes box + ticks
    out.append(f'<rect x="{L}" y="{T}" width="{width - R - L}" '
               f'height="{height - B - T}" fill="none" stroke="#222"/>')
    for tv in _tick_values(xlo, xhi, xlog):
        x = _fmt(X(tv))
        out.append(f'<line x1="{x}" y1="{height - B}" x2="{x}" '
                   f'y2="{height - B + 4}" stroke="#222"/>')
        out.append(f'<text x="{x}" y="{height - B + 16}" '
                   f'text-anchor="middle">{_fmt(tv)}</text>')
    for tv in _tick_values(ylo, yhi, ylog):
        y = _fmt(Y(tv))
        out.append(f'<line x1="{L - 4}" y1="{y}" x2="{L}" y2="{y}" '
                   'stroke="#222"/>')
        out.append(f'<text x="{L - 7}" y="{y}" text-anchor="end" '
                   f'dominant-baseline="middle">{_fmt(tv)}</text>')
    out.append(f'<text x="{width // 2}" y="{height - 8}" '
               f'text-anchor="middle">{xlabel}</text>')
    out.append(f'<text x="14" y="{height // 2}" text-anchor="middle" '
               f'transform="rotate(-90 14 {height // 2})">{ylabel}</text>')
    # series + legend
    for i, (s, keep) in enumerate(zip(series, pts)):
        color = _PALETTE[i % len(_PALETTE)]
        if keep:
            path = " ".join(f"{_fmt(X(x))},{_fmt(Y(y))}" for x, y in keep)
            out.append(f'<polyline points="{path}" fill="none" '
                       f'stroke="{color}" stroke-width="1.5"/>')
            for x, y in keep:
                out.append(f'<circle cx="{_fmt(X(x))}" cy="{_fmt(Y(y))}" '
                           f'r="2.5" fill="{color}"/>')
        ly = T + 14 + 14 * i
        out.append(f'<line x1="{width - R - 150}" y1="{ly - 4}" '
                   f'x2="{width - R - 130}" y2="{ly - 4}" '
                   f'stroke="{color}" stroke-width="2"/>')
        out.append(f'<text x="{width - R - 125}" y="{ly}">'
                   f'{s["label"]}</text>')
    out.append("</svg>")
    return "\n".join(out) + "\n"


# ------------------------------------------------------- row building -----


def _grid_arrays(entry: StoredSweep):
    comm = entry.arrays["trace/comm_rate"]
    j = entry.arrays.get("trace/j_final", entry.arrays.get("j_final"))
    return comm, j


def figure_rows(entry: StoredSweep,
                labels: Optional[dict] = None) -> list[dict]:
    """One row per grid cell, seeds averaged — the numpy mirror of
    ``repro_torch.experiments.sweep.tradeoff_rows`` (torch-free here;
    parity is pinned by tests/test_torch_report.py).  ``labels`` maps a
    leading axis name to a list of human names for its indices (e.g.
    fig2's regimes)."""
    axes = entry.axes
    comm, j = _grid_arrays(entry)
    seed_ax = axes.index("seed")
    comm_m = comm.mean(axis=seed_ax)
    j_m = j.mean(axis=seed_ax) if j is not None else None
    kept = [a for a in axes if a != "seed"]
    modes = entry.modes
    lams = entry.lambdas
    rhos = [float(r) for r in entry.spec["rhos"]]
    labels = labels or {}
    rows = []
    for idx in np.ndindex(*comm_m.shape):
        row = {}
        for name, i in zip(kept, idx):
            if name == "mode":
                row["mode"] = modes[i]
            elif name == "lam":
                row["lam"] = lams[i]
            elif name == "rho":
                row["rho"] = rhos[i]
            elif name in labels:
                row[name] = labels[name][i]
            else:
                row[name] = int(i)
        row["comm_rate"] = float(comm_m[idx])
        if j_m is not None:
            row["J_final"] = float(j_m[idx])
            row["metric8"] = float(row["lam"] * comm_m[idx] + j_m[idx])
        rows.append(row)
    return rows


def _mean_keep(arr: np.ndarray, axes: tuple[str, ...],
               keep: tuple[str, ...]) -> np.ndarray:
    """Mean over every named axis not in ``keep`` (order preserved)."""
    out = arr
    for ax in reversed(range(len(axes))):
        if axes[ax] not in keep:
            out = out.mean(axis=ax)
    return out


# ----------------------------------------------------------- renderers ----


def render_tradeoff(entry: StoredSweep) -> dict:
    """Generic λ-tradeoff artifact: any sweep entry renders to a comm/J
    table plus the per-mode (comm → J) frontier chart."""
    rows = figure_rows(entry)
    comm, j = _grid_arrays(entry)
    c = _mean_keep(comm, entry.axes, ("mode", "lam"))
    series = []
    if j is not None:
        jm = _mean_keep(j, entry.axes, ("mode", "lam"))
        for mi, mode in enumerate(entry.modes):
            order = np.argsort(c[mi])
            series.append(dict(label=mode, x=c[mi][order].tolist(),
                               y=jm[mi][order].tolist()))
        svg = svg_chart(series, title="λ-tradeoff frontier",
                        xlabel="comm rate (eq. 7)", ylabel="final J")
    else:
        lams = entry.lambdas
        for mi, mode in enumerate(entry.modes):
            series.append(dict(label=mode, x=lams, y=c[mi].tolist()))
        svg = svg_chart(series, title="communication rate vs λ",
                        xlabel="λ", ylabel="comm rate (eq. 7)", xlog=True)
    return dict(figure="tradeoff", rows=rows, svg=svg)


def render_fig2(entry: StoredSweep) -> dict:
    """Fig. 2 (grid-MDP tradeoff): regime-labeled rows + per-(regime,
    mode) frontier."""
    regimes = entry.extra.get("regimes")
    labels = {"param_set": list(regimes)} if regimes else None
    rows = [dict(bench="fig2", **r) for r in figure_rows(entry, labels)]
    for r in rows:
        if regimes:
            r["regime"] = r.pop("param_set")
    comm, j = _grid_arrays(entry)
    keep = ("param_set", "mode", "lam")
    c, jm = (_mean_keep(a, entry.axes, keep) for a in (comm, j))
    series = []
    for pi in range(c.shape[0]):
        regime = regimes[pi] if regimes else f"param_set{pi}"
        for mi, mode in enumerate(entry.modes):
            order = np.argsort(c[pi, mi])
            series.append(dict(label=f"{regime}/{mode}",
                               x=c[pi, mi][order].tolist(),
                               y=jm[pi, mi][order].tolist()))
    svg = svg_chart(series, title="Fig. 2 — communication/learning tradeoff",
                    xlabel="comm rate (eq. 7)", ylabel="final J")
    return dict(figure="fig2", rows=rows, svg=svg)


def render_fig3(entry: StoredSweep) -> dict:
    """Fig. 3 (continuous LQ): per-panel trajectory stats recomputed from
    the stored *full* trace (weights + alphas) and the stored w*."""
    wstar = np.asarray(entry.extra["wstar"], np.float64)
    panels = entry.extra["panels"]          # [[name, lam], ...] lam-ordered
    weights = entry.arrays["trace/weights"]  # (1, L, 1, 1, N+1, n)
    alphas = entry.arrays["trace/alphas"]    # (1, L, 1, 1, N, m)
    comm, j = _grid_arrays(entry)
    N = alphas.shape[-2]
    agents = alphas.shape[-1]
    rows, series = [], []
    for li, (name, lam) in enumerate(panels):
        a = alphas[0, li, 0, 0].mean(axis=-1)            # (N,)
        w = weights[0, li, 0, 0]                         # (N+1, n)
        first_tx = int(np.argmax(a > 0)) if a.max() > 0 else N
        ks = [0, N // 4, N // 2, 3 * N // 4, N]
        w_err = [float(np.linalg.norm(w[k] - wstar)) for k in ks]
        rows.append(dict(
            bench="fig3", panel=name, lam=float(lam), agents=agents,
            comm_rate=float(comm[0, li, 0, 0].mean()),
            first_tx_iter=first_tx,
            early_rate=float(a[: N // 4].mean()),
            late_rate=float(a[3 * N // 4:].mean()),
            J_final=float(j[0, li, 0, 0].mean()),
            w_err_quarterly=w_err))
        series.append(dict(label=f"{name} (λ={_fmt(lam)})", x=ks, y=w_err))
    svg = svg_chart(series, title="Fig. 3 — ‖w_k − w*‖ per panel",
                    xlabel="iteration k", ylabel="weight error")
    return dict(figure="fig3", rows=rows, svg=svg)


def render_theorem1(entry: StoredSweep) -> dict:
    """Theorem 1 validation: metric (8) vs bound (12) per (λ, ρ), the
    empirical side from stored arrays, the bound from stored constants."""
    comm, j = _grid_arrays(entry)
    j0 = float(entry.extra["j_w0"])
    jstar = float(entry.extra["j_wstar"])
    tr_phi_g = float(entry.extra["trace_phi_g"])
    eps = float(entry.spec["eps"])
    n_iter = int(entry.spec["num_iterations"])
    lams = entry.lambdas
    rhos = [float(r) for r in entry.spec["rhos"]]
    rows = []
    for li, lam in enumerate(lams):
        for ri, rho in enumerate(rhos):
            vals = lam * comm[0, li, ri] + j[0, li, ri]      # per seed
            lhs = float(np.mean(vals))
            rhs = theorem1_bound(lam, rho, eps, n_iter, j0, jstar, tr_phi_g)
            rows.append(dict(bench="theorem1", lam=float(lam),
                             rho=round(rho, 5), lhs_empirical=lhs,
                             rhs_bound=rhs, holds=bool(lhs <= rhs),
                             slack=rhs - lhs))
    series = []
    for ri, rho in enumerate(rhos):
        series.append(dict(
            label=f"lhs ρ={round(rho, 4)}", x=lams,
            y=[r["lhs_empirical"] for r in rows if r["rho"] == round(rho, 5)]))
        series.append(dict(
            label=f"bound ρ={round(rho, 4)}", x=lams,
            y=[r["rhs_bound"] for r in rows if r["rho"] == round(rho, 5)]))
    svg = svg_chart(series, title="Theorem 1 — E[λ·comm + J] vs bound",
                    xlabel="λ", ylabel="metric (8)", xlog=True, ylog=True)
    return dict(figure="theorem1", rows=rows, svg=svg)


def render_comm_savings(entry: StoredSweep) -> dict:
    """Comm-savings accounting on the reduced LM: bytes/step saved vs λ,
    rebuilt from the stored per-λ measurements."""
    lams = entry.lambdas
    comm = np.asarray(entry.arrays["comm_rate"], np.float64)
    gated = np.asarray(entry.arrays["bytes_per_step_gated"], np.float64)
    full = np.asarray(entry.arrays["bytes_per_step_full"], np.float64)
    rows = []
    for i, lam in enumerate(lams):
        rows.append(dict(
            bench="comm_savings", lam=float(lam),
            comm_rate=float(comm[i]),
            savings_pct=float(100.0 * (1.0 - comm[i])),
            bytes_per_step_full=float(full[i]),
            bytes_per_step_gated=float(gated[i]),
            agents=int(entry.extra["agents"]),
            grad_bytes=int(entry.extra["grad_bytes"])))
    series = [dict(label="expected gated bytes/step", x=lams,
                   y=gated.tolist()),
              dict(label="worst-case bytes/step", x=lams, y=full.tolist())]
    svg = svg_chart(series, title="Gated DCN bytes per step vs λ",
                    xlabel="λ", ylabel="bytes/step")
    return dict(figure="comm_savings", rows=rows, svg=svg)


def render_heterogeneity(entries: list[StoredSweep]) -> dict:
    """Cross-entry heterogeneity frontier: one series per (fleet class,
    mode), envs and seeds averaged, with the per-class J spread across the
    garnet family as the heterogeneity signal."""
    rows, series = [], []
    for e in sorted(entries,
                    key=lambda e: (str(e.extra.get("fleet_class", "")),
                                   e.spec_hash)):
        cls = str(e.extra.get("fleet_class", e.spec_hash[:8]))
        comm, j = _grid_arrays(e)
        keep = ("mode", "lam", "rho")
        c = _mean_keep(comm, e.axes, keep)
        jm = _mean_keep(j, e.axes, keep)
        # per-env means (seeds out), then the spread across the family
        env_keep = ("env_set",) + keep
        j_env = _mean_keep(j, e.axes, env_keep)
        j_spread = j_env.std(axis=e.axes.index("env_set"))
        rhos = [float(r) for r in e.spec["rhos"]]
        for mi, mode in enumerate(e.modes):
            for ri, rho in enumerate(rhos):
                for li, lam in enumerate(e.lambdas):
                    rows.append(dict(
                        bench="heterogeneity", fleet_class=cls, mode=mode,
                        lam=float(lam), rho=rho,
                        env_instances=int(comm.shape[e.axes.index("env_set")]),
                        comm_rate=float(c[mi, li, ri]),
                        J_final=float(jm[mi, li, ri]),
                        J_env_spread=float(j_spread[mi, li, ri]),
                        metric8=float(lam * c[mi, li, ri] + jm[mi, li, ri]),
                        spec_hash=e.spec_hash))
            order = np.argsort(c[mi, :, 0])
            series.append(dict(label=f"{cls}/{mode}",
                               x=c[mi, :, 0][order].tolist(),
                               y=jm[mi, :, 0][order].tolist()))
    svg = svg_chart(series,
                    title="Heterogeneity — λ-frontier per fleet class",
                    xlabel="comm rate (eq. 7)", ylabel="final J (env mean)")
    return dict(figure="heterogeneity", rows=rows, svg=svg)


def render_degraded_edge(entry: StoredSweep) -> dict:
    """Lossy-edge channel study: attempted-vs-delivered comm rates and the
    final J per (channel, trigger, λ) cell, envs and seeds averaged.  The
    entry carries the ``channel`` grid axis (``SweepSpec.channel_sets=``)
    and ``extra["channels"]`` labels; ``trace/delivered_rate`` is the
    post-loss comm rate (comm_rate stays the trigger's *attempted* rate —
    the delivered-vs-attempted contract)."""
    labels = entry.extra.get("channels")
    comm, j = _grid_arrays(entry)
    dlv = entry.arrays.get("trace/delivered_rate")
    keep = ("channel", "mode", "lam", "rho")
    c = _mean_keep(comm, entry.axes, keep)
    d = _mean_keep(dlv, entry.axes, keep) if dlv is not None else None
    jm = _mean_keep(j, entry.axes, keep) if j is not None else None
    num_ch = comm.shape[entry.axes.index("channel")]
    env_n = (int(comm.shape[entry.axes.index("env_set")])
             if "env_set" in entry.axes else 1)
    rhos = [float(r) for r in entry.spec["rhos"]]
    rows, series = [], []
    for ci in range(num_ch):
        ch = str(labels[ci]) if labels else str(ci)
        for mi, mode in enumerate(entry.modes):
            for li, lam in enumerate(entry.lambdas):
                for ri, rho in enumerate(rhos):
                    row = dict(bench="degraded_edge", channel=ch, mode=mode,
                               lam=float(lam), rho=rho, env_instances=env_n,
                               comm_rate=float(c[ci, mi, li, ri]),
                               spec_hash=entry.spec_hash)
                    if d is not None:
                        row["delivered_rate"] = float(d[ci, mi, li, ri])
                    if jm is not None:
                        row["J_final"] = float(jm[ci, mi, li, ri])
                        row["metric8"] = float(lam * c[ci, mi, li, ri]
                                               + jm[ci, mi, li, ri])
                    rows.append(row)
            if jm is not None:
                x = (d if d is not None else c)[ci, mi, :, 0]
                order = np.argsort(x)
                series.append(dict(label=f"{ch}/{mode}",
                                   x=x[order].tolist(),
                                   y=jm[ci, mi, :, 0][order].tolist()))
    svg = svg_chart(series,
                    title="Degraded edge — delivered-comm/J frontier "
                          "per channel",
                    xlabel="delivered comm rate", ylabel="final J (env mean)")
    return dict(figure="degraded_edge", rows=rows, svg=svg)


def render_td_speedup(entries: list[StoredSweep]) -> dict:
    """Cross-entry linear-speedup study for federated TD(0): one store
    entry per fleet size m (``num_agents`` is part of the spec hash), each
    carrying a streamed ``trace/j_trajectory``.  The error estimate is the
    tail mean of J over the last ``extra["tail_frac"]`` of iterations
    (endpoint snapshots of the heavy-tailed J process are too noisy to
    show the 1/m trend), envs and seeds averaged.  Linear speedup reads
    two ways in the rows: ``speedup_vs_m1`` ~ m and ``error_x_m``
    collapsing to a constant across m."""
    ents = sorted(entries, key=lambda e: int(e.extra["m"]))
    ms, err = [], {}                       # err[mode] -> [per-m tail error]
    modes = ents[0].modes if ents else ()
    for e in ents:
        m = int(e.extra["m"])
        jt = np.asarray(e.arrays["trace/j_trajectory"], np.float64)
        tail_frac = float(e.extra.get("tail_frac", 0.25))
        n = jt.shape[-1]
        tail = jt[..., n - max(1, int(round(tail_frac * n))):].mean(axis=-1)
        per_mode = _mean_keep(tail, e.axes, ("mode",))
        ms.append(m)
        for mi, mode in enumerate(e.modes):
            err.setdefault(mode, []).append(float(per_mode[mi]))
    rows, series = [], []
    for mode in modes:
        base = err[mode][0] * ms[0]        # m-normalized baseline error
        for i, m in enumerate(ms):
            e_m = err[mode][i]
            rows.append(dict(
                bench="td_speedup", m=m, mode=mode, tail_error=e_m,
                error_x_m=e_m * m, speedup_vs_m1=base / (e_m * ms[0]),
                env_instances=int(ents[i].arrays["trace/comm_rate"].shape[
                    ents[i].axes.index("env_set")])
                if "env_set" in ents[i].axes else 1,
                spec_hash=ents[i].spec_hash))
        series.append(dict(label=f"{mode} error", x=ms, y=err[mode]))
    for mode in modes:
        series.append(dict(label=f"{mode} error×m", x=ms,
                           y=[e * m for e, m in zip(err[mode], ms)]))
    if ms:
        ideal = [err[modes[0]][0] * ms[0] / m for m in ms]
        series.append(dict(label="ideal 1/m", x=ms, y=ideal))
    svg = svg_chart(series,
                    title="Federated TD(0) — tail error vs fleet size m",
                    xlabel="agents m", ylabel="tail-mean J",
                    xlog=True, ylog=True)
    return dict(figure="td_speedup", rows=rows, svg=svg)


_RENDERERS = {
    "tradeoff": render_tradeoff,
    "fig2": render_fig2,
    "fig3": render_fig3,
    "theorem1": render_theorem1,
    "comm_savings": render_comm_savings,
    "degraded_edge": render_degraded_edge,
}

# figure tags whose entries render as ONE cross-entry artifact (the spec
# hash differs per member — fleet class, num_agents — so they cannot be
# single-entry artifacts); keyed by the hash of their sorted spec hashes
_GROUPED = {
    "heterogeneity": render_heterogeneity,
    "td_speedup": render_td_speedup,
}


# ------------------------------------------------------------ pipeline ----


def _write(path: str, text: str) -> None:
    with open(path, "w", newline="\n", encoding="utf-8") as f:
        f.write(text)


def _json_text(obj) -> str:
    return json.dumps(obj, indent=1, sort_keys=True) + "\n"


def render_entry(entry: StoredSweep) -> dict:
    """Render one store entry by its ``extra["figure"]`` tag (generic
    λ-tradeoff when untagged)."""
    kind = entry.extra.get("figure", "tradeoff")
    return _RENDERERS.get(kind, render_tradeoff)(entry)


def generate_report(store: SweepStore, out_dir: str) -> dict:
    """Regenerate every figure artifact a store backs; returns the index.

    One JSON (rows) + one SVG (chart) per artifact, named
    ``<figure>-<spec_hash16>``; entries with a ``_GROUPED`` figure tag
    (heterogeneity, td_speedup) render as a single cross-entry artifact
    per tag, keyed by the hash of their sorted spec hashes.  Output
    depends only on store contents —
    no timestamps, sorted keys — so regeneration is byte-deterministic
    (tests/test_torch_report.py).
    """
    os.makedirs(out_dir, exist_ok=True)
    entries = [store.get(h) for h in store.hashes()]
    singles = [e for e in entries
               if e.extra.get("figure") not in _GROUPED]
    artifacts = []

    def emit(art: dict, key: str, spec_hash: str, extra_meta: dict):
        stem = f"{art['figure']}-{key}"
        payload = {"figure": art["figure"], "spec_hash": spec_hash,
                   "rows": art["rows"], **extra_meta}
        _write(os.path.join(out_dir, stem + ".json"), _json_text(payload))
        _write(os.path.join(out_dir, stem + ".svg"), art["svg"])
        artifacts.append({"figure": art["figure"], "spec_hash": spec_hash,
                          "json": stem + ".json", "svg": stem + ".svg",
                          "rows": len(art["rows"])})

    for e in singles:
        emit(render_entry(e), e.spec_hash[:16], e.spec_hash,
             {"spec": e.spec})
    for fig in sorted(_GROUPED):
        group = [e for e in entries if e.extra.get("figure") == fig]
        if not group:
            continue
        members = sorted(e.spec_hash for e in group)
        key = hashlib.sha256("".join(members).encode()).hexdigest()[:16]
        emit(_GROUPED[fig](group), key, ",".join(members),
             {"members": members})
    artifacts.sort(key=lambda a: (a["figure"], a["spec_hash"]))
    index = {"store": os.path.abspath(store.root),
             "entries": len(entries), "artifacts": artifacts,
             "torch_loaded": "torch" in sys.modules}
    # the index embeds the absolute store path (useful provenance) but the
    # per-artifact files above stay location-independent
    _write(os.path.join(out_dir, _INDEX), _json_text(index))
    return index


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("store", help="SweepStore root directory")
    ap.add_argument("--out", default=None,
                    help="output dir (default: <store>/../report)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(os.path.dirname(
        os.path.abspath(args.store)), "report")
    index = generate_report(SweepStore(args.store), out)
    print(json.dumps(index, indent=1, sort_keys=True))


if __name__ == "__main__":
    main()
