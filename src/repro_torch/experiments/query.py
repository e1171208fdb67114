"""Trigger-threshold queries over cached sweep summaries, the port's own
copy of ``repro/experiments/query.py``.

The deployment question the paper answers is *"which λ?"*: what trigger
threshold hits a given communication budget, and what value-function
error it costs (Fig. 2/3, Theorem 1).  Once a sweep's summaries sit in a
``SweepStore``, those questions are table lookups plus interpolation:

* ``tradeoff_curve``  — reduce one store entry to (λ, comm rate, J) for a
  chosen trigger mode / ρ (mean over seeds and unselected leading axes).
* ``tradeoff_at``     — the (comm, J) tradeoff at an arbitrary λ, log-λ
  linearly interpolated between cached grid points.
* ``best_lambda``     — the λ meeting a communication budget with the
  best J: cached grid points plus the interpolated budget-crossing λ.
* ``pareto_front``    — the nondominated (comm, J) frontier over λ.

Everything here is plain numpy on arrays already on disk: no torch
import, no device, no recompute; ``serve_sweeps`` exposes it over HTTP.
Comm rates are per eq. 7 (mean transmit fraction); J is the exact final
objective the sweep engine attaches (``SweepResult.j_final``).  It reads
the port's entries and the reference's alike, and gives the reference's
answers on the same arrays (tests/test_torch_report.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.experiments.store import StoredSweep


@dataclasses.dataclass(frozen=True)
class TradeoffCurve:
    """One mode's λ → (comm rate, J) table, λ ascending."""

    mode: str
    rho: float
    lambdas: np.ndarray          # (L,)
    comm: np.ndarray             # (L,) mean comm rate (eq. 7)
    j: Optional[np.ndarray]      # (L,) mean final J, when the sweep had it
    spec_hash: str

    def as_rows(self) -> list[dict]:
        rows = []
        for i, lam in enumerate(self.lambdas):
            row = dict(lam=float(lam), comm_rate=float(self.comm[i]),
                       mode=self.mode, rho=self.rho)
            if self.j is not None:
                row["J"] = float(self.j[i])
            rows.append(row)
        return rows


def _reduce(arr: np.ndarray, axes: tuple[str, ...], mode_idx: int,
            rho_idx: int, select: Optional[dict]) -> np.ndarray:
    """Collapse a grid array to (L,): fix mode/rho (and any ``select``ed
    leading axis), mean over seeds and the unselected leading axes."""
    if arr.ndim != len(axes):
        raise ValueError(f"array rank {arr.ndim} != axes {axes}")
    if select:
        unknown = sorted(set(select) - set(axes))
        if unknown:
            raise KeyError(f"select names unknown axes {unknown} "
                           f"(entry has {axes})")
        reserved = sorted(set(select) & {"mode", "rho", "lam", "seed"})
        if reserved:
            raise KeyError(
                f"select cannot name the base axes {reserved}: use mode= / "
                "rho_index= (lam is the curve axis, seeds are averaged)")
    out = arr
    for ax in reversed(range(len(axes))):
        name = axes[ax]
        if name == "lam":
            continue
        if name == "mode":
            out = np.take(out, mode_idx, axis=ax)
        elif name == "rho":
            out = np.take(out, rho_idx, axis=ax)
        elif select and name in select:
            out = np.take(out, int(select[name]), axis=ax)
        else:                                   # seed + unselected leading
            out = out.mean(axis=ax)
    return out


def tradeoff_curve(entry: StoredSweep, mode: Optional[str] = None,
                   rho_index: int = 0,
                   select: Optional[dict] = None) -> TradeoffCurve:
    """Reduce a store entry to one mode's λ-tradeoff curve.

    ``mode`` defaults to ``"theoretical"`` when present (the paper's
    exact trigger), else the entry's first mode.  ``select`` fixes
    leading grid axes by index (e.g. ``{"env_set": 3}``); unselected
    leading axes and seeds are averaged.
    """
    modes = entry.modes
    if mode is None:
        mode = "theoretical" if "theoretical" in modes else modes[0]
    if mode not in modes:
        raise KeyError(f"mode {mode!r} not in entry (has {modes})")
    mi = modes.index(mode)
    rhos = [float(r) for r in entry.spec["rhos"]]
    if not 0 <= rho_index < len(rhos):
        raise IndexError(f"rho_index {rho_index} out of range ({len(rhos)})")
    comm = _reduce(entry.arrays["trace/comm_rate"], entry.axes, mi,
                   rho_index, select)
    j_arr = entry.arrays.get("trace/j_final", entry.arrays.get("j_final"))
    j = (None if j_arr is None
         else _reduce(j_arr, entry.axes, mi, rho_index, select))
    lams = np.asarray(entry.lambdas, np.float64)
    order = np.argsort(lams)
    return TradeoffCurve(
        mode=mode, rho=rhos[rho_index], lambdas=lams[order],
        comm=np.asarray(comm, np.float64)[order],
        j=None if j is None else np.asarray(j, np.float64)[order],
        spec_hash=entry.spec_hash)


def _interp_log_lam(curve: TradeoffCurve, lam: float,
                    values: np.ndarray) -> float:
    """Linear interpolation in log λ (λ grids span decades)."""
    return float(np.interp(np.log(lam), np.log(curve.lambdas), values))


def tradeoff_at(curve: TradeoffCurve, lam: float) -> dict:
    """(comm, J) at λ, interpolated between cached grid points."""
    if not np.isfinite(lam) or lam <= 0:
        raise ValueError(f"λ must be a finite positive number, got {lam}")
    lo, hi = float(curve.lambdas[0]), float(curve.lambdas[-1])
    if not lo <= lam <= hi:
        raise ValueError(
            f"λ={lam} outside the cached grid [{lo}, {hi}] — extend the "
            "sweep (run_sweep_extend) instead of extrapolating")
    # atol=0: purely relative, so tiny-magnitude λ grids never mislabel an
    # interpolated answer as a cached grid point; rtol at float32 precision
    # (curve data is float32, budget crossings land within ~1e-7 of a grid λ)
    on_grid = bool(np.any(np.isclose(curve.lambdas, lam, rtol=1e-6, atol=0)))
    out = dict(lam=float(lam), mode=curve.mode, rho=curve.rho,
               comm_rate=_interp_log_lam(curve, lam, curve.comm),
               interpolated=not on_grid)
    if curve.j is not None:
        out["J"] = _interp_log_lam(curve, lam, curve.j)
    return out


def best_lambda(curve: TradeoffCurve, comm_budget: float) -> dict:
    """The λ that meets ``comm_budget`` with the best (lowest) J.

    Candidates are the cached grid points with comm ≤ budget plus the
    interpolated λ where the comm curve crosses the budget (comm rate
    decreases as λ grows — eq. 9's threshold gates more aggressively).
    When even the largest cached λ communicates above budget the result
    carries ``feasible=False`` with that closest point.

    Feasible answers carry ``crossing_skipped``: True when the
    budget-crossing candidate was wanted (the budget falls inside the
    grid's comm range) but dropped because seed noise made the comm
    curve non-monotone — the answer is then a conservative cached grid
    point, not the exact crossing; callers can tell the two apart.
    """
    if not np.isfinite(comm_budget) or not 0 <= comm_budget <= 1:
        raise ValueError(f"comm budget must be a finite number in [0, 1], "
                         f"got {comm_budget}")
    feasible = curve.comm <= comm_budget
    if not feasible.any():
        i = int(np.argmin(curve.comm))
        out = tradeoff_at(curve, float(curve.lambdas[i]))
        out.update(feasible=False, comm_budget=comm_budget)
        return out
    candidates = [tradeoff_at(curve, float(curve.lambdas[i]))
                  for i in np.flatnonzero(feasible)]
    # The budget-crossing interpolation needs comm monotone non-increasing
    # in λ (np.interp silently returns garbage on non-monotone xp); seed
    # noise can break that, in which case the cached grid points alone
    # give the (conservative) answer — flagged via crossing_skipped.
    crossing_skipped = False
    if not feasible.all():
        if bool(np.all(np.diff(curve.comm) <= 0)):
            # clip: exp(log λ) can overshoot the grid edge by one ulp,
            # which tradeoff_at would refuse as extrapolation
            lam_star = float(np.clip(np.exp(np.interp(
                comm_budget, curve.comm[::-1], np.log(curve.lambdas)[::-1])),
                curve.lambdas[0], curve.lambdas[-1]))
            cross = tradeoff_at(curve, lam_star)
            if cross["comm_rate"] <= comm_budget * (1 + 1e-9):
                candidates.append(cross)
            else:
                crossing_skipped = True
        else:
            crossing_skipped = True
    key = ((lambda c: c["J"]) if curve.j is not None
           else (lambda c: -c["comm_rate"]))   # no J: most communicative
    best = min(candidates, key=key)
    best.update(feasible=True, comm_budget=comm_budget,
                crossing_skipped=crossing_skipped)
    return best


def best_lambda_batch(curve: TradeoffCurve,
                      comm_budgets) -> list[dict]:
    """``best_lambda`` over a budget *vector*, one vectorized numpy pass.

    Returns one dict per budget, identical to calling ``best_lambda``
    per budget (pinned by tests/test_torch_report.py) — but the feasibility
    matrix, the masked grid argmin, and the budget-crossing
    interpolation are each computed once for the whole vector, so a
    B-budget batch query costs O(B·L) numpy instead of B python-level
    candidate scans.
    """
    budgets = np.asarray(comm_budgets, np.float64).reshape(-1)
    if budgets.size == 0:
        raise ValueError("need at least one comm budget")
    # ~isfinite matters: NaN compares False against both bounds, so without
    # it a NaN budget sails through and poisons the whole vectorized pass
    bad_mask = ~np.isfinite(budgets) | (budgets < 0) | (budgets > 1)
    if np.any(bad_mask):
        bad = budgets[bad_mask][0]
        raise ValueError(f"comm budget must be a finite number in [0, 1], "
                         f"got {bad}")
    comm = curve.comm
    j = curve.j
    log_lams = np.log(curve.lambdas)
    B = budgets.size
    rows_idx = np.arange(B)

    feas = comm[None, :] <= budgets[:, None]              # (B, L)
    any_feas = feas.any(axis=1)
    all_feas = feas.all(axis=1)

    # best cached grid point per budget (same tie-breaking as the scalar
    # path: first index wins, candidates ascend in λ)
    if j is not None:
        grid_score = np.where(feas, j[None, :], np.inf)
        gi = np.argmin(grid_score, axis=1)
    else:
        grid_score = np.where(feas, comm[None, :], -np.inf)
        gi = np.argmax(grid_score, axis=1)
    gbest = grid_score[rows_idx, gi]

    # budget-crossing interpolation for every budget at once (only valid
    # on a monotone non-increasing comm curve, exactly as the scalar path)
    monotone = bool(np.all(np.diff(comm) <= 0))
    cross_ok = np.zeros(B, bool)
    lam_star = comm_at = j_at = on_grid = None
    if monotone:
        lam_star = np.clip(np.exp(np.interp(budgets, comm[::-1],
                                            log_lams[::-1])),
                           curve.lambdas[0], curve.lambdas[-1])
        log_star = np.log(lam_star)
        comm_at = np.interp(log_star, log_lams, comm)
        j_at = None if j is None else np.interp(log_star, log_lams, j)
        on_grid = np.any(np.isclose(curve.lambdas[None, :],
                                    lam_star[:, None], rtol=1e-6, atol=0),
                         axis=1)
        cross_ok = (any_feas & ~all_feas
                    & (comm_at <= budgets * (1 + 1e-9)))
    # the crossing wins only when strictly better under the scalar key
    if j is not None:
        use_cross = cross_ok & (np.where(cross_ok, j_at, np.inf) < gbest)
    else:
        use_cross = cross_ok & (np.where(cross_ok, comm_at, -np.inf) > gbest)
    skipped = any_feas & ~all_feas & ~cross_ok

    closest = int(np.argmin(comm))                        # infeasible fallback
    out = []
    for b in range(B):
        if not any_feas[b]:
            row = tradeoff_at(curve, float(curve.lambdas[closest]))
            row.update(feasible=False, comm_budget=float(budgets[b]))
        elif use_cross[b]:
            row = dict(lam=float(lam_star[b]), mode=curve.mode,
                       rho=curve.rho, comm_rate=float(comm_at[b]),
                       interpolated=not bool(on_grid[b]))
            if j is not None:
                row["J"] = float(j_at[b])
            row.update(feasible=True, comm_budget=float(budgets[b]),
                       crossing_skipped=False)
        else:
            i = int(gi[b])
            row = dict(lam=float(curve.lambdas[i]), mode=curve.mode,
                       rho=curve.rho, comm_rate=float(comm[i]),
                       interpolated=False)
            if j is not None:
                row["J"] = float(j[i])
            row.update(feasible=True, comm_budget=float(budgets[b]),
                       crossing_skipped=bool(skipped[b]))
        out.append(row)
    return out


def pareto_front(curve: TradeoffCurve) -> list[dict]:
    """Nondominated (comm rate, J) grid points, comm ascending.

    A point is kept iff no cached λ achieves both ≤ comm and ≤ J.  With
    no J in the entry the front degenerates to the full curve.
    """
    rows = curve.as_rows()
    if curve.j is None:
        return sorted(rows, key=lambda r: r["comm_rate"])
    rows.sort(key=lambda r: (r["comm_rate"], r["J"]))
    front, best_j = [], np.inf
    for r in rows:
        if r["J"] < best_j:
            front.append(r)
            best_j = r["J"]
    return front
