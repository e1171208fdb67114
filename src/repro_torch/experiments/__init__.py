"""The batched sweep engine on tensors (``repro_torch.experiments.sweep``),
its resumable runtime (``.runtime``), the sweep store (``.store``) and the
sweep service over it (``.query``, ``.report``, ``.registry``,
``.serve_sweeps``, ``.client``).

Exports resolve lazily (PEP 562), as in the reference: the torch modules
(``sweep``, ``runtime``) import only when first touched, so the serving
half stays importable without torch ever entering the process
(tests/test_torch_serving.py asserts this in a subprocess).
"""

_EXPORTS = {
    # sweep engine (torch)
    "BASE_AXES": "repro_torch.experiments.sweep",
    "SweepPlan": "repro_torch.experiments.sweep",
    "SweepResult": "repro_torch.experiments.sweep",
    "SweepSpec": "repro_torch.experiments.sweep",
    "exec_plan": "repro_torch.experiments.sweep",
    "exec_plan_segment": "repro_torch.experiments.sweep",
    "finalize_sweep": "repro_torch.experiments.sweep",
    "matched_random_probs": "repro_torch.experiments.sweep",
    "plan_sweep": "repro_torch.experiments.sweep",
    "run_sweep": "repro_torch.experiments.sweep",
    "segment_shapes": "repro_torch.experiments.sweep",
    "tradeoff_rows": "repro_torch.experiments.sweep",
    # resumable runtime (torch)
    "gc_finished": "repro_torch.experiments.runtime",
    "run_sweep_extend": "repro_torch.experiments.runtime",
    "run_sweep_resumable": "repro_torch.experiments.runtime",
    "store_result": "repro_torch.experiments.runtime",
    "sweep_or_load": "repro_torch.experiments.runtime",
    # summary store, queries and report regeneration (numpy only)
    "SweepStore": "repro_torch.experiments.store",
    "StoredSweep": "repro_torch.experiments.store",
    "family_hash": "repro_torch.experiments.store",
    "spec_hash": "repro_torch.experiments.store",
    "QueryTable": "repro_torch.experiments.registry",
    "StoreRegistry": "repro_torch.experiments.registry",
    "best_lambda": "repro_torch.experiments.query",
    "best_lambda_batch": "repro_torch.experiments.query",
    "pareto_front": "repro_torch.experiments.query",
    "tradeoff_at": "repro_torch.experiments.query",
    "tradeoff_curve": "repro_torch.experiments.query",
    "generate_report": "repro_torch.experiments.report",
    "render_entry": "repro_torch.experiments.report",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
