"""The batched sweep engine on tensors (``repro_torch.experiments.sweep``)."""

from repro_torch.experiments.sweep import (BASE_AXES, SweepPlan, SweepResult,
                                           SweepSpec, exec_plan,
                                           finalize_sweep,
                                           matched_random_probs, plan_sweep,
                                           run_sweep, tradeoff_rows)

__all__ = ["BASE_AXES", "SweepPlan", "SweepResult", "SweepSpec", "exec_plan",
           "finalize_sweep", "matched_random_probs", "plan_sweep",
           "run_sweep", "tradeoff_rows"]
