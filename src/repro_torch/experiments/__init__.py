"""The batched sweep engine on tensors (``repro_torch.experiments.sweep``),
its resumable runtime (``.runtime``) and the sweep store (``.store``)."""

from repro_torch.experiments.runtime import (gc_finished, run_sweep_extend,
                                             run_sweep_resumable,
                                             sweep_or_load)
from repro_torch.experiments.store import SweepStore, spec_hash
from repro_torch.experiments.sweep import (BASE_AXES, SweepPlan, SweepResult,
                                           SweepSpec, exec_plan,
                                           exec_plan_segment, finalize_sweep,
                                           matched_random_probs, plan_sweep,
                                           run_sweep, segment_shapes,
                                           tradeoff_rows)

__all__ = ["BASE_AXES", "SweepPlan", "SweepResult", "SweepSpec", "SweepStore",
           "exec_plan", "exec_plan_segment", "finalize_sweep", "gc_finished",
           "matched_random_probs", "plan_sweep", "run_sweep",
           "run_sweep_extend", "run_sweep_resumable", "segment_shapes",
           "spec_hash", "sweep_or_load", "tradeoff_rows"]
