"""Static analysis: prove costed == executed before training on a plan,
port of `repro.analysis`.

Two passes over a compiled NetworkPlan:

  * lint   — pure-static consistency of the plan object itself
             (divisibility, load-bearing demotions, reshard coverage,
             memory fit, spec round-trip);
  * audit  — the collective auditor: run one real step of the plan
             (forward, backward, gradient bucket, no update) under a
             recorder, and join every collective it executed against the
             perf model's priced inventory; optionally cross-check the
             attribution against a torch.profiler trace of the step.

Entry points: NetworkPlan.audit(), `train.py --audit`,
`python -m repro_torch.launch.dryrun --audit`.
"""
from repro_torch.analysis.lint import (Finding, error_count,
                                       format_findings, lint_plan)
from repro_torch.analysis.collectives import (audit_step, meshnet_audit,
                                              plan_inventory, record)
from repro_torch.analysis.workloads import WORKLOADS, solve_workload

__all__ = [
    "Finding", "error_count", "format_findings", "lint_plan",
    "audit_step", "meshnet_audit",
    "plan_inventory", "record",
    "WORKLOADS", "solve_workload",
]
