"""Fault-injection plane + crash-safe recovery for the port's checkpoint
path (counterpart of ``repro/faults``).

Layering (import-cycle contract): this package init re-exports only the
*injection* and *retry* halves (:mod:`repro_torch.faults.plan`,
:mod:`repro_torch.faults.retry` — stdlib/numpy only), because
``repro_torch.checkpoint`` and ``repro_torch.ckpt.sharded`` import them to host
their injection points.  The *recovery* half
(:mod:`repro_torch.faults.recovery`) imports the checkpoint modules in turn,
and the kill harness (:mod:`repro_torch.faults.harness`) sits above both —
consumers import those submodules explicitly.
"""
from repro_torch.faults.plan import (ENV_VAR, JOB_ENV_VAR, KINDS, FaultPlan,
                               FaultSpec, FiredFault, active_plan,
                               install, install_from_env, maybe_fire,
                               plans_to_env)
from repro_torch.faults.retry import (NO_RETRY, TRANSIENT_ERRNOS, RetryPolicy)

__all__ = [
    "ENV_VAR", "JOB_ENV_VAR", "KINDS", "FaultPlan", "FaultSpec",
    "FiredFault", "active_plan", "install", "install_from_env",
    "maybe_fire", "plans_to_env",
    "NO_RETRY", "TRANSIENT_ERRNOS", "RetryPolicy",
]
