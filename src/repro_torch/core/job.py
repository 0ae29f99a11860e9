"""Job and placement records shared by the orchestration layer.

The port's copy of ``repro/core/job.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.leaves import Instance


# priority tiers (numerically lower = more important).  Tier 0 jobs are
# latency/SLA-sensitive: the cluster runtime places them for best
# transport (single-host SHM when they fit) and lets them trigger
# consolidation repacks of lower-tier jobs; tier 1 is the default
# best-effort tier; higher numbers yield to everything above them.
TIER_HIGH = 0
TIER_NORMAL = 1

# tenant every job belongs to unless a trace says otherwise — keeps the
# single-tenant replay paths (and their goldens) bit-identical
DEFAULT_TENANT = "default"


@dataclasses.dataclass
class Job:
    job_id: str
    model: str                    # Table-1 workload name
    kind: str                     # "train" | "inference"
    size: int                     # workload size (leaves / slices)
    batch: int
    base_duration: float          # JCT on the reference placement (seconds)
    submit_time: float = 0.0

    # multi-tenancy: which tenant owns the job (per-tenant quotas are
    # enforced by the scheduler when armed) and its priority tier.
    # Defaults reproduce the single-tenant, single-tier behavior every
    # existing trace and golden replay encodes.
    tenant: str = DEFAULT_TENANT
    priority_tier: int = TIER_NORMAL

    # runtime bookkeeping
    start_time: Optional[float] = None
    finish_time: Optional[float] = None
    suspended_overhead: float = 0.0
    ckpt_bytes: float = 0.0
    # failure-recovery bookkeeping (simulator MTBF events): fraction of
    # the job's work still to run (shrinks only by checkpoint-saved
    # progress — work since the last save is lost and redone), the
    # restart charge to pay when next placed, and how often this job was
    # killed by a host failure
    remaining_frac: float = 1.0
    pending_recovery_s: float = 0.0
    n_failures: int = 0

    @property
    def train(self) -> bool:
        return self.kind == "train"


@dataclasses.dataclass
class Placement:
    job_id: str
    instances: List[Instance]
    transport: str                # "SHM" | "NET" | "NONE"
    one_to_one: bool = False

    def instance_types(self) -> Tuple[str, ...]:
        return tuple(i.profile for i in self.instances)

    def leaves_per_gpu(self) -> Tuple[int, ...]:
        counts = {}
        for inst in self.instances:
            key = (inst.host_id, inst.gpu_id)
            counts[key] = counts.get(key, 0) + 1
        return tuple(counts.values())

    def hosts(self) -> Tuple[int, ...]:
        return tuple(sorted({i.host_id for i in self.instances}))
