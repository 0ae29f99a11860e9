"""Multi-tenant elastic cluster runtime — co-scheduled jobs on one
shared device pool (the port's counterpart of ``repro/cluster``).

Layers (bottom up):

- :mod:`repro_torch.cluster.pool` — the :class:`DevicePool` ledger:
  disjoint per-job device subsets, geometry-valid placements,
  fragmentation and defrag planning;
- :mod:`repro_torch.cluster.worker` — the per-segment subprocess entry
  point (one :class:`~repro_torch.elastic_driver.ElasticDriver` segment
  per child, on gloo ranks of its own);
- :mod:`repro_torch.cluster.manager` — :class:`JobManager`, one job's
  segment subprocess lifecycle (launch/poll/crash bookkeeping);
- :mod:`repro_torch.cluster.runtime` — :class:`ClusterRuntime`, the
  scheduler-driven co-scheduling loop (quotas, priority tiers, defrag
  and rebalance repacks, crash-restart, handoff-cost measurement).
"""
from repro_torch.cluster.manager import (ClusterJobSpec, JobManager,
                                         SegmentResult)
from repro_torch.cluster.pool import (Allocation, DefragMove, DevicePool,
                                      PoolError)
from repro_torch.cluster.runtime import (ClusterError, ClusterJobOutcome,
                                         ClusterRunResult, ClusterRuntime,
                                         RepackEvent)

__all__ = [
    "Allocation", "DefragMove", "DevicePool", "PoolError",
    "ClusterJobSpec", "JobManager", "SegmentResult",
    "ClusterError", "ClusterJobOutcome", "ClusterRunResult",
    "ClusterRuntime", "RepackEvent",
]
