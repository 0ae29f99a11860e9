"""Wait queue + scheduling policies (§4.1.1, §5.1).

FIFO examines only the queue head; Aggressive Backfilling examines up to
``depth`` candidates (14 in the paper's configuration) and places any that
fit.  The scheduler is mode-agnostic: modes answer placement queries.

Multi-tenant extension (cluster runtime): a scheduler may be armed with
per-tenant device quotas (``quotas``) and then filters candidates whose
tenant is at quota given the caller's current ``usage``; priority tiers
(:attr:`repro_torch.core.job.Job.priority_tier`) order the candidate window
highest tier first.  Both are strictly opt-in — without quotas and with
all jobs on the default tier, ``candidates`` returns exactly what it
always returned (the ordering sort is stable), so every existing golden
replay is bit-identical.

Fleet-scale hardening: the queue used to be a bare list, making
``remove`` O(queue) and the all-default-tier check in ``candidates`` an
O(queue) scan *per scheduling pass* — together the dominant superlinear
term on million-event traces (measured: 60% of wall-clock at 8k jobs,
growing with queue depth).  The queue is now an insertion-ordered dict
keyed by ``job_id`` (O(1) push/remove, same iteration order as the list
it replaces) carrying a live count of non-default-tier members, so the
single-tier fast path peeks only ``depth`` jobs per pass.  Candidate
*order* is unchanged in every case.

The port's copy of ``repro/core/scheduler.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Optional

from repro_torch.core.job import TIER_NORMAL, Job


class WaitQueue:
    """FIFO-ordered wait queue with O(1) push/remove.

    Iteration order is insertion (submission) order, exactly as the
    plain-list implementation it replaced.  ``jobs`` materializes that
    order as a list for callers that want a snapshot (the cluster
    runtime's introspection paths); hot paths iterate instead.
    """

    def __init__(self, jobs: Optional[List[Job]] = None):
        # OrderedDict, not dict: FIFO drains delete from the FRONT, and
        # a plain dict's iteration then re-skips the dead leading slots
        # on every head() peek until a resize compacts them — measured
        # superlinear (15us/peek at 64k jobs).  OrderedDict's linked
        # list makes head access O(1) regardless of deletion history.
        self._jobs: "OrderedDict[str, Job]" = OrderedDict()
        self._n_special = 0           # members not on TIER_NORMAL
        for j in jobs or ():
            self.push(j)

    @property
    def jobs(self) -> List[Job]:
        return list(self._jobs.values())

    @property
    def has_special_tiers(self) -> bool:
        return self._n_special > 0

    def push(self, job: Job) -> None:
        if job.job_id in self._jobs:
            raise ValueError(f"{job.job_id} already queued")
        self._jobs[job.job_id] = job
        if job.priority_tier != TIER_NORMAL:
            self._n_special += 1

    def remove(self, job: Job) -> None:
        if job.job_id not in self._jobs:
            raise ValueError(f"{job.job_id} not in queue")
        del self._jobs[job.job_id]
        if job.priority_tier != TIER_NORMAL:
            self._n_special -= 1

    def head(self, n: int) -> List[Job]:
        """First ``n`` jobs in queue order without materializing the
        whole queue (the single-tier scheduling fast path)."""
        return list(itertools.islice(self._jobs.values(), n))

    def __iter__(self) -> Iterator[Job]:
        return iter(self._jobs.values())

    def __len__(self) -> int:
        return len(self._jobs)

    def __bool__(self) -> bool:
        return bool(self._jobs)


class Scheduler:
    """policy='fifo' | 'backfill'.

    ``quotas`` maps tenant -> maximum concurrently-held device count
    (job sizes).  A job whose tenant would exceed its quota is invisible
    to :meth:`candidates` for that pass; tenants without an entry are
    unrestricted.  Quota filtering only happens when the caller supplies
    ``usage`` (tenant -> devices currently held), so pure replay paths
    that never pass usage are unaffected.
    """

    def __init__(self, policy: str = "fifo", depth: int = 14,
                 quotas: Optional[Mapping[str, int]] = None):
        assert policy in ("fifo", "backfill")
        self.policy = policy
        self.depth = depth
        self.quotas: Dict[str, int] = dict(quotas) if quotas else {}

    def admissible(self, job: Job, usage: Mapping[str, int]) -> bool:
        """Would starting ``job`` keep its tenant within quota?"""
        quota = self.quotas.get(job.tenant)
        if quota is None:
            return True
        return usage.get(job.tenant, 0) + job.size <= quota

    def candidates(self, queue: WaitQueue,
                   usage: Optional[Mapping[str, int]] = None) -> List[Job]:
        if not queue:
            return []
        limit = 1 if self.policy == "fifo" else self.depth
        if usage is None or not self.quotas:
            # single-tier fast path: no full-queue scan.  With special
            # tiers present the sort must see the whole queue; it is
            # stable, so the all-default-tier outcome is unchanged (and
            # sorting an all-normal queue is the identity — the tier
            # counter only short-circuits the cost, never the order).
            if not queue.has_special_tiers:
                return queue.head(limit)
            jobs = sorted(queue, key=lambda j: j.priority_tier)
            return jobs[:limit]
        jobs = [j for j in queue if self.admissible(j, usage)]
        # highest priority tier first; stable, so the all-default-tier
        # case preserves submission order exactly (goldens unchanged)
        if any(j.priority_tier != TIER_NORMAL for j in jobs):
            jobs = sorted(jobs, key=lambda j: j.priority_tier)
        return jobs[:limit]
