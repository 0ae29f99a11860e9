"""Operation modes: Flex-MIG (FM), Dynamic-MIG (DM), Static-MIG (SM).

Each mode implements ``try_place`` / ``release``.  DM may answer with a
``ReconfigPlan`` — the drain-required path (C4) whose costs the simulator
charges: checkpoint save + MIG reconfigure (100-120 s, §2.3.3) + restore +
pod churn.

The port's copy of ``repro/core/modes.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from repro_torch.core import policy
from repro_torch.core.job import Job, Placement
from repro_torch.core.leaves import Cluster, GPUState
from repro_torch.core.profiles import (FLEXMIG_PARTITION, PROFILES,
                                       STATIC_PARTITION, round_up_profile)

# §2.3.3 measured overheads
RECONFIGURE_S = 110.0            # mig-manager cycle: 100-120 s end to end
CKPT_SAVE_S = 3.0                # "a few seconds" per save
CKPT_LOAD_S = 3.0
POD_CHURN_S = 4.0                # pod delete/create


@dataclasses.dataclass
class ReconfigPlan:
    """Drain-required reconfiguration of one GPU for a pending job.

    Cost structure per §2.3.3: the mig-manager reconfigure cycle (100-120 s
    end-to-end) plus, for every running job on the GPU, checkpoint save +
    load and pod delete/create churn.
    """
    host_id: int
    gpu_id: int
    job: Job
    affected_jobs: Tuple[str, ...]

    @property
    def duration(self) -> float:
        per_job = CKPT_SAVE_S + CKPT_LOAD_S + POD_CHURN_S
        return RECONFIGURE_S + per_job * len(self.affected_jobs)

    @property
    def base_duration(self) -> float:
        """The mig-manager reconfigure cycle alone — what remains of the
        geometry change when affected jobs hand off concurrently instead
        of serializing their save/load/churn into the drain."""
        return RECONFIGURE_S


PlaceResult = Union[Placement, ReconfigPlan, None]


class OperationMode:
    name = "base"
    one_to_many = False

    def setup(self, cluster: Cluster) -> None:
        raise NotImplementedError

    def try_place(self, job: Job, cluster: Cluster) -> PlaceResult:
        raise NotImplementedError

    def release(self, placement: Placement, cluster: Cluster) -> None:
        for inst in placement.instances:
            cluster.mark_idle(inst)
        if self.name == "DM":
            # dynamic mode tears idle instances down lazily at next place
            pass

    # helper -----------------------------------------------------------
    @staticmethod
    def _bind(placement: Placement, job: Job,
              cluster: Cluster) -> Placement:
        # busy flips go through the cluster so its O(hosts) idle-leaf
        # accounting stays exact (see Cluster.mark_busy)
        for inst in placement.instances:
            cluster.mark_busy(inst, job.job_id)
        return placement


class FlexMIG(OperationMode):
    """One-to-many over fixed minimal leaves (the paper's system).

    ``placement`` selects the host/leaf scoring: ``"default"`` is the
    paper's policy (most-idle host, round-robin leaves per Fig. 9);
    ``"frag_aware"`` scores candidates by the idle fragments they
    strand and takes the minimum-fragmentation feasible one
    (policy.frag_aware_choose_host / frag_aware_select_instances).
    """
    name = "FM"
    one_to_many = True

    PLACEMENTS = ("default", "frag_aware")

    def __init__(self, *, round_robin: bool = True,
                 placement: str = "default"):
        if placement not in self.PLACEMENTS:
            raise ValueError(f"unknown FM placement {placement!r}; "
                             f"one of {self.PLACEMENTS}")
        self.round_robin = round_robin
        self.placement = placement

    def setup(self, cluster: Cluster) -> None:
        cluster.partition_all(FLEXMIG_PARTITION)

    def try_place(self, job: Job, cluster: Cluster) -> PlaceResult:
        if self.placement == "frag_aware":
            host = policy.frag_aware_choose_host(cluster, job.size)
            if host is None:
                return None
            chosen = policy.frag_aware_select_instances(cluster, host,
                                                        job.size)
        else:
            host = policy.choose_host(cluster, job.size)
            if host is None:
                return None
            chosen = policy.select_instances(cluster, host, job.size,
                                             round_robin=self.round_robin)
        if chosen is None:
            return None
        transport = "NONE" if job.size == 1 else "SHM"
        return self._bind(Placement(job.job_id, chosen, transport), job,
                          cluster)


class StaticMIG(OperationMode):
    """Fixed [1g.10gb, 2g.10gb, 4g.20gb]; upgrade-to-larger rule."""
    name = "SM"
    one_to_many = False

    def setup(self, cluster: Cluster) -> None:
        cluster.partition_all(STATIC_PARTITION)

    def try_place(self, job: Job, cluster: Cluster) -> PlaceResult:
        if job.size > 4:
            return None            # unsupported by the static partition
        want = {1: "1g.10gb", 2: "2g.10gb", 3: "4g.20gb",
                4: "4g.20gb"}[job.size]
        order = {"1g.10gb": 0, "2g.10gb": 1, "4g.20gb": 2}
        # exact fit first, then any larger idle instance (MIG 2025 rule)
        candidates = [i for i in cluster.idle_instances()
                      if order[i.profile] >= order[want]]
        if not candidates:
            return None
        candidates.sort(key=lambda i: order[i.profile])
        inst = candidates[0]
        pl = Placement(job.job_id, [inst], "NONE", one_to_one=True)
        return self._bind(pl, job, cluster)


class DynamicMIG(OperationMode):
    """On-demand reconfiguration with drains (the incumbent model)."""
    name = "DM"
    one_to_many = False

    def setup(self, cluster: Cluster) -> None:
        pass                       # starts unpartitioned

    def try_place(self, job: Job, cluster: Cluster) -> PlaceResult:
        profile = round_up_profile(job.size)
        # 1. an idle instance of the right profile already exists — the
        # only drain-free path (no geometry change).
        for inst in cluster.idle_instances(profile=profile):
            if cluster.gpus[(inst.host_id, inst.gpu_id)].draining:
                continue
            pl = Placement(job.job_id, [inst], "NONE", one_to_one=True)
            return self._bind(pl, job, cluster)
        # 2. any geometry change is a mig-manager reconfigure (C4).  Prefer
        # a GPU with no running jobs (reconfig latency only, no
        # suspend/resume), else drain one whose running jobs can coexist
        # with the new profile.  Inference jobs must not be drained.
        best: Optional[ReconfigPlan] = None
        for gpu in cluster.all_gpus():
            if gpu.draining:
                continue
            if not gpu.could_fit_after_repartition(profile):
                continue
            affected = gpu.running_jobs()
            if self._has_inference(affected, cluster):
                continue
            plan = ReconfigPlan(gpu.host_id, gpu.gpu_id, job,
                                tuple(affected))
            if best is None or len(plan.affected_jobs) < \
                    len(best.affected_jobs):
                best = plan
        return best

    def apply_reconfig(self, plan: ReconfigPlan,
                       cluster: Cluster) -> Placement:
        gpu = cluster.gpus[(plan.host_id, plan.gpu_id)]
        profile = round_up_profile(plan.job.size)
        inst = gpu.repartition_for(profile, _uuid(cluster))
        cluster.invalidate_cache()   # structural: instances re-laid-out
        pl = Placement(plan.job.job_id, [inst], "NONE", one_to_one=True)
        return self._bind(pl, plan.job, cluster)

    # inference jobs cannot be drained (service interruption, §5.1)
    _inference_jobs: set = set()

    def register_inference(self, job_ids) -> None:
        self._inference_jobs = set(job_ids)

    def _has_inference(self, job_ids, cluster) -> bool:
        return any(j in self._inference_jobs for j in job_ids)


def _uuid(cluster: Cluster) -> str:
    return cluster.next_uuid()


def make_mode(name: str, **kw) -> OperationMode:
    return {"FM": FlexMIG, "DM": DynamicMIG, "SM": StaticMIG}[name](**kw)
