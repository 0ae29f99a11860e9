"""Cluster resource model: hosts, GPUs, MIG instances / leaves.

The GPU state machine enforces the hardware constraints the paper builds on:
C1 (fixed profiles), C2 (tree-constrained placement) — see profiles.py — and
C3 (no cross-GPU aggregation) which is a property of *allocation*, enforced
in core/allocation.py for the one-to-one model and deliberately lifted by
the Flex-MIG one-to-many model.

Also provides the TPU-slice analogue used by the runtime layer: hosts of
4 chips, "leaves" = chips, pods of hosts (``TpuLeaf``, which the elastic
remesh plans over).

The port's copy of ``repro/core/leaves.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.profiles import (MEMORY_PER_SLICE_GB, N_COMPUTE_SLICES,
                                 N_MEMORY_SLICES, PROFILES, Profile)


@dataclasses.dataclass
class Instance:
    """A concrete MIG instance on a GPU."""
    uuid: str
    profile: str
    gpu_id: int
    host_id: int
    slices: FrozenSet[int]
    mem_slices: int
    job_id: Optional[str] = None

    @property
    def busy(self) -> bool:
        return self.job_id is not None


@dataclasses.dataclass
class GPUState:
    host_id: int
    gpu_id: int
    instances: List[Instance] = dataclasses.field(default_factory=list)
    pcie_bus_id: str = ""
    draining: bool = False        # drain-required reconfigure in flight

    def __post_init__(self):
        if not self.pcie_bus_id:
            self.pcie_bus_id = f"00:{0x40 + self.gpu_id:02X}:00.0"

    # ------------------------------------------------------------ queries
    def used_slices(self) -> FrozenSet[int]:
        out: FrozenSet[int] = frozenset()
        for inst in self.instances:
            out |= inst.slices
        return out

    def used_mem_slices(self) -> int:
        return sum(inst.mem_slices for inst in self.instances)

    def free_compute_slices(self) -> int:
        return N_COMPUTE_SLICES - len(self.used_slices())

    def free_mem_slices(self) -> int:
        return N_MEMORY_SLICES - self.used_mem_slices()

    def has_running_jobs(self) -> bool:
        return any(i.busy for i in self.instances)

    def running_jobs(self) -> List[str]:
        return [i.job_id for i in self.instances if i.busy]

    # --------------------------------------------------------- placement
    def valid_placement(self, profile: str) -> Optional[FrozenSet[int]]:
        """First tree-valid free slice-set for ``profile`` (C1+C2)."""
        p = PROFILES[profile]
        if p.mem_slices > self.free_mem_slices():
            return None
        used = self.used_slices()
        for cand in p.placements:
            if not (cand & used):
                return cand
        return None

    def create_instance(self, profile: str, uuid: str) -> Instance:
        cand = self.valid_placement(profile)
        if cand is None:
            raise RuntimeError(
                f"no tree-valid placement for {profile} on gpu {self.gpu_id}")
        inst = Instance(uuid=uuid, profile=profile, gpu_id=self.gpu_id,
                        host_id=self.host_id, slices=cand,
                        mem_slices=PROFILES[profile].mem_slices)
        self.instances.append(inst)
        return inst

    def destroy_idle_instances(self):
        self.instances = [i for i in self.instances if i.busy]

    def could_fit_after_repartition(self, profile: str) -> bool:
        """Would ``profile`` fit if idle instances were destroyed and the
        GPU repartitioned (the drain-required path, C4)?  Running jobs keep
        their profiles."""
        p = PROFILES[profile]
        running = [i for i in self.instances if i.busy]
        run_slices = sum(PROFILES[i.profile].sm_slices for i in running)
        run_mem = sum(i.mem_slices for i in running)
        if run_slices + p.sm_slices > N_COMPUTE_SLICES:
            return False
        if run_mem + p.mem_slices > N_MEMORY_SLICES:
            return False
        # conservative feasibility: try to re-lay-out running profiles plus
        # the new one on an empty tree (greedy largest-first).
        profs = sorted([i.profile for i in running] + [profile],
                       key=lambda q: -PROFILES[q].sm_slices)
        return _layout_feasible(profs)

    def repartition_for(self, profile: str, uuid: str) -> Instance:
        """Drain-style repartition: destroy idle instances, re-lay-out
        running instances, create ``profile``.  Caller accounts C4 costs."""
        running = [i for i in self.instances if i.busy]
        profs = sorted(running + [None],
                       key=lambda i: -PROFILES[i.profile].sm_slices
                       if i else -PROFILES[profile].sm_slices)
        self.instances = []
        layout = _layout([i.profile if i else profile for i in profs])
        assert layout is not None
        new_inst: Optional[Instance] = None
        for inst, slices in zip(profs, layout):
            if inst is None:
                new_inst = Instance(uuid=uuid, profile=profile,
                                    gpu_id=self.gpu_id, host_id=self.host_id,
                                    slices=slices,
                                    mem_slices=PROFILES[profile].mem_slices)
                self.instances.append(new_inst)
            else:
                inst.slices = slices
                self.instances.append(inst)
        assert new_inst is not None
        return new_inst


def _layout(profs: Sequence[str]) -> Optional[List[FrozenSet[int]]]:
    """Greedy backtracking layout of profiles onto an empty tree."""
    out: List[FrozenSet[int]] = []

    def rec(i: int, used: FrozenSet[int], mem: int) -> bool:
        if i == len(profs):
            return True
        p = PROFILES[profs[i]]
        if mem + p.mem_slices > N_MEMORY_SLICES:
            return False
        for cand in p.placements:
            if not (cand & used):
                out.append(cand)
                if rec(i + 1, used | cand, mem + p.mem_slices):
                    return True
                out.pop()
        return False

    return out if rec(0, frozenset(), 0) else None


def _layout_feasible(profs: Sequence[str]) -> bool:
    return _layout(profs) is not None


@dataclasses.dataclass
class Cluster:
    """A multi-tenant cluster: hosts x GPUs (paper testbed: 1 host, 2 GPUs).

    Scales to arbitrary host/GPU counts for the 1000-node experiments.

    Fleet-scale accounting: the cluster keeps per-host idle-leaf counts
    and idle/free slice totals as an incrementally-maintained cache so
    the scheduler hot path (host choice, idle-slice sums) is O(hosts)
    instead of O(hosts x GPUs x leaves) per query.  Busy flips MUST go
    through :meth:`mark_busy` / :meth:`mark_idle` (the operation modes
    do); structural changes (partitioning, repartition) call
    :meth:`invalidate_cache`, and the cache rebuilds lazily on next
    query.  Standalone :class:`GPUState` mutation in tests never touches
    a cluster, so it cannot go stale.
    """
    n_hosts: int = 1
    gpus_per_host: int = 2
    gpus: Dict[Tuple[int, int], GPUState] = dataclasses.field(
        default_factory=dict)
    _uuid_counter: int = 0

    def __post_init__(self):
        if not self.gpus:
            for h in range(self.n_hosts):
                for g in range(self.gpus_per_host):
                    self.gpus[(h, g)] = GPUState(host_id=h, gpu_id=g)
        self._cache_dirty = True
        self._idle_by_host: List[int] = []
        self._idle_sm_total = 0
        self._free_compute_total = 0

    # ------------------------------------------------ idle-leaf accounting
    def invalidate_cache(self) -> None:
        """Structural change (instances created/destroyed/re-laid-out):
        drop the idle accounting; it rebuilds on next query."""
        self._cache_dirty = True

    def _ensure_cache(self) -> None:
        if not self._cache_dirty:
            return
        by_host = [0] * self.n_hosts
        sm_total = 0
        free_compute = 0
        for (h, _), gpu in self.gpus.items():
            free_compute += gpu.free_compute_slices()
            for inst in gpu.instances:
                if not inst.busy:
                    by_host[h] += 1
                    sm_total += PROFILES[inst.profile].sm_slices
        self._idle_by_host = by_host
        self._idle_sm_total = sm_total
        self._free_compute_total = free_compute
        self._cache_dirty = False

    def mark_busy(self, inst: Instance, job_id: str) -> None:
        """Bind ``inst`` to a job, maintaining the idle accounting."""
        was_idle = not inst.busy
        inst.job_id = job_id
        if was_idle and not self._cache_dirty:
            self._idle_by_host[inst.host_id] -= 1
            self._idle_sm_total -= PROFILES[inst.profile].sm_slices

    def mark_idle(self, inst: Instance) -> None:
        """Release ``inst``, maintaining the idle accounting."""
        was_busy = inst.busy
        inst.job_id = None
        if was_busy and not self._cache_dirty:
            self._idle_by_host[inst.host_id] += 1
            self._idle_sm_total += PROFILES[inst.profile].sm_slices

    def idle_leaf_count(self, host: int) -> int:
        self._ensure_cache()
        return self._idle_by_host[host]

    def idle_leaf_counts(self) -> List[int]:
        """Idle leaves per host (do not mutate the returned list)."""
        self._ensure_cache()
        return self._idle_by_host

    def idle_sm_slices(self) -> int:
        """Total compute slices held by idle instances."""
        self._ensure_cache()
        return self._idle_sm_total

    def free_compute_total(self) -> int:
        """Total un-partitioned compute slices (no instance over them).
        Changes only on structural ops, never on busy flips."""
        self._ensure_cache()
        return self._free_compute_total

    def next_uuid(self) -> str:
        self._uuid_counter += 1
        return f"MIG-{self._uuid_counter:08x}"

    def host_gpus(self, host: int) -> List[GPUState]:
        return [self.gpus[(host, g)] for g in range(self.gpus_per_host)]

    def all_gpus(self) -> List[GPUState]:
        return list(self.gpus.values())

    def partition_all(self, partition: Sequence[str]):
        """Statically partition every GPU (FM / SM setup).

        Profiles are placed largest-first so tree-valid slice-sets remain
        available (e.g. 4g.20gb must claim {0..3} before 2g takes {2,3}).
        """
        ordered = sorted(partition,
                         key=lambda p: -PROFILES[p].sm_slices)
        for gpu in self.gpus.values():
            assert not gpu.instances
            for prof in ordered:
                gpu.create_instance(prof, self.next_uuid())
        self.invalidate_cache()

    def idle_instances(self, host: Optional[int] = None,
                       profile: Optional[str] = None) -> List[Instance]:
        out = []
        for (h, g), gpu in self.gpus.items():
            if host is not None and h != host:
                continue
            for inst in gpu.instances:
                if not inst.busy and (profile is None
                                      or inst.profile == profile):
                    out.append(inst)
        return out

    def total_leaves(self) -> int:
        return sum(len(g.instances) for g in self.gpus.values())


# ---------------------------------------------------------------------------
# TPU-slice analogue (runtime layer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TpuLeaf:
    """A TPU 'leaf' = one chip.  uuid plays the role of the MIG UUID."""
    pod: int
    host: int
    chip: int

    @property
    def uuid(self) -> str:
        return f"TPU-{self.pod}-{self.host}-{self.chip}"


@dataclasses.dataclass(frozen=True)
class TpuSliceTopology:
    """Pods of hosts of chips; fixed minimal leaves (the one-to-many
    flattening applied to TPU slices)."""
    n_pods: int = 2
    hosts_per_pod: int = 64
    chips_per_host: int = 4

    def leaves(self) -> List[TpuLeaf]:
        return [TpuLeaf(p, h, c)
                for p in range(self.n_pods)
                for h in range(self.hosts_per_pod)
                for c in range(self.chips_per_host)]

    @property
    def chips_per_pod(self) -> int:
        return self.hosts_per_pod * self.chips_per_host
