"""Multi-tenant elastic cluster runtime.

:class:`ClusterRuntime` co-schedules several training jobs — each a
sequence of :mod:`repro_torch.cluster.worker` subprocesses — over ONE shared
device pool.  It closes the loop the simulator only models: the
real :class:`repro_torch.core.scheduler.Scheduler` (FIFO/backfill, per-tenant
quotas, priority tiers) decides *who* runs, the
:class:`~repro_torch.cluster.pool.DevicePool` ledger decides *where*, and the
:class:`~repro_torch.elastic_driver.ElasticDriver` segments execute the
decisions — with every repack a real committed-save → reshard-restore →
recompile handoff whose wallclock is measured and fed back to
:meth:`repro_torch.core.jct_model.ReconfigCostModel.from_measurements`.

Repacks are **geometry moves at constant width**: a job of width R only
ever moves between device subsets / (pod, data) factorizations of the
same R, because the deterministic-reduce bitwise invariant holds across
factorizations of one rank count, not across widths.  Two scheduler-
driven reasons exist, both applied at a victim's segment boundary (the
only place a committed checkpoint exists to hand off from):

- ``defrag``: a queued job is blocked by *fragmentation* (enough free
  devices, no valid placement); the policy picks a victim
  (:func:`repro_torch.core.policy.defrag_victims`) to consolidate (packed),
  freeing a placement for the blocked job — the paper's
  reconfiguration-for-admission case;
- ``rebalance``: devices freed by a departure let a running job return
  to its preferred round-robin (widest-split) placement.

Crash recovery rides the fault-recovery path: a child that dies without a
result file is relaunched with ``resume=True`` onto its current allocation,
restoring the newest committed step; namespaced fault plans
(:func:`repro_torch.faults.plan.plans_to_env`) let a test crash exactly one
tenant's job while its neighbors run on undisturbed.

The port's copy of ``repro/cluster/runtime.py``: the same code, with the
port's imports, and a failed run stops every running segment
(``JobManager.stop``) before it raises.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.policy import cluster_placement, defrag_victims
from repro_torch.core.scheduler import Scheduler, WaitQueue
from repro_torch.cluster.manager import (ClusterJobSpec, JobManager,
                                         SegmentResult)
from repro_torch.cluster.pool import DevicePool
from repro_torch.faults.plan import FaultPlan, plans_to_env


class ClusterError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class RepackEvent:
    """One executed geometry move (constant width)."""
    job_id: str
    reason: str                       # "defrag" | "rebalance"
    at_step: int                      # victim's boundary step
    from_devices: Tuple[int, ...]
    from_shape: Tuple[int, int]
    to_devices: Tuple[int, ...]
    to_shape: Tuple[int, int]
    requested_by: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("from_devices", "from_shape", "to_devices",
                  "to_shape"):
            d[k] = list(d[k])
        return d


@dataclasses.dataclass
class ClusterJobOutcome:
    job_id: str
    losses: List[float]               # stitched over segments, by step
    shapes: List[Tuple[int, int]]     # per segment
    segments: List[SegmentResult]
    restarts: int


@dataclasses.dataclass
class ClusterRunResult:
    jobs: Dict[str, ClusterJobOutcome]
    repacks: List[RepackEvent]
    # stitched cross-process handoff measurements, one per segment
    # boundary (ReconfigCostModel.from_measurements-shaped dicts)
    measurements: List[Dict[str, Any]]
    wall_s: float

    @property
    def n_repacks(self) -> int:
        return len(self.repacks)


class ClusterRuntime:
    def __init__(self, specs: Sequence[ClusterJobSpec], *,
                 pool: DevicePool, base_dir: str,
                 scheduler: Optional[Scheduler] = None,
                 rebalance: bool = True,
                 defrag: bool = True,
                 frag_aware: bool = False,
                 manager_factory=JobManager,
                 max_restarts: int = 2,
                 fault_plans: Optional[Dict[str, FaultPlan]] = None,
                 poll_s: float = 0.1,
                 timeout_s: float = 3000.0):
        ids = [s.job_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ClusterError(f"duplicate job ids in {ids}")
        for s in specs:
            if s.size > pool.n_devices:
                raise ClusterError(
                    f"{s.job_id}: width {s.size} exceeds the pool "
                    f"({pool.n_devices} devices)")
        self.specs: Dict[str, ClusterJobSpec] = {s.job_id: s
                                                 for s in specs}
        self.order = ids
        self.pool = pool
        self.base_dir = base_dir
        self.scheduler = scheduler or Scheduler("backfill", depth=8)
        self.rebalance = rebalance
        self.defrag = defrag
        # frag-aware placement scoring (policy.cluster_placement);
        # strictly opt-in: default False keeps every golden identical
        self.frag_aware = frag_aware
        self.manager_factory = manager_factory
        self.max_restarts = max_restarts
        self.fault_env = (plans_to_env(fault_plans)
                          if fault_plans else None)
        self.poll_s = poll_s
        self.timeout_s = timeout_s

        self.queue = WaitQueue()
        self.deferred: List[str] = []       # specs gated on `after`
        self.managers: Dict[str, Any] = {}
        self.started: Set[str] = set()
        self.finished: Set[str] = set()
        # victim job id -> blocked requester id; applied at the
        # victim's next segment boundary
        self.pending_defrag: Dict[str, str] = {}
        self.reserved: Set[str] = set()     # requesters awaiting defrag
        self.repacks: List[RepackEvent] = []
        self.measurements: List[Dict[str, Any]] = []

        for jid in self.order:
            after = self.specs[jid].after
            if after:
                if after not in self.specs:
                    raise ClusterError(f"{jid}: after={after!r} names "
                                       f"no submitted job")
                self.deferred.append(jid)
            else:
                self.queue.push(self.specs[jid].to_job())

    # ----------------------------------------------------------- helpers
    def _usage(self) -> Dict[str, int]:
        usage: Dict[str, int] = {}
        for jid, a in self.pool.allocs.items():
            t = self.specs[jid].tenant
            usage[t] = usage.get(t, 0) + a.size
        return usage

    def _running_jobs(self) -> List:
        return [self.specs[jid].to_job() for jid in self.order
                if jid in self.pool.allocs]

    def _placement_of(self, job) -> Tuple[str, Optional[int]]:
        return cluster_placement(job.priority_tier, job.size,
                                 self.pool.devices_per_host,
                                 frag_aware=self.frag_aware)

    def _start(self, job, devices, shape) -> None:
        jid = job.job_id
        self.pool.allocate(jid, devices, shape)
        self.queue.remove(job)
        m = self.manager_factory(self.specs[jid], self.base_dir)
        self.managers[jid] = m
        self.started.add(jid)
        m.launch(shape, fault_env=self.fault_env)

    # ---------------------------------------------------------- schedule
    def _admit_deferred(self) -> None:
        still = []
        for jid in self.deferred:
            if self.specs[jid].after in self.started:
                self.queue.push(self.specs[jid].to_job())
            else:
                still.append(jid)
        self.deferred = still

    def _schedule_pass(self) -> bool:
        self._admit_deferred()
        progress = False
        for job in list(self.scheduler.candidates(self.queue,
                                                  usage=self._usage())):
            jid = job.job_id
            if jid in self.reserved:
                continue
            strategy, span = self._placement_of(job)
            placed = self.pool.plan(job.size, strategy=strategy,
                                    require_span=span)
            if placed is not None:
                self._start(job, *placed)
                progress = True
                continue
            # blocked: is it pure fragmentation a repack can fix?
            if not self.defrag:
                continue
            if not self.pool.fragmented_for(job.size, strategy=strategy,
                                            require_span=span):
                continue
            victims = [v.job_id for v in
                       defrag_victims(self._running_jobs(), job)]
            move = self.pool.defrag_plan(jid, job.size,
                                         require_span=span,
                                         victims=victims)
            if move is not None:
                self.pending_defrag[move.victim] = jid
                self.reserved.add(jid)
        return progress

    # ---------------------------------------------------------- boundary
    def _record_boundary(self, jid: str, res: SegmentResult) -> None:
        m = self.managers[jid]
        if len(m.results) < 2:
            return
        prev = m.results[-2]
        self.measurements.append({
            "job_id": jid, "step": res.start_step,
            "from_shape": list(prev.shape),
            "to_shape": list(res.shape), "mode": "handoff",
            "save_s": prev.final_save_s,
            "save_bytes": prev.final_save_bytes,
            "restore_s": res.resume_restore_s,
            "restore_bytes": res.resume_restore_bytes,
            "setup_s": res.resume_setup_s,
            "first_step_s": res.first_step_s,
            "compile_s": max(0.0,
                             res.first_step_s - res.steady_step_s),
            "state_bytes": prev.state_bytes,
            "n_ranks": res.shape[0] * res.shape[1],
            "repack": prev.shape != res.shape,
        })

    def _apply_defrag(self, victim: str) -> bool:
        """At ``victim``'s boundary: re-validate and execute the pending
        consolidation, then admit the blocked requester."""
        rid = self.pending_defrag.pop(victim)
        self.reserved.discard(rid)
        rjob = self.specs[rid].to_job()
        if rid not in [j.job_id for j in self.queue.jobs]:
            return False                  # requester got in some other way
        _, span = self._placement_of(rjob)
        move = self.pool.defrag_plan(rid, rjob.size, require_span=span,
                                     victims=[victim])
        if move is None:
            return False                  # world changed; requeue normally
        old = self.pool.allocs[victim]
        self.pool.reassign(victim, move.victim_to.devices,
                           move.victim_to.shape)
        self.repacks.append(RepackEvent(
            job_id=victim, reason="defrag",
            at_step=self.managers[victim].done_step,
            from_devices=old.devices, from_shape=old.shape,
            to_devices=move.victim_to.devices,
            to_shape=move.victim_to.shape, requested_by=rid))
        self._start(rjob, move.requester_to.devices,
                    move.requester_to.shape)
        return True

    def _maybe_rebalance(self, jid: str) -> None:
        """At a boundary, return the job to its preferred placement if
        departures made a better *geometry* available (device moves with
        no shape change are not worth a handoff)."""
        job = self.specs[jid].to_job()
        strategy, span = self._placement_of(job)
        cur = self.pool.allocs[jid]
        placed = self.pool.plan(
            job.size, strategy=strategy, require_span=span,
            free=self.pool.free_by_host(exclude=(jid,)))
        if placed is None:
            return
        devices, shape = placed
        if shape == cur.shape:
            return
        self.pool.reassign(jid, devices, shape)
        self.repacks.append(RepackEvent(
            job_id=jid, reason="rebalance",
            at_step=self.managers[jid].done_step,
            from_devices=cur.devices, from_shape=cur.shape,
            to_devices=devices, to_shape=shape))

    def _on_segment_done(self, jid: str, res: SegmentResult) -> None:
        m = self.managers[jid]
        self._record_boundary(jid, res)
        if m.finished:
            self.pool.release(jid)
            self.finished.add(jid)
            # a pending defrag whose victim just left is moot — the
            # departure freed more than the move would have
            if jid in self.pending_defrag:
                self.reserved.discard(self.pending_defrag.pop(jid))
            return
        # segment boundary: the one place this job can change geometry
        if jid in self.pending_defrag:
            self._apply_defrag(jid)
        elif self.rebalance:
            self._maybe_rebalance(jid)
        m.launch(self.pool.allocs[jid].shape,
                 fault_env=self.fault_env)

    def _on_crash(self, jid: str, rc: int) -> None:
        m = self.managers[jid]
        if m.attempt >= self.max_restarts:
            raise ClusterError(
                f"{jid}: segment {m.segment} died (rc={rc}) "
                f"{m.attempt + 1} times; giving up.\n--- child log "
                f"---\n{m.tail_log()}")
        m.note_crash()
        # relaunch on the same allocation, resuming the newest committed
        # step (the manager never re-arms the fault plan on relaunch)
        m.launch(self.pool.allocs[jid].shape,
                 fault_env=self.fault_env)

    # --------------------------------------------------------------- run
    def _poll_once(self) -> bool:
        progress = False
        for jid, m in list(self.managers.items()):
            if jid in self.finished:
                continue
            ev = m.poll()
            if ev is None:
                continue
            progress = True
            kind, payload = ev
            if kind == "ok":
                self._on_segment_done(jid, payload)
            else:
                self._on_crash(jid, payload)
        return progress

    def _loop(self, t_start: float) -> None:
        while (self.queue or self.deferred
               or len(self.finished) < len(self.started)):
            progress = self._schedule_pass()
            progress |= self._poll_once()
            if progress:
                continue
            active = [jid for jid, m in self.managers.items()
                      if jid not in self.finished]
            if not active:
                blocked = ([j.job_id for j in self.queue.jobs]
                           + self.deferred)
                raise ClusterError(
                    f"scheduling deadlock: nothing is running and "
                    f"{blocked} cannot start (pool free="
                    f"{self.pool.free_by_host()})")
            if time.monotonic() - t_start > self.timeout_s:
                raise ClusterError(
                    f"cluster run exceeded {self.timeout_s}s "
                    f"(active={active})")
            time.sleep(self.poll_s)

    def run(self) -> ClusterRunResult:
        os.makedirs(self.base_dir, exist_ok=True)
        t_start = time.monotonic()
        try:
            self._loop(t_start)
        except BaseException:
            # a failed run leaves no segment running (a manager_factory's
            # manager may have no stop: the tests' FakeManager)
            for m in self.managers.values():
                stop = getattr(m, "stop", None)
                if stop is not None:
                    stop()
            raise

        jobs: Dict[str, ClusterJobOutcome] = {}
        for jid in self.order:
            m = self.managers[jid]
            n = self.specs[jid].n_steps
            losses: List[Optional[float]] = [None] * n
            for res in m.results:
                for i, l in enumerate(res.losses):
                    losses[res.start_step + i] = l
            missing = [i for i, l in enumerate(losses) if l is None]
            if missing:
                raise ClusterError(f"{jid}: steps {missing[:5]}... "
                                   f"never executed")
            jobs[jid] = ClusterJobOutcome(
                job_id=jid, losses=losses,
                shapes=[r.shape for r in m.results],
                segments=list(m.results), restarts=m.restarts)
        return ClusterRunResult(jobs=jobs, repacks=self.repacks,
                                measurements=self.measurements,
                                wall_s=time.monotonic() - t_start)
