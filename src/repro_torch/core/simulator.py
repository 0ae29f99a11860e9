"""Calibrated discrete-event simulator (§5: the paper's evaluation vehicle).

Replays a trace of jobs against a cluster under one of the three operation
modes (FM/DM/SM) and a scheduling policy (FIFO / aggressive backfilling),
charging the paper's measured cost structure: placement-dependent JCT
scaling (core/jct_model.py), drain-required reconfiguration (C4) with
checkpoint save/load + pod churn, and the x1.06 concurrency calibration.

``ground_truth=True`` turns the simulator into the "real testbed" stand-in
(stochastic interference instead of the constant factor) against which the
Fig. 6 parity plots validate the calibrated simulator.

The port's copy of ``repro/core/simulator.py``: the same code, with the
port's imports (the failure repack is the port's
``repro_torch.elastic.repack_on_failure``).  It is host code, plain
Python floats and numpy random streams, as in the reference.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import jct_model, policy
from repro_torch.core.job import Job, Placement
from repro_torch.core.leaves import Cluster, TpuLeaf
from repro_torch.core.modes import (CKPT_LOAD_S, POD_CHURN_S, DynamicMIG,
                                    OperationMode, PlaceResult, ReconfigPlan,
                                    make_mode)
from repro_torch.core.profiles import N_COMPUTE_SLICES, PROFILES
from repro_torch.core.scheduler import Scheduler, WaitQueue


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Seeded MTBF-style host failures for the simulator.

    Failure arrivals are exponential with mean ``mtbf_s`` (a dedicated
    rng stream, so enabling failures never perturbs the ground-truth
    interference draws).  Each arrival strikes one uniformly-chosen host
    currently running placements; every job with an instance there is
    killed: its work since the last periodic checkpoint
    (``ckpt_interval_s`` cadence) is lost and redone, it pays a
    restart-from-checkpoint charge priced by the active
    :class:`~repro_torch.core.jct_model.ReconfigCostModel`
    (``failure_restart_s`` — restore + recompile under handoffs, the
    incumbent reload constant under drains), and it is requeued.
    ``max_failures`` bounds the arrival count so a pathological
    mtbf << JCT configuration thrashes finitely instead of never
    terminating.
    """
    mtbf_s: float
    ckpt_interval_s: float = 600.0
    max_failures: int = 1000

    def __post_init__(self):
        if self.mtbf_s <= 0:
            raise ValueError("mtbf_s must be positive")
        if self.ckpt_interval_s <= 0:
            raise ValueError("ckpt_interval_s must be positive")
        if self.max_failures < 1:
            raise ValueError("max_failures must be >= 1")


@dataclasses.dataclass(frozen=True)
class ReconfigRecord:
    """One geometry-change event as the simulator charged it."""
    t: float                      # when the reconfiguration started
    kind: str                     # "reshape" | "drain" | "handoff"
    n_affected: int               # running jobs suspended by it
    charged_s: float              # total suspension charged across them
    gpu: Tuple[int, int]          # (host_id, gpu_id)


@dataclasses.dataclass
class SimResult:
    mode: str
    makespan: float
    avg_jct: float
    avg_wait: float
    avg_ext_frag_delay: float
    utilization: float
    n_reconfigs: int
    n_drains: int
    n_jobs: int
    jct_by_job: Dict[str, float]
    wait_by_job: Dict[str, float]
    # drain-vs-handoff accounting (reconfig cost model; defaults keep
    # pre-existing constructors working)
    n_handoffs: int = 0
    drain_cost_s: float = 0.0     # suspension charged under drains
    handoff_cost_s: float = 0.0   # suspension charged under handoffs
    reconfig_events: List[ReconfigRecord] = dataclasses.field(
        default_factory=list)
    # failure-recovery accounting (zero without a FailureModel)
    n_failures: int = 0           # failure events that killed >= 1 job
    n_recoveries: int = 0         # restarts-from-checkpoint consumed
    failure_lost_work_s: float = 0.0   # work redone (since-last-save)
    failure_restart_cost_s: float = 0.0
    goodput: float = 1.0          # useful / total busy job-seconds
    # fleet-scale bookkeeping (pure additions; no golden checks them):
    # heap events processed, and the time-integral of the cluster's
    # stranded-fragment score (policy.cluster_frag) — what the
    # frag-aware bake-off policies minimize
    n_events: int = 0
    frag_slice_seconds: float = 0.0    # integral of stranded frag over time
    avg_frag_slices: float = 0.0       # integral / active span


@dataclasses.dataclass
class _Running:
    job: Job
    placement: Placement
    finish_version: int = 0
    finish_at: float = 0.0        # absolute time of the live finish event
    # segment bookkeeping for failure-recovery math (a "segment" is one
    # continuous placement of the job; restarts begin a new segment)
    seg_start: float = 0.0        # when this segment started
    seg_work: float = 0.0         # JCT-scaled work seconds in the segment
    seg_overhead: float = 0.0     # drain/recovery charges inside finish_at
    seg_frac: float = 1.0         # job.remaining_frac at segment start


class Simulation:
    def __init__(self, jobs: List[Job], mode: OperationMode, *,
                 n_hosts: int = 1, gpus_per_host: int = 2,
                 scheduler: Optional[Scheduler] = None,
                 calibrate: bool = True, ground_truth: bool = False,
                 reconfig_cost: Optional[jct_model.ReconfigCostModel]
                 = None,
                 failure_model: Optional[FailureModel] = None,
                 seed: int = 0):
        self.jobs = {j.job_id: j for j in jobs}
        self.mode = mode
        self.cluster = Cluster(n_hosts=n_hosts, gpus_per_host=gpus_per_host)
        mode.setup(self.cluster)
        if isinstance(mode, DynamicMIG):
            mode.register_inference(
                [j.job_id for j in jobs if not j.train])
        self.scheduler = scheduler or Scheduler("fifo")
        self.calibrate = calibrate
        self.ground_truth = ground_truth
        self.rng = np.random.default_rng(seed)

        self.queue = WaitQueue()
        self.running: Dict[str, _Running] = {}
        self.events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.n_reconfigs = 0      # all geometry changes (C4 events)
        self.n_drains = 0         # geometry changes suspending live jobs
        self.n_handoffs = 0       # suspensions priced as handoffs instead
        self.drain_cost_s = 0.0
        self.handoff_cost_s = 0.0
        self.reconfig_records: List[ReconfigRecord] = []
        self.reconfig_cost = (reconfig_cost if reconfig_cost is not None
                              else jct_model.ReconfigCostModel())
        self.reconfig_pending: Dict[str, ReconfigPlan] = {}
        # failure plane: its own rng stream (enabling failures must not
        # perturb the ground-truth interference draws from self.rng)
        self.failure_model = failure_model
        self.failure_rng = np.random.default_rng([seed, 0xFA11])
        self.n_failures = 0
        self.n_recoveries = 0
        self.failure_lost_work_s = 0.0
        self.failure_restart_cost_s = 0.0
        self._failures_scheduled = 0
        # per-job finish-event version counters, monotone across
        # restarts: without them a stale finish event from a killed
        # segment (same job_id, version 0) would match the restarted
        # segment's fresh version-0 record and finish it early
        self._finish_versions: Dict[str, int] = {}
        self.frag_since: Dict[str, float] = {}
        self.ext_frag: Dict[str, float] = {}
        # utilization integral
        self._busy_slices = 0
        self._last_t = 0.0
        self._busy_integral = 0.0
        self._first_start: Optional[float] = None
        self._last_finish = 0.0
        self.n_events = 0
        # running placements with cross-host ("NET") transport — the JCT
        # model's concurrency term; maintained as a counter so _jct no
        # longer scans self.running per placement (O(running) x
        # O(placements) was superlinear on fleet traces)
        self._net_running = 0
        # stranded-fragment integral (policy.cluster_frag over time),
        # maintained per-host so each placement/release is O(hosts
        # touched) not O(hosts)
        self._frag_by_host = [0.0] * self.cluster.n_hosts
        self._frag_total = 0.0
        self._frag_integral = 0.0
        self._rebuild_frag()

        for j in jobs:
            self._push(j.submit_time, "arrive", j)
        if failure_model is not None:
            self._schedule_next_failure()

    # ------------------------------------------------------------ events
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, payload))

    def _advance(self, t: float) -> None:
        dt = t - self._last_t
        self._busy_integral += self._busy_slices * dt
        self._frag_integral += self._frag_total * dt
        self._last_t = t
        self.now = t

    # -------------------------------------------------- frag bookkeeping
    def _rebuild_frag(self) -> None:
        self._frag_by_host = [
            policy.stranded_frag(idle)
            for idle in self.cluster.idle_leaf_counts()]
        self._frag_total = sum(self._frag_by_host)

    def _update_frag(self, placement: Placement) -> None:
        """Refresh the stranded-frag contribution of every host the
        placement touches (idle counts changed there)."""
        for h in {i.host_id for i in placement.instances}:
            new = policy.stranded_frag(self.cluster.idle_leaf_count(h))
            self._frag_total += new - self._frag_by_host[h]
            self._frag_by_host[h] = new

    # --------------------------------------------------------------- run
    def run(self) -> SimResult:
        while self.events:
            t, _, kind, payload = heapq.heappop(self.events)
            self.n_events += 1
            self._advance(t)
            if kind == "arrive":
                self.queue.push(payload)
            elif kind == "finish":
                job_id, version = payload
                rec = self.running.get(job_id)
                if rec is None or rec.finish_version != version:
                    continue        # stale (rescheduled by a drain)
                self._finish(rec)
            elif kind == "reconfig_done":
                self._reconfig_done(payload)
            elif kind == "failure":
                self._host_failure()
            self._schedule_pass()
        return self._result()

    # ---------------------------------------------------------- placement
    def _schedule_pass(self) -> None:
        placed_any = True
        while placed_any:
            placed_any = False
            # the cluster is immutable until a candidate places, which
            # restarts the while-loop — so the idle-slice sum is computed
            # at most once per round instead of per blocked candidate
            # (quadratic on large traces otherwise)
            idle_slices: Optional[int] = None
            # per-tenant device usage, computed only when the scheduler
            # is armed with quotas (the default replay path never builds
            # it, keeping the quota-free simulator bit-identical)
            usage: Optional[Dict[str, int]] = None
            if self.scheduler.quotas:
                usage = {}
                for rec in self.running.values():
                    usage[rec.job.tenant] = (
                        usage.get(rec.job.tenant, 0) + rec.job.size)
            for job in list(self.scheduler.candidates(self.queue,
                                                      usage=usage)):
                res = self.mode.try_place(job, self.cluster)
                if isinstance(res, Placement):
                    self.queue.remove(job)
                    self._note_frag_end(job)
                    self._start(job, res)
                    placed_any = True
                    break           # re-evaluate candidates from the top
                if isinstance(res, ReconfigPlan):
                    self.queue.remove(job)
                    self._note_frag_end(job)
                    self._start_reconfig(res)
                    placed_any = True
                    break
                if idle_slices is None:
                    idle_slices = self._idle_slice_sum()
                self._note_frag(job, idle_slices)
                if self.scheduler.policy == "fifo":
                    break

    def _idle_slice_sum(self) -> int:
        # cluster-cached totals: the per-instance scan here was charged
        # once per blocked scheduling pass — O(events x leaves) overall
        idle = self.cluster.idle_sm_slices()
        if self.mode.name == "DM":
            idle += self.cluster.free_compute_total()
        return idle

    def _note_frag(self, job: Job, idle_slices: int) -> None:
        """External-fragmentation bookkeeping: enough idle capacity in
        total, but no placement (I2)."""
        blocked_with_capacity = idle_slices >= job.size
        if blocked_with_capacity and job.job_id not in self.frag_since:
            self.frag_since[job.job_id] = self.now
        elif not blocked_with_capacity and job.job_id in self.frag_since:
            self._note_frag_end(job)

    def _note_frag_end(self, job: Job) -> None:
        t0 = self.frag_since.pop(job.job_id, None)
        if t0 is not None:
            self.ext_frag[job.job_id] = (self.ext_frag.get(job.job_id, 0.0)
                                         + (self.now - t0))

    def _jct(self, job: Job, placement: Placement) -> float:
        if placement.one_to_one:
            inst = placement.instances[0]
            view = jct_model.PlacementView(
                (inst.profile,), (1,), "NONE",
                sm_slices=PROFILES[inst.profile].sm_slices)
        else:
            view = jct_model.PlacementView(
                placement.instance_types(), placement.leaves_per_gpu(),
                placement.transport,
                concurrent_net_jobs=self._net_running + 1)
        scale = jct_model.jct_scale(job.model, job.batch, job.size, view,
                                    train=job.train)
        base = job.base_duration * scale
        concurrent = bool(self.running)
        if self.ground_truth:
            return jct_model.interference_ground_truth(
                base, concurrent=concurrent, rng=self.rng)
        return jct_model.calibrated(base, concurrent=concurrent,
                                    calibrate=self.calibrate)

    def _start(self, job: Job, placement: Placement) -> None:
        if job.start_time is None:    # set-once: restarts keep the
            job.start_time = self.now  # original wait-time accounting
        if self._first_start is None:
            self._first_start = self.now
        # a restarted job reruns only its unsaved remainder; the restart
        # charge (restore + recompile, priced at failure time) is paid
        # now, when the job actually reoccupies resources
        work = self._jct(job, placement) * job.remaining_frac
        recovery = job.pending_recovery_s
        if recovery:
            self.n_recoveries += 1
            self.failure_restart_cost_s += recovery
            job.suspended_overhead += recovery
            job.pending_recovery_s = 0.0
        version = self._finish_versions.get(job.job_id, 0)
        rec = _Running(job, placement, finish_version=version,
                       finish_at=self.now + work + recovery,
                       seg_start=self.now, seg_work=work,
                       seg_overhead=recovery, seg_frac=job.remaining_frac)
        self.running[job.job_id] = rec
        self._busy_slices += sum(PROFILES[i.profile].sm_slices
                                 for i in placement.instances)
        if placement.transport == "NET":
            self._net_running += 1
        self._update_frag(placement)
        self._push(rec.finish_at, "finish", (job.job_id, version))

    def _finish(self, rec: _Running) -> None:
        job = rec.job
        job.finish_time = self.now
        self._last_finish = max(self._last_finish, self.now)
        self._busy_slices -= sum(PROFILES[i.profile].sm_slices
                                 for i in rec.placement.instances)
        if rec.placement.transport == "NET":
            self._net_running -= 1
        self.mode.release(rec.placement, self.cluster)
        self._update_frag(rec.placement)
        del self.running[job.job_id]

    # ------------------------------------------------------ reconfig (DM)
    def _start_reconfig(self, plan: ReconfigPlan) -> None:
        cm = self.reconfig_cost
        handoff = cm.mode == "handoff"
        self.n_reconfigs += 1
        if plan.affected_jobs:
            if handoff:
                self.n_handoffs += 1
            else:
                self.n_drains += 1
        gpu = self.cluster.gpus[(plan.host_id, plan.gpu_id)]
        gpu.draining = True
        # suspend affected jobs: push their finish events out by what the
        # cost model charges — the full drain duration under the
        # incumbent model, the (calibrated, measured) sharded
        # save + reshard-restore + recompile under the paper's handoff
        charged_total = 0.0
        for job_id in plan.affected_jobs:
            rec = self.running.get(job_id)
            if rec is None:
                continue
            remaining = self._remaining_until_finish(rec)
            n_ranks = max(rec.job.size, 1)
            charged = cm.job_suspension_s(
                jct_model.ckpt_state_bytes(rec.job.model),
                drain_s=plan.duration,
                n_ranks_old=n_ranks, n_ranks_new=n_ranks)
            charged_total += charged
            rec.finish_version += 1
            self._finish_versions[job_id] = rec.finish_version
            rec.job.suspended_overhead += charged
            rec.seg_overhead += charged
            rec.finish_at = self.now + remaining + charged
            self._push(rec.finish_at, "finish",
                       (job_id, rec.finish_version))
        if handoff:
            self.handoff_cost_s += charged_total
        else:
            self.drain_cost_s += charged_total
        kind = ("reshape" if not plan.affected_jobs
                else "handoff" if handoff else "drain")
        self.reconfig_records.append(ReconfigRecord(
            t=self.now, kind=kind, n_affected=len(plan.affected_jobs),
            charged_s=charged_total, gpu=(plan.host_id, plan.gpu_id)))
        done_in = cm.geometry_s(base_s=plan.base_duration,
                                drain_s=plan.duration)
        self._push(self.now + done_in, "reconfig_done", plan)

    def _remaining_until_finish(self, rec: _Running) -> float:
        """Time left on the currently-live finish event of ``rec``.

        O(1): ``finish_at`` mirrors the live (version-matching) finish
        event — stale events from earlier drains are superseded, never
        removed, so scanning the heap for it was O(events) per drained
        job."""
        return max(0.0, rec.finish_at - self.now)

    def _reconfig_done(self, plan: ReconfigPlan) -> None:
        gpu = self.cluster.gpus[(plan.host_id, plan.gpu_id)]
        gpu.draining = False
        assert isinstance(self.mode, DynamicMIG)
        placement = self.mode.apply_reconfig(plan, self.cluster)
        self._start(plan.job, placement)

    # ----------------------------------------------------- host failures
    def _schedule_next_failure(self) -> None:
        fm = self.failure_model
        if fm is None or self._failures_scheduled >= fm.max_failures:
            return
        self._failures_scheduled += 1
        dt = float(self.failure_rng.exponential(fm.mtbf_s))
        self._push(self.now + dt, "failure", None)

    def _host_failure(self) -> None:
        """One MTBF arrival: kill every placement on a random busy host.

        Each killed job loses its work since the last periodic
        checkpoint (``ckpt_interval_s`` cadence within the segment),
        carries a restart charge priced by the reconfig cost model's
        ``failure_restart_s`` (drain: the incumbent reload constant;
        handoff: the survivors' reshard-restore + recompile, capped at
        the drain figure), and goes back to the queue.  The host's
        resources return to the pool immediately — the model charges
        the *jobs* for the failure, not the hardware's repair time.
        """
        fm = self.failure_model
        if fm is None:
            return
        if any(j.finish_time is None for j in self.jobs.values()):
            self._schedule_next_failure()
        hosts = sorted({i.host_id for rec in self.running.values()
                        for i in rec.placement.instances})
        if not hosts:
            return                   # nothing running: harmless strike
        victim_host = hosts[int(self.failure_rng.integers(len(hosts)))]
        victims = [rec for rec in self.running.values()
                   if any(i.host_id == victim_host
                          for i in rec.placement.instances)]
        if not victims:
            return
        self.n_failures += 1
        cm = self.reconfig_cost
        drain_restart = CKPT_LOAD_S + POD_CHURN_S
        for rec in victims:
            job = rec.job
            # work completed this segment, net of suspension charges
            # that extended finish_at without advancing the job
            elapsed = self.now - rec.seg_start
            done = min(max(elapsed - rec.seg_overhead, 0.0),
                       rec.seg_work)
            saved = (done // fm.ckpt_interval_s) * fm.ckpt_interval_s
            lost = done - saved
            self.failure_lost_work_s += lost
            if rec.seg_work > 0:
                job.remaining_frac = rec.seg_frac * (
                    1.0 - saved / rec.seg_work)
            job.n_failures += 1
            # how many ranks reshard-restore concurrently: repack the
            # job's leaves around the dead host (the runtime's
            # elastic.repack_on_failure policy); no viable repack means
            # a full same-width restart once resources free up
            from repro_torch.elastic import repack_on_failure
            leaves, chip = [], {}
            for i in rec.placement.instances:
                k = chip.get((i.host_id, i.gpu_id), 0)
                chip[(i.host_id, i.gpu_id)] = k + 1
                leaves.append(TpuLeaf(pod=i.host_id, host=i.gpu_id,
                                      chip=k))
            failed = sorted({(i.host_id, i.gpu_id)
                             for i in rec.placement.instances
                             if i.host_id == victim_host})
            plan = repack_on_failure(leaves, failed, model_parallel=1)
            n_ranks_new = (int(np.prod(plan.mesh_shape))
                           if plan is not None else max(job.size, 1))
            job.pending_recovery_s = cm.failure_restart_s(
                jct_model.ckpt_state_bytes(job.model),
                drain_restart_s=drain_restart,
                n_ranks_new=max(n_ranks_new, 1))
            # invalidate the live finish event and release the placement
            rec.finish_version += 1
            self._finish_versions[job.job_id] = rec.finish_version
            self._busy_slices -= sum(PROFILES[i.profile].sm_slices
                                     for i in rec.placement.instances)
            if rec.placement.transport == "NET":
                self._net_running -= 1
            self.mode.release(rec.placement, self.cluster)
            self._update_frag(rec.placement)
            del self.running[job.job_id]
            self.queue.push(job)

    # ------------------------------------------------------------ result
    def _result(self) -> SimResult:
        done = [j for j in self.jobs.values() if j.finish_time is not None]
        jcts = {j.job_id: j.finish_time - j.start_time for j in done}
        # goodput: of all job-seconds between start and finish, the
        # fraction that was neither suspension/restart overhead nor
        # work redone after a failure (1.0 on an overhead-free run)
        busy = sum(jcts.values())
        wasted = (sum(j.suspended_overhead for j in done)
                  + self.failure_lost_work_s)
        goodput = (max(0.0, busy - wasted) / busy) if busy > 0 else 1.0
        waits = {j.job_id: j.start_time - j.submit_time for j in done}
        t0 = self._first_start or 0.0
        makespan = self._last_finish - min(
            (j.submit_time for j in self.jobs.values()), default=0.0)
        total_slices = (len(self.cluster.gpus) * N_COMPUTE_SLICES)
        util_span = max(self._last_finish - t0, 1e-9)
        util = self._busy_integral / (total_slices * util_span)
        frag = list(self.ext_frag.values())
        return SimResult(
            mode=self.mode.name,
            makespan=makespan,
            avg_jct=float(np.mean(list(jcts.values()))) if jcts else 0.0,
            avg_wait=float(np.mean(list(waits.values()))) if waits else 0.0,
            avg_ext_frag_delay=float(np.mean(frag)) if frag else 0.0,
            utilization=util,
            n_reconfigs=self.n_reconfigs,
            n_drains=self.n_drains,
            n_jobs=len(done),
            jct_by_job=jcts,
            wait_by_job=waits,
            n_handoffs=self.n_handoffs,
            drain_cost_s=self.drain_cost_s,
            handoff_cost_s=self.handoff_cost_s,
            reconfig_events=list(self.reconfig_records),
            n_failures=self.n_failures,
            n_recoveries=self.n_recoveries,
            failure_lost_work_s=self.failure_lost_work_s,
            failure_restart_cost_s=self.failure_restart_cost_s,
            goodput=goodput,
            n_events=self.n_events,
            frag_slice_seconds=self._frag_integral,
            avg_frag_slices=self._frag_integral / util_span,
        )


def simulate(jobs: List[Job], mode_name: str, *, n_hosts: int = 1,
             gpus_per_host: int = 2, policy: str = "fifo",
             backfill_depth: int = 14, calibrate: bool = True,
             ground_truth: bool = False, seed: int = 0,
             round_robin: bool = True, placement: str = "default",
             reconfig_mode: Optional[str] = None,
             reconfig_cost: Optional[jct_model.ReconfigCostModel] = None,
             failure_model: Optional[FailureModel] = None,
             tenant_quotas: Optional[Dict[str, int]] = None
             ) -> SimResult:
    """Replay ``jobs`` under operation mode ``mode_name``.

    ``reconfig_mode='handoff'`` prices geometry changes with the paper's
    software-coordinated handoff instead of the drain-required cycle
    (``reconfig_cost`` supplies a calibrated
    :class:`~repro_torch.core.jct_model.ReconfigCostModel`, e.g. built by
    ``ReconfigCostModel.from_measurements`` from the handoffs
    ``repro_torch.elastic_driver`` measured; without one the default
    calibration is used).  The cost model's own mode governs the
    charging, so passing *both* arguments with disagreeing modes is an
    error rather than a silently mislabeled replay.  The default (no
    mode, no cost model) is the incumbent drain behavior, bit-identical
    to the pre-cost-model simulator.

    ``failure_model`` arms seeded MTBF host failures (see
    :class:`FailureModel`); without one the run is bit-identical to the
    failure-free simulator — the failure plane is strictly opt-in.

    ``tenant_quotas`` maps tenant -> max concurrently-held devices; a
    job whose tenant is at quota waits even when resources are free.
    Strictly opt-in like the failure plane: ``None`` (the default)
    never computes usage and replays bit-identically.

    ``placement`` selects the FM host/leaf scoring: ``"default"`` (the
    paper's most-idle + round-robin policy) or ``"frag_aware"``
    (minimum-stranded-fragmentation placement, the bake-off
    challenger).  Ignored by DM/SM, whose one-to-one model has no
    placement freedom beyond the profile rules.
    """
    import copy
    # per-job shallow copies: Job holds only immutable scalar fields, so
    # this is equivalent to the deepcopy it replaces at a fraction of
    # the cost on million-job traces (deepcopy was ~2% of a fleet run)
    jobs = [copy.copy(j) for j in jobs]
    kw: Dict[str, object] = {}
    if mode_name == "FM":
        kw = {"round_robin": round_robin, "placement": placement}
    elif placement != "default":
        raise ValueError(
            f"placement={placement!r} only applies to FM; {mode_name} "
            f"has no placement freedom")
    if reconfig_cost is None:
        reconfig_cost = jct_model.ReconfigCostModel(
            mode=reconfig_mode or "drain")
    elif reconfig_mode is not None and reconfig_cost.mode != reconfig_mode:
        raise ValueError(
            f"reconfig_mode={reconfig_mode!r} conflicts with the given "
            f"cost model's mode={reconfig_cost.mode!r}")
    sim = Simulation(jobs, make_mode(mode_name, **kw),
                     n_hosts=n_hosts, gpus_per_host=gpus_per_host,
                     scheduler=Scheduler(policy, depth=backfill_depth,
                                         quotas=tenant_quotas),
                     calibrate=calibrate, ground_truth=ground_truth,
                     reconfig_cost=reconfig_cost,
                     failure_model=failure_model, seed=seed)
    return sim.run()
