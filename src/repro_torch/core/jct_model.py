"""Analytic job-performance model calibrated the way the paper calibrates.

The paper measures per-workload JCTs on a real 2xA100 testbed and feeds them
to the simulator, then applies a constant x1.06 factor for concurrency
interference (§5.2).  Offline we cannot measure A100s, so the *measured JCT
table* is replaced by an analytic model with the same structure the paper's
job-level analysis exposes (§5.4):

  t_iter = t_compute(instance types) + t_comm(placement, transport)
  - compute rate scales with SM slices; 1g.10gb gives a 10-30% single-
    instance boost (size-aware prioritization evidence);
  - mixed instance types run at the slowest leaf (sync barrier);
  - all SHM traffic of a GPU's leaves shares that GPU's PCIe interface
    (bandwidth saturation -> Fig 9 placement skew);
  - NET (RDMA) bandwidth is shared cluster-wide by concurrent NET jobs
    (Fig 10b concurrency result).

Everything downstream (simulator, figures) only consumes JCT *ratios*, the
same way the paper's simulator consumes measured JCTs.

The port's copy of ``repro/core/jct_model.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# --- hardware constants (A100-40GB PCIe testbed, Appendix B) --------------
# Transport bandwidths come from the runtime layer's canonical tier table
# so this model prices the same SHM/NET cliff the collectives implement.
from repro_torch.parallel.transport import (NET_GBPS, PCIE_GBPS,  # noqa: E402
                                      SHM_STREAM_GBPS)

A100_TFLOPS = 312.0               # fp16 dense
LEAF_TFLOPS = A100_TFLOPS / 7.0   # one 1g slice
SYNC_OVERHEAD_FRAC = 0.04         # per-iteration barrier cost (of compute);
                                  # calibrated to the paper's ~4% avg one-to-
                                  # many JCT penalty (§5.3)
DDP_OVERLAP = 0.5                 # fraction of compute hiding the allreduce


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """One Table-1 workload family."""
    name: str
    params_m: float               # millions of parameters (DDP allreduce)
    gflops_per_sample: float      # forward GFLOPs per sample
    mfu: float                    # achieved fraction of leaf peak
    mem_boost: float              # 1g.10gb single-instance speedup (1.1-1.3)
    train_batches: Tuple[int, ...]
    infer_batches: Tuple[int, ...]
    train_sizes: Tuple[int, ...]
    infer_sizes: Tuple[int, ...]


# Table 1 (paper) with public param counts / FLOPs.  ``mfu`` is the
# *achieved* fraction of slice peak — single-digit for these small models
# (latency/memory-bound; exactly the underutilization premise of §1), and
# mem_boost the measured 1g.10gb single-instance band (10-30%).
WORKLOADS: Dict[str, WorkloadModel] = {
    "resnet18": WorkloadModel("resnet18", 11.7, 1.8, 0.050, 1.12,
                              (128,), (32,), (1,), (1,)),
    "resnet34": WorkloadModel("resnet34", 21.8, 3.6, 0.060, 1.14,
                              (256,), (64,), (2,), (2,)),
    "resnet50": WorkloadModel("resnet50", 25.6, 4.1, 0.070, 1.22,
                              (196, 256), (64,), (4, 6), (4,)),
    "resnet101": WorkloadModel("resnet101", 44.5, 7.8, 0.080, 1.25,
                               (256,), (), (8,), ()),
    "mobilenetv3-small": WorkloadModel("mobilenetv3-small", 2.5, 0.06,
                                       0.012, 1.10, (256, 512), (64, 128),
                                       (1, 2), (1, 2)),
    "mobilenetv3-large": WorkloadModel("mobilenetv3-large", 5.4, 0.22,
                                       0.018, 1.12, (64, 512), (32, 128),
                                       (1, 6), (1, 4)),
    "efficientnet-b0": WorkloadModel("efficientnet-b0", 5.3, 0.39, 0.025,
                                     1.15, (32, 256), (16, 64),
                                     (1, 6), (1, 4)),
    "efficientnet-b2": WorkloadModel("efficientnet-b2", 9.1, 0.68, 0.030,
                                     1.18, (32, 256), (8, 32),
                                     (1, 8), (1, 4)),
    "distilbert": WorkloadModel("distilbert", 66.0, 5.7, 0.050, 1.20,
                                (8, 64), (4, 16), (1, 6), (1, 4)),
    "bert-base": WorkloadModel("bert-base", 110.0, 11.2, 0.060, 1.28,
                               (4, 32), (2, 8), (1, 6), (1, 4)),
    "t5-small": WorkloadModel("t5-small", 60.0, 8.0, 0.050, 1.22,
                              (16, 128), (8, 32), (1, 8), (1, 4)),
}


@dataclasses.dataclass(frozen=True)
class PlacementView:
    """What the JCT model needs to know about a placement."""
    instance_types: Tuple[str, ...]          # e.g. ("1g.5gb","1g.10gb",...)
    leaves_per_gpu: Tuple[int, ...]          # e.g. (3, 3) for 3-3
    transport: str                           # "SHM" | "NET" | "NONE"
    sm_slices: Optional[int] = None          # one-to-one profile slices
    concurrent_net_jobs: int = 0


def _compute_time(w: WorkloadModel, batch: int, view: PlacementView,
                  train: bool) -> float:
    mult = 3.0 if train else 1.0             # fwd+bwd ~ 3x fwd
    flops = w.gflops_per_sample * 1e9 * batch * mult
    if view.sm_slices is not None:           # one-to-one: single instance
        rate = LEAF_TFLOPS * 1e12 * view.sm_slices * w.mfu
        return flops / rate
    n = len(view.instance_types)
    # mixed types -> barrier at the slowest leaf (paper §3.2 observation)
    boosts = [w.mem_boost if t == "1g.10gb" else 1.0
              for t in view.instance_types]
    slowest = min(boosts) if n > 1 else max(boosts)
    rate = LEAF_TFLOPS * 1e12 * w.mfu * slowest
    return flops / (rate * n)                # data-parallel split


def _comm_time(w: WorkloadModel, view: PlacementView, train: bool) -> float:
    n = len(view.instance_types)
    if view.sm_slices is not None or n <= 1:
        return 0.0
    bytes_param = w.params_m * 1e6 * 2       # fp16 grads
    if train:
        per_leaf = 2.0 * (n - 1) / n * bytes_param   # ring allreduce
    else:
        per_leaf = 0.05 * bytes_param                # result allgather
    if view.transport == "SHM":
        # every leaf's stream traverses its GPU's PCIe interface; leaves
        # sharing a GPU share that interface (Fig 9)
        worst_share = max(view.leaves_per_gpu)
        bw = min(SHM_STREAM_GBPS, PCIE_GBPS / max(worst_share, 1))
    else:                                     # NET: NIC shared by all jobs
        bw = NET_GBPS / max(1, view.concurrent_net_jobs)
    return per_leaf / (bw * 1e9)


def iteration_time(model: str, batch: int, view: PlacementView, *,
                   train: bool) -> float:
    w = WORKLOADS[model]
    comp = _compute_time(w, batch, view, train)
    comm = _comm_time(w, view, train)
    # DDP buckets overlap the allreduce with backward; only the exposed
    # remainder and a small per-iteration barrier are visible.
    exposed = max(0.0, comm - DDP_OVERLAP * comp)
    n = len(view.instance_types)
    sync = SYNC_OVERHEAD_FRAC * comp if (n > 1 and
                                         view.sm_slices is None) else 0.0
    return comp + exposed + sync


def reference_view(size: int, n_gpus: int = 2) -> PlacementView:
    """The paper's reference placement: size leaves spread evenly, SHM."""
    if size == 1:
        return PlacementView(("1g.10gb",), (1,), "NONE")
    per = [size // n_gpus] * n_gpus
    for i in range(size % n_gpus):
        per[i] += 1
    return PlacementView(("1g.5gb",) * size, tuple(per), "SHM")


def jct_scale(model: str, batch: int, size: int, view: PlacementView, *,
              train: bool) -> float:
    """JCT(view) / JCT(reference) — scales a trace's base duration."""
    ref = iteration_time(model, batch, reference_view(size), train=train)
    cur = iteration_time(model, batch, view, train=train)
    return cur / ref


# ---------------------------------------------------------------------------
# bucketed gradient-sync schedule (serial vs software-pipelined)
# ---------------------------------------------------------------------------

def bucket_sync_times(bucket_numels: Sequence[int], *, nf: int, ns: int,
                      fast_bps: float, slow_bps: float,
                      bytes_per_elem: float = 4.0,
                      slow_bytes_per_elem: Optional[float] = None
                      ) -> Tuple[List[float], List[float], List[float]]:
    """Per-bucket (fast reduce-scatter, slow hop, fast all-gather) times.

    Ring costs: the fast stages move ``(F-1)/F`` of the bucket over the
    fast tier; the slow hop all-reduces each rank's ``1/F`` shard over
    the ``ns``-way slow tier (``2(S-1)/S`` ring bytes).
    ``slow_bytes_per_elem`` prices slow-hop compression (1.0 for int8 on
    f32 buckets); either tier degenerates to zero time when its axis is
    trivial — mirroring ``hier_reduce_bucket_shards``'s identity paths.
    """
    sb = (slow_bytes_per_elem if slow_bytes_per_elem is not None
          else bytes_per_elem)
    fast_s, slow_s, drain_s = [], [], []
    for n in bucket_numels:
        full = n * bytes_per_elem
        shard = full / max(nf, 1)
        hop = (full - shard) / fast_bps if nf > 1 else 0.0
        slow = (2.0 * (n / max(nf, 1)) * sb * (ns - 1) / ns / slow_bps
                if ns > 1 else 0.0)
        fast_s.append(hop)
        slow_s.append(slow)
        drain_s.append(hop)
    return fast_s, slow_s, drain_s


def hier_sync_makespan(fast_s: Sequence[float], slow_s: Sequence[float],
                       drain_s: Sequence[float], *,
                       overlap: bool) -> float:
    """Makespan of the k-bucket hierarchical sync on a two-channel model.

    Serial: every stage of every bucket sits on the critical path.
    Overlapped: the fast tier streams reduce-scatters ahead (the
    software pipeline issues bucket i+1's before bucket i's slow hop),
    the slow tier pipelines hops back-to-back behind them, and the
    all-gathers drain in bucket order once both their shard's slow hop
    and the fast channel are free.  This is the quantity the overlapped
    train schedule exposes; ``serial - overlapped`` is the slow-tier
    latency the pipeline hides.
    """
    if not overlap:
        return float(sum(fast_s) + sum(slow_s) + sum(drain_s))
    t_fast = 0.0
    t_slow = 0.0
    slow_done = []
    for f, s in zip(fast_s, slow_s):
        t_fast += f
        t_slow = max(t_slow, t_fast) + s
        slow_done.append(t_slow)
    for d, done in zip(drain_s, slow_done):
        t_fast = max(t_fast, done) + d
    return float(max(t_fast, t_slow))


def exposed_slow_fraction(fast_s: Sequence[float],
                          slow_s: Sequence[float],
                          drain_s: Sequence[float], *,
                          overlap: bool) -> float:
    """Fraction of the slow tier's total busy time left on the critical
    path (1.0 = fully exposed, as in the serial schedule)."""
    total_slow = float(sum(slow_s))
    if total_slow <= 0.0:
        return 0.0
    span = hier_sync_makespan(fast_s, slow_s, drain_s, overlap=overlap)
    fast_busy = float(sum(fast_s) + sum(drain_s))
    return max(0.0, span - fast_busy) / total_slow


# ---------------------------------------------------------------------------
# reconfiguration cost model (drain vs software-coordinated handoff)
# ---------------------------------------------------------------------------

# fp16 params + f32 master/mu/nu per parameter — the ZeRO-1 training
# state a reconfiguring job must move (matches what the sharded
# checkpoint actually writes: repro_torch.ckpt)
STATE_BYTES_PER_PARAM = 2 + 3 * 4

# default handoff calibration: conservative local-disk rank throughput
# and a reduced-config jit recompile.  benchmarks/elastic_bench.py
# replaces these with *measured* sharded save/restore/recompile
# wallclock (ReconfigCostModel.from_measurements); the defaults only
# exist so the simulator is usable before a bench run.
DEFAULT_SAVE_BPS = 1.0e9
DEFAULT_RESTORE_BPS = 1.5e9
DEFAULT_RECOMPILE_S = 8.0
DEFAULT_COORD_S = 2.0


def ckpt_state_bytes(model: str) -> float:
    """Bytes of training state a reconfiguration must carry for one job
    of this Table-1 workload (params + ZeRO-1 f32 optimizer state)."""
    return WORKLOADS[model].params_m * 1e6 * STATE_BYTES_PER_PARAM


@dataclasses.dataclass(frozen=True)
class ReconfigCostModel:
    """Prices what a reconfiguration event charges a suspended job.

    ``mode='drain'``: the incumbent drain-required cycle (C4) — the job
    is stopped for the full :class:`~repro_torch.core.modes.ReconfigPlan`
    duration (mig-manager reconfigure + checkpoint save/load + pod
    churn), exactly what the simulator always charged.

    ``mode='handoff'``: the paper's software-coordinated handoff — each
    affected job performs a committed *sharded* save on its old (pod,
    data) mesh, reshard-restores onto the new factorization and re-jits
    (``repro_torch.elastic_driver`` executes this cycle for real).  The charge
    is ``save + restore + recompile + coordination``, parameterized by
    the job's state bytes and how many ranks share the I/O on each side
    (per-rank bytes are 1/F of the flat state), and calibrated from
    measured wallclock via :meth:`from_measurements`.

    A handoff never charges more than the drain it replaces: a
    coordinator that measures its handoff slower than a drain would
    simply drain, so the cap is part of the operational model (and the
    property the calibration tests pin).
    """

    mode: str = "drain"
    save_bps: float = DEFAULT_SAVE_BPS      # sharded save bytes/s per rank
    restore_bps: float = DEFAULT_RESTORE_BPS
    recompile_s: float = DEFAULT_RECOMPILE_S
    coord_s: float = DEFAULT_COORD_S

    def __post_init__(self):
        if self.mode not in ("drain", "handoff"):
            raise ValueError(f"unknown reconfig mode {self.mode!r}; "
                             f"known: ('drain', 'handoff')")
        if min(self.save_bps, self.restore_bps) <= 0:
            raise ValueError("save/restore throughput must be positive")

    def handoff_s(self, state_bytes: float, *, n_ranks_old: int = 1,
                  n_ranks_new: int = 1) -> float:
        """Uncapped handoff wallclock for one job's state."""
        save = state_bytes / max(n_ranks_old, 1) / self.save_bps
        restore = state_bytes / max(n_ranks_new, 1) / self.restore_bps
        return save + restore + self.recompile_s + self.coord_s

    def job_suspension_s(self, state_bytes: float, *, drain_s: float,
                         n_ranks_old: int = 1,
                         n_ranks_new: int = 1) -> float:
        """What the simulator charges one suspended job for this event."""
        if self.mode == "drain":
            return drain_s
        return min(drain_s, self.handoff_s(state_bytes,
                                           n_ranks_old=n_ranks_old,
                                           n_ranks_new=n_ranks_new))

    def failure_restart_s(self, state_bytes: float, *,
                          drain_restart_s: float,
                          n_ranks_new: int = 1) -> float:
        """What restarting one job from its last committed checkpoint
        costs after an *unplanned* failure.

        No save happens (the failed host took the in-memory state with
        it); the charge is the restore side only.  Under ``drain`` the
        incumbent stack reloads a gathered checkpoint and re-admits the
        job through the full churn path (``drain_restart_s`` — the
        simulator passes its CKPT_LOAD + churn constant); under
        ``handoff`` the survivors reshard-restore their 1/F shares and
        re-jit, capped at the drain restart for the same reason planned
        handoffs are capped (a slower recovery path would simply not be
        used).  Lost work since the last commit is charged separately
        by the simulator — it is a property of the checkpoint cadence,
        not of the recovery mechanism.
        """
        if self.mode == "drain":
            return drain_restart_s
        restore = (state_bytes / max(n_ranks_new, 1) / self.restore_bps)
        return min(drain_restart_s,
                   restore + self.recompile_s + self.coord_s)

    def geometry_s(self, *, base_s: float, drain_s: float) -> float:
        """How long the GPU geometry change blocks the *waiting* job.

        Under drains the whole per-job save/load/churn serializes with
        the mig-manager cycle (the full plan duration); under handoffs
        the affected jobs save/restore concurrently with it, so only the
        reconfigure cycle itself remains.  A handed-off job's own
        suspension is deliberately *not* floored at this cycle: the
        handoff relocates the job (sharded save, reshard-restore onto
        other resources — the cycle ``repro_torch.elastic_driver`` executes,
        where the restore lands on a different factorization), so it
        resumes as soon as its own save/restore/recompile completes,
        while the vacated GPU repartitions behind it."""
        return drain_s if self.mode == "drain" else base_s

    @classmethod
    def from_measurements(cls, measurements, *, mode: str = "handoff",
                          coord_s: float = 0.0) -> "ReconfigCostModel":
        """Calibrate from measured handoff cycles.

        ``measurements``: iterable of mappings with ``save_s``,
        ``restore_s``, ``compile_s`` and the total bytes the measuring
        process moved, ``save_bytes`` / ``restore_bytes`` (what
        :class:`repro_torch.elastic_driver.HandoffMeasurement` records).
        Throughputs are medians of per-event bytes/s — the storage
        throughput one writer achieved; :meth:`handoff_s` then divides
        each rank's 1/F share by it, projecting the measured single-host
        cycle (one process moves every rank's shards serially) onto the
        concurrent per-rank writers of a real elastic cluster.
        Recompile is the median measured re-jit wallclock plus the
        new-mesh state build (``setup_s``) — the non-I/O part of the
        cycle.
        """
        import numpy as np
        ms = [dict(m) for m in measurements]
        if not ms:
            raise ValueError("cannot calibrate from zero measurements")
        save_bps = float(np.median(
            [m["save_bytes"] / max(m["save_s"], 1e-9) for m in ms]))
        restore_bps = float(np.median(
            [m["restore_bytes"] / max(m["restore_s"], 1e-9)
             for m in ms]))
        recompile = float(np.median(
            [m["compile_s"] + m.get("setup_s", 0.0) for m in ms]))
        return cls(mode=mode, save_bps=save_bps, restore_bps=restore_bps,
                   recompile_s=recompile, coord_s=coord_s)


def summarize_by_size(measurements) -> List[Dict[str, float]]:
    """Group handoff measurements by job size — ``(state_bytes,
    n_ranks)`` — and take per-group medians.

    The cluster runtime measures handoffs across *several* co-scheduled
    jobs of different widths and model sizes; this summary is what a
    multi-size calibration reports (``BENCH_cluster.json``'s
    ``by_size``), so the dependence of save/restore/recompile wallclock
    on state bytes and rank count is visible rather than averaged away.
    Measurements are mappings shaped like
    :meth:`repro_torch.elastic_driver.HandoffMeasurement.to_dict` with
    ``n_ranks`` (``to_shape`` product) either present or derivable.
    """
    import numpy as np
    groups: Dict[Tuple[int, int], List[Dict]] = {}
    for m in measurements:
        m = dict(m)
        n_ranks = int(m.get("n_ranks")
                      or int(np.prod(m.get("to_shape", (1,)))))
        key = (int(m.get("state_bytes", 0)), n_ranks)
        groups.setdefault(key, []).append(m)
    out: List[Dict[str, float]] = []
    for (state_bytes, n_ranks), ms in sorted(groups.items()):
        med = lambda k: float(np.median([m.get(k, 0.0) for m in ms]))
        out.append({
            "state_bytes": float(state_bytes), "n_ranks": float(n_ranks),
            "n": float(len(ms)), "save_s": med("save_s"),
            "restore_s": med("restore_s"), "setup_s": med("setup_s"),
            "compile_s": med("compile_s"),
            "save_bytes": med("save_bytes"),
            "restore_bytes": med("restore_bytes"),
        })
    return out


# ---------------------------------------------------------------------------
# calibration (§5.2)
# ---------------------------------------------------------------------------

CALIBRATION_FACTOR = 1.06


def calibrated(t: float, *, concurrent: bool, calibrate: bool) -> float:
    """Apply the paper's constant concurrency-interference factor."""
    if calibrate and concurrent:
        return t * CALIBRATION_FACTOR
    return t


def interference_ground_truth(t: float, *, concurrent: bool,
                              rng) -> float:
    """'Real testbed' stand-in: mild stochastic contention (used by the
    Fig. 6 parity benchmark as the measurement the simulator is validated
    against)."""
    if not concurrent:
        return t
    return t * float(rng.uniform(1.03, 1.09))
