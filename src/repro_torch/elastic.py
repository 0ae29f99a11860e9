"""Fault tolerance & elasticity of the port (counterpart of
``repro/elastic.py``): heartbeats, stragglers, elastic re-mesh.

The one-to-many model makes elasticity natural: a job's resources are a
*set of leaves*, so losing a host shrinks the set; the job re-meshes over
the survivors and restores from the latest checkpoint onto its new grid
(``repro_torch.ckpt`` reshards on restore).  This is the runtime
counterpart of the simulator's drain-free operation (I3).  The leaves are
``repro_torch.core.leaves.TpuLeaf``, the port's copy of the reference's.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.leaves import TpuLeaf


class HeartbeatMonitor:
    """Tracks per-worker heartbeats; reports workers past the timeout."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.last: Dict[int, float] = {}

    def beat(self, worker: int, t: Optional[float] = None) -> None:
        self.last[worker] = time.time() if t is None else t

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return [w for w, t in self.last.items()
                if now - t > self.timeout_s]


class StragglerDetector:
    """Flags steps slower than median + k*MAD (straggler mitigation
    trigger: re-shard away from the slow worker / skip its contribution)."""

    def __init__(self, k: float = 5.0, window: int = 50):
        self.k = k
        self.window = window
        self.durations: List[float] = []
        self.flagged: List[int] = []

    def record(self, dt: float) -> bool:
        self.durations.append(dt)
        tail = self.durations[-self.window:]
        if len(tail) < 8:
            return False
        med = statistics.median(tail)
        # MAD floored at 5% of the median: near-constant step times must
        # not turn ordinary jitter into straggler alarms
        mad = max(statistics.median([abs(x - med) for x in tail]),
                  0.05 * med)
        slow = dt > med + self.k * mad
        if slow:
            self.flagged.append(len(self.durations) - 1)
        return slow

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {"steps": 0, "stragglers": 0}
        return {"steps": len(self.durations),
                "stragglers": len(self.flagged),
                "median_s": statistics.median(self.durations)}


@dataclasses.dataclass(frozen=True)
class CheckpointHandoff:
    """The state handoff a remesh rides on: which committed checkpoint
    the re-meshed job restores from, and how.

    ``sharded`` names the per-rank shard + manifest format
    (:mod:`repro_torch.ckpt`): each new rank reads only its own slices of the
    flat bucket address space, so the restore is drain-free — no rank
    ever gathers a full optimizer bucket while the job reconfigures.
    """

    base_dir: str
    step: int
    step_dir: str
    sharded: bool


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    surviving: Tuple[TpuLeaf, ...]
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_hosts: Tuple[Tuple[int, int], ...]
    # the checkpoint the re-meshed job resumes from (None when the plan
    # was made without a checkpoint directory — pre-PR-4 callers)
    handoff: Optional[CheckpointHandoff] = None


def plan_elastic_remesh(leaves: Sequence[TpuLeaf],
                        failed_hosts: Sequence[Tuple[int, int]],
                        *, model_parallel: int,
                        ckpt_base_dir: Optional[str] = None
                        ) -> RemeshPlan:
    """Shrink the data axis to the largest size the survivors support.

    Keeps 'model' intact (parameter shards must stay complete) and drops
    whole data-parallel groups containing failed hosts — the standard
    elastic-DP policy.

    ``ckpt_base_dir`` names the checkpoint handoff: the plan then
    carries the latest *committed* step the re-meshed job restores from
    (torn/in-flight step dirs are never selected).  A remesh without any
    committed checkpoint is refused — reconfiguring a job whose state
    cannot be recovered silently restarts it from scratch, which is
    exactly the failure mode drain-free reconfiguration exists to avoid.
    """
    failed = set(failed_hosts)
    surviving = [l for l in leaves if (l.pod, l.host) not in failed]
    n = len(surviving)
    if n < model_parallel:
        raise RuntimeError("not enough leaves for one model shard")
    data = n // model_parallel
    # power-of-two friendly shrink for clean microbatching
    while data > 1 and (n % (data * model_parallel)):
        data -= 1
    used = surviving[:data * model_parallel]
    handoff = None
    if ckpt_base_dir is not None:
        from repro_torch import ckpt as ckpt_lib
        step = ckpt_lib.latest_step(ckpt_base_dir)
        if step is None:
            raise RuntimeError(
                f"remesh requested with checkpoint handoff, but "
                f"{ckpt_base_dir!r} holds no committed checkpoint")
        sdir = ckpt_lib.step_dir(ckpt_base_dir, step)
        handoff = CheckpointHandoff(
            base_dir=ckpt_base_dir, step=step, step_dir=sdir,
            sharded=ckpt_lib.is_sharded_dir(sdir))
    return RemeshPlan(tuple(used), (data, model_parallel),
                      ("data", "model"), tuple(sorted(failed)),
                      handoff=handoff)


def repack_on_failure(leaves: Sequence[TpuLeaf],
                      failed_hosts: Sequence[Tuple[int, int]],
                      *, model_parallel: int = 1,
                      ckpt_base_dir: Optional[str] = None
                      ) -> Optional[RemeshPlan]:
    """Remesh a job after an *unplanned* host failure.

    Differs from :func:`plan_elastic_remesh` (the planned-repack path)
    in how it degrades: a planned handoff with no committed checkpoint
    is a caller bug and is refused, but a *failure* can strike before
    the first commit, and the honest answer there is a full restart —
    so a ``ckpt_base_dir`` with no committed step is dropped rather
    than raised on (the plan carries ``handoff=None``: restart from
    scratch), and losing too many hosts to form even one model shard
    returns ``None`` (no viable repack; the scheduler requeues the
    job).  The simulator's MTBF failure events recover through this
    entry point and charge the result via
    ``repro.core.jct_model.ReconfigCostModel.failure_restart_s``.
    """
    if ckpt_base_dir is not None:
        from repro_torch import ckpt as ckpt_lib
        if ckpt_lib.latest_step(ckpt_base_dir) is None:
            ckpt_base_dir = None
    try:
        return plan_elastic_remesh(leaves, failed_hosts,
                                   model_parallel=model_parallel,
                                   ckpt_base_dir=ckpt_base_dir)
    except RuntimeError:
        return None
