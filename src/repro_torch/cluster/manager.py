"""Per-job subprocess lifecycle for the cluster runtime (the port's
counterpart of ``repro/cluster/manager.py``).

A :class:`JobManager` wraps ONE training job as a sequence of segment
subprocesses (:mod:`repro_torch.cluster.worker`), each sized to the job's
current :class:`~repro_torch.cluster.pool.Allocation`: the child spawns
exactly ``size`` gloo ranks of its own, ``REPRO_JOB_ID`` names the job for
namespaced fault plans, and the per-job checkpoint directory carries state
across segments (and across crash relaunches — the restart-resume path).

The manager is deliberately dumb: it launches what the
:class:`~repro_torch.cluster.runtime.ClusterRuntime` tells it to and
reports ``("ok", SegmentResult)`` / ``("crash", returncode)``.  All
scheduling, placement, and repack policy live in the runtime.  Each
worker runs in a session of its own, so a crash or :meth:`JobManager.stop`
kills its process group: the worker and the ranks it spawned.

The spec has two fields the reference's lacks, both written into the
segment's spec file: ``device`` (``None``: the card; ``"cpu"`` for the CPU)
and ``n_layers`` (``None``: the reference's ``reduced_config``; an int:
the arch's published widths at that depth).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

import repro_torch
from repro_torch.core.job import DEFAULT_TENANT, TIER_NORMAL, Job
from repro_torch.faults.plan import ENV_VAR as FAULT_ENV_VAR
from repro_torch.faults.plan import JOB_ENV_VAR

# the directory that holds the repro_torch package (__path__ works for a
# namespace package too)
_SRC_DIR = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


@dataclasses.dataclass(frozen=True)
class ClusterJobSpec:
    """Everything the runtime needs to co-schedule one training job."""
    job_id: str
    size: int                          # device width (constant for life)
    n_steps: int                       # total training steps
    segment_steps: int = 2             # handoff boundary cadence
    arch: str = "llama3.2-1b"
    tenant: str = DEFAULT_TENANT
    priority_tier: int = TIER_NORMAL
    seed: int = 0
    bucket_bytes: int = 64 << 10
    seq_len: int = 16
    global_batch: int = 8
    # arrival gating: enter the wait queue only once the named job has
    # STARTED — a deterministic stand-in for wallclock submit times, so
    # contention scenarios (job arrives into a fragmented pool) replay
    # identically every run
    after: Optional[str] = None
    # the port's two fields: where the segment's ranks run (None: the
    # card), and the model's depth at the arch's published widths (None:
    # the reference's reduced config)
    device: Optional[str] = None
    n_layers: Optional[int] = None

    def __post_init__(self):
        if self.size < 1 or self.n_steps < 1 or self.segment_steps < 1:
            raise ValueError(f"bad spec for {self.job_id}: size/steps "
                             f"must be >= 1")

    def to_job(self) -> Job:
        """The :class:`repro_torch.core.job.Job` record the scheduler sees."""
        return Job(job_id=self.job_id, model=self.arch, kind="train",
                   size=self.size, batch=self.global_batch,
                   base_duration=float(self.n_steps), submit_time=0.0,
                   tenant=self.tenant, priority_tier=self.priority_tier)


@dataclasses.dataclass
class SegmentResult:
    """Parsed worker output for one completed segment."""
    job_id: str
    segment: int
    attempt: int
    start_step: int
    end_step: int
    shape: Tuple[int, int]
    losses: List[float]
    steady_step_s: float
    first_step_s: float
    state_bytes: int
    final_save_s: float
    final_save_bytes: int
    resume_restore_s: float
    resume_restore_bytes: int
    resume_setup_s: float
    recovered_step: Optional[int]


class JobManager:
    """Launch/poll one job's segment subprocesses."""

    def __init__(self, spec: ClusterJobSpec, work_dir: str, *,
                 python: str = sys.executable,
                 env_extra: Optional[Dict[str, str]] = None):
        self.spec = spec
        self.work_dir = os.path.join(work_dir, spec.job_id)
        self.ckpt_dir = os.path.join(self.work_dir, "ckpt")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.python = python
        self.env_extra = dict(env_extra or {})
        self.proc: Optional[subprocess.Popen] = None
        self.segment = 0               # index of the NEXT/RUNNING segment
        self.attempt = 0               # relaunches of the current segment
        self.restarts = 0              # total crash relaunches
        self.done_step = 0             # last committed boundary
        self.results: List[SegmentResult] = []
        self._result_path: Optional[str] = None
        self._log_path: Optional[str] = None

    # ------------------------------------------------------------- state
    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def finished(self) -> bool:
        return self.done_step >= self.spec.n_steps

    def next_run_to(self) -> int:
        return min(self.done_step + self.spec.segment_steps,
                   self.spec.n_steps)

    # ------------------------------------------------------------ launch
    def launch(self, shape: Tuple[int, int], *,
               fault_env: Optional[str] = None) -> None:
        """Start the next segment (or relaunch the current one after a
        crash) on mesh ``shape``.  ``fault_env`` is forwarded only on a
        job's very first launch: fault-plan arrival counters are
        per-process, so re-arming the plan on a relaunch would make a
        one-shot crash spec fire forever."""
        if self.running:
            raise RuntimeError(f"{self.spec.job_id}: segment already "
                               f"running")
        s = self.spec
        if shape[0] * shape[1] != s.size:
            raise ValueError(f"{s.job_id}: shape {shape} is not a "
                             f"factorization of width {s.size}")
        run_to = self.next_run_to()
        tag = f"seg{self.segment:03d}_a{self.attempt}"
        spec_path = os.path.join(self.work_dir, f"{tag}.spec.json")
        self._result_path = os.path.join(self.work_dir,
                                         f"{tag}.result.json")
        self._log_path = os.path.join(self.work_dir, f"{tag}.log")
        with open(spec_path, "w") as f:
            json.dump({
                "job_id": s.job_id, "arch": s.arch,
                "shape": list(shape), "base_dir": self.ckpt_dir,
                "run_to": run_to, "total_steps": s.n_steps,
                "seed": s.seed, "resume": self.done_step > 0
                                          or self.attempt > 0,
                "final_save": run_to < s.n_steps,
                "bucket_bytes": s.bucket_bytes, "seq_len": s.seq_len,
                "global_batch": s.global_batch,
                "device": s.device, "n_layers": s.n_layers,
            }, f)
        env = dict(os.environ)
        env.update(self.env_extra)
        env["PYTHONPATH"] = (_SRC_DIR + os.pathsep
                             + env.get("PYTHONPATH", ""))
        env[JOB_ENV_VAR] = s.job_id
        env.pop(FAULT_ENV_VAR, None)
        if fault_env is not None and self.segment == 0 \
                and self.attempt == 0:
            env[FAULT_ENV_VAR] = fault_env
        log = open(self._log_path, "w")
        # a session of its own: the worker's process group holds it and
        # the ranks it spawns, so stop() and a crash reach them all
        self.proc = subprocess.Popen(
            [self.python, "-m", "repro_torch.cluster.worker",
             "--spec", spec_path, "--result", self._result_path],
            stdout=log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
        log.close()

    # -------------------------------------------------------------- poll
    def poll(self) -> Optional[Tuple[str, Any]]:
        """None while running; ``("ok", SegmentResult)`` when the
        segment completed; ``("crash", returncode)`` when the child died
        without a complete result file."""
        if self.proc is None:
            return None
        rc = self.proc.poll()
        if rc is None:
            return None
        if rc != 0:
            # a rank the dead worker left behind
            _kill_group(self.proc.pid)
        self.proc = None
        if rc == 0 and os.path.exists(self._result_path):
            with open(self._result_path) as f:
                d = json.load(f)
            res = SegmentResult(
                job_id=d["job_id"], segment=self.segment,
                attempt=self.attempt, start_step=d["start_step"],
                end_step=d["end_step"], shape=tuple(d["shape"]),
                losses=list(d["losses"]),
                steady_step_s=d["steady_step_s"],
                first_step_s=d["first_step_s"],
                state_bytes=int(d["state_bytes"]),
                final_save_s=d["final_save_s"],
                final_save_bytes=int(d["final_save_bytes"]),
                resume_restore_s=d["resume_restore_s"],
                resume_restore_bytes=int(d["resume_restore_bytes"]),
                resume_setup_s=d["resume_setup_s"],
                recovered_step=d.get("recovered_step"))
            self.results.append(res)
            self.done_step = res.end_step
            self.segment += 1
            self.attempt = 0
            return ("ok", res)
        return ("crash", rc)

    def stop(self) -> None:
        """Kill the running segment, the worker and its ranks."""
        if self.proc is None:
            return
        _kill_group(self.proc.pid)
        self.proc.wait()
        self.proc = None

    def note_crash(self) -> None:
        """Bookkeeping after the runtime decides to relaunch."""
        self.attempt += 1
        self.restarts += 1

    def tail_log(self, n: int = 2000) -> str:
        if self._log_path and os.path.exists(self._log_path):
            with open(self._log_path) as f:
                return f.read()[-n:]
        return ""


def _kill_group(pgid: int) -> None:
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass
