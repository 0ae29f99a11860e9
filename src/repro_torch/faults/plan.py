"""Deterministic fault-injection plane for the checkpoint/handoff path.

The recovery machinery this repo claims (atomic commits, CRC quarantine,
restart-resume) is only as real as the failures it has survived.  This
module provides the *injection* half: a seeded :class:`FaultPlan` holding
:class:`FaultSpec` entries keyed by **named injection points** that the
checkpoint writers/readers and the elastic driver call out to
(:func:`maybe_fire`) at every step of their protocols.  A spec decides
deterministically — by arrival count at its point, never by wallclock —
when to

- raise ``ENOSPC`` / ``EIO`` (transient-I/O faults the retry policy must
  absorb, or hard failures the async writer must surface at join);
- truncate or bit-flip the file just written (*post*-CRC-computation, so
  the corruption is invisible until a reader checksums it — the case the
  shard-level quarantine exists for);
- SIGKILL the process on the spot (the crash-matrix tests relaunch and
  assert the commit protocol's invariant).

Plans are installed ambiently (:func:`install` context manager) so
production code pays one module-global ``None`` check per point when no
plan is armed, and serialized through the environment
(:meth:`FaultPlan.to_env` / :func:`install_from_env`) so the subprocess
kill harness can arm a child process it is about to murder.

Injection-point names threaded through the repo (see README
"Fault tolerance" for the full protocol map):

==========================  ================================================
point                       fired
==========================  ================================================
``sharded.write``           before each sharded payload ``np.save``
``sharded.written``         after each payload write (path of the file)
``sharded.manifest``        after the manifest write (commit marker,
                            still in the temp dir; path of the file)
``sharded.pre_rename_aside``  before a same-step re-save moves the old
                            commit aside
``sharded.between_renames``  after the rename-aside, before the commit
                            rename — the ``.old-*`` crash window
``sharded.committed``       after the atomic commit rename
``sharded.read``            before each shard-file ``np.load`` on restore
``legacy.write``            before each legacy per-leaf write
``legacy.manifest``         before the legacy manifest ``os.replace``
``legacy.read``             before each legacy leaf ``np.load``
``driver.pre_save``         ElasticDriver: entering a handoff save
``driver.post_restore``     ElasticDriver: reshard-restore returned
``driver.first_step``       ElasticDriver: before the first step of
                            each grid segment
==========================  ================================================

The port's copy of ``repro/faults/plan.py``: the same environment
variables (``REPRO_FAULT_PLAN``, ``REPRO_JOB_ID``) and the same JSON, so
one serialized plan arms either package.  In a gloo job every rank arms
the plan of its environment (``parallel.launch``), and each counts the
arrivals at its own points.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import json
import os
import signal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ENV_VAR = "REPRO_FAULT_PLAN"

# which job a cluster child *is* — set by the cluster runtime's
# JobManager so a namespaced fault plan (see plans_to_env) only arms in
# the subprocess it targets
JOB_ENV_VAR = "REPRO_JOB_ID"

KINDS = ("enospc", "eio", "truncate", "bitflip", "crash")

# .npy files put their header in the first ~128 bytes; corrupting past it
# keeps np.load parseable so the damage is only visible to the CRC check
_NPY_HEADER_BYTES = 128


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: at arrival ``hit`` (1-based) of injection
    point ``point``, apply ``kind``; keep firing for ``times``
    consecutive arrivals (>1 models a transient fault window a bounded
    retry must outlast)."""

    point: str
    kind: str
    hit: int = 1
    times: int = 1
    nbytes: int = 1               # bitflip: bytes to flip; truncate: keep-frac denominator

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.hit < 1 or self.times < 1:
            raise ValueError(f"hit/times must be >= 1 ({self})")

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d) -> "FaultSpec":
        return FaultSpec(point=d["point"], kind=d["kind"],
                         hit=int(d.get("hit", 1)),
                         times=int(d.get("times", 1)),
                         nbytes=int(d.get("nbytes", 1)))


@dataclasses.dataclass
class FiredFault:
    """Record of one applied fault (for assertions in tests/benches)."""
    point: str
    kind: str
    count: int
    path: Optional[str]


class FaultPlan:
    """A seeded set of :class:`FaultSpec`\\ s plus per-point arrival
    counters.  ``fire`` is called by the production code's injection
    points; the plan applies every matching spec."""

    def __init__(self, specs: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.counts: Dict[str, int] = {}
        self.fired: List[FiredFault] = []

    # ------------------------------------------------------------- firing
    def fire(self, point: str, *, path: Optional[str] = None) -> None:
        count = self.counts.get(point, 0) + 1
        self.counts[point] = count
        for spec in self.specs:
            if spec.point != point:
                continue
            if not (spec.hit <= count < spec.hit + spec.times):
                continue
            self.fired.append(FiredFault(point, spec.kind, count, path))
            self._apply(spec, path)

    def _apply(self, spec: FaultSpec, path: Optional[str]) -> None:
        if spec.kind == "enospc":
            raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC),
                          path or spec.point)
        if spec.kind == "eio":
            raise OSError(errno.EIO, os.strerror(errno.EIO),
                          path or spec.point)
        if spec.kind == "crash":
            # a real SIGKILL: no atexit handlers, no finally blocks — the
            # only state that survives is what the commit protocol
            # already made durable
            os.kill(os.getpid(), signal.SIGKILL)
        # file-corruption kinds need the just-written file
        if path is None or not os.path.exists(path):
            raise RuntimeError(
                f"fault {spec.kind!r} at {spec.point!r} needs a file "
                f"path, got {path!r}")
        size = os.path.getsize(path)
        if spec.kind == "truncate":
            os.truncate(path, max(size // 2, 0))
        elif spec.kind == "bitflip":
            lo = min(_NPY_HEADER_BYTES, max(size - 1, 0))
            with open(path, "r+b") as f:
                for _ in range(max(spec.nbytes, 1)):
                    off = int(self.rng.integers(lo, max(size, lo + 1)))
                    f.seek(off)
                    b = f.read(1)
                    f.seek(off)
                    f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")

    # -------------------------------------------------------- env plumbing
    def to_env(self) -> str:
        """Serialize for a child process (``env[ENV_VAR] = plan.to_env()``)."""
        return json.dumps({"seed": self.seed,
                           "specs": [s.to_dict() for s in self.specs]})

    @staticmethod
    def from_env(value: str) -> "FaultPlan":
        d = json.loads(value)
        return FaultPlan([FaultSpec.from_dict(s) for s in d["specs"]],
                         seed=int(d.get("seed", 0)))


# ambient plan: production code calls maybe_fire at every injection
# point; a single global None check is the entire no-fault overhead
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def maybe_fire(point: str, *, path: Optional[str] = None) -> None:
    """The hook production code calls at a named injection point."""
    if _ACTIVE is not None:
        _ACTIVE.fire(point, path=path)


@contextlib.contextmanager
def install(plan: FaultPlan):
    """Arm ``plan`` ambiently for the duration of the context."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def plans_to_env(plans: Dict[str, FaultPlan]) -> str:
    """Serialize a *namespaced* plan set — one plan per job id — for a
    multi-job (cluster) environment.  Every cluster child inherits the
    same ``$REPRO_FAULT_PLAN``; :func:`install_from_env` arms only the
    entry matching the child's own job id, so a plan aimed at one job
    can never fire inside its co-scheduled neighbors."""
    return json.dumps({"jobs": {jid: json.loads(p.to_env())
                                for jid, p in plans.items()}})


def install_from_env(job_id: Optional[str] = None) -> Optional[FaultPlan]:
    """Arm the plan serialized in ``$REPRO_FAULT_PLAN`` (kill-harness and
    cluster children call this first thing; no-op without the variable).
    The plan stays armed for the life of the process — crash specs make
    the process not outlive them anyway.

    Two wire formats:

    - legacy single plan (top-level ``specs``): armed unconditionally,
      exactly as before — the single-job kill harness's path;
    - namespaced (top-level ``jobs``: job id -> plan, from
      :func:`plans_to_env`): only the entry for this process's job id is
      armed.  ``job_id`` defaults to ``$REPRO_JOB_ID``; a process with
      no job id, or one no entry targets, arms nothing.
    """
    global _ACTIVE
    value = os.environ.get(ENV_VAR)
    if not value:
        return None
    d = json.loads(value)
    if "jobs" in d:
        if job_id is None:
            job_id = os.environ.get(JOB_ENV_VAR)
        entry = d["jobs"].get(job_id) if job_id is not None else None
        if entry is None:
            return None
        _ACTIVE = FaultPlan(
            [FaultSpec.from_dict(s) for s in entry["specs"]],
            seed=int(entry.get("seed", 0)))
        return _ACTIVE
    _ACTIVE = FaultPlan.from_env(value)
    return _ACTIVE
