"""Crash-safe restore: committed-step fallback walk + quarantine.

The sharded format's CRC catches silent corruption (bit rot, torn
writes that survived the atomic-rename protocol's crash windows), but a
raise at restore time kills the relaunched job exactly when it is trying
to recover.  This module turns that raise into a *fallback walk*: try
the newest committed step; if restoring it fails for a reason that means
"these bytes are bad" (checksum mismatch, unparseable manifest, missing
shard file), quarantine that step directory on disk — rename it so step
discovery stops offering it — and fall back to the previous committed
step, repeating until a restore succeeds or history runs out.  The
caller gets a structured :class:`RecoveryReport` of everything that was
skipped and why; an empty history still fails loudly (a job with no
recoverable state must not silently start from scratch).

Quarantining renames ``step_<n>`` to ``step_<n>.quarantined-<pid>``:
the name no longer matches the committed-step regex, so
``latest_step``/``committed_steps`` — and with them the elastic driver's
stale-checkpoint guards — all agree the step is gone, while the bytes
stay on disk for forensics.  Quarantined dirs are *not* garbage
collected by later saves (unlike ``.old-*``/``.tmp-*`` debris): they are
evidence.

The port's copy of ``repro/faults/recovery.py``.  On a grid every rank
walks together (``mesh``): a step that fails on one rank fails on all
(``checkpoint.Job``), rank 0 alone renames it aside, and every rank's
report names the same steps and targets.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, Optional, Tuple

from repro_torch import checkpoint as ckpt_legacy
from repro_torch.checkpoint import CorruptCheckpointError, Job
from repro_torch.ckpt.manifest import ManifestError
from repro_torch.faults.retry import NO_RETRY, RetryPolicy

# exception types that mean "this step's bytes are unusable" (fall back)
# rather than "the caller's request is malformed" (propagate).  OSError
# covers missing/unreadable shard files; ValueError/EOFError cover
# np.load on truncated npy payloads; json decode errors are ValueError.
RESTORABLE_ERRORS = (CorruptCheckpointError, ManifestError, OSError,
                     ValueError, EOFError, KeyError)


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One committed step that was offered, failed, and was skipped."""
    step: int
    path: str
    error: str                     # repr of the triggering exception
    quarantined_to: Optional[str]  # on-disk rename target, if performed


@dataclasses.dataclass
class RecoveryReport:
    """What the fallback walk did to produce a restored state."""
    base_dir: str
    attempted: List[int] = dataclasses.field(default_factory=list)
    quarantined: List[QuarantineRecord] = dataclasses.field(
        default_factory=list)
    restored_step: Optional[int] = None
    retries_used: int = 0

    @property
    def fell_back(self) -> bool:
        return bool(self.quarantined)

    def to_dict(self):
        return {
            "base_dir": self.base_dir,
            "attempted": list(self.attempted),
            "quarantined": [dataclasses.asdict(q)
                            for q in self.quarantined],
            "restored_step": self.restored_step,
            "retries_used": self.retries_used,
        }


def quarantine_dir(path: str) -> str:
    """Rename a bad step dir out of the committed-step namespace."""
    target = f"{path}.quarantined-{os.getpid()}"
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{path}.quarantined-{os.getpid()}.{n}"
    os.rename(path, target)
    return target


def walk_committed(base_dir: str,
                   attempt: Callable[[int, str], Any], *,
                   quarantine_on_disk: bool = True,
                   max_fallbacks: Optional[int] = None,
                   report: Optional[RecoveryReport] = None,
                   mesh=None) -> Tuple[Any, RecoveryReport]:
    """Run ``attempt(step, step_path)`` over committed steps newest-first
    until one succeeds; quarantine the ones that fail restorably.

    ``max_fallbacks`` bounds how many *bad* steps may be skipped (None =
    walk the whole history).  Raises :class:`CorruptCheckpointError` when
    no committed step exists or every candidate failed — recovery that
    cannot recover must be loud.  ``mesh``: the grid (or process group)
    whose ranks walk together; ``attempt`` must fail on all of them or
    on none (the checkpoint restores' own ``mesh`` sees to that).
    """
    job = Job(mesh)
    rep = report if report is not None else RecoveryReport(base_dir)
    steps = ckpt_legacy.committed_steps(base_dir)
    if not steps:
        raise CorruptCheckpointError(
            f"no committed checkpoint under {base_dir!r} — nothing to "
            f"restore from")
    for step in reversed(steps):
        if (max_fallbacks is not None
                and len(rep.quarantined) > max_fallbacks):
            break
        path = ckpt_legacy.step_dir(base_dir, step)
        rep.attempted.append(step)
        try:
            result = attempt(step, path)
        except RESTORABLE_ERRORS as exc:
            moved = None
            if quarantine_on_disk and job.rank == 0 and os.path.isdir(path):
                moved = quarantine_dir(path)
            moved = job.broadcast(moved)
            rep.quarantined.append(QuarantineRecord(
                step=step, path=path, error=repr(exc),
                quarantined_to=moved))
            continue
        rep.restored_step = step
        return result, rep
    raise CorruptCheckpointError(
        f"every committed checkpoint under {base_dir!r} failed to "
        f"restore; quarantined "
        f"{[q.step for q in rep.quarantined]} "
        f"({[q.error for q in rep.quarantined]})")


def restore_with_fallback(base_dir: str, template, *, policy=None,
                          layout=None, verify: bool = True,
                          retry: RetryPolicy = NO_RETRY,
                          quarantine_on_disk: bool = True,
                          max_fallbacks: Optional[int] = None, mesh=None
                          ) -> Tuple[int, Any, RecoveryReport]:
    """``restore_auto`` with transient-I/O retry and corrupt-step
    fallback.  Returns ``(step, tree, report)``.

    Transient OSErrors inside one step's restore are retried per
    ``retry`` *before* the step is declared bad; only after retries are
    exhausted (or on non-transient corruption) does the walk quarantine
    and fall back.
    """
    from repro_torch.ckpt import restore_auto   # deferred: init cycle
    rep = RecoveryReport(base_dir)

    def attempt(step: int, path: str):
        tries = 0

        def once():
            nonlocal tries
            tries += 1
            return restore_auto(path, template, policy=policy,
                                layout=layout, verify=verify, mesh=mesh)
        try:
            return retry.call(once)
        finally:
            rep.retries_used += tries - 1

    (step, tree), rep = walk_committed(
        base_dir, attempt, quarantine_on_disk=quarantine_on_disk,
        max_fallbacks=max_fallbacks, report=rep, mesh=mesh)
    return step, tree, rep
