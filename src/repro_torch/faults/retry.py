"""Bounded retry-with-exponential-backoff for transient checkpoint I/O.

Multi-tenant MIG hosts see transient I/O failures (ENOSPC races while a
neighbor's checkpoint is being garbage-collected, EIO blips on network
filesystems) that should not kill a training job mid-handoff.  The
sharded writer/reader wrap their filesystem work in
:meth:`RetryPolicy.call`, which retries *only* OSErrors whose errno is in
a transient allow-list, with exponential backoff and a hard retry bound.

Corruption is never retried: a failing CRC means the bytes on disk are
wrong and will be wrong on every read — that is the quarantine/fallback
path's job (:mod:`repro_torch.faults.recovery`), not a backoff loop's.

The port's copy of ``repro/faults/retry.py``.
"""
from __future__ import annotations

import dataclasses
import errno
import time
from typing import Callable, FrozenSet, TypeVar

T = TypeVar("T")

# errnos that plausibly clear on their own; anything else is structural
TRANSIENT_ERRNOS: FrozenSet[int] = frozenset(
    {errno.EIO, errno.ENOSPC, errno.EAGAIN, errno.EINTR})


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_retries`` *additional* attempts after the first; delay
    doubles from ``base_delay_s`` capped at ``max_delay_s``.  The default
    (0 retries) makes ``call`` a plain invoke — callers opt in."""

    max_retries: int = 0
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    errnos: FrozenSet[int] = TRANSIENT_ERRNOS

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")

    def retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, OSError) and exc.errno in self.errnos

    def call(self, fn: Callable[[], T]) -> T:
        """Run ``fn``; on a transient OSError retry up to ``max_retries``
        times with exponential backoff, then re-raise.  Non-transient
        exceptions propagate immediately."""
        delay = self.base_delay_s
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except OSError as exc:
                if attempt >= self.max_retries or not self.retryable(exc):
                    raise
                if delay > 0:
                    time.sleep(min(delay, self.max_delay_s))
                delay *= 2
        raise AssertionError("unreachable")


NO_RETRY = RetryPolicy()
