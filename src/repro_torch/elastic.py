"""Heartbeats and straggler detection of the port (copies of
``HeartbeatMonitor`` and ``StragglerDetector`` in ``repro/elastic.py``).

The rest of the reference module (re-meshing over surviving leaves, the
checkpoint handoff) waits for ROADMAP.md queue 1 item 8: it builds on
``repro.core.leaves``, which the port has not got yet.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional


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
