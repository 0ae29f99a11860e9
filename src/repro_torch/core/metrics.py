"""Cross-mode comparison utilities (the ratios plotted in Figs. 7-8).

The port's copy of ``repro/core/metrics.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.simulator import SimResult


@dataclasses.dataclass
class ModeComparison:
    """Numerator/denominator metric ratios (<1 favours the numerator)."""
    jct_ratio: float
    wait_ratio: float
    makespan_ratio: float
    util_ratio: float

    @staticmethod
    def of(num: SimResult, den: SimResult) -> "ModeComparison":
        def safe(a, b):
            return a / b if b > 0 else float("nan")
        return ModeComparison(
            jct_ratio=safe(num.avg_jct, den.avg_jct),
            wait_ratio=safe(num.avg_wait, den.avg_wait),
            makespan_ratio=safe(num.makespan, den.makespan),
            util_ratio=safe(num.utilization, den.utilization),
        )


def summarize(ratios: List[ModeComparison]) -> Dict[str, float]:
    return {
        "jct_ratio_mean": float(np.mean([r.jct_ratio for r in ratios])),
        "wait_ratio_mean": float(np.mean([r.wait_ratio for r in ratios])),
        "makespan_ratio_mean": float(
            np.mean([r.makespan_ratio for r in ratios])),
        "makespan_ratio_min": float(
            np.min([r.makespan_ratio for r in ratios])),
        "util_ratio_mean": float(np.mean([r.util_ratio for r in ratios])),
    }
