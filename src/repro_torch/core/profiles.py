"""MIG profile table and tree-constrained layout (paper Table 3 / Fig. 3).

An A100-40GB exposes 7 compute slices and 8 memory slices (5 GB each).
Profiles occupy a *specific* set of compute slices (the tree constraint C2:
only slice-sets sharing a parent are valid) plus a memory-slice budget.

The port's copy of ``repro/core/profiles.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Tuple

N_COMPUTE_SLICES = 7
N_MEMORY_SLICES = 8
MEMORY_PER_SLICE_GB = 5


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    sm_slices: int               # compute slices (i in ig.jgb)
    mem_gb: int
    mem_slices: int
    max_per_gpu: int
    # tree-valid compute-slice placements (C2)
    placements: Tuple[FrozenSet[int], ...]


def _fz(*xs) -> FrozenSet[int]:
    return frozenset(xs)


# A100-40GB PCIe profile tree (paper Appendix A + NVIDIA MIG user guide).
PROFILES: Dict[str, Profile] = {
    "1g.5gb": Profile("1g.5gb", 1, 5, 1, 7,
                      tuple(_fz(i) for i in range(7))),
    "1g.10gb": Profile("1g.10gb", 1, 10, 2, 4,
                       (_fz(0), _fz(2), _fz(4), _fz(6))),
    "2g.10gb": Profile("2g.10gb", 2, 10, 2, 3,
                       (_fz(0, 1), _fz(2, 3), _fz(4, 5))),
    "3g.20gb": Profile("3g.20gb", 3, 20, 4, 2,
                       (_fz(0, 1, 2), _fz(4, 5, 6))),
    "4g.20gb": Profile("4g.20gb", 4, 20, 4, 1,
                       (_fz(0, 1, 2, 3),)),
    "7g.40gb": Profile("7g.40gb", 7, 40, 8, 1,
                       (_fz(0, 1, 2, 3, 4, 5, 6),)),
}

# Flex-MIG fixed partition (§3): 6 x 1g.5gb + 1 x 1g.10gb fills all 40 GB.
FLEXMIG_PARTITION: Tuple[str, ...] = ("1g.5gb",) * 6 + ("1g.10gb",)

# Static-MIG fixed partition (§5.1 baselines).
STATIC_PARTITION: Tuple[str, ...] = ("1g.10gb", "2g.10gb", "4g.20gb")

# one-to-one rounding (I1): workload size -> smallest covering profile.
SIZE_TO_PROFILE: Dict[int, str] = {
    1: "1g.5gb", 2: "2g.10gb", 3: "4g.20gb", 4: "4g.20gb",
    5: "7g.40gb", 6: "7g.40gb", 7: "7g.40gb", 8: "7g.40gb",
}


def round_up_profile(size: int) -> str:
    """One-to-one allocation model rounding (over-provisioning, Fig. 2)."""
    if size not in SIZE_TO_PROFILE:
        raise ValueError(f"workload size {size} unsupported")
    return SIZE_TO_PROFILE[size]


def overprovision_slices(size: int) -> int:
    """Wasted compute slices when rounding size -> profile (Fig. 2)."""
    return PROFILES[round_up_profile(size)].sm_slices - size


def mergeable(slice_a: int, slice_b: int) -> bool:
    """Fig. 3a: two adjacent 1g slices merge into 2g only if they share a
    2g parent node in the tree."""
    return frozenset((slice_a, slice_b)) in PROFILES["2g.10gb"].placements
