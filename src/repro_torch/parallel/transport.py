"""Canonical transport tiers shared by the analytic model and the runtime
(a copy of ``repro/parallel/transport.py``, which the port may not import).

Flex-MIG's runtime insight is that collectives should ride the fastest
transport that connects the participating leaves: host shared memory (SHM)
between MIG instances on one box, RDMA (NET) across boxes.  On TPU the
same two-tier cliff separates intra-pod ICI from cross-pod DCN.

This module is the single source of truth for those numbers and for the
axis -> tier naming convention, so the analytic bandwidth model
(``repro_torch.collectives.transport``) and the executable hierarchical
collectives (``repro_torch.collectives.hierarchical``) agree on what
"fast" and "slow" mean: the ``pod`` axis is the slow one, ``data`` the
fast one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# --- GPU testbed (paper Fig. 10/11) -----------------------------------------
SHM_STREAM_GBPS = 12.0            # per-leaf-pair host-shm effective
PCIE_GBPS = 20.0                  # practical per-GPU PCIe gen4 x16 cap
NET_GBPS = 8.0                    # RDMA via host NIC: effective per-stream
SHM_LATENCY_S = 4e-6
NET_LATENCY_S = 12e-6

# --- TPU v5e-ish fabric (per chip) ------------------------------------------
ICI_GBPS_PER_LINK = 50.0
ICI_LINKS = 4
DCN_GBPS_PER_HOST = 6.25          # 50 Gb/s NIC per host


@dataclasses.dataclass(frozen=True)
class TransportTier:
    """One rung of the bandwidth hierarchy."""

    name: str                     # "SHM" | "NET" | "ICI" | "DCN"
    fabric: str                   # "gpu" | "tpu"
    gbps: float                   # effective per-stream bandwidth
    latency_s: float


TIERS: Dict[str, TransportTier] = {
    "SHM": TransportTier("SHM", "gpu", SHM_STREAM_GBPS, SHM_LATENCY_S),
    "NET": TransportTier("NET", "gpu", NET_GBPS, NET_LATENCY_S),
    "ICI": TransportTier("ICI", "tpu", ICI_GBPS_PER_LINK, SHM_LATENCY_S),
    "DCN": TransportTier("DCN", "tpu", DCN_GBPS_PER_HOST, NET_LATENCY_S),
}

# Mesh-axis naming convention used across the repro: collectives over
# 'pod' cross the slow boundary; everything else stays on the fast fabric.
AXIS_TIER: Dict[str, str] = {
    "pod": "DCN",
    "data": "ICI",
    "model": "ICI",
    "stage": "ICI",
}
_SLOW_TIERS = frozenset({"NET", "DCN"})


def tier_for_axis(axis: str) -> TransportTier:
    return TIERS[AXIS_TIER.get(axis, "ICI")]


def is_slow_axis(axis: str) -> bool:
    """True when collectives over ``axis`` cross the NET/DCN boundary."""
    return AXIS_TIER.get(axis, "ICI") in _SLOW_TIERS


def fast_slow_axes(axis_names: Tuple[str, ...]
                   ) -> Tuple[Tuple[str, ...], Optional[str]]:
    """Split mesh axes into (fast_axes, slow_axis) per the tier map.

    At most one slow axis is supported (the meshes here have a single
    'pod' dimension); returns slow_axis=None for single-tier meshes.
    """
    fast = tuple(a for a in axis_names if not is_slow_axis(a))
    slow = [a for a in axis_names if is_slow_axis(a)]
    if len(slow) > 1:
        raise ValueError(f"multiple slow axes {slow!r} unsupported")
    return fast, (slow[0] if slow else None)
