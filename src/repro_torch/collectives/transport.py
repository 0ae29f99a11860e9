"""Transport selection + analytic bandwidth model (paper Fig. 10/11): a
copy of ``repro/collectives/transport.py``, which the port may not import.

Models AllReduce/AllGather/ReduceScatter bus bandwidth for:
- GPU testbed transports: SHM (host shared memory across MIG leaves) vs
  NET (RDMA): the paper's Fig. 11 microbenchmark;
- TPU fabrics: intra-pod ICI vs cross-pod DCN: the adapted two-tier cliff
  used for roofline collective terms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

# Canonical tier constants live in the runtime layer so the analytic model
# and the executable collectives (repro_torch.collectives.hierarchical)
# price and name the same transports.
from repro_torch.parallel.transport import (  # noqa: F401
    DCN_GBPS_PER_HOST, ICI_GBPS_PER_LINK, ICI_LINKS, NET_GBPS, NET_LATENCY_S,
    PCIE_GBPS, SHM_LATENCY_S, SHM_STREAM_GBPS, TIERS)


@dataclasses.dataclass(frozen=True)
class CollectivePerf:
    transport: str
    n_ranks: int
    bytes_per_rank: float
    bus_bandwidth_gbps: float
    time_s: float


def _ring_factor(op: str, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all_reduce":
        return 2.0 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter"):
        return (n - 1) / n
    if op == "all_to_all":
        return (n - 1) / n
    raise ValueError(op)


def gpu_collective(op: str, nbytes: float, *, transport: str,
                   leaves_per_gpu: Tuple[int, ...],
                   concurrent_net_jobs: int = 1) -> CollectivePerf:
    """Paper testbed model: SHM streams share each GPU's PCIe interface;
    NET shares the host NIC across concurrent jobs."""
    n = sum(leaves_per_gpu)
    traffic = _ring_factor(op, n) * nbytes
    if transport == "SHM":
        worst = max(leaves_per_gpu) if leaves_per_gpu else 1
        bw = min(TIERS["SHM"].gbps, PCIE_GBPS / max(1, worst))
        lat = TIERS["SHM"].latency_s
    else:
        bw = TIERS["NET"].gbps / max(1, concurrent_net_jobs)
        lat = TIERS["NET"].latency_s
    t = traffic / (bw * 1e9) + lat * max(1, n - 1)
    bus = (nbytes * _ring_factor(op, n)) / t / 1e9 if t > 0 else 0.0
    return CollectivePerf(transport, n, nbytes, bus, t)


def tpu_collective_time(op: str, nbytes_per_chip: float, *, n_chips: int,
                        axis: str) -> float:
    """Roofline collective-term helper: time to move ``nbytes_per_chip``
    through the named fabric tier."""
    if n_chips <= 1:
        return 0.0
    traffic = _ring_factor(op, n_chips) * nbytes_per_chip
    tier = TIERS["ICI" if axis == "ici" else "DCN"]
    return traffic / (tier.gbps * 1e9)        # per-link serial model


def hierarchical_vs_flat_bytes(nbytes: float, *, fast: int,
                               slow: int) -> Dict[str, float]:
    """Slow-boundary bytes: flat all-reduce vs hierarchical schedule.

    Flat ring spanning both tiers sends O(nbytes) across the slow cut;
    hierarchical sends nbytes/fast (the reduce-scattered shard).
    """
    flat_slow = 2.0 * (slow - 1) / slow * nbytes
    hier_slow = 2.0 * (slow - 1) / slow * (nbytes / fast)
    return {"flat_slow_bytes": flat_slow, "hier_slow_bytes": hier_slow,
            "reduction": flat_slow / max(hier_slow, 1e-12)}
