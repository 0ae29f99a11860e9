"""Executable model of the paper's NCCL modifications (§4.2).

NCCL identifies GPUs by PCIe bus ID.  All MIG instances of one GPU share a
bus ID, so stock peer discovery (a) aborts on a false duplicate-GPU check
and (b) collapses distinct instances into one topology node.  Flex-MIG fixes
this with (1) a ``mig_id`` field in peer metadata compared during dedup, and
(2) *synthetic bus-ID labeling* during topology construction
(``00:4B:00.0 -> 00:4B:00.1``) with a restoration routine stripping the
suffix before any driver call.

We reproduce the failing logic and both fixes verbatim over simulated rank
metadata; tests assert the stock path fails exactly the way the paper
describes and the fixed path yields communicator == ranks.  The *effect* of
the fix (fast-path collectives between same-host leaves) is implemented
natively in ``repro_torch.collectives.hierarchical``.

The port's copy of ``repro/core/registry.py``: the same code, a model
over rank metadata.  It forms no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class DuplicateGpuError(RuntimeError):
    """NCCL 'Duplicate GPU detected' abort (paper §2.5, failure point 1)."""


class TopologyMismatchError(RuntimeError):
    """Topology has fewer devices than ranks (failure point 2)."""


class InvalidBusIdError(RuntimeError):
    """A synthetic bus ID leaked to a driver call without restoration."""


@dataclasses.dataclass(frozen=True)
class PeerInfo:
    """Rank metadata exchanged during NCCL bootstrap (paper Fig. 5)."""
    rank: int
    device_id: int
    host_hash: int
    pid_hash: int
    pcie_bus_id: str
    mig_id: Optional[str] = None    # the Flex-MIG addition (NCCL_MIG_ID)


def env_to_peer(rank: int, env: Dict[str, str], *, host_hash: int,
                pid_hash: int, pcie_bus_id: str) -> PeerInfo:
    """Runtime-layer env plumbing (§4.2): NVIDIA_VISIBLE_DEVICES ->
    CUDA_VISIBLE_DEVICES + NCCL_MIG_ID -> peer metadata."""
    mig_uuid = env.get("NVIDIA_VISIBLE_DEVICES")
    derived = dict(env)
    if mig_uuid:
        derived["CUDA_VISIBLE_DEVICES"] = mig_uuid
        derived["NCCL_MIG_ID"] = mig_uuid
    return PeerInfo(rank=rank, device_id=0, host_hash=host_hash,
                    pid_hash=pid_hash, pcie_bus_id=pcie_bus_id,
                    mig_id=derived.get("NCCL_MIG_ID"))


# ---------------------------------------------------------------------------
# peer discovery (failure point 1 + fix 1)
# ---------------------------------------------------------------------------

def peer_discovery(peers: List[PeerInfo], *, mig_aware: bool) -> None:
    """NCCL duplicate-GPU check during rank info exchange.

    Stock NCCL (mig_aware=False): two ranks on the same host with the same
    bus ID are classified as double-binding one GPU -> abort.
    Flex-MIG (mig_aware=True): additionally compare ``mig_id``; identical
    (host, bus_id) with different mig_id is legal.  Double-binding the
    *same* instance is still detected (mig_id equal).
    """
    seen: Dict[Tuple[int, str], PeerInfo] = {}
    for p in peers:
        key = (p.host_hash, p.pcie_bus_id)
        if key in seen:
            other = seen[key]
            if not mig_aware:
                raise DuplicateGpuError(
                    f"Duplicate GPU detected: rank {p.rank} and rank "
                    f"{other.rank} both report busId {p.pcie_bus_id}")
            if p.mig_id is None or other.mig_id is None \
                    or p.mig_id == other.mig_id:
                raise DuplicateGpuError(
                    f"rank {p.rank} and rank {other.rank} bind the same "
                    f"MIG instance {p.mig_id}")
            # distinct mig_id: same physical GPU, different instances - OK
        else:
            seen[key] = p


# ---------------------------------------------------------------------------
# topology construction (failure point 2 + fix 2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TopoNode:
    label: str                     # (possibly synthetic) bus id
    rank: int
    host_hash: int


SYNTH_SEP = "."


def _with_suffix(bus_id: str, count: int) -> str:
    # "00:4B:00.0" -> "00:4B:00.<count>"  (paper's example transformation)
    base, _, _fn = bus_id.rpartition(SYNTH_SEP)
    return f"{base}{SYNTH_SEP}{count}"


def restore_bus_id(label: str) -> str:
    """Restoration routine: strip synthetic suffix before driver use."""
    base, _, fn = label.rpartition(SYNTH_SEP)
    if fn != "0":
        return f"{base}{SYNTH_SEP}0"
    return label


def is_synthetic(label: str) -> bool:
    return label.rpartition(SYNTH_SEP)[2] != "0"


def driver_call_guard(label: str) -> str:
    """Any path passing a bus id to the driver goes through here."""
    restored = restore_bus_id(label)
    if is_synthetic(restored):
        raise InvalidBusIdError(f"synthetic bus id leaked: {label}")
    return restored


def build_topology(peers: List[PeerInfo], *,
                   synthetic_labeling: bool) -> List[TopoNode]:
    """NCCL system-topology registration.

    Stock (synthetic_labeling=False): devices registered incrementally; a
    bus ID already present is *deduplicated* -> distinct MIG instances
    collapse into one node and node count < ranks.
    Flex-MIG: keep a (bus_id -> count) ``mig_list``; re-registrations get a
    synthetic suffix so each rank becomes a unique node.
    """
    nodes: List[TopoNode] = []
    mig_list: Dict[Tuple[int, str], int] = {}
    for p in peers:
        key = (p.host_hash, p.pcie_bus_id)
        if key not in mig_list:
            mig_list[key] = 0
            nodes.append(TopoNode(label=p.pcie_bus_id, rank=p.rank,
                                  host_hash=p.host_hash))
        else:
            if not synthetic_labeling:
                continue           # stock NCCL: silently deduplicated
            mig_list[key] += 1
            nodes.append(TopoNode(
                label=_with_suffix(p.pcie_bus_id, mig_list[key]),
                rank=p.rank, host_hash=p.host_hash))
    return nodes


def form_communicator(peers: List[PeerInfo], *, mig_aware: bool,
                      synthetic_labeling: bool) -> List[TopoNode]:
    """Full bootstrap: peer discovery then topology; returns topo nodes.

    Raises the same class of failures the paper observes when run without
    the Flex-MIG modifications.
    """
    peer_discovery(peers, mig_aware=mig_aware)
    nodes = build_topology(peers, synthetic_labeling=synthetic_labeling)
    if len(nodes) != len(peers):
        raise TopologyMismatchError(
            f"topology has {len(nodes)} devices for {len(peers)} ranks "
            f"(MIG instances collapsed)")
    # every node label must round-trip the driver guard
    for n in nodes:
        driver_call_guard(n.label)
    return nodes


def select_transport(a: PeerInfo, b: PeerInfo) -> str:
    """NCCL transport selection under MIG (§2.5): no P2P/NVLink across MIG;
    same host -> SHM, different host -> NET."""
    if a.host_hash == b.host_hash:
        return "SHM"
    return "NET"
