"""Logical aggregation of leaves into a job's device layout (one-to-many).

This is the runtime half of the one-to-many model: a job is given an
arbitrary set of leaves (chips) — possibly non-contiguous, spanning hosts
and pods — and we lay its devices out over named axes in an order that
implements the paper's *topology-aware placement*: leaves are
round-robined across hosts so the collective-heavy axes land on the fast
intra-host/intra-pod fabric (the SHM analogue) and only the outermost axis
crosses the slow boundary (the NET analogue).

The port's copy of ``repro/core/aggregation.py``: the orders and
``choose_leaves`` are the same code.  ``leaves_to_mesh`` keeps its name,
arguments and orders, but where the reference builds a
``jax.sharding.Mesh`` it returns the layout itself (:class:`LeafLayout`):
the ordered leaves' devices as an array of ``shape``, with
``axis_names``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.leaves import TpuLeaf


def round_robin_order(leaves: Sequence[TpuLeaf]) -> List[TpuLeaf]:
    """Topology-aware (round-robin across hosts) leaf ordering (§3.2)."""
    by_host = {}
    for leaf in leaves:
        by_host.setdefault((leaf.pod, leaf.host), []).append(leaf)
    for v in by_host.values():
        v.sort(key=lambda l: l.chip)
    hosts = sorted(by_host)
    out: List[TpuLeaf] = []
    cursors = {h: 0 for h in hosts}
    while len(out) < len(leaves):
        progressed = False
        for h in hosts:
            if cursors[h] < len(by_host[h]):
                out.append(by_host[h][cursors[h]])
                cursors[h] += 1
                progressed = True
        assert progressed
    return out


def packed_order(leaves: Sequence[TpuLeaf]) -> List[TpuLeaf]:
    """Naive pack-host-first ordering (the Fig. 9 ablation baseline)."""
    return sorted(leaves, key=lambda l: (l.pod, l.host, l.chip))


def grouped_order(leaves: Sequence[TpuLeaf]) -> List[TpuLeaf]:
    """Fast-axis-contiguous ordering: chips of one host stay adjacent so
    the *innermost* mesh axis is intra-host (used to map 'model' onto the
    fastest links)."""
    return packed_order(leaves)


def choose_leaves(all_leaves: Sequence[TpuLeaf], n: int, *,
                  busy: Optional[set] = None) -> List[TpuLeaf]:
    """Allocate ``n`` idle leaves, spreading across hosts (one-to-many)."""
    busy = busy or set()
    idle = [l for l in all_leaves if l.uuid not in busy]
    if len(idle) < n:
        raise RuntimeError(f"need {n} leaves, only {len(idle)} idle")
    return round_robin_order(idle)[:n]


@dataclasses.dataclass(frozen=True, eq=False)
class LeafLayout:
    """A job's devices laid out over named axes (what the reference's
    ``Mesh`` holds): ``devices[idx]`` backs the leaf at position ``idx``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def leaves_to_mesh(leaves: Sequence[TpuLeaf], shape: Tuple[int, ...],
                   axis_names: Tuple[str, ...], *,
                   devices: Optional[Sequence] = None,
                   order: str = "grouped") -> LeafLayout:
    """Lay the job's leaves out over ``axis_names``.

    ``devices``: the device backing each leaf (same length/order as
    ``leaves``); defaults to the job's ranks ``0..len(leaves)-1``, which
    stand for the reference's ``jax.devices()[:len(leaves)]``.

    ``order``: 'grouped' keeps hosts contiguous on the innermost axis
    (fast-axis collectives stay intra-host); 'round_robin' spreads them
    (the placement the paper's Fig. 9 *evaluates*, optimal for PCIe-bound
    GPU leaves); 'packed' is the naive baseline.
    """
    assert math.prod(shape) == len(leaves), (shape, len(leaves))
    if order == "round_robin":
        ordered = round_robin_order(leaves)
    elif order == "packed":
        ordered = packed_order(leaves)
    else:
        ordered = grouped_order(leaves)
    if devices is None:
        devices = list(range(len(leaves)))
    index = {l: i for i, l in enumerate(leaves)}
    dev_arr = np.array([devices[index[l]] for l in ordered],
                       dtype=object).reshape(shape)
    return LeafLayout(dev_arr, tuple(axis_names))
