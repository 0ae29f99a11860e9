"""Rank grids: the port's counterpart of ``repro/parallel/mesh.py`` and of
``repro/sharding.py::grad_sync_axes``.

A ``RankGrid`` lays ``R`` processes of a ``torch.distributed`` job out on
named axes, row-major over ``axis_names``: on a ``(pod, data)`` grid of
``S x F`` ranks, rank ``r`` sits at pod ``r // F`` and data index
``r % F``, which is jax's device order in ``jax.make_mesh``.  Each axis of
size above 1 gets one process group per line of the grid along it: the
``data`` (fast) group holds the ranks of one pod, the ``pod`` (slow) group
the ranks that share a data index.  A rank's group along an axis lists the
ranks in the order of their coordinate, so a collective's group rank is
the coordinate (``torch.distributed.new_group`` sorts its ranks, and the
coordinate grows with the rank).

``torch.distributed.new_group`` is collective over the whole job: every
process calls it for every group, in the same order, member or not.  So
every process of the job builds every grid, also grids it is not part of
(``RankGrid.member`` is then false).  Beside its axes' groups a grid has
one group of all its ranks (``RankGrid.group``), the job a checkpoint of
the grid's state is saved and restored by.  A grid of one rank makes no
group,
and every collective over it is the identity: the reference's degenerate
mesh (``repro/train.py:266-270``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a grid as seen by one rank: its size, the rank's
    coordinate on it and the process group along it (None at size 1)."""

    name: str
    size: int
    index: int
    group: object = None


class RankGrid:
    """``shape`` over ``axis_names``, on the job's ranks ``ranks`` (in the
    grid's linear order; default all ranks of the job).  Every process of
    the job constructs it (see the module's docstring)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 ranks: Optional[Sequence[int]] = None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axes "
                             f"{axis_names}")
        n = 1
        for s in shape:
            n *= s
        my_rank, world = _job()
        ranks = tuple(range(n) if ranks is None else ranks)
        if (len(ranks) != n or any(r >= max(world, 1) for r in ranks)
                or list(ranks) != sorted(set(ranks))):
            raise ValueError(f"grid {shape} needs {n} distinct ranks of "
                             f"the job's {world}, ascending; got {ranks}")
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.ranks = ranks
        self.size = n
        self.member = my_rank in ranks
        # the rank's linear index in the grid (pod-major on (pod, data))
        self.rank = ranks.index(my_rank) if self.member else None
        coords = (_unravel(self.rank, shape) if self.member
                  else (0,) * len(shape))
        self._axes: Dict[str, Axis] = {}
        for k, name in enumerate(axis_names):
            group = None
            if shape[k] > 1:
                import torch.distributed as dist
                others = [range(s) for j, s in enumerate(shape) if j != k]
                for fixed in itertools.product(*others):
                    members = tuple(
                        ranks[_ravel(fixed[:k] + (i,) + fixed[k:], shape)]
                        for i in range(shape[k]))
                    g = dist.new_group(list(members))
                    if self.member and my_rank in members:
                        group = g
            self._axes[name] = Axis(name, shape[k], coords[k], group)
        # all the grid's ranks (None on a grid of one rank, or for a
        # process outside the grid)
        self.group = None
        if n > 1:
            import torch.distributed as dist
            g = dist.new_group(list(ranks))
            if self.member:
                self.group = g

    def axis(self, name: Optional[str]) -> Optional[Axis]:
        """This rank's view of axis ``name``; None for an axis the grid
        does not have."""
        if name is None or name not in self._axes:
            return None
        return self._axes[name]

    def __repr__(self):
        return (f"RankGrid({self.shape}, rank={self.rank}, "
                f"ranks={self.ranks})")


def _job() -> Tuple[int, int]:
    """(this process's rank, the job's size); (0, 1) outside a job."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _unravel(i: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


def _ravel(coords: Tuple[int, ...], shape: Tuple[int, ...]) -> int:
    i = 0
    for c, s in zip(coords, shape):
        i = i * s + c
    return i


def make_rank_grid(shape: Sequence[int], axis_names: Sequence[str], *,
                   ranks: Optional[Sequence[int]] = None) -> RankGrid:
    """The counterpart of ``make_device_mesh``: a grid over the job's ranks
    (all of them unless ``ranks`` names the grid's)."""
    return RankGrid(shape, axis_names, ranks=ranks)


def axis_tuple(axes: Axes) -> Tuple[str, ...]:
    """Normalize a logical-rule value (None | str | tuple) to a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_size(grid: Optional[RankGrid], axes: Axes) -> int:
    """Product of grid extents over ``axes`` (1 for None / no grid)."""
    if grid is None or axes is None:
        return 1
    n = 1
    for a in axis_tuple(axes):
        n *= grid.shape[a]
    return n


def grad_sync_axes(grid: Optional[RankGrid]
                   ) -> Tuple[Optional[str], Optional[str]]:
    """(fast_axis, slow_axis) for explicit gradient synchronization.

    The manual gradient-sync modes reduce over the data-parallel fast axis
    and the cross-pod slow axis; a grid carrying any *other* non-trivial
    axis (tensor/expert parallelism) cannot keep params replicated, so it
    is rejected here rather than silently miscomputing.
    """
    if grid is None:
        return None, None
    names = tuple(grid.axis_names)
    extra = [a for a in names if a not in ("data", "pod")
             and grid.shape[a] > 1]
    if extra:
        raise ValueError(
            f"manual gradient-sync modes support (pod, data) meshes only; "
            f"mesh has non-trivial axes {extra!r} (use cross_pod_mode="
            f"'xla' for tensor/expert-parallel meshes)")
    fast = "data" if "data" in names else None
    slow = "pod" if "pod" in names else None
    return fast, slow
