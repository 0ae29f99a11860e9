"""The port's multi-rank runtime layer (counterpart of ``repro/parallel``).

- :mod:`repro_torch.parallel.mesh`: rank grids over a gloo job, and axis
  bookkeeping;
- :mod:`repro_torch.parallel.collectives`: named collectives over a grid's
  axes, staged through pinned host memory;
- :mod:`repro_torch.parallel.transport`: the canonical transport tiers
  (SHM / NET / ICI / DCN);
- :mod:`repro_torch.parallel.launch`: R spawned processes as one gloo job.

The reference's ``compat.shard_map`` has no counterpart: a rank function is
a function that runs in each process.
"""
from repro_torch.parallel.collectives import (all_gather, all_gather_flat,
                                              axis_index, axis_size, pmax,
                                              pmean, psum,
                                              reduce_scatter_flat)
from repro_torch.parallel.mesh import (Axis, RankGrid, axes_size,
                                       axis_tuple, grad_sync_axes,
                                       make_rank_grid)
from repro_torch.parallel.transport import (AXIS_TIER, TIERS, TransportTier,
                                            fast_slow_axes, is_slow_axis,
                                            tier_for_axis)

__all__ = [
    "Axis", "RankGrid", "make_rank_grid", "axes_size", "axis_tuple",
    "grad_sync_axes", "psum", "pmean", "pmax", "all_gather", "axis_index",
    "axis_size", "reduce_scatter_flat", "all_gather_flat", "TIERS",
    "AXIS_TIER", "TransportTier", "tier_for_axis", "is_slow_axis",
    "fast_slow_axes",
]
