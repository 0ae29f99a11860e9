"""Two-level ("SHM-first") collectives: the paper's runtime insight
(counterpart of ``repro/collectives/hierarchical.py``).

Flex-MIG's SHM collectives exploit the intra-host fast path between
leaves.  These functions implement the hierarchical schedule explicitly
over a rank grid's axes:

    all_reduce  = reduce_scatter(fast axis)
                -> all_reduce(slow axis, optionally compressed)
                -> all_gather(fast axis)

which moves only 1/F of the tensor across the slow boundary (F = fast-axis
size) instead of the whole tensor: "keep bulk traffic on SHM, not NET".
Fast/slow classification comes from ``repro_torch.parallel.transport``.
Each function runs in every rank of the grid; an axis that is ``None`` or
of size 1 skips its hop.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import parallel as PX
from repro_torch.collectives.compression import (compressed_psum_mean,
                                                 compressed_psum_mean_ef)
from repro_torch.parallel.mesh import Axis, RankGrid
from repro_torch.parallel.transport import is_slow_axis


def fast_reduce_scatter(flat: torch.Tensor, fast_axis: Optional[Axis], *,
                        async_op: bool = False):
    """Stage 1 of the hierarchical schedule: fast-axis reduce-scatter.

    Identity when the fast axis is absent or trivial.  ``flat`` must be
    1-D with length divisible by the fast-axis size.  ``async_op=True``
    returns a handle whose ``wait()`` gives the shard, so the bucketed
    paths can pipeline it against the previous bucket's slow hop.
    """
    return PX.reduce_scatter_flat(flat, fast_axis, async_op=async_op)


def slow_mean_shard(shard: torch.Tensor, *, fast_axis: Optional[Axis],
                    slow_axis: Optional[Axis], compress_bits: int = 0,
                    residual: Optional[torch.Tensor] = None):
    """Stage 2: slow-axis mean (optionally compressed) + /F normalization.

    ``shard`` is one rank's fast-axis reduce-scattered slice (stage 1's
    output).  When ``residual`` is given the compressed slow hop runs
    with error feedback (int8 only) and the new residual, in the same
    pre-normalization units as the input, is returned alongside:
    ``(meaned_shard, new_residual)``.  With ``residual=None`` only the
    shard is returned.
    """
    nf = PX.axis_size(fast_axis)
    if slow_axis is not None:
        if compress_bits and residual is not None:
            shard, residual = compressed_psum_mean_ef(
                shard, residual, slow_axis, bits=compress_bits)
        elif compress_bits:
            shard = compressed_psum_mean(shard, slow_axis,
                                         bits=compress_bits)
        else:
            ns = PX.axis_size(slow_axis)
            shard = PX.psum(shard, slow_axis) / ns
    shard = shard / nf
    return shard if residual is None else (shard, residual)


def hier_reduce_mean_shard(flat: torch.Tensor, *,
                           fast_axis: Optional[Axis],
                           slow_axis: Optional[Axis],
                           compress_bits: int = 0) -> torch.Tensor:
    """Fast-axis reduce-scatter + slow-axis mean of a flat f32 buffer.

    Each rank is left holding the *globally meaned* 1/F contiguous slice
    of ``flat`` (replicated across the slow axis), which is what a
    shard-resident (ZeRO-1) optimizer consumes.  Composition of
    :func:`fast_reduce_scatter` and :func:`slow_mean_shard`, which the
    overlapped bucket schedule calls stage by stage, so serial and
    overlapped results are bitwise equal by construction.
    """
    return slow_mean_shard(fast_reduce_scatter(flat, fast_axis),
                           fast_axis=fast_axis, slow_axis=slow_axis,
                           compress_bits=compress_bits)


def hier_all_reduce_mean(x: torch.Tensor, *, fast_axis: Optional[Axis],
                         slow_axis: Optional[Axis],
                         compress_bits: int = 0) -> torch.Tensor:
    """Hierarchical mean all-reduce of one tensor.

    compress_bits: 0 (full precision) | 16 (bf16) | 8 (int8+scale) for the
    slow hop only.  Pads the flattened tensor so the fast axis divides it.
    """
    nf = PX.axis_size(fast_axis)
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % nf
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = hier_reduce_mean_shard(flat, fast_axis=fast_axis,
                                   slow_axis=slow_axis,
                                   compress_bits=compress_bits)
    flat = PX.all_gather_flat(shard, fast_axis)          # fast all-gather
    if pad:
        flat = flat[:-pad]
    return flat.reshape(x.shape)


def flat_all_reduce_mean(x: torch.Tensor, *,
                         axes: Sequence[Optional[Axis]]) -> torch.Tensor:
    """Baseline: psum over all axes (the 'NET-everything' schedule the
    paper's stock-NCCL workaround forces)."""
    n = 1
    for ax in axes:
        n *= PX.axis_size(ax)
    return PX.psum(x, axes) / n


def make_hier_all_reduce(grid: RankGrid, *, fast_axis: str = "data",
                         slow_axis: Optional[str] = "pod",
                         compress_bits: int = 0, flat: bool = False):
    """fn(x) -> the mean of every rank's ``x`` over the grid, on every
    rank: hierarchical, or the flat baseline with ``flat=True``.  The
    default fast/slow split matches the transport tier map; passing a slow
    axis as ``fast_axis`` (or vice versa) is almost certainly a bug."""
    assert not is_slow_axis(fast_axis), (
        f"fast_axis {fast_axis!r} is a slow-transport axis")
    assert slow_axis is None or is_slow_axis(slow_axis), (
        f"slow_axis {slow_axis!r} is a fast-transport axis")
    fast, slow = grid.axis(fast_axis), grid.axis(slow_axis)

    def fn(x):
        if flat:
            return flat_all_reduce_mean(x, axes=(fast, slow))
        return hier_all_reduce_mean(x, fast_axis=fast, slow_axis=slow,
                                    compress_bits=compress_bits)

    return fn
