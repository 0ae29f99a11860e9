"""Deterministic (grid-factorization-invariant) bucket reduction
(counterpart of ``repro/collectives/deterministic.py``).

The hierarchical schedule's floating-point sum *grouping* follows the grid
factorization: on a (2, 2) pod x data grid the global mean is
``(g0+g1)+(g2+g3)`` while a (4, 1) or (1, 4) grid sums otherwise, so a run
restored onto a re-factorized grid drifts bitwise even though every rank's
local gradient is identical.  This module fixes the associativity instead
of the grid: every rank

1. all-gathers all R = S*F per-rank contributions over (slow, fast) into
   *global pod-major rank order*, a property of the job, not of the (S, F)
   factorization;
2. sums them with a fixed pairwise balanced-tree fold
   (:func:`tree_fold_sum`) and divides by R.

The result is bitwise identical for every (S, F) factorization of the same
R ranks.  Cost: the gather moves R/F x the bytes of a reduce-scatter and
every rank holds the (R, bucket) stack, so this is the verification /
elasticity schedule, not the bandwidth-optimal one.  With
``compress_bits=8`` each rank int8-quantizes its own full contribution
before the gather and, with error feedback, carries the residual of its
*own* contribution: per-global-rank state that reshards exactly under any
re-factorization.

The reference seals the reduction with an ``optimization_barrier`` so that
XLA cannot fuse the division by R into its consumers; eager PyTorch fuses
nothing, so the port needs none.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import parallel as PX
from repro_torch.collectives.compression import (dequantize_int8,
                                                 quantize_int8)
from repro_torch.parallel.mesh import Axis

# Buckets in deterministic mode are padded to a multiple of this, so the
# padded bucket sizes, and with them every sum and fold shape, are
# identical across grid factorizations whose fast-axis size divides it.
DETERMINISTIC_ALIGN = 64


def det_align(fast_size: int) -> int:
    """Grid-invariant bucket alignment: lcm(fast, DETERMINISTIC_ALIGN)."""
    f = max(1, int(fast_size))
    return f * DETERMINISTIC_ALIGN // math.gcd(f, DETERMINISTIC_ALIGN)


def gather_rank_stack(x: torch.Tensor,
                      sync_axes: Sequence[Optional[Axis]]) -> torch.Tensor:
    """All-gather ``x`` over ``sync_axes`` into global pod-major order.

    ``sync_axes`` is (outer, ..., inner): (pod, data) in the train step.
    Returns an ``(R,) + x.shape`` stack whose index is the global linear
    rank id, independent of how R factors over the axes.
    """
    out = x.reshape((1,) + tuple(x.shape))
    for ax in reversed(tuple(sync_axes)):
        if PX.axis_size(ax) > 1:
            out = PX.all_gather(out, ax)
            out = out.reshape((-1,) + tuple(x.shape))
    return out


def tree_fold_sum(stack: torch.Tensor) -> torch.Tensor:
    """Balanced pairwise fold over axis 0, a fixed summation tree:
    ``((g0+g1)+(g2+g3))+...``.  Depends only on the number of
    contributions; odd tails pass through to the next level unchanged."""
    while stack.shape[0] > 1:
        m = stack.shape[0]
        half = m // 2
        folded = stack[: 2 * half: 2] + stack[1: 2 * half: 2]
        stack = (torch.cat([folded, stack[2 * half:]], dim=0)
                 if m % 2 else folded)
    return stack[0]


def det_mean(x: torch.Tensor,
             sync_axes: Sequence[Optional[Axis]]) -> torch.Tensor:
    """Grid-invariant mean of a per-rank value (loss scalars, metrics)."""
    if all(PX.axis_size(a) <= 1 for a in sync_axes):
        return x
    stack = gather_rank_stack(x, sync_axes)
    return tree_fold_sum(stack) / stack.shape[0]


def det_reduce_bucket_full(buckets: Sequence[torch.Tensor], *,
                           sync_axes: Sequence[Optional[Axis]],
                           compress_bits: int = 0,
                           residuals: Optional[Sequence[torch.Tensor]] = None
                           ) -> Tuple[Tuple[torch.Tensor, ...], tuple]:
    """Deterministic global mean of flat f32 buckets.

    Every rank ends up holding the *full* meaned bucket (identical bits on
    every rank and for every grid factorization).  ``compress_bits``
    compresses each rank's own contribution before the gather (16 = bf16,
    8 = int8 + per-bucket scale); ``residuals`` (int8 only; one per
    bucket, each the size of the rank's full bucket) switches on error
    feedback over the rank's own contribution.  Returns
    ``(full_buckets, new_residuals)``; residuals are ``()`` when error
    feedback is off.
    """
    if residuals is not None and compress_bits != 8:
        raise ValueError(
            "deterministic error feedback requires the int8 contribution "
            f"(compress_bits=8, got {compress_bits})")
    buckets = tuple(buckets)
    res_in = (tuple(residuals) if residuals is not None
              else (None,) * len(buckets))
    full, res_out = [], []
    for b, res in zip(buckets, res_in):
        contrib = b.float()
        new_res = None
        if res is not None:
            contrib = contrib + res.float()
        if compress_bits == 8:
            q, scale = quantize_int8(contrib)
            recon = dequantize_int8(q, scale)
            if res is not None:
                new_res = contrib - recon
            qs = gather_rank_stack(q, sync_axes)          # (R, C) int8
            ss = gather_rank_stack(scale, sync_axes)      # (R,)
            stack = qs.float() * ss.reshape((-1, 1))
        elif compress_bits == 16:
            stack = gather_rank_stack(contrib.to(torch.bfloat16),
                                      sync_axes).float()
        else:
            assert compress_bits == 0, compress_bits
            stack = gather_rank_stack(contrib, sync_axes)
        full.append(tree_fold_sum(stack) / stack.shape[0])
        res_out.append(new_res)
    if residuals is not None:
        return tuple(full), tuple(res_out)
    return tuple(full), ()


def det_fast_shards(full_buckets: Sequence[torch.Tensor],
                    fast_axis: Optional[Axis]
                    ) -> Tuple[torch.Tensor, ...]:
    """Each rank's contiguous fast-axis slice of the full meaned buckets:
    the deterministic analogue of the reduce-scattered shard the ZeRO-1
    optimizer consumes; identity when the fast axis is absent/trivial."""
    nf = PX.axis_size(fast_axis)
    if nf <= 1:
        return tuple(full_buckets)
    idx = PX.axis_index(fast_axis)
    out = []
    for b in full_buckets:
        size = b.shape[0] // nf
        out.append(b[idx * size:(idx + 1) * size])
    return tuple(out)


def det_global_norm(full_buckets: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global gradient norm from the full meaned buckets: local arithmetic
    on data that is bitwise identical on every rank and across
    factorizations (same padded shapes via :func:`det_align`), so no
    collective is needed and the result is grid-invariant."""
    ss = torch.zeros((), dtype=torch.float32,
                     device=full_buckets[0].device)
    for b in full_buckets:
        ss = ss + b.float().square().sum()
    return ss.sqrt()
