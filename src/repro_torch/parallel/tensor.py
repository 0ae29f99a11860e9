"""Differentiable collectives at the edges of a tensor-parallel region.

``parallel/collectives.py``'s ``psum`` is not differentiable.  A layer whose
weights the rules split over a grid axis (Megatron's column- and
row-parallel matmuls) is a *region*: every rank holds the whole input, runs
its share of the columns, and the row-parallel output is a partial sum.
Its edges are Megatron's pair:

- :func:`copy_to` at the entry: identity forward; backward, the sum of
  every rank's partial input gradient (``psum``);
- :func:`reduce_from` at the exit: ``psum`` forward; identity backward
  (each rank's share receives the whole output's gradient).

A parameter that a computation left whole uses on every rank gets the same
gradient on each of them, while a parameter read through the rank's slice
gets zeros outside it; the training step sums every gradient over the
tensor-parallel axes.  :func:`replicated` marks the first kind of use: its
backward keeps the gradient on the rank at index 0 of those axes and gives
the others zeros, so that the sum counts it once.

All three go through ``parallel/collectives.py``: its pinned-host staging
on the card and its ``STATS``.  With no axes (or axes of size 1) each is the
identity.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.parallel import collectives as PX
from repro_torch.parallel.mesh import Axis

__all__ = ["copy_to", "reduce_from", "replicated"]


def _live(axes: Sequence[Axis]) -> tuple:
    return tuple(a for a in axes if a is not None and a.size > 1)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return PX.psum(g.contiguous(), ctx.axes), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return PX.psum(x.contiguous(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, axes):
        ctx.keep = all(a.index == 0 for a in axes)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def copy_to(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """Enter a region split over ``axes``: identity forward, ``psum`` of
    the input's gradient backward."""
    axes = _live(axes)
    return _CopyTo.apply(x, axes) if axes else x


def reduce_from(x: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """Leave a region split over ``axes``: the ``psum`` of every rank's
    partial ``x``; identity backward."""
    axes = _live(axes)
    return _ReduceFrom.apply(x, axes) if axes else x


def replicated(w: torch.Tensor, axes: Sequence[Axis]) -> torch.Tensor:
    """``w`` as used by a computation that every rank along ``axes`` runs
    whole: identity forward; backward, the gradient on the rank at index 0
    of ``axes``, zeros on the others.  A no-op without grad."""
    axes = _live(axes)
    if not axes or not torch.is_grad_enabled():
        return w
    return _Replicated.apply(w, axes)
