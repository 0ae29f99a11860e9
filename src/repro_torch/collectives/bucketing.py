"""Bucketed flat-buffer gradient collectives, the fused hot path
(counterpart of ``repro/collectives/bucketing.py``).

Applied *per gradient tensor*, the hierarchical schedule of
:mod:`repro_torch.collectives.hierarchical` launches 3 collectives and a
pad for every leaf.  This module fuses it: the f32 gradients are packed
into a few fixed-capacity contiguous f32 *buckets* with a deterministic
leaf -> bucket layout, and the schedule runs **once per bucket**:

    reduce_scatter(fast)  ->  psum(slow, optionally int8/bf16)  ->
    all_gather(fast)

Bucket sizes are padded to a multiple of ``align`` (the fast-axis size), so
the reduce-scatter needs no per-tensor padding.

**The layout is the reference's, leaf for leaf.**  The reference plans over
``jax.tree.flatten`` order: dict keys sorted, and a model's stacked
subtrees (the dense ``blocks``, stacked over layers) as single leaves.  The
port's parameters are unstacked, one tensor a layer (``blocks.<i>.<path>``,
``convert.STACKED_AXES``).  So :func:`leaf_tree` rebuilds the reference's
leaves from the port's names: a stacked leaf is the concatenation, in layer
order, of the port's per-layer tensors, which is its row-major flattening.
:func:`plan_buckets` over that tree gives the reference's bucket sizes and
slots, and :func:`flatten_to_buckets` of bridged weights the reference's
buffers bit for bit; that is what a checkpoint of flat buckets written by
one side and read by the other needs.  Each :class:`LeafSlot` also names
the port tensors (``parts``) it is made of.

Two consumers, as in the reference: ``cross_pod_mode="hier_bucketed"``
re-gathers the full mean gradient for a replicated optimizer;
``"hier_bucketed_zero1"`` stops after the slow hop, updates each rank's
bucket *shard* (f32 masters sharded over the fast axis) and all-gathers
the updated *params*.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch import parallel as PX
from repro_torch.collectives.hierarchical import (fast_reduce_scatter,
                                                  slow_mean_shard)
from repro_torch.convert import STACKED_AXES
from repro_torch.parallel.mesh import Axis

DEFAULT_BUCKET_BYTES = 32 << 20          # 32 MiB of f32 per bucket

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's tree: its stacked shape and dtype, and
    the port's tensors that make it, in stacking order."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    parts: Tuple[str, ...]
    part_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf lives inside the bucket set."""

    bucket: int                  # bucket index
    offset: int                  # f32-element offset within the bucket
    size: int                    # number of elements
    shape: Tuple[int, ...]       # the reference's (stacked) shape
    dtype: torch.dtype           # storage dtype (restored on unflatten)
    path: str                    # the reference's leaf path
    parts: Tuple[str, ...]       # the port's tensors, in stacking order
    part_shape: Tuple[int, ...]  # the shape of each of them


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Deterministic leaf -> bucket placement for one tree structure.

    ``slots`` follow the reference's ``jax.tree.flatten`` leaf order;
    greedy first-fit in that order makes the layout a pure function of
    (tree structure, leaf shapes and dtypes, bucket_bytes, align).
    """

    slots: Tuple[LeafSlot, ...]
    bucket_sizes: Tuple[int, ...]        # padded numels, each % align == 0
    align: int

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    def n_elements(self) -> int:
        """Live (un-padded) elements across all buckets."""
        return sum(s.size for s in self.slots)

    def n_padded_elements(self) -> int:
        return sum(self.bucket_sizes)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _round_up(n: int, align: int) -> int:
    return ((n + align - 1) // align) * align


def leaf_tree(named: Mapping[str, object], family: Optional[str] = "dense"
              ) -> Dict[str, Leaf]:
    """The reference's leaves, in ``jax.tree.flatten`` order, from the
    port's tensors by name (anything with ``shape`` and ``dtype``: tensors,
    meta tensors).  ``family`` picks the stacked subtrees
    (``convert.STACKED_AXES``); ``None`` stacks nothing."""
    stacked = STACKED_AXES[family] if family is not None else {}
    groups: Dict[str, list] = {}
    for name, t in named.items():
        prefix = next((p for p in stacked if name.startswith(p + ".")), "")
        if not prefix:
            groups.setdefault(name, []).append(((), name, t))
            continue
        comps = name[len(prefix) + 1:].split(".")
        n_axes = stacked[prefix]
        index = tuple(int(c) for c in comps[:n_axes])
        path = ".".join([prefix] + comps[n_axes:])
        groups.setdefault(path, []).append((index, name, t))
    tree = {}
    for path in sorted(groups, key=lambda p: tuple(p.split("."))):
        members = sorted(groups[path], key=lambda m: m[0])
        first = members[0][2]
        counts = tuple(max(m[0][k] for m in members) + 1
                       for k in range(len(members[0][0])))
        part_shape = tuple(first.shape)
        if _numel(counts) != len(members) or any(
                tuple(m[2].shape) != part_shape or m[2].dtype != first.dtype
                for m in members):
            raise ValueError(f"leaf {path}: its parts do not stack")
        tree[path] = Leaf(counts + part_shape, first.dtype,
                          tuple(m[1] for m in members), part_shape)
    return tree


def plan_buckets(named: Mapping[str, object], *,
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES, align: int = 1,
                 family: Optional[str] = "dense") -> BucketLayout:
    """Greedy first-fit bucketing of the reference's leaves of ``named``
    (see :func:`leaf_tree`) into f32 buckets.

    A bucket closes when the next leaf would push it past ``bucket_bytes``
    worth of f32; a single leaf larger than the capacity gets a bucket of
    its own.  Every bucket is padded up to a multiple of ``align`` (pass
    the fast-axis size so reduce-scatter divides evenly).
    """
    assert bucket_bytes >= 4 and align >= 1
    capacity = max(1, bucket_bytes // 4)   # f32 elements per bucket
    slots = []
    bucket_sizes = []
    fill = 0
    for path, leaf in leaf_tree(named, family).items():
        size = _numel(leaf.shape)
        if fill and fill + size > capacity:
            bucket_sizes.append(_round_up(fill, align))
            fill = 0
        slots.append(LeafSlot(bucket=len(bucket_sizes), offset=fill,
                              size=size, shape=leaf.shape, dtype=leaf.dtype,
                              path=path, parts=leaf.parts,
                              part_shape=leaf.part_shape))
        fill += size
    if fill or not bucket_sizes:
        bucket_sizes.append(_round_up(max(fill, 1), align))
    return BucketLayout(slots=tuple(slots), bucket_sizes=tuple(bucket_sizes),
                        align=align)


def flatten_bucket(layout: BucketLayout, tree: Mapping[str, torch.Tensor],
                   b: int) -> torch.Tensor:
    """Bucket ``b`` of ``tree`` (the port's tensors by name) as a new f32
    buffer; padding is zero."""
    slots = [s for s in layout.slots if s.bucket == b]
    buf = torch.zeros(layout.bucket_sizes[b], dtype=torch.float32,
                      device=tree[slots[0].parts[0]].device)
    for slot in slots:
        n = _numel(slot.part_shape)
        for i, name in enumerate(slot.parts):
            lo = slot.offset + i * n
            buf[lo:lo + n].copy_(tree[name].reshape(-1))
    return buf


def flatten_to_buckets(layout: BucketLayout,
                       tree: Mapping[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, ...]:
    """Pack ``tree`` into f32 buckets per ``layout``: new buffers, leaves
    cast to f32, padding zero.  Exact inverse of
    :func:`unflatten_from_buckets` on the live regions."""
    n_parts = sum(len(s.parts) for s in layout.slots)
    assert n_parts == len(tree), (
        f"{len(tree)} tensors vs a layout of {n_parts}")
    return tuple(flatten_bucket(layout, tree, b)
                 for b in range(layout.n_buckets))


def _bucket_pieces(layout: BucketLayout, buckets: Sequence[torch.Tensor]):
    """(name, slot, view of the bucket) of every tensor in ``buckets``:
    each bucket is cut with one ``split``, whose backward is one
    concatenation, so differentiating through it costs one buffer a
    bucket."""
    assert len(buckets) == layout.n_buckets
    for b, bucket in enumerate(buckets):
        slots = [s for s in layout.slots if s.bucket == b]
        names, sizes = [], []
        for slot in slots:
            n = _numel(slot.part_shape)
            for name in slot.parts:
                names.append((name, slot))
                sizes.append(n)
        pad = bucket.shape[0] - sum(sizes)
        pieces = torch.split(bucket, sizes + [pad] if pad else sizes)
        for (name, slot), piece in zip(names, pieces):
            yield name, slot, piece.view(slot.part_shape)


def unflatten_from_buckets(layout: BucketLayout,
                           buckets: Sequence[torch.Tensor], *,
                           dtype: Optional[torch.dtype] = None) -> Tree:
    """The port's tensors by name from flat buckets.

    ``dtype=None`` restores each tensor's storage dtype from the layout;
    passing a dtype (``torch.float32`` for gradients) overrides it; where
    the dtype is f32 the tensors are views of the buckets.
    """
    return {name: piece.to(slot.dtype if dtype is None else dtype)
            for name, slot, piece in _bucket_pieces(layout, buckets)}


@torch.no_grad()
def unflatten_into(layout: BucketLayout, buckets: Sequence[torch.Tensor],
                   params: Tree) -> None:
    """:func:`unflatten_from_buckets` written into ``params``' own
    storage, each piece cast to the param's dtype as ``to`` casts it."""
    for name, _slot, piece in _bucket_pieces(layout, buckets):
        params[name].copy_(piece)


# ---------------------------------------------------------------------------
# bucket-resident loss/grad + collectives
# ---------------------------------------------------------------------------

def make_bucket_loss_and_grad(model: nn.Module, layout: BucketLayout, *,
                              accum: int):
    """fn(param_buckets, batch) -> (loss, grad buckets): the mean loss over
    ``accum`` microbatches and the mean of their gradients with respect to
    the flat f32 buckets.

    The forward reads the buckets through :func:`unflatten_from_buckets`,
    cast to each tensor's storage dtype (so the math is that of
    ``train.make_loss_and_grad``); the gradient lands in bucket form and
    accumulates there, in f32.  Loss and backward run in one
    ``functional_call``, as in ``train.make_loss_and_grad``.
    """
    from repro_torch.train import _LossAndGrad, _split_micro
    wrapper = _LossAndGrad(model)

    def fn(param_buckets: Sequence[torch.Tensor], batch: Tree):
        micro = _split_micro(batch, accum)
        bks = [b.detach().requires_grad_() for b in param_buckets]
        grads = [torch.zeros_like(b) for b in bks]
        loss_sum = torch.zeros((), dtype=torch.float32, device=bks[0].device)
        for i in range(accum):
            mb = {k: v[i] for k, v in micro.items()}
            cast = {f"model.{n}": t for n, t in
                    unflatten_from_buckets(layout, bks).items()}
            loss, g = torch.func.functional_call(wrapper, cast, (mb, bks))
            for acc, gi in zip(grads, g):
                acc += gi
            del g
            loss_sum += loss
        inv = 1.0 / accum
        return loss_sum * inv, tuple(g * inv for g in grads)

    return fn


def hier_reduce_bucket_shards(buckets: Sequence[torch.Tensor], *,
                              fast_axis: Optional[Axis],
                              slow_axis: Optional[Axis],
                              compress_bits: int = 0,
                              overlap: bool = False,
                              residuals: Optional[Sequence[torch.Tensor]]
                              = None):
    """One hierarchical reduce per *bucket* (not per tensor).

    Returns each rank's globally meaned contiguous shard of every bucket
    (full buckets when ``fast_axis`` is None / size 1).

    ``overlap=True`` runs the k-bucket sync as a depth-1 software pipeline
    (``repro/collectives/bucketing.py:206-279``): bucket i+1's fast-axis
    reduce-scatter is issued, asynchronously, *before* bucket i's slow hop
    runs, so the slow hop of every bucket but the last runs while the next
    bucket's fast phase is in flight.  Per-bucket arithmetic is that of the
    serial schedule (:func:`fast_reduce_scatter` / :func:`slow_mean_shard`),
    so the result is bitwise identical; with a single bucket, a trivial
    fast axis, or no slow axis the pipeline degenerates to the serial path.

    ``residuals`` (one per bucket, per-rank shard-shaped) switches the
    compressed slow hop to error feedback; the return value is then
    ``(shards, new_residuals)`` instead of just the shards.
    """
    k = len(buckets)
    nf = PX.axis_size(fast_axis)
    ns = PX.axis_size(slow_axis)
    if residuals is not None and compress_bits != 8:
        raise ValueError(
            "error-feedback residuals require the int8 slow hop "
            f"(compress_bits=8, got {compress_bits}): without it the "
            "residuals would silently never update")
    res_in = tuple(residuals) if residuals is not None else (None,) * k
    assert len(res_in) == k, (len(res_in), k)

    def slow(shard, res):
        out = slow_mean_shard(shard, fast_axis=fast_axis,
                              slow_axis=slow_axis,
                              compress_bits=compress_bits, residual=res)
        return out if res is not None else (out, None)

    pipelined = overlap and k >= 2 and nf > 1 and ns > 1
    shards, res_out = [], []
    if not pipelined:
        for b, res in zip(buckets, res_in):
            s, r = slow(fast_reduce_scatter(b, fast_axis), res)
            shards.append(s)
            res_out.append(r)
    else:
        cur = fast_reduce_scatter(buckets[0], fast_axis, async_op=True)
        for i in range(k):
            nxt = None
            if i + 1 < k:
                # issued before bucket i's slow hop, waited on after it
                nxt = fast_reduce_scatter(buckets[i + 1], fast_axis,
                                          async_op=True)
            s, r = slow(cur.wait(), res_in[i])
            shards.append(s)
            res_out.append(r)
            cur = nxt
    if residuals is not None:
        return tuple(shards), tuple(res_out)
    return tuple(shards)


def all_gather_buckets(shards: Sequence[torch.Tensor], *,
                       fast_axis: Optional[Axis]
                       ) -> Tuple[torch.Tensor, ...]:
    """Re-assemble full buckets from per-rank shards (identity when the
    fast axis is absent or trivial)."""
    return tuple(PX.all_gather_flat(s, fast_axis) for s in shards)


def shard_global_norm(shards: Sequence[torch.Tensor],
                      fast_axis: Optional[Axis]) -> torch.Tensor:
    """Global gradient norm from reduce-scattered bucket shards.

    The shards are already summed over the slow axis (replicated there),
    so one psum over the fast axis completes the global sum of squares.
    Both bucketed train paths use this, so they stay bitwise identical.
    """
    ss = torch.zeros((), dtype=torch.float32, device=shards[0].device)
    for s in shards:
        ss = ss + s.float().square().sum()
    return PX.psum(ss, fast_axis).sqrt()
