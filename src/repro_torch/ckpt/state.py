"""The port's training state as the reference's checkpoint tree.

The reference saves ``(params, opt_state)``: params a nested dict whose
stacked subtrees carry a leading layer axis (``blocks.attn.wq`` of shape
``(L, d, d)``), the optimizer state an ``OptState`` / ``BucketedOptState``
(its ``step`` a 0-d int32 array) or an ``EFState`` around one.  The port
keeps one tensor a layer (``blocks.<i>.attn.wq``), its step a Python int,
and on a rank grid only its own box of each flat bucket.
:func:`state_tree` builds the reference's tree from the port's state —
:class:`~repro_torch.checkpoint.Stacked` leaves for the stacked params
(``bucketing.leaf_tree``), :class:`~repro_torch.checkpoint.Shard` leaves
for the ZeRO-1 bucket shards (over the fast axis, one pod's replica
writes) and the error-feedback residuals (over (pod, data)) — so the
leaf paths, shapes, dtypes, boxes and specs of a save are the
reference's.  :func:`state_from_tree` takes a restored tree back.

:func:`state_digest` fingerprints a state tree by leaf, the same on any
grid the state lives on: the checkpoint handoff's ``verify``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import Job, Shard, Stacked, leaf_shape
from repro_torch.ckpt.sharded import EXACT, PAD_FLAT, ZERO
from repro_torch.ckpt.treepaths import leaf_paths, rebuild
from repro_torch.collectives.bucketing import leaf_tree
from repro_torch.parallel.mesh import grad_sync_axes

Tree = Dict[str, torch.Tensor]


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def params_tree(params: Tree, family: Optional[str] = "dense"
                ) -> Dict[str, Any]:
    """The reference's (nested, stacked) tree of the port's tensors."""
    flat = {}
    for path, leaf in leaf_tree(params, family).items():
        if len(leaf.parts) == 1 and leaf.shape == leaf.part_shape:
            flat[path] = params[leaf.parts[0]]
        else:
            flat[path] = Stacked(leaf.parts,
                                 tuple(params[n] for n in leaf.parts),
                                 leaf.shape)
    return _nest(flat)


def _params_back(tree, order=None) -> Tree:
    out: Tree = {}
    for path, leaf in leaf_paths(tree).items():
        if isinstance(leaf, Stacked):
            out.update(zip(leaf.names, leaf.parts))
        else:
            out[path] = leaf
    return {n: out[n] for n in order} if order is not None else out


def _step(step) -> np.ndarray:
    return np.asarray(step, dtype=np.int32)


def _shards(tensors, grid, *, residual: bool):
    """``Shard`` leaves of this rank's boxes: bucket shards over the fast
    axis, replicated over pod (pod 0 writes); residuals over (pod, data),
    one box a rank."""
    fast, slow = grad_sync_axes(grid)
    if residual:
        axes = tuple(a for a in (slow, fast) if a)
        parts = grid.size if grid is not None else 1
        index = grid.rank if grid is not None else 0
        return tuple(Shard(t, parts, index, True, (axes,) if axes else ())
                     for t in tensors)
    ax = grid.axis(fast) if grid is not None else None
    parts = ax.size if ax is not None else 1
    index = ax.index if ax is not None else 0
    slow_ax = grid.axis(slow) if grid is not None else None
    writer = slow_ax is None or slow_ax.index == 0
    return tuple(Shard(t, parts, index, writer, (fast,)) for t in tensors)


def _opt_tree(opt_state, family, grid):
    if isinstance(opt_state, optim.BucketedOptState):
        return optim.BucketedOptState(
            step=_step(opt_state.step),
            mu=_shards(opt_state.mu, grid, residual=False),
            nu=_shards(opt_state.nu, grid, residual=False),
            master=_shards(opt_state.master, grid, residual=False))
    master = (params_tree(opt_state.master, family)
              if opt_state.master is not None else None)
    return optim.OptState(step=_step(opt_state.step),
                          mu=params_tree(opt_state.mu, family),
                          nu=params_tree(opt_state.nu, family),
                          master=master)


def state_tree(params: Tree, opt_state, *, family: Optional[str] = "dense",
               grid=None) -> Tuple[Any, Any]:
    """The reference's ``(params, opt_state)`` checkpoint tree of the
    port's training state on ``grid`` (this rank's part of it)."""
    from repro_torch.train import EFState
    if isinstance(opt_state, EFState):
        otree = EFState(_opt_tree(opt_state.opt, family, grid),
                        _shards(opt_state.residuals, grid, residual=True))
    else:
        otree = _opt_tree(opt_state, family, grid)
    return params_tree(params, family), otree


def _opt_back(o, order):
    step = int(np.asarray(o.step))
    if isinstance(o, optim.BucketedOptState):
        return optim.BucketedOptState(
            step=step, mu=tuple(s.local for s in o.mu),
            nu=tuple(s.local for s in o.nu),
            master=tuple(s.local for s in o.master))
    return optim.OptState(step=step, mu=_params_back(o.mu, order),
                          nu=_params_back(o.nu, order),
                          master=(_params_back(o.master, order)
                                  if o.master is not None else None))


def state_from_tree(tree, order=None) -> Tuple[Tree, Any]:
    """The port's ``(params, opt_state)`` from a (restored) tree of
    :func:`state_tree`'s structure, its dicts in the key order ``order``
    (the model's parameter order: a step sums over its leaves in that
    order, so a resumed run continues bitwise only in it)."""
    from repro_torch.train import EFState
    ptree, otree = tree
    if isinstance(otree, EFState):
        opt = EFState(_opt_back(otree.opt, order),
                      tuple(s.local for s in otree.residuals))
    else:
        opt = _opt_back(otree, order)
    return _params_back(ptree, order), opt


def restore_policy(tree) -> Tuple[Any, Any]:
    """Per-leaf shape-mismatch policy for reshard-on-restore of a
    :func:`state_tree` (``repro/train.py:766-794``).

    Flat ZeRO-1 buckets (masters/moments) tolerate padded-size drift
    between grid factorizations (PAD_FLAT: the tail past the live prefix
    is zeros on both sides); hierarchical EF residuals whose global size
    follows the rank count are re-zeroed (ZERO — deterministic-mode
    residuals are rank-count-keyed, so their shapes match and restore
    exactly); everything else must match exactly.
    """
    from repro_torch.train import EFState

    def exact(t):
        return rebuild(t, {k: EXACT for k in leaf_paths(t)})

    def opt_policy(o):
        if isinstance(o, optim.BucketedOptState):
            nb = len(o.master)
            return optim.BucketedOptState(
                step=EXACT, mu=(PAD_FLAT,) * nb, nu=(PAD_FLAT,) * nb,
                master=(PAD_FLAT,) * nb)
        return exact(o)

    ptree, otree = tree
    if isinstance(otree, EFState):
        pol = EFState(opt_policy(otree.opt), (ZERO,) * len(otree.residuals))
    else:
        pol = opt_policy(otree)
    return exact(ptree), pol


def state_bytes(tree) -> int:
    """Logical bytes of a state tree: every leaf at its global size."""
    total = 0
    for leaf in leaf_paths(tree).values():
        if leaf is None:
            continue
        local = leaf.local if isinstance(leaf, Shard) else leaf
        dtype = (local.dtype if isinstance(leaf, (torch.Tensor, Shard,
                                                  Stacked))
                 else np.asarray(local).dtype)
        itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                    else np.dtype(dtype).itemsize)
        total += int(np.prod(leaf_shape(leaf))) * itemsize
    return total


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

_P = (1 << 61) - 1          # the digest's modulus
_M31 = (1 << 31) - 1
_A, _B = 1_103_515_245, 12_345
_CHUNK = 1 << 22


def _words(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as non-negative int64 words (< 2^32), flat."""
    t = t.detach().contiguous().reshape(-1)
    size = t.element_size()
    if size == 1:
        return t.view(torch.uint8).to(torch.int64)
    if size == 2:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def box_digest(t, offset: int = 0) -> int:
    """Σ_i w(offset + i) · v_i mod 2^61-1 over the words v_i of ``t``,
    where w(i) = (((A·i + B) mod M)² mod M) + 1, M = 2^31-1.

    Additive over boxes at their global offsets (in words), so the boxes of
    a leaf on any grid sum to the same value, and zero words add nothing
    (zero padding leaves it unchanged).  A single changed word always
    changes it: 1 <= w <= M, and neither w nor a word's change (< 2^32)
    is a multiple of the prime 2^61-1.  w repeats with period M, so
    changes to several words may cancel; unequal arrays then agree only
    by chance.  Exact int64 arithmetic: i < 2^32, w <= 2^31-1, v < 2^32.
    """
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, copy=True).reshape(-1))
    v = _words(t)
    total = 0
    for lo in range(0, v.numel(), _CHUNK):
        vv = v[lo:lo + _CHUNK]
        i = torch.arange(offset + lo, offset + lo + vv.numel(),
                         dtype=torch.int64, device=vv.device)
        w = (i * _A + _B) % _M31
        w = (w * w) % _M31 + 1
        prod = (w * vv) % _P
        total += (int((prod >> 31).sum()) << 31) + int((prod & _M31).sum())
    return total % _P


def _words_per_element(t) -> int:
    size = t.element_size() if isinstance(t, torch.Tensor) \
        else np.asarray(t).dtype.itemsize
    return 1 if size <= 4 else size // 4


def state_digest(tree, mesh=None) -> Dict[str, int]:
    """Per-leaf digest of a state tree (:func:`box_digest`), the same on
    every rank of ``mesh`` and on any grid the state lives on: a sharded
    leaf's boxes are summed over the ranks that write them, a replicated
    leaf is digested whole by each rank."""
    job = Job(mesh)
    mine: Dict[str, int] = {}
    shared: Dict[str, int] = {}
    for key, leaf in leaf_paths(tree).items():
        if leaf is None:
            continue
        if isinstance(leaf, Shard) and leaf.parts > 1:
            if leaf.writer:
                n = int(np.prod(leaf.local.shape))
                shared[key] = box_digest(
                    leaf.local, leaf.index * n
                    * _words_per_element(leaf.local))
            continue
        if isinstance(leaf, Shard):
            leaf = leaf.local
        if isinstance(leaf, Stacked):
            n = int(np.prod(leaf.parts[0].shape)) * _words_per_element(
                leaf.parts[0])
            mine[key] = sum(box_digest(p, i * n)
                            for i, p in enumerate(leaf.parts)) % _P
        else:
            mine[key] = box_digest(leaf)
    for part in job.all_gather(shared):
        for key, d in part.items():
            mine[key] = (mine.get(key, 0) + d) % _P
    return mine
