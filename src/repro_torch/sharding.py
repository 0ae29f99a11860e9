"""Logical-axis sharding rules (counterpart of ``repro/sharding.py``).

Model code names a tensor's dimensions by *logical* axis ("batch",
"heads", "ff", "vocab", ...).  A ``MeshRules`` mapping, chosen per rank
grid, resolves logical names to the grid's physical axes.  Outside a rules
context (one process, no grid) every dimension is whole, so the same model
code runs everywhere.

In the reference GSPMD partitions the program from these annotations.  The
port has no partitioner: its models ask :func:`split` (or :func:`part`,
one dimension) which grid axis splits each dimension of a tensor, and
compute only the rank's share of it, with the collectives of
``parallel/tensor.py`` at the edges of the split regions.  ``split`` holds
the reference's drop rule (``shard`` and ``tree_shardings``): an axis whose
size does not divide the dimension is dropped, and that dimension stays
whole on every rank (6 heads under a 4-way ``model`` axis).

``grad_sync_axes`` stays in ``parallel/mesh.py``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.parallel.mesh import Axis, RankGrid, axes_size, axis_tuple

Axes = Union[None, str, Tuple[str, ...]]

# the logical axes whose split makes a rank compute a share of a layer: a
# grid axis one of them maps to is a tensor-parallel axis
TENSOR_AXES = ("heads", "kv_heads", "ff", "vocab", "expert")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Maps logical axis names to physical grid axis names (or None)."""

    rules: Dict[str, Axes]
    mesh: Optional[RankGrid] = None

    def to_pspec(self, logical: Sequence[Optional[str]]) -> Tuple[Axes, ...]:
        """The physical axes of each logical name (the reference's
        ``PartitionSpec``, as a tuple)."""
        phys = []
        for name in logical:
            if name is None:
                phys.append(None)
            else:
                if name not in self.rules:
                    raise KeyError(f"unknown logical axis {name!r}; "
                                   f"known: {sorted(self.rules)}")
                phys.append(self.rules[name])
        return tuple(phys)


_current: contextvars.ContextVar[Optional[MeshRules]] = contextvars.ContextVar(
    "mesh_rules", default=None)


def current_rules() -> Optional[MeshRules]:
    return _current.get()


@contextlib.contextmanager
def use_rules(rules: Optional[MeshRules]):
    tok = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(tok)


def _kept(dim: int, axes: Axes, grid: Optional[RankGrid]) -> Axes:
    """The drop rule for one dimension (``repro/sharding.py:88-95``)."""
    n = axes_size(grid, axes)
    return axes if (n > 1 and dim % n == 0) or n == 1 else None


def split(shape: Sequence[int], *logical: Optional[str],
          rules: Optional[MeshRules] = None) -> Tuple[Axes, ...]:
    """For a tensor of ``shape`` annotated ``logical`` (missing trailing
    names are None), the grid axes that split each dimension after the drop
    rule; None for a whole dimension.  ``rules`` defaults to the active
    rules; with none, or rules without a grid, every dimension is whole."""
    rules = rules if rules is not None else _current.get()
    if rules is None or rules.mesh is None:
        return (None,) * len(shape)
    spec = rules.to_pspec(logical) + (None,) * (len(shape) - len(logical))
    return tuple(_kept(dim, ax, rules.mesh) for dim, ax in zip(shape, spec))


@dataclasses.dataclass(frozen=True)
class Part:
    """This rank's share of one dimension of ``size``: the ``index``-th of
    ``n`` equal parts, split over the grid axes ``axes`` (outer to inner;
    empty and ``n == 1`` when the dimension is whole)."""

    size: int
    n: int = 1
    index: int = 0
    axes: Tuple[Axis, ...] = ()

    @property
    def lo(self) -> int:
        return self.index * (self.size // self.n)

    @property
    def hi(self) -> int:
        return self.lo + self.size // self.n

    @property
    def slice(self) -> slice:
        return slice(self.lo, self.hi)


def part(size: int, name: Optional[str],
         rules: Optional[MeshRules] = None) -> Part:
    """This rank's :class:`Part` of a dimension of ``size`` named ``name``
    (:func:`split`'s answer for one dimension)."""
    rules = rules if rules is not None else _current.get()
    (ax,) = split((size,), name, rules=rules)
    axes = tuple(a for a in (rules.mesh.axis(n) for n in axis_tuple(ax))
                 if a is not None and a.size > 1) if ax else ()
    if not axes:
        return Part(size)
    if not rules.mesh.member:
        raise ValueError(f"this process is not a rank of {rules.mesh}")
    n, index = 1, 0
    for a in axes:
        n, index = n * a.size, index * a.size + a.index
    return Part(size, n, index, axes)


def tensor_axes(rules: Optional[MeshRules] = None) -> Tuple[Axis, ...]:
    """The grid axes (of size above 1) that the rules split a layer's
    heads, ``ff`` columns, vocabulary or experts over: a computation the
    rules leave whole runs the same on every rank along them, and the
    training step sums the parameters' gradients over them."""
    rules = rules if rules is not None else _current.get()
    if rules is None or rules.mesh is None:
        return ()
    names = []
    for logical in TENSOR_AXES:
        for a in axis_tuple(rules.rules.get(logical)):
            if a not in names:
                names.append(a)
    batch = set(axis_tuple(rules.rules.get("batch")))
    if batch & set(names):
        raise NotImplementedError(
            f"rules split the batch and a layer over the same grid axes "
            f"{sorted(batch & set(names))}")
    axes = (rules.mesh.axis(a) for a in names)
    return tuple(a for a in axes if a is not None and a.size > 1)


def tree_shardings(mesh: RankGrid, rules: MeshRules, shapes_tree, axes_tree):
    """The split of every leaf of a tree (nested dicts) of shapes (tuples,
    or anything with ``.shape``) given its logical axes: the reference's
    ``tree_shardings``, each ``NamedSharding``'s spec as a tuple with the
    drop rule applied per dimension."""
    if isinstance(axes_tree, dict):
        return {k: tree_shardings(mesh, rules, shapes_tree[k], v)
                for k, v in axes_tree.items()}
    shape = tuple(getattr(shapes_tree, "shape", shapes_tree))
    return split(shape, *axes_tree,
                 rules=dataclasses.replace(rules, mesh=mesh))


def without_axes(rules: MeshRules, drop: frozenset) -> MeshRules:
    """Rules with some physical axes removed."""
    new: Dict[str, Axes] = {}
    for k, ax in rules.rules.items():
        if ax is None:
            new[k] = None
        elif isinstance(ax, str):
            new[k] = None if ax in drop else ax
        else:
            kept = tuple(a for a in ax if a not in drop)
            new[k] = kept if len(kept) > 1 else (kept[0] if kept else None)
    return MeshRules(rules=new, mesh=rules.mesh)


def batch_axes(rules: Optional[MeshRules] = None) -> Tuple[str, ...]:
    """Physical axes the batch dim is sharded over."""
    rules = rules or _current.get()
    if rules is None:
        return ()
    return axis_tuple(rules.rules.get("batch"))


def model_axes(rules: Optional[MeshRules] = None) -> Tuple[str, ...]:
    rules = rules or _current.get()
    if rules is None:
        return ()
    return axis_tuple(rules.rules.get("expert"))


# ---------------------------------------------------------------------------
# Standard rule sets
# ---------------------------------------------------------------------------

def make_rules(mesh: RankGrid, *, seq_shard: bool = False,
               long_ctx: bool = False, fsdp: bool = True,
               seq_parallel: bool = False) -> MeshRules:
    """Production rules for ("pod","data","model") / ("data","model") grids
    (``repro/sharding.py:162-208``, the dict key for key).

    - batch       -> all data-parallel axes (pod outermost)
    - embed       -> 'data' (FSDP; no model of the port names it yet)
    - heads/ff/vocab/expert -> 'model' (tensor / expert parallelism)
    - kv_seq      -> 'model' when seq_shard (sequence-parallel long decode)
    """
    names = tuple(mesh.axis_names)
    dp: Axes
    if "pod" in names:
        dp = ("pod", "data")
    elif "data" in names:
        dp = "data"
    else:
        dp = None
    rules: Dict[str, Axes] = {
        "batch": dp,
        "embed": "data" if (fsdp and "data" in names) else None,
        "heads": "model" if "model" in names else None,
        "kv_heads": None,          # GQA kv heads often don't divide TP
        "ff": "model" if "model" in names else None,
        "vocab": "model" if "model" in names else None,
        "expert": "model" if "model" in names else None,
        "seq": ("model" if seq_parallel and "model" in names else None),
        "kv_seq": ("model" if seq_shard and "model" in names else None),
        "kv_batch": dp,
        "state": None,
        "conv": None,
        "norm": None,
        "lora": None,
    }
    if long_ctx:
        rules["batch"] = None
        rules["kv_batch"] = None
        seq_axes = tuple(a for a in ("data", "model") if a in names)
        rules["kv_seq"] = seq_axes if seq_axes else None
    return MeshRules(rules=rules, mesh=mesh)


def single_device_rules() -> MeshRules:
    return MeshRules(rules={k: None for k in (
        "batch", "embed", "heads", "kv_heads", "ff", "vocab", "expert",
        "seq", "kv_seq", "kv_batch", "state", "conv", "norm", "lora")})

