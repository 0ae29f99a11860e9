"""Named collectives over a rank grid's axes (counterpart of
``repro/parallel/collectives.py``), on ``torch.distributed``'s gloo backend.

An axis is a :class:`repro_torch.parallel.mesh.Axis` (``grid.axis(name)``);
an axis of size 1, or ``None``, makes every collective the identity.  Each
call returns a new tensor on its input's device and leaves the input as it
was.

**Host staging: the paper's SHM path.**  NCCL refuses two ranks on one GPU
("Duplicate GPU detected"), so the port's ranks talk through gloo in host
memory.  A tensor on the card is copied into a pinned host buffer, the gloo
collective runs on host tensors, and the result is copied back; CPU tensors
skip the copies.  The same gloo calls thus run here on the CPU and on the
card.  Pinned buffers come from a pool keyed by size and dtype and go back
to it when the result has reached the card, so a step reuses the buffers
of the step before and two collectives in flight never share one.

``async_op=True`` returns a :class:`Pending` whose ``wait()`` gives the
result: the overlap schedule of ``collectives.bucketing`` issues one
bucket's reduce-scatter before it waits on the previous bucket's slow hop.

``STATS`` adds up, per process, the seconds spent in each collective (from
issue to the end of its wait) by tier and op, in the copies to and from
the host, and the bytes each collective handed to its tier: the split of a
step that ``chip_smoke.py``'s sync phase prints.  ``ppermute`` and
``psum_scatter`` are not ported: nothing on the ported paths calls them.
"""
from __future__ import annotations

import collections
import time
import warnings
from typing import Optional, Sequence, Union

import torch

from repro_torch.parallel.mesh import Axis
from repro_torch.parallel.transport import is_slow_axis

AxisArg = Union[None, Axis, Sequence[Optional[Axis]]]

__all__ = ["psum", "pmean", "pmax", "all_gather", "axis_index",
           "axis_size", "reduce_scatter_flat", "all_gather_flat",
           "Pending", "STATS"]


class SyncStats:
    """Seconds, bytes and calls by phase, for this process."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.seconds = collections.defaultdict(float)
        self.bytes = collections.defaultdict(int)
        self.calls = collections.defaultdict(int)

    def add(self, key: str, seconds: float, nbytes: int = 0):
        self.seconds[key] += seconds
        self.bytes[key] += nbytes
        self.calls[key] += 1

    def snapshot(self) -> dict:
        return {"seconds": dict(self.seconds), "bytes": dict(self.bytes),
                "calls": dict(self.calls)}


STATS = SyncStats()


class _PinnedPool:
    """Pinned host buffers by (numel, dtype), taken and given back.  A
    buffer is a normal tensor even when first taken under
    ``torch.inference_mode`` (a serve step's), so that a later collective
    outside it (a training step's) may write into it again."""

    def __init__(self):
        self._free = collections.defaultdict(list)

    def take(self, numel: int, dtype: torch.dtype) -> torch.Tensor:
        free = self._free[(numel, dtype)]
        if free:
            return free.pop()
        with torch.inference_mode(False):
            return torch.empty(numel, dtype=dtype, pin_memory=True)

    def give(self, buf: torch.Tensor):
        self._free[(buf.numel(), buf.dtype)].append(buf)


_POOL = _PinnedPool()


def _stage_in(x: torch.Tensor) -> torch.Tensor:
    """x flattened into a host buffer gloo may write: a pinned pool buffer
    for a CUDA tensor, a fresh copy for a CPU tensor."""
    flat = x.reshape(-1)
    if not x.is_cuda:
        return flat.clone()
    t0 = time.perf_counter()
    buf = _POOL.take(flat.numel(), flat.dtype)
    buf.copy_(flat)         # waits for the work that produces x
    STATS.add("d2h", time.perf_counter() - t0, buf.numel()
              * buf.element_size())
    return buf


def _host_out(numel: int, dtype: torch.dtype, cuda: bool) -> torch.Tensor:
    if cuda:
        return _POOL.take(numel, dtype)
    return torch.empty(numel, dtype=dtype)


def _release(buf: torch.Tensor, cuda: bool):
    if cuda:
        _POOL.give(buf)


def _tier(axis: Axis) -> str:
    return "slow" if is_slow_axis(axis.name) else "fast"


class Pending:
    """An issued collective; ``wait()`` returns its result on the input's
    device, shaped ``shape``."""

    def __init__(self, work, out: torch.Tensor, staged, *, device, shape,
                 key: str, nbytes: int, t_issue: float):
        self._work, self._out, self._staged = work, out, staged
        self._device, self._shape = device, shape
        self._key, self._nbytes, self._t_issue = key, nbytes, t_issue
        self._result = None

    def wait(self) -> torch.Tensor:
        if self._result is not None:
            return self._result
        t0 = time.perf_counter()
        self._work.wait()
        STATS.add(self._key, self._t_issue + time.perf_counter() - t0,
                  self._nbytes)
        cuda = self._device.type == "cuda"
        for buf in self._staged:
            if buf is not self._out:
                _release(buf, cuda)
        if cuda:
            t1 = time.perf_counter()
            res = torch.empty(self._shape, dtype=self._out.dtype,
                              device=self._device)
            res.copy_(self._out.view(self._shape))   # synchronous
            STATS.add("h2d", time.perf_counter() - t1,
                      self._out.numel() * self._out.element_size())
            _release(self._out, cuda)
        else:
            res = self._out.view(self._shape)
        self._result = res
        return res


class Done:
    """A collective that had nothing to do (an axis of size 1)."""

    def __init__(self, x: torch.Tensor):
        self._x = x

    def wait(self) -> torch.Tensor:
        return self._x


def _issue(op: str, x: torch.Tensor, axis: Axis, *, out_numel: int,
           shape, async_op: bool, reduce_op=None):
    """Stage ``x`` to the host and start ``op`` over ``axis``'s group."""
    import torch.distributed as dist
    cuda = x.is_cuda
    src = _stage_in(x)
    t0 = time.perf_counter()
    if op == "all_reduce":
        out = src
        work = dist.all_reduce(out, op=reduce_op, group=axis.group,
                               async_op=True)
    else:
        out = _host_out(out_numel, src.dtype, cuda)
        with warnings.catch_warnings():
            # newer torch deprecates these names; both versions the port
            # runs on have them
            warnings.simplefilter("ignore", FutureWarning)
            if op == "reduce_scatter":
                work = dist.reduce_scatter_tensor(out, src, group=axis.group,
                                                  async_op=True)
            else:
                work = dist.all_gather_into_tensor(out, src,
                                                   group=axis.group,
                                                   async_op=True)
    nbytes = (out if op == "all_gather" else src).numel() \
        * src.element_size()
    pending = Pending(work, out, (src,), device=x.device, shape=shape,
                      key=f"{_tier(axis)} {op}", nbytes=nbytes,
                      t_issue=time.perf_counter() - t0)
    return pending if async_op else pending.wait()


def _axes(axes: AxisArg):
    if axes is None or isinstance(axes, Axis):
        axes = (axes,)
    return tuple(a for a in axes if a is not None and a.size > 1)


def axis_size(axis: Optional[Axis]) -> int:
    """Size of a grid axis (1 for None)."""
    return axis.size if axis is not None else 1


def axis_index(axis: Optional[Axis]) -> int:
    """This rank's coordinate along a grid axis (0 for None)."""
    return axis.index if axis is not None else 0


def _reduce(x: torch.Tensor, axes: AxisArg, reduce_op) -> torch.Tensor:
    for ax in _axes(axes):
        x = _issue("all_reduce", x, ax, out_numel=x.numel(),
                   shape=x.shape, async_op=False, reduce_op=reduce_op)
    return x


def psum(x: torch.Tensor, axes: AxisArg) -> torch.Tensor:
    """Sum-reduce over one or more grid axes (one all-reduce an axis, the
    inner result fed to the outer)."""
    import torch.distributed as dist
    return _reduce(x, axes, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, axes: AxisArg) -> torch.Tensor:
    """Mean-reduce over one or more grid axes."""
    n = 1
    for ax in _axes(axes):
        n *= ax.size
    return psum(x, axes) / n


def pmax(x: torch.Tensor, axes: AxisArg) -> torch.Tensor:
    """Max-reduce over one or more grid axes."""
    import torch.distributed as dist
    return _reduce(x, axes, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: Optional[Axis], *,
               async_op: bool = False):
    """Each rank's ``x`` stacked along a new leading axis, in the axis's
    order: ``(n,) + x.shape``."""
    n = axis_size(axis)
    if n <= 1:
        out = x.reshape((1,) + tuple(x.shape))
        return Done(out) if async_op else out
    return _issue("all_gather", x, axis, out_numel=n * x.numel(),
                  shape=(n,) + tuple(x.shape), async_op=async_op)


def reduce_scatter_flat(x: torch.Tensor, axis: Optional[Axis], *,
                        async_op: bool = False):
    """Reduce-scatter a flat buffer: sum over ``axis``, rank ``i`` keeps the
    ``i``-th contiguous 1/n slice.  ``x`` must be 1-D with length divisible
    by the axis size (the bucket layouts guarantee this by their
    ``align``)."""
    n = axis_size(axis)
    if n <= 1:
        return Done(x) if async_op else x
    if x.dim() != 1 or x.numel() % n:
        raise ValueError(f"reduce_scatter_flat needs a 1-D buffer divisible "
                         f"by {n}, got {tuple(x.shape)}")
    return _issue("reduce_scatter", x, axis, out_numel=x.numel() // n,
                  shape=(x.numel() // n,), async_op=async_op)


def all_gather_flat(shard: torch.Tensor, axis: Optional[Axis], *,
                    async_op: bool = False):
    """Concatenate per-rank flat shards in rank order into one flat buffer
    (the inverse of :func:`reduce_scatter_flat`'s slicing)."""
    n = axis_size(axis)
    if n <= 1:
        return Done(shard) if async_op else shard
    return _issue("all_gather", shard, axis, out_numel=n * shard.numel(),
                  shape=(n * shard.numel(),), async_op=async_op)
