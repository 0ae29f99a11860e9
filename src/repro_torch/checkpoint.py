"""Gathered checkpoint format of the port, and what both formats share
(counterpart of ``repro/checkpoint.py``).

The legacy format: one ``.npy`` per pytree leaf (path-encoded filename) +
a JSON manifest with dtypes/shapes, step and CRC32 checksums, the manifest
moved into place last with ``os.replace``.  Used by the elastic driver's
``mode="drain"`` cycle and for small replicated states.

What both formats share lives here, upstream of ``repro_torch.ckpt``:

- **The reference's bytes.**  Tensors cross to the host as numpy arrays
  (bf16 as its uint16 bit patterns) and are written with the ``.npy``
  header the reference writes: bf16 as ``'<V2'``, which is how ml_dtypes'
  bfloat16 saves (plain numpy void would write ``'|V2'``).  Dtypes are
  named as numpy names them (``"bfloat16"``, ``"float32"``), never
  ``"torch.bfloat16"``, so a file or manifest written by one package is
  byte for byte the other's.
- **Leaves of the port's trees.**  A plain tensor, array or scalar is
  replicated: every rank holds all of it and one writes it.  A
  :class:`Shard` is this rank's box of a global array split along axis 0
  (a ZeRO-1 bucket shard); a :class:`Stacked` is one leaf of the
  reference's tree made of the port's per-layer tensors.
- **The job.**  In a gloo job each rank holds only its shards, so a save
  or restore is collective over the ranks of its grid (:class:`Job`):
  the ranks agree on one temp name, every rank writes the boxes it owns,
  rank 0 writes the manifest and commits, and a failure on any rank is a
  failure on all, so retries and fallbacks stay in step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.faults.plan import maybe_fire

# dtype names (numpy's) -> torch dtypes; bf16 lives on the host as uint16
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
_HOST = {"bfloat16": np.dtype(np.uint16)}
# the .npy descr ml_dtypes' bfloat16 writes
_DESCR = {"bfloat16": "<V2"}


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _NAMES[dtype]
    return str(np.dtype(dtype))


def host_dtype(name: str) -> np.dtype:
    """The numpy dtype an array of dtype ``name`` is held in on the host."""
    return _HOST.get(name) or np.dtype(name)


def to_host(x) -> Tuple[np.ndarray, str]:
    """(a host copy of ``x``, its dtype name): tensors are copied to the
    host (they may change after the call), anything else goes through
    ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        name = dtype_name(x.dtype)
        t = x.detach().contiguous().to("cpu", copy=True)
        if name == "bfloat16":
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _c(arr) -> np.ndarray:
    """``arr`` C-contiguous (0-d arrays stay 0-d)."""
    arr = np.asarray(arr)
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def from_host(arr: np.ndarray, name: str, device=None) -> torch.Tensor:
    """A tensor of dtype ``name`` from its host array, on ``device``."""
    arr = _c(arr)
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    # on the CPU a tensor that owns its memory, not a view of the array
    if device is None or torch.device(device).type == "cpu":
        return t.clone()
    return t.to(device)


def crc32(arr: np.ndarray) -> int:
    return zlib.crc32(_c(arr).reshape(-1).view(np.uint8)) & 0xffffffff


def write_npy(path: str, arr: np.ndarray, name: str) -> None:
    """``np.save``'s bytes, with the reference's descr for ``name``."""
    arr = _c(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = _DESCR.get(name, header["descr"])
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(arr.reshape(-1).view(np.uint8).data)


def read_npy(path: str, name: str) -> np.ndarray:
    arr = np.load(path)
    want = host_dtype(name)
    if arr.dtype != want:         # bf16 files load as void16
        arr = arr.view(want)
    return arr


# ---------------------------------------------------------------------------
# leaves of the port's trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's box of a global array split along axis 0 into ``parts``
    equal boxes: box ``index``.  ``writer``: this rank writes the box (one
    replica of each box does); ``spec``: the reference's PartitionSpec of
    the array, recorded in the manifest.  One part is the whole array, a
    replicated leaf."""

    local: Any
    parts: int
    index: int
    writer: bool = True
    spec: Tuple[Any, ...] = ()

    @property
    def shape(self) -> Tuple[int, ...]:
        s = tuple(self.local.shape)
        return (self.parts * s[0],) + s[1:]

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def box(self) -> Tuple[Tuple[int, int], ...]:
        s = tuple(self.local.shape)
        return (((self.index * s[0], (self.index + 1) * s[0]),)
                + tuple((0, d) for d in s[1:]))

    def with_local(self, local) -> "Shard":
        return dataclasses.replace(self, local=local)


@dataclasses.dataclass(frozen=True)
class Stacked:
    """One leaf of the reference's tree: the port's tensors ``names``
    (``parts``), stacked in that order (row-major) to ``shape``."""

    names: Tuple[str, ...]
    parts: Tuple[torch.Tensor, ...]
    shape: Tuple[int, ...]

    @property
    def dtype(self):
        return self.parts[0].dtype


def leaf_shape(leaf) -> Tuple[int, ...]:
    """The global shape of a leaf of the port's trees."""
    if isinstance(leaf, (Shard, Stacked)):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def leaf_dtype(leaf) -> str:
    if isinstance(leaf, Shard):
        return leaf_dtype(leaf.local)
    if isinstance(leaf, (torch.Tensor, Stacked)):
        return dtype_name(leaf.dtype)
    return str(np.asarray(leaf).dtype)


def host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """(host copy, dtype name) of a whole replicated leaf."""
    if isinstance(leaf, Shard):
        return to_host(leaf.local)
    if isinstance(leaf, Stacked):
        parts = [to_host(p) for p in leaf.parts]
        arr = np.concatenate([a.reshape(-1) for a, _ in parts])
        return arr.reshape(leaf.shape), parts[0][1]
    return to_host(leaf)


def like(leaf, arr: np.ndarray, name: str):
    """A leaf of ``leaf``'s kind holding ``arr`` (the leaf's box of it)."""
    if isinstance(leaf, Shard):
        return leaf.with_local(like(leaf.local, arr, name))
    if isinstance(leaf, Stacked):
        n = int(np.prod(leaf.parts[0].shape))
        flat = arr.reshape(-1)
        return Stacked(leaf.names, tuple(
            from_host(flat[i * n:(i + 1) * n].reshape(p.shape), name,
                      p.device) for i, p in enumerate(leaf.parts)),
            leaf.shape)
    if isinstance(leaf, torch.Tensor):
        return from_host(arr, name, leaf.device)
    return arr


def local_box(leaf) -> Tuple[Tuple[int, int], ...]:
    """The box of the global array this rank holds of ``leaf``."""
    if isinstance(leaf, Shard):
        return leaf.box
    return tuple((0, d) for d in leaf_shape(leaf))


# ---------------------------------------------------------------------------
# the job: the ranks that save or restore one checkpoint together
# ---------------------------------------------------------------------------

def _group_of(mesh):
    """The process group of ``mesh``: a RankGrid's ``group`` (None on a
    grid of one rank), or a process group itself; None for one process."""
    if mesh is None:
        return None
    return getattr(mesh, "group", mesh)


class Job:
    """The ranks of ``mesh`` (a ``parallel.mesh.RankGrid`` or a process
    group) that save or restore one checkpoint; one process when ``mesh``
    is None or has one rank.  Object collectives over gloo."""

    def __init__(self, mesh=None):
        self.group = _group_of(mesh)
        if self.group is None:
            self.rank, self.size = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(self.group)
            self.size = dist.get_world_size(self.group)

    def all_gather(self, obj) -> List[Any]:
        if self.size == 1:
            return [obj]
        import torch.distributed as dist
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(
            self.group, 0), group=self.group)
        return box[0]

    def run(self, fn):
        """``fn()`` on every rank; when it raises on any rank, every rank
        raises: the failing rank its own error, the others one of the same
        kind (an OSError with its errno, a checkpoint error), so that a
        retry or a fallback decides alike on every rank.  Also a barrier."""
        err, out = None, None
        try:
            out = fn()
        except BaseException as e:     # noqa: BLE001 — re-raised below
            err = e
        if self.size == 1:
            if err is not None:
                raise err
            return out
        infos = self.all_gather(None if err is None else _error_info(err))
        for r, info in enumerate(infos):
            if info is None:
                continue
            if r == self.rank:
                raise err
            raise _peer_error(r, info) from err
        return out


def _error_info(e: BaseException):
    from repro_torch.ckpt.manifest import ManifestError
    if isinstance(e, OSError):
        return ("os", e.errno, repr(e))
    if isinstance(e, (CorruptCheckpointError, ManifestError, ValueError,
                      EOFError, KeyError)):
        return ("corrupt", None, repr(e))
    return ("other", None, repr(e))


def _peer_error(rank: int, info) -> BaseException:
    kind, errno_, text = info
    msg = f"rank {rank} of the checkpoint's job failed: {text}"
    if kind == "os":
        return OSError(errno_, msg)
    if kind == "corrupt":
        return CorruptCheckpointError(msg)
    return RuntimeError(msg)


def gather_full(leaf, job: Job) -> torch.Tensor:
    """The whole global array of a :class:`Shard` on every rank of
    ``job`` (host memory): every rank's box, gathered as bytes."""
    import torch.distributed as dist
    t = leaf.local.detach().contiguous().to("cpu", copy=True)
    if leaf.parts == 1 or job.size == 1:
        return t
    raw = t.reshape(-1).view(torch.uint8)
    got = [torch.empty_like(raw) for _ in range(job.size)]
    dist.all_gather(got, raw, group=job.group)
    idx = job.all_gather(leaf.index)
    boxes = {i: g for i, g in zip(idx, got)}
    if sorted(boxes) != list(range(leaf.parts)):
        raise ValueError(f"the job's boxes {sorted(boxes)} do not tile "
                         f"{leaf.parts} parts")
    full = torch.cat([boxes[i] for i in range(leaf.parts)])
    return full.view(t.dtype).reshape(leaf.shape)


# ---------------------------------------------------------------------------
# the gathered (legacy) format
# ---------------------------------------------------------------------------

def _leaf_paths(tree) -> Dict[str, Any]:
    # one implementation of the leaf-path grammar (repro_torch.ckpt
    # .treepaths); imported at call time, as the package init imports this
    # module
    from repro_torch.ckpt.treepaths import leaf_paths
    return leaf_paths(tree)


def _sanitize(path: str) -> str:
    from repro_torch.ckpt.treepaths import sanitize
    return sanitize(path)


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True,
         mesh=None) -> Optional[threading.Thread]:
    """Save a tree, every leaf whole.  blocking=False returns the writer
    thread (async).  On a grid (``mesh``) every rank calls it: the
    :class:`Shard` leaves are gathered whole, and rank 0 writes."""
    job = Job(mesh)
    flat = _leaf_paths(tree)
    host = {}
    for k, v in flat.items():
        if v is None:
            continue
        if isinstance(v, Shard):
            full = gather_full(v, job)
            if job.rank == 0:
                host[k] = to_host(full)
        elif job.rank == 0:
            host[k] = host_leaf(v)
    if job.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)

    def write_rank0():
        manifest = {"step": step, "leaves": {}}
        for k, (arr, name) in host.items():
            fname = _sanitize(k) + ".npy"
            maybe_fire("legacy.write")
            write_npy(os.path.join(ckpt_dir, fname), arr, name)
            manifest["leaves"][k] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": name,
                "crc32": crc32(arr),
            }
        tmp = os.path.join(ckpt_dir, "manifest.json.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        maybe_fire("legacy.manifest", path=tmp)
        os.replace(tmp, os.path.join(ckpt_dir, "manifest.json"))

    def write():
        job.run(write_rank0 if job.rank == 0 else (lambda: None))

    if blocking:
        write()
        return None
    t = _WriterThread(write)
    t.start()
    return t


class _WriterThread(threading.Thread):
    """Async-save writer whose ``join`` re-raises write failures.

    A daemon thread that swallowed ENOSPC/EPERM would make a failed
    checkpoint indistinguishable from a committed one — the trainer
    would run for hours believing it is protected.  ``Trainer`` joins
    the pending writer before each new save (and in its ``finally``), so
    failures surface at the next checkpoint boundary at the latest.
    Shared by both checkpoint formats (this module is upstream of
    ``repro_torch.ckpt``, which imports it here).
    """

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self.exc: Optional[BaseException] = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:      # noqa: BLE001 — re-raised in join
            self.exc = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.exc is not None:
            raise self.exc


class CorruptCheckpointError(RuntimeError):
    pass


def restore(ckpt_dir: str, template, *, verify: bool = True, mesh=None):
    """Restore into ``template``'s structure; returns (step, tree).

    Each leaf comes back as its template's kind: a tensor on the
    template's device, a :class:`Shard` holding the rank's box of the
    saved array, a :class:`Stacked` of per-layer tensors, else a numpy
    array.  The saved shape must be the template's (global) shape: the
    gathered format cannot reshard onto a different layout.  On a grid
    (``mesh``) a failure on any rank fails every rank.
    """
    from repro_torch.ckpt.treepaths import rebuild

    def attempt():
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for k, leaf in _leaf_paths(template).items():
            if leaf is None:
                out[k] = None
                continue
            meta = manifest["leaves"].get(k)
            if meta is None:
                raise CorruptCheckpointError(f"missing leaf {k}")
            leaf_path = os.path.join(ckpt_dir, meta["file"])
            maybe_fire("legacy.read", path=leaf_path)
            arr = read_npy(leaf_path, meta["dtype"])
            if (hasattr(leaf, "shape")
                    and tuple(arr.shape) != leaf_shape(leaf)):
                # fail here with a clear error instead of deep inside the
                # step; the gathered format cannot reshard — that is what
                # repro_torch.ckpt's shard+manifest format is for
                raise CorruptCheckpointError(
                    f"shape mismatch for {k}: saved {tuple(arr.shape)} vs "
                    f"template {leaf_shape(leaf)} — the legacy gathered format cannot "
                    f"reshard onto a different layout (save with "
                    f"repro_torch.ckpt.save_sharded for that)")
            if hasattr(leaf, "dtype") and meta["dtype"] != leaf_dtype(leaf):
                raise CorruptCheckpointError(
                    f"dtype mismatch for {k}: saved {meta['dtype']} vs "
                    f"template {leaf_dtype(leaf)}")
            if verify:
                if crc32(arr) != meta["crc32"]:
                    raise CorruptCheckpointError(
                        f"checksum mismatch for {k}")
            if isinstance(leaf, Shard):
                arr = arr[tuple(slice(a, b) for a, b in leaf.box)]
            out[k] = like(leaf, arr, meta["dtype"])
        return manifest["step"], rebuild(template, out)

    return Job(mesh).run(attempt)


# committed step dirs match exactly; anything else — in-flight temp dirs
# from the atomic rename protocol ("step_00000010.tmp-1234"), editor
# droppings, torn copies — is skipped instead of crashing int()
_STEP_DIR_RE = re.compile(r"^step_(\d+)$")


def committed_steps(base_dir: str) -> List[int]:
    """All *committed* steps in ``base_dir``, sorted ascending.

    A step dir counts only if its name matches ``step_<digits>`` exactly
    AND it contains a manifest that parses as JSON whose ``step`` equals
    the directory's digits — the commit marker both checkpoint formats
    write last, verified rather than merely present.  Partially-written
    dirs (crash mid-save, torn temp dirs awaiting their atomic rename,
    a manifest whose write was itself torn) are ignored, never raised
    on: a restart after a mid-checkpoint crash must resume from the
    previous good step, not die enumerating the wreckage.

    This is the history the CRC-quarantine fallback walks newest-first
    (``repro_torch.faults.recovery``) and the driver restart path replays
    against its event schedule.
    """
    if not os.path.isdir(base_dir):
        return []
    steps = []
    for d in os.listdir(base_dir):
        m = _STEP_DIR_RE.match(d)
        if not m:
            continue
        man_path = os.path.join(base_dir, d, "manifest.json")
        try:
            with open(man_path) as f:
                man = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(man, dict) and man.get("step") == int(m.group(1)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(base_dir: str) -> Optional[int]:
    """Largest committed step in ``base_dir`` (see ``committed_steps``)."""
    steps = committed_steps(base_dir)
    return steps[-1] if steps else None


def step_dir(base_dir: str, step: int) -> str:
    return os.path.join(base_dir, f"step_{step:08d}")


