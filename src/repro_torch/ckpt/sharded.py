"""Sharded checkpoint save/restore with drain-free reshard-on-restore (the
port's counterpart of ``repro/ckpt/sharded.py``, the same on-disk format).

Save side: every :class:`~repro_torch.checkpoint.Shard` leaf of more than
one part is written as one ``.npy`` *per box* — the ranks of a gloo job
each hold their own box (for a ZeRO-1 state the 1/F bucket shard; no rank
ever gathers a full bucket), and one replica of each box writes it.
Replicated leaves (params, the step counter) are written once, by rank 0.
The file index ``j`` of ``{stem}.s{j}.npy`` is the box's place in the
sorted list of the leaf's boxes, which every rank derives alike.  Files
land in a temp directory (``<dir>.tmp-<pid>``, the pid rank 0's, so every
rank writes into the same one), the manifest — its CRCs gathered from the
writers — is written last by rank 0, and the directory is atomically
renamed into place: a crash at any point, of any rank, leaves either the
previous committed step or an ignorable torn dir.

Restore side: the target grid is the *restorer's*; the saved grid shape is
irrelevant.  Each rank assembles its own box of every leaf from the
intersecting saved boxes (:meth:`ShardedCheckpoint.read_box`).  Restoring
onto a different (pod, data) factorization is therefore pure offset
arithmetic over the manifest's index boxes.  When a flat bucket's
*padded* size differs (bucket alignment follows the fast-axis size), the
``pad_flat`` policy copies the common prefix and zero-fills the tail —
exact, because everything past the layout's live prefix is zeros on both
sides.

On a grid every rank calls :func:`save_sharded` and the restores with the
grid as ``mesh``; a failure on any rank is a failure on every rank
(``checkpoint.Job``), so retries and fallbacks stay in step.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import (CorruptCheckpointError, Job, Shard,
                                    _WriterThread, crc32, host_dtype,
                                    host_leaf, leaf_dtype, leaf_shape, like,
                                    local_box, read_npy, to_host, write_npy)
from repro_torch.ckpt import manifest as mf
from repro_torch.ckpt.treepaths import leaf_paths, rebuild, sanitize
from repro_torch.faults.plan import maybe_fire
from repro_torch.faults.retry import NO_RETRY, RetryPolicy

# restore policies (per leaf, via a same-structure policy tree):
EXACT = "exact"          # shapes must match the manifest (default)
PAD_FLAT = "pad_flat"    # 1-D flat resize: copy common prefix, zero tail
ZERO = "zero"            # shape mismatch / missing leaf -> fresh zeros


def _box_shape(box) -> Tuple[int, ...]:
    return tuple(b - a for a, b in box)


# rename-protocol debris: in-flight temp dirs and moved-aside old commits,
# both tagged with the writing pid.  Quarantined dirs (".quarantined-*")
# deliberately do NOT match — they are evidence, not garbage.
_DEBRIS_RE = re.compile(r"^step_\d+\.(?:tmp|old)-(\d+)$")


def _pid_alive(pid: int) -> bool:
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True        # exists but not ours / indeterminate: keep it
    return True


def gc_debris(base_dir: str) -> list:
    """Remove rename-protocol leftovers whose writer is dead.

    A crash between the same-step rename-aside and the commit rename
    strands a ``.old-<pid>`` dir forever (its name fails the committed
    regex, so nothing ever looks at it again); a crash mid-write strands
    ``.tmp-<pid>``.  Each successful save sweeps its base dir for such
    debris from *dead* pids — a live pid may be another writer mid-save
    on a shared filesystem, so its dirs are left alone.  Returns the
    paths removed.
    """
    try:
        names = os.listdir(base_dir)
    except OSError:
        return []
    removed = []
    for name in sorted(names):
        m = _DEBRIS_RE.match(name)
        if not m or _pid_alive(int(m.group(1))):
            continue
        path = os.path.join(base_dir, name)
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


def _spec_of(leaf: Shard) -> Tuple[Any, ...]:
    return tuple(tuple(a) if isinstance(a, (list, tuple)) else a
                 for a in leaf.spec)


def save_sharded(ckpt_dir: str, step: int, tree, *, layout=None,
                 mesh=None, blocking: bool = True,
                 retry: RetryPolicy = NO_RETRY
                 ) -> Optional[threading.Thread]:
    """Save ``tree`` in the sharded per-rank format.

    ``layout`` (a ``bucketing.BucketLayout``) is recorded in the manifest
    for reshard bookkeeping; ``mesh`` (the ``RankGrid`` every rank of which
    calls this) records provenance and is the job that saves.  The host
    copies are made before the call returns; with ``blocking=False`` the
    file writes and the commit run on the returned daemon thread (join it
    before the next save).  ``retry`` bounds transient-I/O retries: the
    whole write protocol is idempotent up to the commit rename (the temp
    dir is rebuilt from the already-captured host arrays), so a retried
    attempt restarts it from scratch, on every rank.
    """
    job = Job(mesh)
    flat = leaf_paths(tree)
    entries: Dict[str, Any] = {}               # key -> kind, shape, dtype…
    payload = []                               # (fname, arr, dtype) mine
    crcs: Dict[str, int] = {}
    for key, leaf in flat.items():
        if leaf is None:
            continue
        stem = sanitize(key)
        if isinstance(leaf, Shard) and leaf.parts > 1:
            shape, box = leaf_shape(leaf), leaf.box
            m = box[0][1] - box[0][0]
            boxes = [((j * m, (j + 1) * m),) + box[1:]
                     for j in range(leaf.parts)]
            entries[key] = ("sharded", shape, leaf_dtype(leaf), boxes,
                            _spec_of(leaf))
            if leaf.writer:
                arr, name = to_host(leaf.local)
                fname = f"{stem}.s{leaf.index}.npy"
                payload.append((fname, arr, name))
                crcs[fname] = crc32(arr)
        else:
            entries[key] = ("replicated", leaf_shape(leaf), leaf_dtype(leaf))
            if job.rank == 0:
                arr, name = host_leaf(leaf)
                payload.append((stem + ".npy", arr, name))
                crcs[stem + ".npy"] = crc32(arr)
                entries[key] = ("replicated", tuple(arr.shape), name)
    # rank 0 writes the manifest: it needs every writer's CRCs, and every
    # rank the one temp name
    all_crcs: Dict[str, int] = {}
    for c in job.all_gather(crcs):
        all_crcs.update(c)
    pid = job.broadcast(os.getpid())
    man = None
    if job.rank == 0:
        leaves = {}
        for key, e in entries.items():
            if e[0] == "replicated":
                fname = sanitize(key) + ".npy"
                leaves[key] = mf.LeafEntry(
                    kind="replicated", shape=tuple(e[1]), dtype=e[2],
                    file=fname, crc32=all_crcs[fname])
                continue
            _, shape, dtype, boxes, spec = e
            shards = []
            for j, box in enumerate(boxes):
                fname = f"{sanitize(key)}.s{j}.npy"
                if fname not in all_crcs:
                    raise ValueError(
                        f"no rank of the job writes box {box} of {key} — "
                        f"the shards do not tile the array")
                shards.append(mf.ShardFile(file=fname, index=box,
                                           crc32=all_crcs[fname]))
            leaves[key] = mf.LeafEntry(
                kind="sharded", shape=tuple(shape), dtype=dtype,
                shards=tuple(shards), spec=spec)
        man = mf.Manifest(step=step, leaves=leaves,
                          mesh=mf.mesh_to_dict(mesh),
                          layout=mf.layout_to_dict(layout))
    tmp = f"{ckpt_dir}.tmp-{pid}"
    old = f"{ckpt_dir}.old-{pid}"

    def prepare():
        if job.rank == 0:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)

    def write_files():
        for fname, arr, name in payload:
            fpath = os.path.join(tmp, fname)
            maybe_fire("sharded.write")
            write_npy(fpath, arr, name)
            maybe_fire("sharded.written", path=fpath)

    def commit():
        if job.rank != 0:
            return
        man_path = os.path.join(tmp, mf.MANIFEST)
        with open(man_path, "w") as f:
            f.write(man.to_json())               # commit marker, last
        maybe_fire("sharded.manifest", path=man_path)
        if os.path.exists(ckpt_dir):
            # re-save of the same step: move the old commit ASIDE, never
            # rmtree it pre-commit — deleting first would leave a crash
            # window in which the only committed checkpoint is destroyed
            # irrecoverably.  A crash between the two renames still
            # hides this step from latest_step (the .old-* name fails
            # its regex, resume falls back to an earlier step); the
            # bytes survive on disk until the next successful save's
            # debris sweep (gc_debris) collects them.
            maybe_fire("sharded.pre_rename_aside")
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(ckpt_dir, old)
            maybe_fire("sharded.between_renames")
        os.rename(tmp, ckpt_dir)                 # atomic commit
        maybe_fire("sharded.committed")
        shutil.rmtree(old, ignore_errors=True)
        gc_debris(os.path.dirname(ckpt_dir) or ".")

    def write_once():
        # each phase ends with the job's agreement (a barrier): every
        # rank's files are down before rank 0 commits, and the commit is
        # visible to every rank when the save returns
        for phase in (prepare, write_files, commit):
            job.run(phase)

    def write():
        retry.call(write_once)

    if blocking:
        write()
        return None
    t = _WriterThread(write)
    t.start()
    return t


class ShardedCheckpoint:
    """Reader for one committed sharded checkpoint directory."""

    def __init__(self, ckpt_dir: str, *, verify: bool = True,
                 retry: RetryPolicy = NO_RETRY):
        self.dir = ckpt_dir
        self.manifest = mf.read_manifest(ckpt_dir)
        self.verify = verify
        self.retry = retry
        # restore walks target boxes in order, so consecutive reads
        # usually hit the same saved file: keep exactly one file hot (a
        # full cache would hold the whole state in host RAM, the thing
        # the sharded format exists to avoid) and remember which files
        # already passed their checksum so CRC work happens once per
        # file, not once per intersecting target box
        self._hot: Tuple[Optional[str], Optional[np.ndarray]] = (None,
                                                                 None)
        self._verified: set = set()

    @property
    def step(self) -> int:
        return self.manifest.step

    def _load_file(self, fname: str, crc: Optional[int],
                   dtype: str) -> np.ndarray:
        if self._hot[0] == fname:
            return self._hot[1]
        fpath = os.path.join(self.dir, fname)

        def load():
            maybe_fire("sharded.read", path=fpath)
            return read_npy(fpath, dtype)

        arr = self.retry.call(load)
        if (self.verify and crc is not None
                and fname not in self._verified):
            if crc32(arr) != crc:
                raise CorruptCheckpointError(
                    f"checksum mismatch for {fname}")
            self._verified.add(fname)
        self._hot = (fname, arr)
        return arr

    def read_box(self, path: str, box) -> np.ndarray:
        """Assemble the global index ``box`` of leaf ``path`` from the
        intersecting saved shard files (host array; bf16 as its bits).

        Never materializes more than the requested box plus one saved
        shard at a time — the reshard-on-restore memory guarantee.
        Coordinates past the saved extent are zero-filled (the flat
        bucket padding rule); entirely out-of-range boxes are all zeros.
        """
        entry = self.manifest.leaves[path]
        box = tuple(box)
        out = np.zeros(_box_shape(box), dtype=host_dtype(entry.dtype))
        # a replicated leaf is just one saved box covering the whole
        # array — the same intersection arithmetic serves both kinds
        shards = entry.shards or (mf.ShardFile(
            file=entry.file, index=tuple((0, d) for d in entry.shape),
            crc32=entry.crc32),)
        for sf in shards:
            inter = tuple((max(a, c), min(b, d))
                          for (a, b), (c, d) in zip(box, sf.index))
            if any(a >= b for a, b in inter):
                continue
            arr = self._load_file(sf.file, sf.crc32, entry.dtype)
            src = tuple(slice(a - c, b - c)
                        for (a, b), (c, _) in zip(inter, sf.index))
            dst = tuple(slice(a - c, b - c)
                        for (a, b), (c, _) in zip(inter, box))
            out[dst] = arr[src]
        return out

    def read_leaf(self, path: str) -> np.ndarray:
        entry = self.manifest.leaves[path]
        return self.read_box(path, tuple((0, d) for d in entry.shape))

    def restore(self, template, *, policy=None, layout=None,
                mesh=None) -> Tuple[int, Any]:
        """Restore into ``template``'s structure; returns (step, tree).

        Each leaf comes back as its template's kind
        (``checkpoint.like``): a :class:`~repro_torch.checkpoint.Shard`
        template is filled with the rank's own box — each rank reads only
        its box.  ``policy``: same-structure tree of EXACT / PAD_FLAT /
        ZERO strings controlling shape-mismatch behavior; default EXACT
        everywhere.  ``layout``: the restorer's ``BucketLayout`` —
        validated against the manifest's recorded slot placement, which
        PAD_FLAT correctness depends on.  ``mesh``: the grid whose ranks
        restore together (a failure on one fails all).
        """
        return Job(mesh).run(
            lambda: self._restore(template, policy=policy, layout=layout))

    def _restore(self, template, *, policy, layout) -> Tuple[int, Any]:
        if layout is not None and self.manifest.layout is None:
            raise CorruptCheckpointError(
                "layout validation requested but the checkpoint's "
                "manifest records no bucket layout (saved with "
                "layout=None) — cannot prove the leaf->bucket placement "
                "matches; restore without `layout` only if you know the "
                "placement is unchanged")
        if layout is not None:
            # PAD_FLAT's copy-prefix rule is only exact when the leaf ->
            # (bucket, offset) placement is unchanged; placement is
            # alignment-invariant but NOT bucket_bytes-invariant.  A
            # restore with a different bucket capacity would silently
            # scramble masters across bucket boundaries — refuse it.
            tgt = [(s.bucket, s.offset, s.size) for s in layout.slots]
            sav = [(int(s["bucket"]), int(s["offset"]), int(s["size"]))
                   for s in self.manifest.layout["slots"]]
            if tgt != sav:
                raise CorruptCheckpointError(
                    f"bucket layout mismatch: checkpoint was saved with "
                    f"a different leaf->bucket placement "
                    f"({len(sav)} slots over "
                    f"{len(self.manifest.layout['bucket_sizes'])} "
                    f"buckets vs {len(tgt)} slots over "
                    f"{layout.n_buckets}) — restore with the same "
                    f"bucket_bytes the checkpoint was trained with")
        flat_t = leaf_paths(template)
        flat_p = leaf_paths(policy) if policy is not None else {}

        def zeros(leaf, dtype):
            # ZERO-policy leaves are the rank's own box of zeros: never
            # the full (possibly GB-scale residual) array
            return like(leaf, np.zeros(_box_shape(local_box(leaf)),
                                       host_dtype(dtype)), dtype)

        out: Dict[str, Any] = {}
        for key, leaf in flat_t.items():
            if leaf is None:
                out[key] = None
                continue
            pol = flat_p.get(key, EXACT)
            entry = self.manifest.leaves.get(key)
            want_shape = leaf_shape(leaf)
            want_dtype = leaf_dtype(leaf) if hasattr(leaf, "dtype") \
                else None
            if entry is None:
                if pol == ZERO:
                    out[key] = zeros(leaf, leaf_dtype(leaf))
                    continue
                raise CorruptCheckpointError(f"missing leaf {key}")
            if want_dtype is not None and entry.dtype != want_dtype:
                # a silent dtype swap would run the step at the
                # checkpoint's precision, not the configured one
                if pol == ZERO:
                    out[key] = zeros(leaf, leaf_dtype(leaf))
                    continue
                raise CorruptCheckpointError(
                    f"dtype mismatch for {key}: saved {entry.dtype} vs "
                    f"template {want_dtype}")
            if tuple(entry.shape) != want_shape:
                if pol == ZERO:
                    out[key] = zeros(leaf, leaf_dtype(leaf))
                    continue
                if pol != PAD_FLAT:
                    raise CorruptCheckpointError(
                        f"shape mismatch for {key}: saved "
                        f"{tuple(entry.shape)} vs template {want_shape} "
                        f"(policy {pol})")
                if len(entry.shape) != 1 or len(want_shape) != 1:
                    raise CorruptCheckpointError(
                        f"pad_flat policy needs 1-D leaves, got "
                        f"{entry.shape} -> {want_shape} for {key}")
                if want_shape[0] < entry.shape[0]:
                    # shrinking is only exact when the dropped tail is
                    # padding: verify it is actually all zeros instead
                    # of silently truncating live optimizer state
                    tail = self.read_box(
                        key, ((want_shape[0], entry.shape[0]),))
                    if tail.any():
                        raise CorruptCheckpointError(
                            f"pad_flat would truncate live data of "
                            f"{key}: saved extent {entry.shape[0]}, "
                            f"template {want_shape[0]}, and the dropped "
                            f"tail is not all zeros")
            if entry.kind == "sharded":
                # the save side proved its shards tiled the array; prove
                # it again on the read side — a manifest that parses but
                # lost shard entries (torn hand-edit, a save missing one
                # rank's files) would otherwise zero-fill the gap
                # silently, with every surviving CRC passing
                vol = sum(int(np.prod(_box_shape(s.index)))
                          for s in entry.shards)
                if vol != int(np.prod(entry.shape)):
                    raise CorruptCheckpointError(
                        f"shards of {key} cover {vol} of "
                        f"{int(np.prod(entry.shape))} saved elements — "
                        f"manifest lost shard entries")
            out[key] = like(leaf, self.read_box(key, local_box(leaf)),
                            entry.dtype)
        return self.manifest.step, rebuild(template, out)


def restore_sharded(ckpt_dir: str, template, *, policy=None, layout=None,
                    verify: bool = True, retry: RetryPolicy = NO_RETRY,
                    mesh=None) -> Tuple[int, Any]:
    def attempt():
        return ShardedCheckpoint(ckpt_dir, verify=verify, retry=retry)
    # a manifest that does not parse fails every rank alike
    return Job(mesh).run(attempt).restore(template, policy=policy,
                                          layout=layout, mesh=mesh)


def restore_auto(ckpt_dir: str, template, *, policy=None, layout=None,
                 verify: bool = True, retry: RetryPolicy = NO_RETRY,
                 mesh=None) -> Tuple[int, Any]:
    """Dispatch on the on-disk format: sharded manifest or legacy
    per-leaf (``repro_torch.checkpoint``) — old checkpoints keep
    restoring.

    The legacy format cannot apply ``policy`` (it has no reshard
    arithmetic); its restore instead validates saved-vs-template shapes
    and fails with a clear error on mismatch, so a re-factorized resume
    from a legacy dir dies loudly rather than deep inside the step."""
    if mf.is_sharded_dir(ckpt_dir):
        return restore_sharded(ckpt_dir, template, policy=policy,
                               layout=layout, verify=verify, retry=retry,
                               mesh=mesh)
    from repro_torch import checkpoint as legacy
    return legacy.restore(ckpt_dir, template, verify=verify, mesh=mesh)
