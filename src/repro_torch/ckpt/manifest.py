"""Manifest schema for the sharded checkpoint format.

One ``manifest.json`` per committed step directory records everything a
restore — possibly onto a *different* (pod, data) mesh — needs:

- ``format``/``version``: format identification (the legacy per-leaf
  format has no ``format`` key, which is how ``restore_auto`` dispatches);
- ``step``: the training step the state belongs to;
- ``mesh``: axis names + shape of the mesh the state was saved from
  (informational: restore targets its *own* mesh);
- ``layout``: the flat-bucket layout (per-leaf slots with bucket index,
  offset, size, shape, dtype; padded bucket sizes; alignment) — the
  offset arithmetic a reshard needs, serialized without the treedef;
- ``leaves``: per-leaf entries.  ``replicated`` leaves have one file;
  ``sharded`` leaves have one file per distinct shard with its global
  index box ``[[start, stop], ...]``.  Every file carries a CRC32.

The manifest is written *last* inside a temp directory which is then
atomically renamed into place: a directory containing ``manifest.json``
under its final name is a committed checkpoint, everything else is torn
and ignored by ``latest_step``.

The port's copy of ``repro/ckpt/manifest.py``: the same schema and the same
JSON, with the port's bucket layout (``collectives.bucketing``) and rank
grid (``parallel.mesh.RankGrid``) serialized as the reference's layout and
mesh are, slot dtypes by numpy's names.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

FORMAT = "repro-ckpt-sharded"
VERSION = 1
MANIFEST = "manifest.json"


class ManifestError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class ShardFile:
    """One saved shard: its file and the global index box it covers."""

    file: str
    index: Tuple[Tuple[int, int], ...]      # per-dim [start, stop)
    crc32: int

    def to_dict(self) -> Dict[str, Any]:
        return {"file": self.file,
                "index": [list(ab) for ab in self.index],
                "crc32": self.crc32}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ShardFile":
        return ShardFile(file=d["file"],
                         index=tuple((int(a), int(b))
                                     for a, b in d["index"]),
                         crc32=int(d["crc32"]))


@dataclasses.dataclass(frozen=True)
class LeafEntry:
    """Manifest record for one pytree leaf."""

    kind: str                               # "replicated" | "sharded"
    shape: Tuple[int, ...]
    dtype: str
    file: Optional[str] = None              # replicated
    crc32: Optional[int] = None             # replicated
    shards: Tuple[ShardFile, ...] = ()      # sharded
    spec: Tuple[Any, ...] = ()              # PartitionSpec axes (info only)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "shape": list(self.shape),
                             "dtype": self.dtype}
        if self.kind == "replicated":
            d["file"] = self.file
            d["crc32"] = self.crc32
        else:
            d["shards"] = [s.to_dict() for s in self.shards]
            d["spec"] = [list(a) if isinstance(a, (list, tuple)) else a
                         for a in self.spec]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LeafEntry":
        return LeafEntry(
            kind=d["kind"], shape=tuple(int(s) for s in d["shape"]),
            dtype=d["dtype"], file=d.get("file"), crc32=d.get("crc32"),
            shards=tuple(ShardFile.from_dict(s)
                         for s in d.get("shards", ())),
            spec=tuple(tuple(a) if isinstance(a, list) else a
                       for a in d.get("spec", ())))


def layout_to_dict(layout) -> Optional[Dict[str, Any]]:
    """Serialize a ``bucketing.BucketLayout`` (duck-typed; no treedef)."""
    from repro_torch.checkpoint import dtype_name
    if layout is None:
        return None
    return {
        "align": int(layout.align),
        "bucket_sizes": [int(c) for c in layout.bucket_sizes],
        "live_sizes": bucket_live_sizes(layout),
        "slots": [{"bucket": int(s.bucket), "offset": int(s.offset),
                   "size": int(s.size), "shape": list(s.shape),
                   "dtype": dtype_name(s.dtype)} for s in layout.slots],
    }


def bucket_live_sizes(layout) -> List[int]:
    """Per-bucket live (un-padded) prefix length; the rest is zeros."""
    live = [0] * len(layout.bucket_sizes)
    for s in layout.slots:
        live[s.bucket] = max(live[s.bucket], s.offset + s.size)
    return live


@dataclasses.dataclass
class Manifest:
    step: int
    leaves: Dict[str, LeafEntry]
    mesh: Optional[Dict[str, Any]] = None         # {axis_names, shape}
    layout: Optional[Dict[str, Any]] = None
    version: int = VERSION

    def to_json(self) -> str:
        return json.dumps({
            "format": FORMAT, "version": self.version, "step": self.step,
            "mesh": self.mesh, "layout": self.layout,
            "leaves": {k: v.to_dict() for k, v in self.leaves.items()},
        }, indent=1, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Manifest":
        d = json.loads(text)
        if d.get("format") != FORMAT:
            raise ManifestError(
                f"not a {FORMAT} manifest (format={d.get('format')!r})")
        version = int(d.get("version", VERSION))
        if version > VERSION:
            raise ManifestError(
                f"manifest version {version} is newer than "
                f"supported {VERSION}")
        return Manifest(
            step=int(d["step"]),
            leaves={k: LeafEntry.from_dict(v)
                    for k, v in d["leaves"].items()},
            mesh=d.get("mesh"), layout=d.get("layout"),
            version=version)


def mesh_to_dict(mesh) -> Optional[Dict[str, Any]]:
    """Axis names and sizes of a ``RankGrid`` (or anything with
    ``axis_names`` and ``shape[name]``)."""
    if mesh is None or not hasattr(mesh, "axis_names"):
        return None
    return {"axis_names": list(mesh.axis_names),
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names]}


def read_manifest(ckpt_dir: str) -> Manifest:
    path = os.path.join(ckpt_dir, MANIFEST)
    with open(path) as f:
        return Manifest.from_json(f.read())


def is_sharded_dir(ckpt_dir: str) -> bool:
    """True when ``ckpt_dir`` holds a committed sharded-format manifest."""
    path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            return json.load(f).get("format") == FORMAT
    except (OSError, ValueError):
        return False
