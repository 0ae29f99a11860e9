"""Elastic sharded checkpointing of the port: per-rank shards + manifest
(counterpart of ``repro/ckpt``, the same on-disk format).

The subsystem behind drain-free reconfiguration: each data-parallel rank
saves only the ZeRO-1 bucket shards (f32 masters/moments, EF residuals)
it already holds plus the replicated small leaves, under an atomic
temp-dir-rename commit protocol; a JSON manifest records the bucket
layout, grid, step and per-file checksums; and restore reshards the flat
bucket address space onto whatever (pod, data) grid the *restorer* runs
— no rank ever gathers a full bucket on either side.  A checkpoint one
package writes, the other restores: file names, ``.npy`` bytes and
manifests are the reference's (:mod:`repro_torch.ckpt.state` maps the
port's training state onto the reference's tree).

Public API:

- :func:`save_sharded` / :func:`restore_sharded` — the sharded format;
- :func:`restore_auto` — format dispatch (legacy per-leaf dirs keep
  restoring);
- :class:`ShardedCheckpoint` — range-level reader (reshard arithmetic);
- :func:`latest_step` / :func:`committed_steps` / :func:`step_dir` —
  step-dir bookkeeping (full manifest-verified history), shared with
  (and crash-safe against) the legacy format;
- :func:`gc_debris` — dead-writer ``.tmp-*``/``.old-*`` sweep (also run
  automatically by every successful :func:`save_sharded`);
- restore policies :data:`EXACT` / :data:`PAD_FLAT` / :data:`ZERO`.

Fault-injection points and retry/fallback recovery live in
:mod:`repro_torch.faults` (``restore_with_fallback`` wraps
:func:`restore_auto` with the committed-history quarantine walk).

The legacy gathered per-leaf format lives on in
:mod:`repro_torch.checkpoint` for small replicated states and old
checkpoints.
"""
from repro_torch.checkpoint import (CorruptCheckpointError, committed_steps,
                                    latest_step, step_dir)
from repro_torch.ckpt.manifest import (FORMAT, MANIFEST, VERSION, LeafEntry,
                                       Manifest, ManifestError, ShardFile,
                                       bucket_live_sizes, is_sharded_dir,
                                       read_manifest)
from repro_torch.ckpt.sharded import (EXACT, PAD_FLAT, ZERO,
                                      ShardedCheckpoint, gc_debris,
                                      restore_auto, restore_sharded,
                                      save_sharded)
from repro_torch.ckpt.treepaths import leaf_paths, rebuild, sanitize

__all__ = [
    "CorruptCheckpointError", "committed_steps", "latest_step",
    "step_dir", "gc_debris",
    "FORMAT", "MANIFEST", "VERSION", "LeafEntry", "Manifest",
    "ManifestError", "ShardFile", "bucket_live_sizes", "is_sharded_dir",
    "read_manifest",
    "EXACT", "PAD_FLAT", "ZERO", "ShardedCheckpoint", "restore_auto",
    "restore_sharded", "save_sharded",
    "leaf_paths", "rebuild", "sanitize",
]
