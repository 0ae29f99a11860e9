"""Cluster worker: one job *segment* in a subprocess (the port's
counterpart of ``repro/cluster/worker.py``).

The :class:`~repro_torch.cluster.manager.JobManager` launches this module
(``python -m repro_torch.cluster.worker --spec S --result R``).  The
segment spawns exactly the job's ``size`` gloo ranks
(:func:`repro_torch.parallel.launch.run_ranks`), a world of its own that
meets at a fresh ``file://`` store, so co-scheduled jobs never join each
other's world.  Every rank arms the job's namespaced fault plan *first*
(:func:`repro_torch.faults.plan.install_from_env`), builds the model the
reference's worker builds and runs its share of one
:class:`~repro_torch.elastic_driver.ElasticDriver` segment; rank 0's result
is written atomically (tmp + rename) — a missing result file is how the
parent tells a crash from a finished segment.  When a rank dies (a fault
plan's SIGKILL, or any error), ``run_ranks`` stops the others at once and
this process exits non-zero without a result.

Segment protocol (the cluster runtime's handoff-by-segments):

- first segment: fresh start on the assigned shape, train to ``run_to``,
  ``final_save`` commits step ``run_to``;
- later segments: ``resume=True`` restores the newest committed step
  onto the (possibly different) assigned shape — the reshard-restore is
  the receiving half of the repack — and continues to the new ``run_to``.

``total_steps`` is always the job's FULL step count: the AdamW schedule
is absolute-step-indexed and :class:`~repro_torch.data.SyntheticCorpus`
batches are deterministic by absolute step, which is what makes the
stitched per-job loss curve bitwise-equal to an uninterrupted run.

The spec's ``device`` (``None``: the card, and a rank that finds none
raises) and ``n_layers`` (``None``: the reference's ``reduced_config``; an
int: the arch's published widths at that depth) are the port's.  The
result holds the reference worker's keys, and ``device``,
``kernel_launches`` (rank 0's launches of each kernel in this segment) and
``peak_memory_gib`` (each rank's peak of allocated card memory; 0 on the
CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

# a hung rank is killed after this long (gloo's own timeout, 90 s, stops a
# rank that waits on a dead peer sooner)
SEGMENT_DEADLINE_S = 3000.0


def segment_config(spec: dict):
    """The model config of a segment spec."""
    from repro_torch.models.registry import get_config, reduced_config
    cfg = get_config(spec["arch"])
    n_layers = spec.get("n_layers")
    if n_layers is None:
        return reduced_config(cfg)
    return dataclasses.replace(cfg, n_layers=int(n_layers))


def segment_driver(spec: dict, model, dev):
    """The ``ElasticDriver`` of a segment over ``model``: the reference
    worker's AdamW, data and bucket bytes, ``fallback_on_corrupt``."""
    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.elastic_driver import ElasticDriver
    ocfg = optim.AdamWConfig(peak_lr=spec.get("peak_lr", 1e-3),
                             warmup_steps=spec.get("warmup_steps", 2),
                             total_steps=spec["total_steps"])
    dcfg = DataConfig(vocab_size=model.cfg.vocab_size,
                      seq_len=spec.get("seq_len", 16),
                      global_batch=spec.get("global_batch", 8))
    return ElasticDriver(model, ocfg, dcfg, base_dir=spec["base_dir"],
                         bucket_bytes=spec.get("bucket_bytes", 64 << 10),
                         fallback_on_corrupt=True, device=dev)


def segment_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of a segment: its ``ElasticDriver`` run and counts."""
    # arm the (namespaced) fault plan before anything is built, so
    # injected crashes can hit the first step and save paths too
    from repro_torch.faults.plan import install_from_env
    install_from_env(spec.get("job_id"))

    import torch
    from repro_torch.kernels._build import all_kernels
    from repro_torch.models.registry import build_model, resolve_device

    dev = resolve_device(spec.get("device"))
    model = build_model(segment_config(spec), device=dev, seed=None,
                        remat=False)
    drv = segment_driver(spec, model, dev)
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    shape = tuple(spec["shape"])
    res = drv.run(spec["run_to"], (), initial_shape=shape,
                  seed=spec.get("seed", 0),
                  resume=bool(spec.get("resume", False)),
                  final_save=bool(spec.get("final_save", True)))
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else 0.0)
    return {
        "job_id": spec["job_id"],
        "start_step": res.start_step,
        "end_step": spec["run_to"],
        "shape": list(shape),
        "n_ranks": shape[0] * shape[1],
        "losses": res.losses,
        "steady_step_s": res.steady_step_s,
        "first_step_s": res.first_step_s,
        "state_bytes": res.state_bytes,
        "final_save_s": res.final_save_s,
        "final_save_bytes": res.final_save_bytes,
        "resume_restore_s": res.resume_restore_s,
        "resume_restore_bytes": res.resume_restore_bytes,
        "resume_setup_s": res.resume_setup_s,
        "recovered_step": (res.recovery.restored_step
                           if res.recovery else None),
        "device": dev.type,
        "kernel_launches": {k.name: k.launches for k in kernels},
        "peak_memory_gib": peak,
    }


def run_segment(spec: dict) -> dict:
    """Runs the segment on ``size`` spawned gloo ranks; rank 0's result,
    with every rank's peak memory."""
    # spawn pickles the rank function by its module's name, which is
    # __main__ when this module runs as a script
    from repro_torch.cluster.worker import segment_rank as rank_fn
    from repro_torch.parallel.launch import run_ranks
    shape = tuple(spec["shape"])
    outs = run_ranks(rank_fn, shape[0] * shape[1], args=(spec,),
                     deadline_s=SEGMENT_DEADLINE_S,
                     threads=1 if spec.get("device") == "cpu" else None)
    out = dict(outs[0])
    out["peak_memory_gib"] = [o["peak_memory_gib"] for o in outs]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--spec", required=True)
    ap.add_argument("--result", required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    out = run_segment(spec)
    tmp = args.result + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, args.result)      # atomic: exists => complete


if __name__ == "__main__":
    main()
