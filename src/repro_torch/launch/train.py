"""Training launcher of the port:
``python -m repro_torch.launch.train --arch llama3.2-1b [--steps N]
[--batch B] [--seq S] [--accum A] [--lr LR] [--full-config]
[--device cuda|cpu] [--data-parallel N] [--cross-pod-mode MODE]
[--bucket-mb MB] [--overlap] [--slow-compress-bits 0|8|16]
[--error-feedback] [--deterministic-reduce] [--ckpt-dir DIR]
[--resume | --no-resume] [--max-restore-retries K] [--fallback-on-corrupt]
[--save-sharded | --no-save-sharded] [--reconfig-at STEP:PODxDATA,...
--reconfig-mode handoff|drain --pod-parallel P]``.

Trains on synthetic batches, on the card unless ``--device cpu`` is given,
and prints the reference launcher's line every 10 steps.  The reduced
(test) config unless ``--full-config``, with per-layer remat only at full
size, as the reference launcher.  ``--data-parallel N`` spawns N ranks of a
gloo job on a ``(data,)`` grid (the reference's ``(data, model)`` mesh with
model 1; all ranks share the one card, or the CPU), each running its own
``Trainer`` on its rows of the global batch; rank 0's lines are printed.
The ``Trainer`` commits a checkpoint every 50 steps to ``--ckpt-dir`` and
resumes from its latest committed step unless ``--no-resume``.

``--reconfig-at 2:4x1,4:1x4`` runs the elastic driver instead
(``repro_torch.elastic_driver``) in ``--pod-parallel`` x
``--data-parallel`` spawned ranks: a save -> reshard-restore -> continue
cycle at each listed step (``--reconfig-mode drain``: the gathered save
and full restore), ``hier_bucketed_zero1`` with the deterministic reduce;
it prints each step's loss and grid and each cycle's measurement.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import optim
from repro_torch.data import DataConfig
from repro_torch.models.registry import (ARCH_IDS, build_model, get_config,
                                         reduced_config)
from repro_torch.train import CROSS_POD_MODES, Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (fails when there is no card)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="ranks of a (data,) grid, spawned as one gloo "
                         "job; 0 = single rank")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="must be 1: the port's grids have no parameter "
                         "axes")
    ap.add_argument("--cross-pod-mode", default="xla",
                    choices=CROSS_POD_MODES,
                    help="gradient sync schedule (bucketed modes need a "
                         "pure data-parallel mesh)")
    ap.add_argument("--bucket-mb", type=int, default=32,
                    help="bucket capacity for the hier_bucketed* modes")
    ap.add_argument("--overlap", action="store_true",
                    help="pipeline bucket i+1's fast reduce-scatter under "
                         "bucket i's slow hop (hier_bucketed* modes; "
                         "bitwise-identical losses)")
    ap.add_argument("--slow-compress-bits", type=int, default=0,
                    choices=(0, 8, 16),
                    help="compress the slow (cross-pod) hop: 16=bf16, "
                         "8=int8+scale")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry int8 quantization residuals across steps "
                         "(requires --slow-compress-bits 8 and a "
                         "hier_bucketed* mode)")
    ap.add_argument("--deterministic-reduce", action="store_true",
                    help="mesh-factorization-invariant gradient reduce "
                         "(hier_bucketed* modes): bitwise-identical "
                         "training across (pod, data) factorizations, so "
                         "sharded checkpoints reshard-restore exactly "
                         "onto a repacked mesh")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--resume", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="resume from the latest committed checkpoint in "
                         "--ckpt-dir (--no-resume starts from scratch)")
    ap.add_argument("--max-restore-retries", type=int, default=0,
                    help="bounded exponential-backoff retries for "
                         "transient I/O (EIO/ENOSPC/...) during "
                         "checkpoint save and restore")
    ap.add_argument("--fallback-on-corrupt", action="store_true",
                    help="if the newest committed checkpoint fails its "
                         "CRC/manifest validation at resume, quarantine "
                         "it on disk and fall back to the previous "
                         "committed step instead of dying")
    ap.add_argument("--save-sharded", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="write per-rank shard + manifest checkpoints "
                         "(repro_torch.ckpt); --no-save-sharded keeps the "
                         "legacy gathered per-leaf format")
    ap.add_argument("--reconfig-at", default="",
                    help="elastic repack schedule 'STEP:PODxDATA[,...]' "
                         "(e.g. '10:4x1,20:1x4'): run the elastic "
                         "driver, executing a save -> reshard-restore "
                         "-> continue cycle at each step; implies "
                         "hier_bucketed_zero1 + deterministic reduce")
    ap.add_argument("--reconfig-mode", default="handoff",
                    choices=("drain", "handoff"),
                    help="how --reconfig-at events move state: "
                         "'handoff' = committed sharded save + "
                         "reshard-restore (drain-free); 'drain' = "
                         "legacy gathered save + full restore (the "
                         "incumbent cycle, for cost comparison)")
    ap.add_argument("--pod-parallel", type=int, default=1,
                    help="pod axis of the initial (pod, data) "
                         "factorization for --reconfig-at runs")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        ap.error("--model-parallel above 1 is not ported: the port's rank "
                 "grids have no parameter axes (ROADMAP.md queue 1 item 10)")
    # the recovery knobs act at restore time; with --no-resume there is
    # no restore, so accepting them would silently do nothing
    if not args.resume and args.fallback_on_corrupt:
        raise SystemExit("--fallback-on-corrupt is a resume-time "
                         "recovery knob; it does nothing with "
                         "--no-resume — drop one of the two")
    if (not args.resume and args.max_restore_retries
            and not args.reconfig_at):
        raise SystemExit("--max-restore-retries needs a restore to "
                         "retry; with --no-resume (and no --reconfig-at "
                         "handoffs) it does nothing — drop one of the "
                         "two")
    if args.max_restore_retries < 0:
        raise SystemExit("--max-restore-retries must be >= 0")
    return args


def parse_reconfig_schedule(spec: str):
    """'10:4x1,20:1x4' -> [ReconfigEvent(step=10, mesh_shape=(4, 1)), …]"""
    from repro_torch.elastic_driver import ReconfigEvent
    events = []
    for item in spec.split(","):
        try:
            step_s, shape_s = item.strip().split(":")
            pod_s, data_s = shape_s.lower().split("x")
            events.append(ReconfigEvent(step=int(step_s),
                                        mesh_shape=(int(pod_s),
                                                    int(data_s))))
        except ValueError as e:
            raise SystemExit(
                f"bad --reconfig-at entry {item!r} (want STEP:PODxDATA,"
                f" e.g. '10:4x1'): {e}")
    return events


def check_elastic(args):
    """The reference's checks of a --reconfig-at run; its schedule."""
    if not args.data_parallel:
        raise SystemExit("--reconfig-at needs --data-parallel (the "
                         "data axis of the initial factorization)")
    # the driver pins its training configuration; reject sync flags it
    # would otherwise silently ignore ('xla' is the untouched default)
    if args.cross_pod_mode not in ("xla", "hier_bucketed_zero1"):
        raise SystemExit(
            f"--reconfig-at implies cross_pod_mode=hier_bucketed_zero1; "
            f"{args.cross_pod_mode!r} is not supported by the elastic "
            f"driver")
    if args.overlap:
        raise SystemExit("--overlap has no pipeline under the driver's "
                         "deterministic reduce")
    if args.slow_compress_bits and not (args.slow_compress_bits == 8
                                        and args.error_feedback):
        raise SystemExit(
            "the elastic driver compresses the slow hop only as int8 "
            "with error feedback (--slow-compress-bits 8 "
            "--error-feedback)")
    schedule = parse_reconfig_schedule(args.reconfig_at)
    n_devices = args.pod_parallel * args.data_parallel
    for e in schedule:
        if e.mesh_shape[0] * e.mesh_shape[1] != n_devices:
            raise SystemExit(
                f"reconfig target {e.mesh_shape} is not a factorization "
                f"of {n_devices} devices")
        if e.step >= args.steps:
            raise SystemExit(
                f"reconfig step {e.step} is past the run "
                f"(--steps {args.steps}); it would silently never fire")
    return schedule


def _model(args):
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
    return cfg, build_model(cfg, device=args.device, seed=None,
                            remat=args.full_config)


def _ocfg(args):
    return optim.AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                             total_steps=args.steps)


def elastic_rank(rank: int, world: int, args, schedule) -> list:
    """One rank of a --reconfig-at run; returns the lines to print."""
    from repro_torch.elastic_driver import ElasticDriver
    from repro_torch.faults.retry import RetryPolicy
    cfg, model = _model(args)
    drv = ElasticDriver(
        model, _ocfg(args),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch),
        base_dir=args.ckpt_dir, bucket_bytes=args.bucket_mb << 20,
        accum=args.accum, mode=args.reconfig_mode,
        error_feedback=args.error_feedback,
        retry=RetryPolicy(max_retries=args.max_restore_retries),
        fallback_on_corrupt=args.fallback_on_corrupt, device=args.device)
    out = drv.run(args.steps, schedule,
                  initial_shape=(args.pod_parallel, args.data_parallel),
                  resume=args.resume)
    lines = []
    if out.start_step:
        lines.append(f"resumed from committed step {out.start_step}")
    if out.recovery is not None and out.recovery.quarantined:
        for q in out.recovery.quarantined:
            lines.append(f"quarantined corrupt step {q.step} -> "
                         f"{q.quarantined_to}")
    for i, (loss, shape) in enumerate(zip(out.losses, out.mesh_shapes),
                                      start=out.start_step):
        lines.append(f"step {i:4d}  loss {loss:.4f}  mesh {shape}")
    for m in out.measurements:
        lines.append(f"reconfig@{m.step}: {m.from_shape}->{m.to_shape} "
                     f"[{m.mode}] save {m.save_s*1e3:.0f} ms, restore "
                     f"{m.restore_s*1e3:.0f} ms, recompile "
                     f"{m.compile_s*1e3:.0f} ms, verified={m.verified}")
    return lines


def train_rank(rank: int, world: int, args) -> list:
    """One rank's training run; returns its history."""
    from repro_torch.parallel.mesh import make_rank_grid
    cfg, model = _model(args)
    grid = make_rank_grid((world,), ("data",)) if world > 1 else None
    trainer = Trainer(
        model, _ocfg(args),
        TrainerConfig(n_steps=args.steps, ckpt_every=50,
                      ckpt_dir=args.ckpt_dir, log_every=10,
                      accum=args.accum,
                      cross_pod_mode=args.cross_pod_mode,
                      bucket_bytes=args.bucket_mb << 20,
                      slow_compress_bits=args.slow_compress_bits,
                      overlap=args.overlap,
                      slow_error_feedback=args.error_feedback,
                      deterministic_reduce=args.deterministic_reduce,
                      save_sharded=args.save_sharded,
                      max_restore_retries=args.max_restore_retries,
                      fallback_on_corrupt=args.fallback_on_corrupt),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch), device=args.device, grid=grid)
    return trainer.run(seed=0, resume=args.resume)["history"]


def _spawn(fn, n: int, args, *extra):
    from repro_torch.parallel.launch import run_ranks
    # ranks on the CPU share its cores
    threads = (max(1, (os.cpu_count() or 1) // n)
               if args.device == "cpu" else None)
    return run_ranks(fn, n, args=(args,) + extra, deadline_s=3600,
                     threads=threads)[0]


def main(argv=None):
    args = parse_args(argv)
    if args.reconfig_at:
        schedule = check_elastic(args)
        n = args.pod_parallel * args.data_parallel
        lines = (_spawn(elastic_rank, n, args, schedule) if n > 1
                 else elastic_rank(0, 1, args, schedule))
        print("\n".join(lines))
        return
    if args.data_parallel > 1:
        history = _spawn(train_rank, args.data_parallel, args)
    else:
        history = train_rank(0, 1, args)
    for h in history:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"{h['sec_per_step']*1e3:.0f} ms")


if __name__ == "__main__":
    main()
