"""Training launcher of the port:
``python -m repro_torch.launch.train --arch llama3.2-1b [--steps N]
[--batch B] [--seq S] [--accum A] [--lr LR] [--full-config]
[--device cuda|cpu] [--data-parallel N] [--cross-pod-mode MODE]
[--bucket-mb MB] [--overlap] [--slow-compress-bits 0|8|16]
[--error-feedback] [--deterministic-reduce]``.

Trains on synthetic batches, on the card unless ``--device cpu`` is given,
and prints the reference launcher's line every 10 steps.  The reduced
(test) config unless ``--full-config``, with per-layer remat only at full
size, as the reference launcher.  ``--data-parallel N`` spawns N ranks of a
gloo job on a ``(data,)`` grid (the reference's ``(data, model)`` mesh with
model 1; all ranks share the one card, or the CPU), each running its own
``Trainer`` on its rows of the global batch; rank 0's lines are printed.
The checkpoint, resume and reconfiguration flags of ``repro.launch.train``
come with ROADMAP.md queue 1 items 7-8.
"""
from __future__ import annotations

import argparse
import os

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
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        ap.error("--model-parallel above 1 is not ported: the port's rank "
                 "grids have no parameter axes (ROADMAP.md queue 1 item 10)")
    return args


def train_rank(rank: int, world: int, args) -> list:
    """One rank's training run; returns its history."""
    from repro_torch.parallel.mesh import make_rank_grid
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
    grid = make_rank_grid((world,), ("data",)) if world > 1 else None
    model = build_model(cfg, device=args.device, seed=None,
                        remat=args.full_config)
    trainer = Trainer(
        model,
        optim.AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                          total_steps=args.steps),
        TrainerConfig(n_steps=args.steps, log_every=10, accum=args.accum,
                      cross_pod_mode=args.cross_pod_mode,
                      bucket_bytes=args.bucket_mb << 20,
                      slow_compress_bits=args.slow_compress_bits,
                      overlap=args.overlap,
                      slow_error_feedback=args.error_feedback,
                      deterministic_reduce=args.deterministic_reduce),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch), device=args.device, grid=grid)
    return trainer.run(seed=0)["history"]


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel > 1:
        from repro_torch.parallel.launch import run_ranks
        # ranks on the CPU share its cores
        threads = (max(1, (os.cpu_count() or 1) // args.data_parallel)
                   if args.device == "cpu" else None)
        history = run_ranks(train_rank, args.data_parallel, args=(args,),
                            deadline_s=3600, threads=threads)[0]
    else:
        history = train_rank(0, 1, args)
    for h in history:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"{h['sec_per_step']*1e3:.0f} ms")


if __name__ == "__main__":
    main()
