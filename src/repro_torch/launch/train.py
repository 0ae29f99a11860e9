"""Training launcher of the port:
``python -m repro_torch.launch.train --arch llama3.2-1b [--steps N]
[--batch B] [--seq S] [--accum A] [--lr LR] [--full-config]
[--device cuda|cpu]``.

Trains on synthetic batches on one device, the card unless ``--device cpu``
is given, and prints the reference launcher's line every 10 steps.  The
reduced (test) config unless ``--full-config``, with per-layer remat only
at full size, as the reference launcher.  The mesh, cross-pod, checkpoint
and reconfiguration flags of ``repro.launch.train`` come with ROADMAP.md
queue 1 items 5-8.
"""
from __future__ import annotations

import argparse

from repro_torch import optim
from repro_torch.data import DataConfig
from repro_torch.models.registry import (ARCH_IDS, build_model, get_config,
                                         reduced_config)
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=args.device, seed=None,
                        remat=args.full_config)
    trainer = Trainer(
        model,
        optim.AdamWConfig(peak_lr=args.lr, warmup_steps=20,
                          total_steps=args.steps),
        TrainerConfig(n_steps=args.steps, log_every=10, accum=args.accum),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                   global_batch=args.batch), device=args.device)
    out = trainer.run(seed=0)
    for h in out["history"]:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"{h['sec_per_step']*1e3:.0f} ms")


if __name__ == "__main__":
    main()
