"""Serving launcher of the port:
``python -m repro_torch.launch.serve
--arch llama3.2-1b|zamba2-1.2b|xlstm-125m [--full-config]
[--device cuda|cpu]``.

Runs the continuous-batching server on synthetic requests, on the card
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.models.registry import (ARCH_IDS, build_model, get_config,
                                         reduced_config)
from repro_torch.serve import BatchedServer, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: cuda (fails when there is no card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=args.device, seed=0)
    server = BatchedServer(model, max_batch=args.max_batch,
                           max_seq=args.max_seq, device=args.device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(2, 10))
                              ).astype(np.int32)
        server.submit(Request(rid, prompt, max_new=args.max_new))
    server.run_until_drained()
    for req in sorted(server.completed, key=lambda r: r.rid):
        print(f"request {req.rid}: {len(req.out)} tokens -> {req.out}")


if __name__ == "__main__":
    main()
