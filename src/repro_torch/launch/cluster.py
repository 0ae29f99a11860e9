"""CLI for the multi-tenant cluster runtime (the port's counterpart of
``repro/launch/cluster.py``).

Runs several training jobs as co-scheduled subprocesses over one shared
device pool — each job segment's ranks are gloo processes that share the
card, or the CPU with ``--device cpu`` — printing every scheduler-driven
repack and the measured per-boundary handoff costs.  Jobs come from a
CSV trace file
(:func:`repro_torch.core.traces.load_trace` — the optional ``tenant`` /
``priority_tier`` columns select tenancy) or from ``--demo``, the
canonical 3-job/2-tenant contention scenario (one defrag repack forced
by a single-host-pinned tier-0 arrival, one rebalance repack after it
departs).

Usage:
  python -m repro_torch.launch.cluster --demo [--device cpu]
  python -m repro_torch.launch.cluster --trace jobs.csv --pool 2x4 \\
      --policy backfill --quota beta=6 --steps 8 --segment-steps 4
"""
from __future__ import annotations

import argparse
import json
import tempfile

from repro_torch.cluster import ClusterJobSpec, ClusterRuntime, DevicePool
from repro_torch.core.job import TIER_HIGH
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.traces import load_trace


def demo_specs(steps: int, segment_steps: int, *, device=None):
    """3 jobs, 2 tenants, mixed tiers on a 2x4 pool: j1's departure
    leaves the pool fragmented for the single-host-pinned j2, forcing a
    defrag repack of j0; j2's departure triggers j0's rebalance.
    ``device``: where the jobs' ranks run (None: the card)."""
    return [
        ClusterJobSpec("j0", size=4, n_steps=max(steps, 12),
                       segment_steps=segment_steps, tenant="acme",
                       device=device),
        ClusterJobSpec("j1", size=2, n_steps=2, segment_steps=2,
                       tenant="beta", device=device),
        ClusterJobSpec("j2", size=4, n_steps=2, segment_steps=2,
                       tenant="beta", priority_tier=TIER_HIGH,
                       after="j1", device=device),
    ]


def specs_from_trace(path: str, *, steps: int, segment_steps: int,
                     device=None):
    jobs = load_trace(path)
    return [ClusterJobSpec(j.job_id, size=j.size, n_steps=steps,
                           segment_steps=segment_steps, tenant=j.tenant,
                           priority_tier=j.priority_tier, seed=i,
                           device=device)
            for i, j in enumerate(jobs)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--trace", help="CSV trace file")
    src.add_argument("--demo", action="store_true",
                     help="canonical 3-job contention scenario")
    ap.add_argument("--pool", default="2x4",
                    help="HOSTSxDEVICES_PER_HOST (default 2x4)")
    ap.add_argument("--policy", default="backfill",
                    choices=("fifo", "backfill"))
    ap.add_argument("--depth", type=int, default=8,
                    help="backfill window")
    ap.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=N",
                    help="per-tenant device quota (repeatable)")
    ap.add_argument("--steps", type=int, default=15,
                    help="steps per trace job (demo: long job)")
    ap.add_argument("--segment-steps", type=int, default=3)
    ap.add_argument("--base-dir", default=None,
                    help="work dir (default: a fresh temp dir)")
    ap.add_argument("--no-rebalance", action="store_true")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also dump the run summary to this file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the jobs' ranks run (default: the card)")
    args = ap.parse_args(argv)
    if args.device is None:
        # the card unless asked for the CPU: refuse here, before any job
        # starts, rather than in every worker
        from repro_torch.models.registry import resolve_device
        resolve_device(None)

    n_hosts, dph = (int(x) for x in args.pool.lower().split("x"))
    quotas = {}
    for q in args.quota:
        tenant, n = q.split("=")
        quotas[tenant] = int(n)

    if args.demo:
        specs = demo_specs(args.steps, args.segment_steps,
                           device=args.device)
    else:
        specs = specs_from_trace(args.trace, steps=args.steps,
                                 segment_steps=args.segment_steps,
                                 device=args.device)

    rt = ClusterRuntime(
        specs, pool=DevicePool(n_hosts, dph),
        base_dir=args.base_dir or tempfile.mkdtemp(prefix="cluster_"),
        scheduler=Scheduler(args.policy, depth=args.depth,
                            quotas=quotas or None),
        rebalance=not args.no_rebalance)
    res = rt.run()

    print(f"pool {n_hosts}x{dph}  jobs {len(specs)}  "
          f"repacks {res.n_repacks}  wall {res.wall_s:.1f}s")
    for r in res.repacks:
        print(f"  repack {r.job_id}: {r.reason} at step {r.at_step}  "
              f"{r.from_shape}->{r.to_shape}"
              + (f"  (admits {r.requested_by})" if r.requested_by
                 else ""))
    for jid in sorted(res.jobs):
        o = res.jobs[jid]
        print(f"  {jid}: {len(o.losses)} steps, shapes "
              f"{o.shapes}, restarts {o.restarts}, "
              f"final loss {o.losses[-1]:.4f}")
    for m in res.measurements:
        print(f"  handoff {m['job_id']}@{m['step']}: "
              f"save {m['save_s'] * 1e3:.0f}ms  restore "
              f"{m['restore_s'] * 1e3:.0f}ms  repack={m['repack']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({
                "repacks": [r.to_dict() for r in res.repacks],
                "measurements": res.measurements,
                "jobs": {jid: {"losses": o.losses,
                               "shapes": [list(s) for s in o.shapes],
                               "restarts": o.restarts}
                         for jid, o in res.jobs.items()},
            }, f, indent=2)


if __name__ == "__main__":
    main()
