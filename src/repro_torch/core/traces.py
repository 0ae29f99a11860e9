"""Synthetic trace generation (§5.1).

Three orthogonal dimensions, assumed independent:
  (i)  execution-time distribution — short (600-1800 s) / medium
       (1800-3600 s) / long (3600-7200 s) buckets with mixes derived from
       the four public traces (Helios Earth/Venus, Philly, Alibaba);
  (ii) workload-size distribution — small-dominant / balanced /
       large-dominant (paper Table 2);
  (iii) workload type — training-only / inference-only / 50:50 mixed.

The port's copy of ``repro/core/traces.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.jct_model import WORKLOADS
from repro_torch.core.job import DEFAULT_TENANT, TIER_NORMAL, Job

DURATION_BUCKETS = {
    "short": (600.0, 1800.0),
    "medium": (1800.0, 3600.0),
    "long": (3600.0, 7200.0),
}

# bucket mixes approximating the empirical duration skew of each source
# trace (single-GPU / 0.5-1-GPU jobs).
DURATION_SOURCES: Dict[str, Tuple[float, float, float]] = {
    "helios_earth": (0.55, 0.25, 0.20),
    "helios_venus": (0.45, 0.30, 0.25),
    "philly": (0.60, 0.25, 0.15),
    "alibaba": (0.70, 0.20, 0.10),
}

# Table 2: jobs per workload size.
TRAIN_SIZES = (1, 2, 4, 6, 8)
INFER_SIZES = (1, 2, 4)
SIZE_DISTS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    "small": {"train": (16, 8, 4, 2, 1), "infer": (16, 8, 4)},
    "balanced": {"train": (8, 8, 8, 4, 4), "infer": (10, 10, 10)},
    "large": {"train": (4, 4, 12, 8, 4), "infer": (8, 8, 16)},
}

TYPE_MIXES = ("train", "inference", "mixed")


def _sizes_in_range(lo_hi: Tuple[int, ...], pool: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
    if len(lo_hi) == 1:
        return (lo_hi[0],) if lo_hi[0] in pool or True else ()
    lo, hi = lo_hi
    return tuple(s for s in pool if lo <= s <= hi)


def models_for(kind: str, size: int) -> List[str]:
    out = []
    for name, w in WORKLOADS.items():
        sizes = w.train_sizes if kind == "train" else w.infer_sizes
        batches = w.train_batches if kind == "train" else w.infer_batches
        if not sizes or not batches:
            continue
        pool = TRAIN_SIZES if kind == "train" else INFER_SIZES
        if size in _sizes_in_range(sizes, pool):
            out.append(name)
    return out


def _pick_batch(model: str, kind: str, rng) -> int:
    w = WORKLOADS[model]
    br = w.train_batches if kind == "train" else w.infer_batches
    if len(br) == 1:
        return br[0]
    lo, hi = br
    opts = [b for b in (4, 8, 16, 32, 64, 128, 196, 256, 512)
            if lo <= b <= hi]
    return int(rng.choice(opts)) if opts else lo


@dataclasses.dataclass(frozen=True)
class TraceCategory:
    duration_source: str
    size_dist: str
    type_mix: str

    @property
    def name(self) -> str:
        return f"{self.duration_source}/{self.size_dist}/{self.type_mix}"


ALL_CATEGORIES: Tuple[TraceCategory, ...] = tuple(
    TraceCategory(d, s, t)
    for d, s, t in itertools.product(DURATION_SOURCES, SIZE_DISTS,
                                     TYPE_MIXES))


def generate_trace(cat: TraceCategory, *, seed: int = 0,
                   double: bool = False, max_size: Optional[int] = None,
                   mean_interarrival: float = 30.0,
                   n_tenants: int = 1) -> List[Job]:
    """One synthetic trace for a category.

    ``double=True`` doubles the Table-2 job counts (§5.1 Metrics).
    ``max_size`` folds larger sizes down (Fig. 7 uses max 4 so SM is
    comparable).  Arrivals are open-loop (exponential interarrivals).

    ``n_tenants > 1`` assigns jobs round-robin (by arrival index) to
    tenants ``t0..t{n-1}``.  The assignment consumes no rng draws, so a
    multi-tenant trace is the single-tenant trace with tenant labels
    painted on — every other field, and therefore every quota-free
    replay, is bit-identical.
    """
    rng = np.random.default_rng(seed)
    mix = DURATION_SOURCES[cat.duration_source]
    dist = SIZE_DISTS[cat.size_dist]

    specs: List[Tuple[str, int]] = []      # (kind, size)
    mult = 2 if double else 1

    def add(kind: str, sizes: Tuple[int, ...], counts: Tuple[int, ...],
            scale: float = 1.0):
        for size, count in zip(sizes, counts):
            n = max(1, round(count * mult * scale)) if count else 0
            if max_size is not None and size > max_size:
                size = max_size
            specs.extend([(kind, size)] * n)

    if cat.type_mix == "train":
        add("train", TRAIN_SIZES, dist["train"])
    elif cat.type_mix == "inference":
        add("inference", INFER_SIZES, dist["infer"])
    else:
        add("train", TRAIN_SIZES, dist["train"], 0.5)
        add("inference", INFER_SIZES, dist["infer"], 0.5)

    rng.shuffle(specs)
    jobs: List[Job] = []
    t = 0.0
    for i, (kind, size) in enumerate(specs):
        bucket = rng.choice(("short", "medium", "long"), p=mix)
        lo, hi = DURATION_BUCKETS[bucket]
        duration = float(rng.uniform(lo, hi))
        choices = models_for(kind, size)
        model = str(rng.choice(choices)) if choices else "efficientnet-b2"
        batch = _pick_batch(model, kind, rng)
        t += float(rng.exponential(mean_interarrival))
        tenant = (f"t{i % n_tenants}" if n_tenants > 1
                  else DEFAULT_TENANT)
        jobs.append(Job(job_id=f"j{i:04d}", model=model, kind=kind,
                        size=size, batch=batch, base_duration=duration,
                        submit_time=t, tenant=tenant))
    return jobs


# ---------------------------------------------------------------------------
# fleet-scale synthetic traces (the bake-off's 10-100x host regime)
# ---------------------------------------------------------------------------

# fleet job-size mix: the Table-2 balanced train/infer distributions
# merged 50:50 (same mass the DEFAULT_FRAG_DEMAND scoring assumes)
FLEET_SIZES: Tuple[int, ...] = (1, 2, 4, 6, 8)
FLEET_SIZE_WEIGHTS: Tuple[float, ...] = (18.0, 18.0, 18.0, 4.0, 4.0)


def generate_fleet_trace(n_jobs: int, *, seed: int = 0,
                         mean_interarrival: float = 30.0,
                         pareto_alpha: float = 1.8,
                         n_tenants: int = 8,
                         max_size: Optional[int] = None,
                         duration_source: str = "philly") -> List[Job]:
    """A fleet-scale open-loop trace: ``n_jobs`` mixed train+serve jobs
    with heavy-tailed interarrivals and multi-tenant labels.

    Unlike :func:`generate_trace` (whose job counts are pinned to the
    paper's Table-2 category totals), this scales to millions of jobs:

    - **arrivals** are Pareto(``pareto_alpha``) interarrivals rescaled
      to ``mean_interarrival`` — heavy-tailed bursts, the regime where
      placement policy actually differentiates (exponential arrivals
      rarely build deep queues at fixed utilization);
    - **sizes** follow the Table-2 balanced train+infer mix
      (:data:`FLEET_SIZES`), folded down by ``max_size`` like the
      figure traces;
    - **kinds** alternate train/serve 50:50 (inference jobs keep the
      DM no-drain semantics, so the mix exercises both paths);
    - **tenants** are painted round-robin by arrival index exactly as
      :func:`generate_trace` does — zero extra rng draws.

    All draws are vectorized; generating 500k jobs takes seconds, not
    the minutes a per-job ``rng.choice`` loop costs.
    """
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if pareto_alpha <= 1.0:
        raise ValueError("pareto_alpha must be > 1 (finite mean)")
    rng = np.random.default_rng(seed)
    w = np.asarray(FLEET_SIZE_WEIGHTS) / sum(FLEET_SIZE_WEIGHTS)
    sizes = rng.choice(np.asarray(FLEET_SIZES), size=n_jobs, p=w)
    if max_size is not None:
        sizes = np.minimum(sizes, max_size)
    mix = np.asarray(DURATION_SOURCES[duration_source])
    buckets = rng.choice(3, size=n_jobs, p=mix)
    lows = np.asarray([DURATION_BUCKETS[b][0]
                       for b in ("short", "medium", "long")])
    highs = np.asarray([DURATION_BUCKETS[b][1]
                        for b in ("short", "medium", "long")])
    durations = rng.uniform(lows[buckets], highs[buckets])
    # Pareto(a) has mean a/(a-1) (for the numpy Lomax form, 1/(a-1));
    # rescale the empirical-mean-free analytic mean to the target
    inter = rng.pareto(pareto_alpha, size=n_jobs) * (
        mean_interarrival * (pareto_alpha - 1.0))
    arrivals = np.cumsum(inter)
    kinds = np.where(np.arange(n_jobs) % 2 == 0, "train", "inference")
    # model/batch pools per (kind, size): drawn by index so one
    # vectorized integer draw covers every job of the group
    jobs: List[Job] = [None] * n_jobs              # type: ignore
    idx = np.arange(n_jobs)
    for kind in ("train", "inference"):
        for size in sorted(set(int(s) for s in sizes)):
            sel = idx[(kinds == kind) & (sizes == size)]
            if not len(sel):
                continue
            pool = models_for(kind, size) or ["efficientnet-b2"]
            picks = rng.integers(len(pool), size=len(sel))
            batches = {m: _pick_batch(m, kind, rng) for m in pool}
            for i, p in zip(sel, picks):
                model = pool[p]
                jobs[i] = Job(
                    job_id=f"f{i:07d}", model=model, kind=kind,
                    size=int(sizes[i]), batch=batches[model],
                    base_duration=float(durations[i]),
                    submit_time=float(arrivals[i]),
                    tenant=(f"t{i % n_tenants}" if n_tenants > 1
                            else DEFAULT_TENANT))
    return jobs


# ---------------------------------------------------------------------------
# trace files (CSV) — the executable cluster runtime's input format
# ---------------------------------------------------------------------------

# required columns, in canonical order; ``tenant`` and ``priority_tier``
# are optional trailing columns (absent in every pre-multi-tenant trace
# file, whose rows keep parsing to byte-identical Jobs)
TRACE_COLUMNS = ("job_id", "model", "kind", "size", "batch",
                 "base_duration", "submit_time")
TRACE_OPTIONAL_COLUMNS = ("tenant", "priority_tier")


def parse_trace(text: str) -> List[Job]:
    """Parse a CSV trace (header + rows) into :class:`Job` records.

    The header must name every column in :data:`TRACE_COLUMNS` and may
    additionally name ``tenant`` / ``priority_tier``; rows without the
    optional columns get the single-tenant defaults, so loading an old
    trace file replays bit-identically.
    """
    import csv
    import io

    rows = list(csv.reader(io.StringIO(text)))
    rows = [r for r in rows if r and any(c.strip() for c in r)]
    if not rows:
        return []
    header = [c.strip() for c in rows[0]]
    missing = [c for c in TRACE_COLUMNS if c not in header]
    if missing:
        raise ValueError(f"trace header is missing columns {missing}; "
                         f"got {header}")
    unknown = [c for c in header
               if c not in TRACE_COLUMNS + TRACE_OPTIONAL_COLUMNS]
    if unknown:
        raise ValueError(f"trace header has unknown columns {unknown}")
    idx = {c: header.index(c) for c in header}
    jobs: List[Job] = []
    for lineno, row in enumerate(rows[1:], start=2):
        if len(row) != len(header):
            raise ValueError(
                f"trace line {lineno}: {len(row)} fields, header has "
                f"{len(header)}")

        def col(name, default=None):
            return row[idx[name]].strip() if name in idx else default

        jobs.append(Job(
            job_id=col("job_id"), model=col("model"), kind=col("kind"),
            size=int(col("size")), batch=int(col("batch")),
            base_duration=float(col("base_duration")),
            submit_time=float(col("submit_time")),
            tenant=col("tenant", DEFAULT_TENANT) or DEFAULT_TENANT,
            priority_tier=int(col("priority_tier", TIER_NORMAL)
                              or TIER_NORMAL)))
    return jobs


def load_trace(path: str) -> List[Job]:
    with open(path) as f:
        return parse_trace(f.read())


def trace_to_csv(jobs: List[Job], *,
                 include_tenancy: Optional[bool] = None) -> str:
    """Serialize jobs as a CSV trace (round-trips with
    :func:`parse_trace`).  ``include_tenancy=None`` auto-detects: the
    tenant/priority columns are written only when some job departs from
    the single-tenant defaults, so single-tenant traces keep the
    original column set."""
    if include_tenancy is None:
        include_tenancy = any(j.tenant != DEFAULT_TENANT
                              or j.priority_tier != TIER_NORMAL
                              for j in jobs)
    cols = TRACE_COLUMNS + (TRACE_OPTIONAL_COLUMNS if include_tenancy
                            else ())
    lines = [",".join(cols)]
    for j in jobs:
        row = [j.job_id, j.model, j.kind, str(j.size), str(j.batch),
               repr(j.base_duration), repr(j.submit_time)]
        if include_tenancy:
            row += [j.tenant, str(j.priority_tier)]
        lines.append(",".join(row))
    return "\n".join(lines) + "\n"
