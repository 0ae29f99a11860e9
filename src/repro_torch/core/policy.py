"""Flex-MIG instance-selection policy (§3.2) + fragmentation-aware
placement scoring (the online frag-aware MIG schedulers, arXiv
2512.16099 / 2511.18906).

Two Flex-MIG heuristics:
1. *Size-aware instance prioritization* — ``1g.10gb`` for size-1 jobs
   (10-30% JCT win), ``1g.5gb`` for size>=2 (sync caps at the slowest leaf,
   so the bigger-memory leaf is wasted there).
2. *Topology-aware placement* — round-robin leaves across physical GPUs of
   the host (uneven packing saturates a single GPU's PCIe interface, Fig 9).

Fragmentation-aware scoring (the bake-off challengers): score each
candidate placement by the idle-leaf *fragments it strands* against a
job-size demand distribution, and pick the minimum-fragmentation
feasible candidate.  Following the FGD-style measure both cited
schedulers build on, a host left with ``idle`` free leaves strands all
of them with respect to any demanded size ``s > idle`` (an ``s``-job
cannot use that host at all), so the host's fragmentation is the
demand-weighted expectation

    F(idle) = idle * P[demand size > idle]        (:func:`stranded_frag`)

— zero for an exact-fit placement (``idle == 0``) and monotone under
pointwise dominance of the per-size stranded counts.
:func:`frag_aware_choose_host` is the exact argmin of F over feasible
hosts; :func:`frag_aware_select_instances` applies the same idea at
leaf/GPU granularity (consume already-fragmented GPUs before breaking
pristine ones).

The cluster-runtime half (:mod:`repro_torch.cluster`) reuses the same
ideas at host granularity: :func:`cluster_placement` maps a job's
priority tier to a device-pool placement strategy (optionally the
frag-aware one), and :func:`defrag_victims` orders which running jobs a
fragmentation-driven repack may move.

The port's copy of ``repro/core/policy.py``: the same code, with the
port's imports.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.core.job import TIER_HIGH, Job
from repro_torch.core.leaves import Cluster, Instance

# Canonical job-size demand distribution for the fragmentation measure:
# Table-2 "balanced" train+infer mix (sizes 1..8 with the paper's
# balanced per-size job counts), normalized.  Callers may pass their own
# ``demand`` (e.g. measured from the live queue); every scoring function
# threads it through.
DEFAULT_FRAG_DEMAND: Tuple[Tuple[int, float], ...] = (
    (1, 18 / 62), (2, 18 / 62), (4, 18 / 62), (6, 4 / 62), (8, 4 / 62))


def size_aware_priority(size: int) -> List[str]:
    """Preferred instance types, best first."""
    if size == 1:
        return ["1g.10gb", "1g.5gb"]
    return ["1g.5gb", "1g.10gb"]


def select_instances(cluster: Cluster, host: int, size: int,
                     *, round_robin: bool = True) -> Optional[List[Instance]]:
    """Pick ``size`` idle leaves on ``host`` under the §3.2 policy.

    Returns None if the host lacks idle leaves.  ``round_robin=False``
    reproduces the naive pack-one-GPU-first policy (Fig. 9 ablation).
    """
    prefs = size_aware_priority(size)
    # idle leaves per gpu, preferred types first within a gpu
    per_gpu: List[List[Instance]] = []
    for gpu in cluster.host_gpus(host):
        idle = [i for i in gpu.instances if not i.busy
                and i.profile in prefs]
        idle.sort(key=lambda i: prefs.index(i.profile))
        per_gpu.append(idle)

    total_idle = sum(len(g) for g in per_gpu)
    if total_idle < size:
        return None

    chosen: List[Instance] = []
    if round_robin:
        # breadth-first across GPUs -> most even leaves_per_gpu split
        cursors = [0] * len(per_gpu)
        while len(chosen) < size:
            progressed = False
            for g, idle in enumerate(per_gpu):
                if len(chosen) == size:
                    break
                if cursors[g] < len(idle):
                    chosen.append(idle[cursors[g]])
                    cursors[g] += 1
                    progressed = True
            if not progressed:
                return None
        if size == 1:
            # size-aware prioritization dominates placement for size 1
            all_idle = [i for g in per_gpu for i in g]
            all_idle.sort(key=lambda i: prefs.index(i.profile))
            chosen = [all_idle[0]]
    else:
        for idle in per_gpu:
            for inst in idle:
                if len(chosen) == size:
                    break
                chosen.append(inst)
    return chosen if len(chosen) == size else None


def choose_host(cluster: Cluster, size: int) -> Optional[int]:
    """Pick the host with the most idle leaves that can fit the job.

    Tie-breaking is explicitly deterministic: among hosts with equal
    idle-leaf counts the LOWEST host id wins (strict ``>`` keeps the
    first maximum).  The golden bake-off tables key on this ordering —
    changing it silently re-keys every (policy, trace) row.

    Uses the cluster's O(hosts) cached idle counts; the old per-host
    ``idle_instances`` scan was O(hosts^2 x leaves) per placement
    attempt, the second-largest superlinear term on fleet traces.
    """
    best, best_idle = None, -1
    for h, idle in enumerate(cluster.idle_leaf_counts()):
        if idle >= size and idle > best_idle:
            best, best_idle = h, idle
    return best


# ---------------------------------------------------------------------------
# fragmentation-aware scoring (arXiv 2512.16099 / 2511.18906 bake-off)
# ---------------------------------------------------------------------------

def stranded_frag(idle: int,
                  demand: Sequence[Tuple[int, float]] = DEFAULT_FRAG_DEMAND
                  ) -> float:
    """Demand-weighted stranded idle leaves of a host left with ``idle``
    free leaves: ``idle * P[demand size > idle]``.

    Per demanded size ``s``, all ``idle`` leaves are stranded when
    ``idle < s`` (an ``s``-job cannot run there), none otherwise; the
    score is the demand-probability-weighted sum of those per-size
    stranded counts.  Zero at ``idle == 0`` (exact fit) and monotone
    under pointwise dominance: if placement A strands at least as many
    leaves as B for every demanded size, ``F(A) >= F(B)``.
    """
    if idle < 0:
        raise ValueError(f"idle leaf count must be >= 0, got {idle}")
    return idle * sum(p for s, p in demand if idle < s)


def frag_score_host(cluster: Cluster, host: int, size: int,
                    demand: Sequence[Tuple[int, float]]
                    = DEFAULT_FRAG_DEMAND) -> float:
    """Fragmentation the candidate assignment (``size`` leaves on
    ``host``) would strand: the host's post-placement F(idle)."""
    return stranded_frag(cluster.idle_leaf_count(host) - size, demand)


def cluster_frag(cluster: Cluster,
                 demand: Sequence[Tuple[int, float]] = DEFAULT_FRAG_DEMAND
                 ) -> float:
    """Total stranded fragmentation across hosts (the simulator's
    frag-integral metric samples this)."""
    return sum(stranded_frag(idle, demand)
               for idle in cluster.idle_leaf_counts())


def frag_aware_choose_host(cluster: Cluster, size: int,
                           demand: Sequence[Tuple[int, float]]
                           = DEFAULT_FRAG_DEMAND) -> Optional[int]:
    """Minimum-fragmentation feasible host: the exact argmin of
    post-placement F over hosts with ``idle >= size``.

    Deterministic tie-breaking, in order: (1) lowest post-placement
    fragmentation; (2) fewest leftover idle leaves (tightest fit — two
    idle counts can score identically, e.g. both above the largest
    demanded size); (3) lowest host id.  Documented because the golden
    tables bake this ordering in.
    """
    best: Optional[int] = None
    best_key: Optional[Tuple[float, int]] = None
    for h, idle in enumerate(cluster.idle_leaf_counts()):
        if idle < size:
            continue
        key = (stranded_frag(idle - size, demand), idle - size)
        if best_key is None or key < best_key:
            best, best_key = h, key
    return best


def frag_aware_select_instances(cluster: Cluster, host: int, size: int
                                ) -> Optional[List[Instance]]:
    """Leaf-granularity fragmentation-aware selection on ``host``.

    GPU-level analogue of the host score: idle leaves on a *partially
    busy* GPU are stranded fragments (they can never again be part of a
    whole-GPU block), so the policy consumes already-fragmented GPUs
    first — ascending idle count (tightest fit first), pristine
    fully-idle GPUs last, lowest gpu id on ties — leaving as many
    pristine GPUs intact as the job size allows.  Within a GPU, leaves
    follow the same size-aware profile preference as the default
    policy.  Returns None if the host lacks idle leaves.
    """
    prefs = size_aware_priority(size)
    gpus = []
    for gpu in cluster.host_gpus(host):
        idle = [i for i in gpu.instances if not i.busy
                and i.profile in prefs]
        idle.sort(key=lambda i: prefs.index(i.profile))
        if idle:
            gpus.append((bool(gpu.has_running_jobs()), len(idle),
                         gpu.gpu_id, idle))
    if sum(g[1] for g in gpus) < size:
        return None
    # fragmented (partially busy) GPUs first, tightest first, id-stable
    gpus.sort(key=lambda g: (not g[0], g[1], g[2]))
    chosen: List[Instance] = []
    for _, _, _, idle in gpus:
        for inst in idle:
            if len(chosen) == size:
                return chosen
            chosen.append(inst)
    return chosen if len(chosen) == size else None


# ---------------------------------------------------------------------------
# cluster-runtime placement policy (host-level analogue of the above)
# ---------------------------------------------------------------------------

def cluster_placement(priority_tier: int, size: int,
                      devices_per_host: int, *,
                      frag_aware: bool = False
                      ) -> Tuple[str, Optional[int]]:
    """Device-pool placement for one cluster job: ``(strategy,
    required host span)``.

    - Tier-0 (high/SLA) jobs that fit on one host are *pinned* to a
      single host (span 1): single-host transport is the latency tier
      they pay for, so a cross-host placement is not an acceptable
      fallback — they queue (and force a defrag repack) instead.
      Frag-aware mode keeps the pin but scores WHICH host by stranded
      fragments (``frag_aware`` strategy at span 1).
    - Everyone else spreads round-robin across hosts (the Fig.-9
      balanced default: widest equal per-host split) — or, frag-aware,
      takes the minimum-stranding feasible span/host combination
      (:meth:`repro_torch.cluster.pool.DevicePool.plan` scoring).
    """
    if priority_tier == TIER_HIGH and size <= devices_per_host:
        return ("frag_aware" if frag_aware else "packed"), 1
    if frag_aware:
        return "frag_aware", None
    return "round_robin", None


def defrag_victims(running: Sequence[Job], requester: Job) -> List[Job]:
    """Which running jobs a defrag repack may move to admit
    ``requester``, best victim first.

    Only jobs at the requester's priority tier or below are movable (a
    repack must never perturb a *higher*-priority tenant on behalf of a
    lower one); among those, lowest priority first, then smallest state
    (size) — the cheapest checkpoint/restore cycle.

    Tie-breaking is explicitly deterministic: the sort is stable and
    keyed only on ``(-priority_tier, size)``, so jobs with equal keys
    keep the exact order of the ``running`` sequence the caller passed.
    The cluster runtime passes its insertion-ordered running ledger
    (admission order), which is itself deterministic — NOT an arbitrary
    set/dict order.  Golden tables and the repack tests pin this: a
    final ``job_id`` tie-break would look safer but would silently
    re-order equal victims admitted under non-lexicographic ids.
    """
    eligible = [j for j in running
                if j.priority_tier >= requester.priority_tier]
    return sorted(eligible, key=lambda j: (-j.priority_tier, j.size))
