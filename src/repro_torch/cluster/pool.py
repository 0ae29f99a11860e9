"""Shared device-pool ledger for the multi-tenant cluster runtime.

One :class:`DevicePool` owns the cluster's host devices — ``n_hosts
× devices_per_host`` global device ids, host ``h`` holding the
contiguous block ``[h*dph, (h+1)*dph)`` — and the ledger of which
*disjoint* subset each running job occupies.  Placement is
geometry-constrained by the bitwise elastic invariant: a job of width
``size`` runs an SPMD mesh of shape ``(span, size // span)`` — one mesh
row per spanned host, equal device counts per host — so every placement
the pool plans is a valid (pod, data) factorization the
:class:`~repro_torch.elastic_driver.ElasticDriver` can hand off between.

Two strategies mirror :func:`repro_torch.core.policy.cluster_placement`:

- ``round_robin`` spreads across as many hosts as possible (widest
  equal split — the paper's Fig.-9 balanced default), onto the
  emptiest hosts first;
- ``packed`` minimizes host span (fills the fullest hosts first), the
  shape defrag repacks squeeze victims into and the single-host SLA
  tier requires (``require_span=1``);
- ``frag_aware`` scores every feasible (span, host set) by the
  demand-weighted stranded-fragment measure
  (:func:`repro_torch.core.policy.stranded_frag`) summed over the touched
  hosts' post-placement free counts, and takes the minimum — the
  host-granularity analogue of the leaf-level frag-aware placement.

The pool also answers the two scheduling questions that drive repacks:
:meth:`fragmented_for` — is a job blocked *only* by fragmentation (free
capacity exists but no valid placement)? — and :meth:`defrag_plan` —
which single victim, re-placed packed, admits it?

The port's copy of ``repro/cluster/pool.py``: the same code, with the
port's imports.  In the port a pool device is one gloo rank of a job's
segment; the ranks of every job share the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policy import DEFAULT_FRAG_DEMAND, stranded_frag


@dataclasses.dataclass(frozen=True)
class Allocation:
    """One job's slice of the pool: global device ids + mesh shape."""
    job_id: str
    devices: Tuple[int, ...]          # sorted global device ids
    shape: Tuple[int, int]            # (pod = hosts spanned, data = per host)

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class DefragMove:
    """Defrag plan: move ``victim`` to ``victim_to`` so ``requester``
    (currently blocked by fragmentation) fits at ``requester_to``."""
    victim: str
    victim_to: Allocation
    requester: str
    requester_to: Allocation


class PoolError(ValueError):
    pass


class DevicePool:
    def __init__(self, n_hosts: int, devices_per_host: int):
        if n_hosts < 1 or devices_per_host < 1:
            raise PoolError("pool needs at least one host and one device")
        self.n_hosts = n_hosts
        self.devices_per_host = devices_per_host
        self.allocs: Dict[str, Allocation] = {}

    # ------------------------------------------------------------ geometry
    @property
    def n_devices(self) -> int:
        return self.n_hosts * self.devices_per_host

    def host_of(self, dev: int) -> int:
        if not 0 <= dev < self.n_devices:
            raise PoolError(f"device {dev} outside pool of "
                            f"{self.n_devices}")
        return dev // self.devices_per_host

    def free_by_host(self,
                     exclude: Sequence[str] = ()) -> List[List[int]]:
        """Free device ids per host; ``exclude`` treats those jobs'
        devices as free (hypothetical planning: the excluded job is the
        one about to move)."""
        used = set()
        for jid, a in self.allocs.items():
            if jid in exclude:
                continue
            used.update(a.devices)
        return [[d for d in range(h * self.devices_per_host,
                                  (h + 1) * self.devices_per_host)
                 if d not in used]
                for h in range(self.n_hosts)]

    def total_free(self, exclude: Sequence[str] = ()) -> int:
        return sum(len(f) for f in self.free_by_host(exclude))

    # ------------------------------------------------------------ planning
    def _spans(self, size: int, strategy: str) -> List[int]:
        spans = [s for s in range(1, self.n_hosts + 1)
                 if size % s == 0 and size // s <= self.devices_per_host]
        if strategy == "round_robin":
            return sorted(spans, reverse=True)       # widest split first
        return spans                                 # packed/frag: narrow

    def _plan_frag_aware(self, size: int, require_span: Optional[int],
                         free: List[List[int]]
                         ) -> Optional[Tuple[Tuple[int, ...],
                                             Tuple[int, int]]]:
        """Exact argmin of post-placement stranded fragmentation.

        Per-host fragmentation is independent, so for a fixed span the
        optimal host set picks the ``span`` hosts with the smallest
        fragmentation *delta* ``F(free - per) - F(free)``; spans then
        compare by total delta (untouched hosts contribute zero).
        Deterministic tie-breaks: per host ``(delta, leftover free,
        host id)``; across spans lowest total delta wins, ties to the
        NARROWEST span (fewest hosts perturbed — the consolidation-
        leaning choice, matching defrag's packed bias).
        """
        best = None          # (total_delta, span, hosts, per)
        for span in self._spans(size, "frag_aware"):
            if require_span is not None and span != require_span:
                continue
            per = size // span
            scored = []
            for h in range(self.n_hosts):
                if len(free[h]) < per:
                    continue
                left = len(free[h]) - per
                delta = (stranded_frag(left, DEFAULT_FRAG_DEMAND)
                         - stranded_frag(len(free[h]),
                                         DEFAULT_FRAG_DEMAND))
                scored.append((delta, left, h))
            if len(scored) < span:
                continue
            scored.sort()
            take = scored[:span]
            total = sum(s[0] for s in take)
            hosts = sorted(s[2] for s in take)
            if best is None or total < best[0]:
                best = (total, span, hosts, per)
        if best is None:
            return None
        _, span, hosts, per = best
        devices = tuple(sorted(d for h in hosts for d in free[h][:per]))
        return devices, (span, per)

    def plan(self, size: int, *, strategy: str = "round_robin",
             require_span: Optional[int] = None,
             free: Optional[List[List[int]]] = None
             ) -> Optional[Tuple[Tuple[int, ...], Tuple[int, int]]]:
        """Find ``(devices, shape)`` for a job of width ``size``, or
        None.  Deterministic: host choice is by free-count then index
        (emptiest-first for ``round_robin``, fullest-first for
        ``packed``), devices lowest-id-first within a host."""
        if strategy not in ("round_robin", "packed", "frag_aware"):
            raise PoolError(f"unknown placement strategy {strategy!r}")
        if size < 1:
            raise PoolError(f"job width must be >= 1, got {size}")
        if free is None:
            free = self.free_by_host()
        if strategy == "frag_aware":
            return self._plan_frag_aware(size, require_span, free)
        for span in self._spans(size, strategy):
            if require_span is not None and span != require_span:
                continue
            per = size // span
            hosts = [h for h in range(self.n_hosts)
                     if len(free[h]) >= per]
            if len(hosts) < span:
                continue
            if strategy == "round_robin":
                hosts.sort(key=lambda h: (-len(free[h]), h))
            else:
                hosts.sort(key=lambda h: (len(free[h]), h))
            chosen = sorted(hosts[:span])
            devices = tuple(sorted(
                d for h in chosen for d in free[h][:per]))
            return devices, (span, per)
        return None

    def fragmented_for(self, size: int, *,
                       strategy: str = "round_robin",
                       require_span: Optional[int] = None) -> bool:
        """True iff the job is blocked by *fragmentation*: enough total
        free devices exist, but no valid placement does."""
        if self.total_free() < size:
            return False
        return self.plan(size, strategy=strategy,
                         require_span=require_span) is None

    def defrag_plan(self, requester_id: str, size: int, *,
                    require_span: Optional[int],
                    victims: Sequence[str]) -> Optional[DefragMove]:
        """Admit a fragmentation-blocked job by moving ONE victim.

        For each candidate victim (policy-ordered by the caller, see
        :func:`repro_torch.core.policy.defrag_victims`): hypothetically free
        its devices, re-place it *packed* (minimum span — defrag exists
        to consolidate), and check the requester then fits under its own
        constraints on what remains.  First victim that works wins;
        None if no single move suffices.
        """
        for vid in victims:
            alloc = self.allocs.get(vid)
            if alloc is None:
                continue
            free = self.free_by_host(exclude=(vid,))
            new_v = self.plan(alloc.size, strategy="packed", free=free)
            if new_v is None:
                continue
            v_devices, v_shape = new_v
            remaining = [[d for d in f if d not in v_devices]
                         for f in free]
            placed = self.plan(size, strategy="packed" if require_span
                               else "round_robin",
                               require_span=require_span, free=remaining)
            if placed is None:
                continue
            r_devices, r_shape = placed
            return DefragMove(
                victim=vid,
                victim_to=Allocation(vid, v_devices, v_shape),
                requester=requester_id,
                requester_to=Allocation(requester_id, r_devices,
                                        r_shape))
        return None

    # ------------------------------------------------------------- ledger
    def _validate(self, job_id: str, devices: Tuple[int, ...],
                  shape: Tuple[int, int], *,
                  ignore: Sequence[str] = ()) -> None:
        devices = tuple(sorted(devices))
        if len(set(devices)) != len(devices):
            raise PoolError(f"{job_id}: duplicate devices {devices}")
        for d in devices:
            self.host_of(d)                      # range check
        for jid, a in self.allocs.items():
            if jid in ignore or jid == job_id:
                continue
            clash = set(devices) & set(a.devices)
            if clash:
                raise PoolError(
                    f"{job_id}: devices {sorted(clash)} already held "
                    f"by {jid}")
        span, per = shape
        if span * per != len(devices):
            raise PoolError(f"{job_id}: shape {shape} does not "
                            f"factor {len(devices)} devices")
        by_host: Dict[int, int] = {}
        for d in devices:
            by_host[self.host_of(d)] = by_host.get(self.host_of(d),
                                                   0) + 1
        if len(by_host) != span or set(by_host.values()) != {per}:
            raise PoolError(
                f"{job_id}: devices {devices} do not form an equal "
                f"{per}-per-host split over {span} hosts (got "
                f"{by_host})")

    def allocate(self, job_id: str, devices: Sequence[int],
                 shape: Tuple[int, int]) -> Allocation:
        if job_id in self.allocs:
            raise PoolError(f"{job_id} already allocated")
        devices = tuple(sorted(devices))
        self._validate(job_id, devices, tuple(shape))
        a = Allocation(job_id, devices, tuple(shape))
        self.allocs[job_id] = a
        return a

    def release(self, job_id: str) -> Allocation:
        try:
            return self.allocs.pop(job_id)
        except KeyError:
            raise PoolError(f"{job_id} holds no allocation")

    def reassign(self, job_id: str, devices: Sequence[int],
                 shape: Tuple[int, int]) -> Allocation:
        """Atomically move a job to a new placement (repack)."""
        if job_id not in self.allocs:
            raise PoolError(f"{job_id} holds no allocation to move")
        devices = tuple(sorted(devices))
        self._validate(job_id, devices, tuple(shape),
                       ignore=(job_id,))
        a = Allocation(job_id, devices, tuple(shape))
        self.allocs[job_id] = a
        return a
