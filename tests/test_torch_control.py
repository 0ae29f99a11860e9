"""The port's control plane (``repro_torch.core``, ``repro_torch.cluster``'s
pool) against the JAX package's, on the CPU, bitwise.

Two layers:

- the reference's own unit cases of these modules
  (``tests/test_scheduler.py``, ``test_jct_model.py``,
  ``test_trace_parse.py``, ``test_profiles.py``, ``test_cluster_pool.py``
  and ``test_policy_frag.py``), each run as written against both
  packages: the file's source is executed once with its imports as they
  are and once with ``repro.core.*`` and ``repro.cluster`` read as
  ``repro_torch``'s (``tests/_torch_reference.py::reference_cases``);
- the same inputs through both packages, the outputs compared exactly:
  every trace category at several seeds, CSV traces with and without the
  tenancy columns, scheduler decisions on generated queues with quotas,
  placement, fragmentation and defrag choices on generated pool states,
  MIG layouts, and the JCT model's predictions.

These modules are arithmetic and numpy RNG calls only, so no tolerance
applies: floats are compared with ``==`` (and by ``repr``, which tells
-0.0 from 0.0).
"""
import dataclasses
import itertools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.cluster import pool as jpool
from repro.core import jct_model as jjct
from repro.core import job as jjob
from repro.core import leaves as jleaves
from repro.core import policy as jpolicy
from repro.core import profiles as jprofiles
from repro.core import scheduler as jsched
from repro.core import traces as jtraces
from repro_torch.cluster import pool as tpool
from repro_torch.core import jct_model as tjct
from repro_torch.core import job as tjob
from repro_torch.core import leaves as tleaves
from repro_torch.core import modes as tmodes
from repro_torch.core import policy as tpolicy
from repro_torch.core import profiles as tprofiles
from repro_torch.core import scheduler as tsched
from repro_torch.core import traces as ttraces
from tests._torch_reference import PACKAGES, reference_cases, run_case

# the reference's files of these modules
REFERENCE_FILES = ("test_scheduler", "test_jct_model", "test_trace_parse",
                   "test_profiles", "test_cluster_pool", "test_policy_frag")
NOT_PORTED_CASES = set()
_MODULES = {(n, p): reference_cases(n, p)
            for n in REFERENCE_FILES for p in PACKAGES}
CASES = [(n, c) for n in REFERENCE_FILES
         for c in sorted(vars(_MODULES[(n, "repro")]))
         if c.startswith("test_") and c not in NOT_PORTED_CASES]


def test_reference_files_have_their_cases():
    counts = {n: sum(1 for m, _ in CASES if m == n)
              for n in REFERENCE_FILES}
    assert counts == {"test_scheduler": 12, "test_jct_model": 20,
                      "test_trace_parse": 6, "test_profiles": 8,
                      "test_cluster_pool": 16, "test_policy_frag": 20}
    # the port's run reads the port's modules, the reference's its own
    port = _MODULES[("test_cluster_pool", "repro_torch")]
    assert port.DevicePool is tpool.DevicePool
    assert _MODULES[("test_profiles", "repro_torch")].P is tprofiles
    assert _MODULES[("test_policy_frag", "repro_torch")].FlexMIG \
        is tmodes.FlexMIG
    assert _MODULES[("test_scheduler", "repro")].Scheduler \
        is jsched.Scheduler


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{n}::{c}" for n, c in CASES])
def test_reference_case(name, case, package, tmp_path):
    run_case(_MODULES[(name, package)], case, tmp_path)


# ------------------------------------------------------------- helpers

def _rows(jobs):
    """Jobs as comparable rows (floats by repr)."""
    return [repr(dataclasses.astuple(j)) for j in jobs]


def _out(fn, *args, **kw):
    """fn's value, or the error it raised, as a comparable row."""
    try:
        return ("ok", repr(fn(*args, **kw)))
    except Exception as e:             # noqa: BLE001 — compared by caller
        return (type(e).__name__, str(e))


# -------------------------------------------------------------- traces

@pytest.mark.parametrize("cat", jtraces.ALL_CATEGORIES,
                         ids=[c.name for c in jtraces.ALL_CATEGORIES])
def test_generate_trace_matches_reference(cat):
    tcat = ttraces.TraceCategory(cat.duration_source, cat.size_dist,
                                 cat.type_mix)
    assert tcat.name == cat.name
    for seed, kw in itertools.product(
            (0, 1, 7), ({}, dict(double=True), dict(max_size=4),
                        dict(n_tenants=3, mean_interarrival=12.5))):
        ref = jtraces.generate_trace(cat, seed=seed, **kw)
        got = ttraces.generate_trace(tcat, seed=seed, **kw)
        assert ref and _rows(got) == _rows(ref), (cat.name, seed, kw)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_generate_fleet_trace_matches_reference(seed):
    for kw in ({}, dict(n_tenants=1, max_size=4, pareto_alpha=1.2),
               dict(duration_source="alibaba", mean_interarrival=5.0)):
        ref = jtraces.generate_fleet_trace(200, seed=seed, **kw)
        got = ttraces.generate_fleet_trace(200, seed=seed, **kw)
        assert _rows(got) == _rows(ref), (seed, kw)


@pytest.mark.parametrize("tenancy", [False, True],
                         ids=["legacy_columns", "tenant_columns"])
def test_load_trace_matches_reference(tmp_path, tenancy):
    cat = jtraces.TraceCategory("philly", "balanced", "mixed")
    jobs = jtraces.generate_trace(cat, seed=5,
                                  n_tenants=3 if tenancy else 1)
    if tenancy:
        jobs[0].priority_tier = jjob.TIER_HIGH
    text = jtraces.trace_to_csv(jobs)
    assert ("tenant" in text.splitlines()[0]) == tenancy
    path = tmp_path / "trace.csv"
    path.write_text(text)
    ref = jtraces.load_trace(str(path))
    got = ttraces.load_trace(str(path))
    assert _rows(got) == _rows(ref)
    assert ttraces.trace_to_csv(got) == text
    assert ttraces.trace_to_csv(got, include_tenancy=True) == \
        jtraces.trace_to_csv(ref, include_tenancy=True)


@pytest.mark.parametrize("text", [
    "job_id,model\na,b\n",
    "job_id,model,kind,size,batch,base_duration,submit_time\n"
    "a,bert-large,train,x,32,1.0,0.0\n",
    "", "job_id,model,kind,size,batch,base_duration,submit_time,tenant\n"
    "a,bert-large,train,4,32,1.0,0.0\n"], ids=["columns", "int", "empty",
                                               "short_row"])
def test_parse_trace_errors_match_reference(text):
    def parse(mod):
        return _out(lambda: _rows(mod.parse_trace(text)))
    assert parse(ttraces) == parse(jtraces)


# ----------------------------------------------------------- scheduler

_JOB_SPECS = st.lists(
    st.tuples(st.sampled_from([1, 2, 4, 6, 8]),
              st.sampled_from([jjob.TIER_HIGH, jjob.TIER_NORMAL, 2]),
              st.sampled_from(["acme", "beta", "gamma"])),
    min_size=0, max_size=24)


def _jobs(mod, specs):
    return [mod.Job(job_id=f"j{i}", model="m", kind="train", size=size,
                    batch=8, base_duration=float(i + 1), tenant=tenant,
                    priority_tier=tier)
            for i, (size, tier, tenant) in enumerate(specs)]


@settings(max_examples=60, deadline=None)
@given(specs=_JOB_SPECS, policy=st.sampled_from(["fifo", "backfill"]),
       depth=st.integers(min_value=1, max_value=16),
       quota=st.sampled_from([None, {"beta": 4}, {"acme": 2, "beta": 8}]),
       used=st.tuples(st.integers(0, 8), st.integers(0, 8)),
       removed=st.integers(min_value=0, max_value=3))
def test_scheduler_decisions_match_reference(specs, policy, depth, quota,
                                             used, removed):
    usage = {"acme": used[0], "beta": used[1]}
    out = []
    for mod, sched in ((jjob, jsched), (tjob, tsched)):
        jobs = _jobs(mod, specs)
        q = sched.WaitQueue()
        for j in jobs:
            q.push(j)
        for j in jobs[:removed]:
            q.remove(j)
        s = sched.Scheduler(policy, depth=depth, quotas=quota)
        out.append((
            [j.job_id for j in s.candidates(q)],
            [j.job_id for j in s.candidates(q, usage=usage)],
            [j.job_id for j in q.head(depth)], q.has_special_tiers, len(q),
            [s.admissible(j, usage) for j in jobs]))
    assert out[1] == out[0]


# ----------------------------------------------------- pool and policy

def _pool_state(mod, n_hosts, dph, fills):
    """A pool with jobs placed in order (strategy per job) until one does
    not fit: the same calls on either package's pool."""
    pool = mod.DevicePool(n_hosts, dph)
    for i, (size, strategy) in enumerate(fills):
        placed = pool.plan(size, strategy=strategy)
        if placed is not None:
            pool.allocate(f"f{i}", *placed)
    return pool


_FILLS = st.lists(st.tuples(st.sampled_from([1, 2, 3, 4, 6, 8]),
                            st.sampled_from(["round_robin", "packed",
                                             "frag_aware"])),
                  max_size=8)


@settings(max_examples=60, deadline=None)
@given(n_hosts=st.integers(1, 4), dph=st.sampled_from([2, 4, 8]),
       fills=_FILLS, release=st.integers(0, 3))
def test_pool_choices_match_reference(n_hosts, dph, fills, release):
    out = []
    for mod in (jpool, tpool):
        pool = _pool_state(mod, n_hosts, dph, fills)
        for jid in sorted(pool.allocs)[:release]:
            pool.release(jid)
        rows = [sorted((k, a.devices, a.shape)
                       for k, a in pool.allocs.items()),
                pool.free_by_host(), pool.total_free()]
        for size in (1, 2, 3, 4, 6, 8):
            for strategy, span in itertools.product(
                    ("round_robin", "packed", "frag_aware"),
                    (None, 1, 2)):
                rows.append((pool.plan(size, strategy=strategy,
                                       require_span=span),
                             pool.fragmented_for(size, strategy=strategy,
                                                 require_span=span)))
            for span in (None, 1):
                mv = pool.defrag_plan("req", size, require_span=span,
                                      victims=sorted(pool.allocs))
                rows.append(None if mv is None else (
                    mv.victim, mv.victim_to.devices, mv.victim_to.shape,
                    mv.requester_to.devices, mv.requester_to.shape))
        out.append(repr(rows))
    assert out[1] == out[0]


@pytest.mark.parametrize("dph", [2, 4, 8])
def test_cluster_placement_and_stranded_frag_match_reference(dph):
    for tier, size, fa in itertools.product(
            (jjob.TIER_HIGH, jjob.TIER_NORMAL, 2), range(1, 17),
            (False, True)):
        assert tpolicy.cluster_placement(tier, size, dph, frag_aware=fa) \
            == jpolicy.cluster_placement(tier, size, dph, frag_aware=fa)
    assert tpolicy.DEFAULT_FRAG_DEMAND == jpolicy.DEFAULT_FRAG_DEMAND
    demands = (None, ((1, 0.5), (2, 0.25), (8, 0.25)), ((3, 1.0),))
    for idle, demand in itertools.product(range(0, 4 * dph + 1), demands):
        kw = {} if demand is None else {"demand": demand}
        a = tpolicy.stranded_frag(idle, **kw)
        b = jpolicy.stranded_frag(idle, **kw)
        assert repr(a) == repr(b), (idle, demand)


@settings(max_examples=60, deadline=None)
@given(specs=_JOB_SPECS, req=st.tuples(
    st.sampled_from([1, 2, 4, 8]),
    st.sampled_from([jjob.TIER_HIGH, jjob.TIER_NORMAL, 2])))
def test_defrag_victims_match_reference(specs, req):
    out = []
    for mod, pol in ((jjob, jpolicy), (tjob, tpolicy)):
        requester = mod.Job(job_id="req", model="m", kind="train",
                            size=req[0], batch=8, base_duration=1.0,
                            priority_tier=req[1])
        out.append([j.job_id for j in pol.defrag_victims(
            _jobs(mod, specs), requester)])
    assert out[1] == out[0]


def _flex_cluster(mod, n_hosts, busy, jid="b"):
    c = mod.Cluster(n_hosts=n_hosts, gpus_per_host=2)
    c.partition_all(
        (tprofiles if mod is tleaves else jprofiles).FLEXMIG_PARTITION)
    for h, n in enumerate(busy):
        idle = [i for g in c.host_gpus(h) for i in g.instances
                if not i.busy][:n]
        for k, inst in enumerate(idle):
            c.mark_busy(inst, f"{jid}-{h}-{k}")
    return c


def _instances(insts):
    return None if insts is None else [
        (i.uuid, i.profile, i.gpu_id, i.host_id, sorted(i.slices),
         i.mem_slices, i.job_id) for i in insts]


@settings(max_examples=40, deadline=None)
@given(busy=st.lists(st.integers(0, 14), min_size=1, max_size=4),
       size=st.integers(1, 16))
def test_host_and_instance_selection_matches_reference(busy, size):
    out = []
    for leaves, pol in ((jleaves, jpolicy), (tleaves, tpolicy)):
        c = _flex_cluster(leaves, len(busy), busy)
        row = [_out(pol.choose_host, c, size),
               _out(pol.frag_aware_choose_host, c, size),
               repr(pol.cluster_frag(c)), c.idle_leaf_counts(),
               c.idle_sm_slices(), c.free_compute_total(),
               pol.size_aware_priority(size)]
        for h in range(len(busy)):
            row += [_out(lambda: _instances(pol.select_instances(c, h,
                                                                 size))),
                    _out(lambda: _instances(pol.select_instances(
                        c, h, size, round_robin=False))),
                    _out(lambda: _instances(
                        pol.frag_aware_select_instances(c, h, size))),
                    _out(pol.frag_score_host, c, h, size)]
        out.append(row)
    assert out[1] == out[0]


# ------------------------------------------------------------- layouts

_PARTITIONS = [
    jprofiles.FLEXMIG_PARTITION, jprofiles.STATIC_PARTITION,
    ("7g.40gb",), ("4g.20gb", "3g.20gb"), ("3g.20gb", "3g.20gb"),
    ("2g.10gb",) * 3 + ("1g.10gb",), ("1g.5gb",) * 7,
    ("1g.5gb",) * 8, ("4g.20gb", "4g.20gb"), ("1g.10gb",) * 4,
    ("2g.10gb", "1g.5gb", "4g.20gb"), ("3g.20gb", "2g.10gb", "1g.5gb")]


def test_profiles_match_reference():
    assert tprofiles.PROFILES == {k: tprofiles.Profile(*dataclasses.astuple(v))
                                  for k, v in jprofiles.PROFILES.items()}
    for name in ("N_COMPUTE_SLICES", "N_MEMORY_SLICES", "MEMORY_PER_SLICE_GB",
                 "FLEXMIG_PARTITION", "STATIC_PARTITION", "SIZE_TO_PROFILE"):
        assert getattr(tprofiles, name) == getattr(jprofiles, name), name
    for size in range(1, 9):
        assert tprofiles.round_up_profile(size) == \
            jprofiles.round_up_profile(size)
        assert tprofiles.overprovision_slices(size) == \
            jprofiles.overprovision_slices(size)
    for a, b in itertools.product(range(7), repeat=2):
        assert tprofiles.mergeable(a, b) == jprofiles.mergeable(a, b)


@pytest.mark.parametrize("profs", _PARTITIONS,
                         ids=["+".join(p) for p in _PARTITIONS])
def test_layouts_match_reference(profs):
    def layout(mod):
        lay = mod._layout(profs)
        return (None if lay is None else [sorted(s) for s in lay],
                mod._layout_feasible(profs))
    assert layout(tleaves) == layout(jleaves)


def _gpu_rows(gpu):
    return (gpu.host_id, gpu.gpu_id, gpu.pcie_bus_id,
            _instances(gpu.instances), sorted(gpu.used_slices()),
            gpu.used_mem_slices(), gpu.free_compute_slices(),
            gpu.free_mem_slices(), gpu.has_running_jobs(),
            gpu.running_jobs())


@pytest.mark.parametrize("profs", _PARTITIONS[:6],
                         ids=["+".join(p) for p in _PARTITIONS[:6]])
def test_gpu_state_and_cluster_match_reference(profs):
    out = []
    for mod in (jleaves, tleaves):
        rows = []
        g = mod.GPUState(host_id=0, gpu_id=1)
        for k, p in enumerate(profs):
            if g.valid_placement(p) is not None:
                g.create_instance(p, f"u{k}")
        rows.append(_gpu_rows(g))
        if g.instances:
            g.instances[0].job_id = "run"
        for p in sorted(jprofiles.PROFILES):
            placement = g.valid_placement(p)
            rows.append((p, None if placement is None else sorted(placement),
                         g.could_fit_after_repartition(p)))
            if g.could_fit_after_repartition(p):
                g2 = mod.GPUState(host_id=0, gpu_id=1)
                for inst in g.instances:
                    g2.create_instance(inst.profile, inst.uuid)
                g2.instances[0].job_id = "run"
                g2.repartition_for(p, "new")
                rows.append(_gpu_rows(g2))
        g.destroy_idle_instances()
        rows.append(_gpu_rows(g))
        c = mod.Cluster(n_hosts=2, gpus_per_host=3)
        c.partition_all(profs)
        inst = c.idle_instances(1)[0]
        c.mark_busy(inst, "x")
        rows += [[_gpu_rows(x) for x in c.all_gpus()], c.idle_leaf_counts(),
                 c.idle_sm_slices(), c.free_compute_total(),
                 c.total_leaves(), c.next_uuid(),
                 _instances(c.idle_instances(0, profile=profs[0]))]
        c.mark_idle(inst)
        rows.append(c.idle_leaf_counts())
        topo = mod.TpuSliceTopology(n_pods=2, hosts_per_pod=3,
                                    chips_per_host=4)
        rows.append(([x.uuid for x in topo.leaves()], topo.chips_per_pod))
        out.append(repr(rows))
    assert out[1] == out[0]


# ----------------------------------------------------------- JCT model

_VIEWS = [(("1g.5gb",), (1,), "NONE", 1), (("1g.10gb",), (1,), "NONE", 1),
          (("1g.5gb",) * 4, (4,), "SHM", 1),
          (("1g.5gb",) * 3 + ("1g.10gb",), (2, 2), "SHM", 1),
          (("1g.5gb",) * 6, (3, 3), "NET", 1),
          (("1g.5gb",) * 8, (4, 4), "NET", 3),
          (("1g.5gb",) * 7 + ("1g.10gb",), (6, 2), "NET", 2)]


@pytest.mark.parametrize("workload", sorted(jjct.WORKLOADS))
def test_jct_predictions_match_reference(workload):
    assert dataclasses.astuple(tjct.WORKLOADS[workload]) == \
        dataclasses.astuple(jjct.WORKLOADS[workload])
    for (types_, per_gpu, transport, net), batch, train in \
            itertools.product(_VIEWS, (8, 64), (True, False)):
        views = [mod.PlacementView(types_, per_gpu, transport,
                                   concurrent_net_jobs=net)
                 for mod in (jjct, tjct)]
        size = len(types_)
        a = (jjct.iteration_time(workload, batch, views[0], train=train),
             jjct.jct_scale(workload, batch, size, views[0], train=train))
        b = (tjct.iteration_time(workload, batch, views[1], train=train),
             tjct.jct_scale(workload, batch, size, views[1], train=train))
        assert repr(b) == repr(a), (workload, types_, batch, train)
    assert repr(tjct.ckpt_state_bytes(workload)) == \
        repr(jjct.ckpt_state_bytes(workload))
    for size in (1, 2, 4, 8):
        assert dataclasses.astuple(tjct.reference_view(size)) == \
            dataclasses.astuple(jjct.reference_view(size))


def test_sync_and_reconfig_costs_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(40):
        numels = [int(x) for x in rng.integers(1, 1 << 22, size=5)]
        kw = dict(nf=int(rng.integers(1, 9)), ns=int(rng.integers(1, 5)),
                  fast_bps=float(rng.uniform(1e9, 2e10)),
                  slow_bps=float(rng.uniform(1e8, 1e10)),
                  slow_bytes_per_elem=[None, 1.0, 2.0][int(rng.integers(3))])
        a = jjct.bucket_sync_times(numels, **kw)
        assert repr(tjct.bucket_sync_times(numels, **kw)) == repr(a)
        for overlap in (False, True):
            assert repr(tjct.hier_sync_makespan(*a, overlap=overlap)) == \
                repr(jjct.hier_sync_makespan(*a, overlap=overlap))
            assert repr(tjct.exposed_slow_fraction(*a, overlap=overlap)) \
                == repr(jjct.exposed_slow_fraction(*a, overlap=overlap))
    meas = [dict(save_s=1.5, restore_s=2.0, setup_s=0.3, first_step_s=4.0,
                 compile_s=3.0, state_bytes=2e9, save_bytes=2.1e9,
                 n_ranks=4, restore_bytes=2.1e9, mode="handoff"),
            dict(save_s=0.5, restore_s=0.7, setup_s=0.1, first_step_s=1.0,
                 compile_s=0.5, state_bytes=5e8, save_bytes=5e8, n_ranks=2,
                 restore_bytes=5e8, mode="handoff")]
    models = [mod.ReconfigCostModel.from_measurements(meas)
              for mod in (jjct, tjct)]
    models += [jjct.ReconfigCostModel(), tjct.ReconfigCostModel()]
    for ref, port in (models[:2], models[2:]):
        assert dataclasses.astuple(port) == dataclasses.astuple(ref)
        for b, r0, r1, drain in itertools.product((0.0, 1e9, 7.3e10),
                                                  (1, 4), (1, 8),
                                                  (0.0, 12.5)):
            for m, call in (
                    ("handoff_s", lambda c: c.handoff_s(
                        b, n_ranks_old=r0, n_ranks_new=r1)),
                    ("job_suspension_s", lambda c: c.job_suspension_s(
                        b, drain_s=drain, n_ranks_old=r0, n_ranks_new=r1)),
                    ("failure_restart_s", lambda c: c.failure_restart_s(
                        b, drain_restart_s=drain, n_ranks_new=r1)),
                    ("geometry_s", lambda c: c.geometry_s(
                        base_s=b * 1e-9, drain_s=drain))):
                assert repr(call(port)) == repr(call(ref)), m
    assert repr(tjct.summarize_by_size(meas)) == \
        repr(jjct.summarize_by_size(meas))
    for t, conc, cal in itertools.product((0.0, 3.7, 1e4), (False, True),
                                          (False, True)):
        assert repr(tjct.calibrated(t, concurrent=conc, calibrate=cal)) == \
            repr(jjct.calibrated(t, concurrent=conc, calibrate=cal))
