"""The port's multi-tenant cluster runtime (``repro_torch.cluster``,
``repro_torch.launch.cluster``) against the JAX package's, on the CPU.

- **Decisions.**  The reference's ``FakeManager`` cases
  (``tests/test_cluster_runtime.py``, run as written against both
  packages through ``_torch_reference.reference_cases``), and scenarios
  driven through both runtimes under the same ``FakeManager``: the repack
  list, the launch log (job, segment, attempt, shape, fault plan) in
  launch order, the stitched measurements and every job's outcome are the
  reference's, event for event.
- **Real co-scheduled runs** on gloo ranks on the CPU (``device="cpu"``),
  the reference's two scenarios at its sizes: the 3-job/2-tenant
  contention scenario through the launcher (``--demo --device cpu``;
  both repack kinds, j2's losses j0's first two bit for bit), and a
  namespaced crash that restarts exactly the job it targets.
- **The losses.**  The repacked job j0 continues bitwise against the
  port's uninterrupted run of the same segment code (``worker.
  segment_rank`` to step 15 on (2,2)).  Against the reference: the port's
  worker segment started from the reference's init (bridged), held against
  the reference's worker (``repro.cluster.worker.run_segment``) over the
  same 15 steps, within ``rtol=2e-2``: ``tests/test_torch_train.py``'s
  bound for a bf16 training curve against the reference (the worker's
  model is bf16; ``tests/test_torch_elastic.py`` holds no loss against the
  reference).  Steps 0 and 1, at the initial weights, are held to the bf16
  loss bound ``rtol=2e-3``, and the reference's curve must fall by more
  than 4 times the curve's bound, so that a segment that did not train
  lies outside it (one with a learning rate of 0 misses it by 0.131).  The reference's own cluster smoke holds its stitched j0 to
  that uninterrupted run (its handoffs and resumes are bitwise), so this
  is the port's j0 against the reference's, by way of each package's own
  bitwise invariant.
"""
import dataclasses
import glob
import json
import os
import time

import jax
import numpy as np
import pytest

from repro.core import traces as jtraces
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch.cluster import ClusterRuntime, DevicePool, JobManager
from repro_torch.cluster import ClusterJobSpec, worker
from repro_torch.convert import params_from_jax
from repro_torch.faults.plan import FaultPlan, FaultSpec
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
from tests.conftest import run_multidevice
from tests._torch_reference import PACKAGES, reference_cases, run_case

_MODULES = {p: reference_cases("test_cluster_runtime", p) for p in PACKAGES}
FAKE_CASES = sorted(c for c in vars(_MODULES["repro"])
                    if c.startswith("test_") and "multidevice" not in c)


def test_fake_cases_are_the_reference_ten():
    assert len(FAKE_CASES) == 10
    assert _MODULES["repro_torch"].ClusterRuntime is ClusterRuntime


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", FAKE_CASES)
def test_fake_manager_case(case, package, tmp_path):
    run_case(_MODULES[package], case, tmp_path)


# ------------------------------------------- decisions, event for event

def _contention(m, **kw):
    S = m.ClusterJobSpec
    specs = [S("j0", size=4, n_steps=15, segment_steps=3, tenant="acme"),
             S("j1", size=2, n_steps=2, segment_steps=2, tenant="beta"),
             S("j2", size=4, n_steps=2, segment_steps=2, tenant="beta",
               priority_tier=m.TIER_HIGH, after="j1")]
    return specs, dict(scheduler=m.Scheduler("backfill", depth=8,
                                             quotas={"beta": 6}), **kw), {}


def _trace_specs(m):
    """Jobs of a generated 2-tenant trace, every third at the high tier,
    each odd one arriving after its predecessor started."""
    jobs = jtraces.generate_trace(
        jtraces.TraceCategory("philly", "balanced", "mixed"), seed=3,
        max_size=4, n_tenants=2)[:9]
    return [m.ClusterJobSpec(
        j.job_id, size=j.size, n_steps=2 + i % 4, segment_steps=2,
        tenant=j.tenant, seed=i,
        priority_tier=m.TIER_HIGH if i % 3 == 0 else j.priority_tier,
        after=jobs[i - 1].job_id if i % 2 else None)
        for i, j in enumerate(jobs)]


SCENARIOS = {
    "side_by_side": lambda m: ([
        m.ClusterJobSpec("a", size=4, n_steps=4, segment_steps=2),
        m.ClusterJobSpec("b", size=4, n_steps=4, segment_steps=2)], {}, {}),
    "contention": _contention,
    "contention_fifo": lambda m: (_contention(m)[0], dict(
        scheduler=m.Scheduler("fifo", depth=8, quotas={"beta": 6})), {}),
    "contention_no_rebalance": lambda m: _contention(m, rebalance=False),
    "contention_no_defrag": lambda m: _contention(m, defrag=False),
    "contention_frag_aware": lambda m: _contention(m, frag_aware=True),
    "frag_aware_exact_fits": lambda m: ([
        m.ClusterJobSpec("a", size=4, n_steps=4, segment_steps=4),
        m.ClusterJobSpec("b", size=4, n_steps=2, segment_steps=2,
                         after="a")],
        dict(frag_aware=True, rebalance=False), {}),
    "quota": lambda m: ([
        m.ClusterJobSpec("b1", size=2, n_steps=2, tenant="beta"),
        m.ClusterJobSpec("b2", size=2, n_steps=2, tenant="beta")],
        dict(pool=m.DevicePool(1, 4),
             scheduler=m.Scheduler("backfill", depth=8,
                                   quotas={"beta": 2})), {}),
    "after": lambda m: ([
        m.ClusterJobSpec("first", size=2, n_steps=2),
        m.ClusterJobSpec("second", size=2, n_steps=2, after="first")],
        dict(pool=m.DevicePool(1, 2)), {}),
    "crash_relaunch": lambda m: ([
        m.ClusterJobSpec("a", size=2, n_steps=4, segment_steps=2),
        m.ClusterJobSpec("b", size=2, n_steps=4, segment_steps=2)], {},
        {"a": {(1, 0)}}),
    "fault_plan": lambda m: ([
        m.ClusterJobSpec("j_a", size=2, n_steps=2),
        m.ClusterJobSpec("j_b", size=2, n_steps=2)],
        dict(pool=m.DevicePool(1, 4), fault_plans={"j_a": m.FaultPlan(
            [m.FaultSpec("driver.first_step", "crash", hit=1)])}),
        {"j_a": {(0, 0)}}),
    "giving_up": lambda m: ([m.ClusterJobSpec("a", size=2, n_steps=2)],
                            dict(max_restarts=2),
                            {"a": {(0, 0), (0, 1), (0, 2)}}),
    "deadlock": lambda m: ([m.ClusterJobSpec("a", size=4, n_steps=2,
                                             tenant="beta")],
                           dict(scheduler=m.Scheduler(
                               "fifo", quotas={"beta": 2})), {}),
    "trace": lambda m: (_trace_specs(m), dict(
        scheduler=m.Scheduler("backfill", depth=4,
                              quotas={"t1": 6})), {}),
    "trace_frag_aware": lambda m: (_trace_specs(m), dict(
        frag_aware=True, pool=m.DevicePool(3, 4)), {}),
}


def _drive(m, name, tmp_path):
    """One scenario through package module ``m``'s runtime under its
    ``FakeManager``: everything the runtime decided, in order."""
    specs, kw, crash = SCENARIOS[name](m)
    log = []

    def factory(spec, wd):
        mgr = m.FakeManager(spec, wd, crash_at=crash.get(spec.job_id, ()))
        launch = mgr.launch

        def logged(shape, *, fault_env=None):
            log.append((spec.job_id, mgr.segment, mgr.attempt,
                        tuple(shape), fault_env))
            launch(shape, fault_env=fault_env)
        mgr.launch = logged
        return mgr

    kw.setdefault("pool", m.DevicePool(2, 4))
    rt = m.ClusterRuntime(specs, base_dir=str(tmp_path),
                          manager_factory=factory, poll_s=0.0, **kw)
    try:
        res = rt.run()
    except m.ClusterError as e:
        return {"error": str(e), "launches": log}
    return {"repacks": [r.to_dict() for r in res.repacks],
            "launches": log, "measurements": repr(res.measurements),
            "jobs": {jid: (o.losses, o.shapes, o.restarts,
                           [dataclasses.astuple(s) for s in o.segments])
                     for jid, o in res.jobs.items()},
            "left": {k: (a.devices, a.shape)
                     for k, a in rt.pool.allocs.items()},
            "n_repacks": res.n_repacks}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_runtime_decisions_match_reference(name, tmp_path):
    ref = _drive(_MODULES["repro"], name, tmp_path / "ref")
    got = _drive(_MODULES["repro_torch"], name, tmp_path / "port")
    assert got == ref
    # the scenarios do what they are named for
    assert bool(ref["launches"]) == (name != "deadlock")
    if name in ("contention", "contention_fifo", "contention_no_rebalance"):
        assert any(r["reason"] == "defrag" for r in ref["repacks"])
    assert ("error" in ref) == (name in ("giving_up", "deadlock"))


# ------------------------------------------------------ real workers

def _results(base):
    """Every segment's result file of a cluster run, by job."""
    out = {}
    for path in sorted(glob.glob(os.path.join(base, "*",
                                              "seg*.result.json"))):
        with open(path) as f:
            d = json.load(f)
        out.setdefault(d["job_id"], []).append(d)
    return out


@pytest.fixture(scope="module")
def contention(tmp_path_factory):
    """The contention scenario through the launcher on CPU gloo ranks."""
    from repro_torch.launch.cluster import main
    base = tmp_path_factory.mktemp("contention")
    summary = str(base / "summary.json")
    main(["--demo", "--device", "cpu", "--steps", "15", "--segment-steps",
          "3", "--base-dir", str(base / "run"), "--json", summary])
    with open(summary) as f:
        return json.load(f), _results(str(base / "run"))


def test_contention_scenario_on_gloo_ranks(contention):
    """``test_cluster_smoke_multidevice``'s gates: both repack kinds, the
    defrag of j0 requested by j2, every job's steps, j2's losses j0's first
    two bit for bit, the measured handoffs."""
    res, _ = contention
    reasons = [r["reason"] for r in res["repacks"]]
    assert len(reasons) >= 2 and "defrag" in reasons \
        and "rebalance" in reasons
    defrag = res["repacks"][reasons.index("defrag")]
    assert defrag["job_id"] == "j0" and defrag["requested_by"] == "j2"
    assert defrag["to_shape"] == [1, 4]
    for jid, n in (("j0", 15), ("j1", 2), ("j2", 2)):
        assert len(res["jobs"][jid]["losses"]) == n
    assert res["jobs"]["j2"]["losses"] == res["jobs"]["j0"]["losses"][:2]
    assert res["jobs"]["j2"]["shapes"] == [[1, 4]]
    shapes = res["jobs"]["j0"]["shapes"]
    assert shapes[0] == [2, 2] and [1, 4] in shapes and shapes[-1] == [2, 2]
    assert res["measurements"] and any(m["repack"]
                                       for m in res["measurements"])
    for m in res["measurements"]:
        assert m["save_s"] > 0 and m["restore_s"] > 0
        assert m["state_bytes"] > 0 and m["save_bytes"] > 0


def test_contention_segments_report_their_ranks(contention):
    """Each segment ran on the CPU, rank 0 counted no kernel launch there
    (the plain versions run), and every rank reported its peak."""
    res, results = contention
    assert sorted(results) == ["j0", "j1", "j2"]
    assert [len(results[j]) for j in ("j0", "j1", "j2")] == [5, 1, 1]
    for segs in results.values():
        for d in segs:
            assert d["device"] == "cpu"
            assert set(d["kernel_launches"]) == {"rmsnorm",
                                                 "flash_attention", "ssd",
                                                 "mlstm"}
            assert not any(d["kernel_launches"].values())
            assert len(d["peak_memory_gib"]) == d["n_ranks"]


def _segment_spec(base, run_to, **kw):
    """The spec file the manager writes for one job's first segment."""
    return dict({"job_id": "ref", "arch": "llama3.2-1b", "shape": [2, 2],
                 "base_dir": str(base), "run_to": run_to,
                 "total_steps": run_to, "seed": 0, "resume": False,
                 "final_save": False, "bucket_bytes": 64 << 10,
                 "seq_len": 16, "global_batch": 8, "device": "cpu",
                 "n_layers": None}, **kw)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """j0's 15 steps by the worker's segment code on (2,2), no repack."""
    spec = _segment_spec(tmp_path_factory.mktemp("uninterrupted"), 15)
    return run_ranks(worker.segment_rank, 4, args=(spec,), deadline_s=300,
                     threads=1)


def test_repacked_job_continues_bitwise(contention, uninterrupted):
    res, _ = contention
    ref = uninterrupted[0]["losses"]
    assert all(u["losses"] == ref for u in uninterrupted)
    assert res["jobs"]["j0"]["losses"] == ref
    assert res["jobs"]["j2"]["losses"] == ref[:2]


# tests/test_torch_train.py's bound for a bf16 training curve
LOSS_RTOL = 2e-2

REF_SEGMENT = """
import json
from repro.cluster.worker import run_segment
out = run_segment(json.loads(%r))
print("LOSSES", json.dumps(out["losses"]))
"""


def test_cluster_losses_match_reference(tmp_path):
    """The worker's segment from the reference's init against the
    reference's worker over j0's 15 steps (see the module docstring)."""
    cfg = jax_reduced_config(jax_get_config("llama3.2-1b"))
    weights = params_from_jax(jax.tree.map(
        np.asarray, jax_build_model(cfg, remat=False).init(
            jax.random.key(0))))
    spec = _segment_spec(tmp_path / "port", 15)
    port = run_ranks(R.bridged_segment_ranks, 4, args=(spec, weights),
                     deadline_s=300, threads=1)
    ref_spec = dict(_segment_spec(tmp_path / "ref", 15))
    out = run_multidevice(REF_SEGMENT % json.dumps(ref_spec), n_devices=4)
    ref = json.loads(out.split("LOSSES", 1)[1])
    assert len(ref) == 15 and all(p["losses"] == port[0]["losses"]
                                  for p in port)
    got = port[0]["losses"]
    # steps 0 and 1 run at the initial weights (the warmup's lr is 0 at
    # step 0): test_loss_and_grad_matches_jax's bf16 loss bound
    np.testing.assert_allclose(got[:2], ref[:2], rtol=2e-3)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    # the bound tells a run that trained from one that did not: the
    # reference's last steps lie far more than it below its first loss,
    # so a segment whose optimizer did nothing, or that restored a wrong
    # step, lies outside it
    fall = 1 - max(ref[-3:]) / ref[0]
    assert fall > 4 * LOSS_RTOL, (ref, fall)


def test_crash_restarts_only_the_target_on_gloo_ranks(tmp_path):
    """``test_cluster_fault_restarts_only_target_multidevice``: a
    namespaced plan SIGKILLs j_a's ranks at their first step; the worker
    exits non-zero without a result, the runtime relaunches j_a (fresh:
    nothing was committed) while j_b runs on, and both end on the same
    losses."""
    specs = [ClusterJobSpec("j_a", size=2, n_steps=2, device="cpu"),
             ClusterJobSpec("j_b", size=2, n_steps=2, device="cpu")]
    rt = ClusterRuntime(
        specs, pool=DevicePool(1, 4), base_dir=str(tmp_path),
        fault_plans={"j_a": FaultPlan(
            [FaultSpec("driver.first_step", "crash", hit=1)])},
        timeout_s=400.0)
    res = rt.run()
    assert res.jobs["j_a"].restarts == 1
    assert res.jobs["j_b"].restarts == 0
    assert res.jobs["j_a"].losses == res.jobs["j_b"].losses
    assert len(res.jobs["j_a"].losses) == 2
    # the killed attempt left a log and no result
    assert not os.path.exists(os.path.join(
        str(tmp_path), "j_a", "seg000_a0.result.json"))
    assert os.path.exists(os.path.join(str(tmp_path), "j_a",
                                       "seg000_a1.result.json"))


def test_worker_without_card_crashes_without_result(tmp_path):
    """A spec with no device means the card: on a machine without one the
    segment's rank raises, and the manager sees a crash, not a result."""
    mgr = JobManager(ClusterJobSpec("nocard", size=1, n_steps=1),
                     str(tmp_path))
    mgr.launch((1, 1))
    mgr.proc.wait(timeout=120)
    kind, rc = mgr.poll()
    assert (kind, rc != 0) == ("crash", True)
    assert "no CUDA device" in mgr.tail_log(20000)


def _session(sid):
    """The live processes of session ``sid``: their command lines by pid."""
    out = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, _, _, session = f.read().rsplit(")", 1)[1].split()[:4]
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode()
        except (OSError, ValueError):
            continue
        if state != "Z" and int(session) == sid:
            out[int(d)] = cmd
    return out


def test_failed_run_stops_the_worker_and_its_ranks(tmp_path):
    """A run that fails while a segment runs kills the segment's worker
    and the gloo ranks it spawned, all in the worker's session, and
    raises."""
    seen = []

    class Failing(JobManager):
        def poll(self):
            if self.proc is not None:
                ranks = [c for c in _session(self.proc.pid).values()
                         if "spawn_main" in c]
                if len(ranks) == self.spec.size:
                    seen.append(self.proc.pid)
                    raise RuntimeError("planted failure")
            return super().poll()

    rt = ClusterRuntime(
        [ClusterJobSpec("j", size=2, n_steps=10 ** 4,
                        segment_steps=10 ** 4, device="cpu")],
        pool=DevicePool(1, 2), base_dir=str(tmp_path),
        manager_factory=Failing, timeout_s=120.0)
    with pytest.raises(RuntimeError, match="planted failure"):
        rt.run()
    assert rt.managers["j"].proc is None
    deadline = time.monotonic() + 10
    while _session(seen[0]) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _session(seen[0]) == {}


def test_launcher_without_device_raises_without_card(monkeypatch, tmp_path):
    import torch
    from repro_torch.launch.cluster import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--demo", "--base-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_spec_departures_reach_the_worker(tmp_path):
    """``device`` and ``n_layers`` are written into the segment spec; None
    keeps the reference's reduced config, an int the published widths."""
    from repro_torch.models.registry import get_config, reduced_config
    for n_layers, device in ((None, "cpu"), (1, None)):
        mgr = JobManager(ClusterJobSpec("s", size=1, n_steps=1,
                                        device=device, n_layers=n_layers),
                         str(tmp_path / str(n_layers)), python="true")
        mgr.launch((1, 1))
        mgr.proc.wait()
        with open(os.path.join(mgr.work_dir, "seg000_a0.spec.json")) as f:
            spec = json.load(f)
        assert (spec["device"], spec["n_layers"]) == (device, n_layers)
        cfg = worker.segment_config(spec)
        full = get_config("llama3.2-1b")
        if n_layers is None:
            assert cfg == reduced_config(full)
        else:
            assert cfg == dataclasses.replace(full, n_layers=1)
