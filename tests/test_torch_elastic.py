"""The port's elastic remesh and handoff driver against the JAX package's,
on the CPU: ``tests/test_elastic_driver.py``'s unit cases and
``tests/test_fault_matrix.py``'s kill-and-resume, on 4 gloo ranks.

``ElasticDriver`` runs in every rank of a 4-rank job
(``tests/_torch_ranks.py::driver_ranks``) on the reduced model in f32,
its weights bridged from the reference's init.  Gates: the 3-handoff run
(2,2) -> (4,1) -> (1,4) -> (2,2) at steps 2, 4 and 6 of 8 has the
uninterrupted run's losses bit for bit, every handoff verified, and its
final checkpoint byte-identical to the uninterrupted run's; so do a drain
cycle, an int8 + error-feedback handoff and the simulated trace's event
(``schedule_from_sim`` of the port's simulator, equal to the reference's
schedule of the reference's).  A SIGKILL of the job at two sampled points
(the commit window of handoff 2, the first step of grid segment 3),
relaunched with ``resume=True``, continues bitwise and ends on the same
final checkpoint.
"""
import os
import re

import jax
import numpy as np
import pytest

from repro import elastic as jelastic
from repro import elastic_driver as jdriver
from repro.core import leaves as jleaves
from repro.core import simulator as jsim
from repro.core import traces as jtraces
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import ckpt as ckpt_lib
from repro_torch import elastic, optim
from repro_torch.convert import params_from_jax
from repro_torch.core.leaves import TpuLeaf
from repro_torch.core import simulator as tsim
from repro_torch.core import traces as ttraces
from repro_torch.data import DataConfig
from repro_torch.elastic_driver import (ElasticDriver, ReconfigEvent,
                                        factorizations, schedule_from_sim)
from repro_torch.faults import FaultPlan, FaultSpec, harness
from repro_torch.models.registry import get_config, reduced_config
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R

ARCH = "llama3.2-1b"
N_STEPS = 8
SCHEDULE = [(2, (4, 1)), (4, (1, 4)), (6, (2, 2))]


def _golden_trace(traces=ttraces):
    return traces.generate_trace(
        traces.TraceCategory("philly", "balanced", "mixed"), seed=7,
        double=False, max_size=4)


def _sim_with_drains(sim=tsim, traces=ttraces):
    """A DM replay of the golden trace: the port's, or with the
    reference's modules, the reference's."""
    r = sim.simulate(_golden_trace(traces), "DM")
    assert r.n_drains > 0
    return r


# ---------------------------------------------------------------- units

@pytest.mark.parametrize("n", [1, 4, 6, 12])
def test_factorizations_match_reference(n):
    assert factorizations(n) == jdriver.factorizations(n)
    with pytest.raises(ValueError):
        factorizations(0)


def test_reconfig_event_validation():
    with pytest.raises(ValueError, match="step"):
        ReconfigEvent(step=0, mesh_shape=(2, 2))
    with pytest.raises(ValueError, match="mesh shape"):
        ReconfigEvent(step=1, mesh_shape=(2, 0))


@pytest.mark.parametrize("kw", [
    dict(n_devices=4, n_steps=20, initial_shape=(2, 2)),
    dict(n_devices=4, n_steps=8, initial_shape=(2, 2), max_events=1),
    dict(n_devices=4, n_steps=20, max_events=1),
    dict(n_devices=4, n_steps=1),
    dict(n_devices=1, n_steps=20)], ids=["20", "8_one", "first", "short",
                                         "one_device"])
def test_schedule_from_sim_matches_reference(kw):
    ours = schedule_from_sim(_sim_with_drains(), **kw)
    ref = jdriver.schedule_from_sim(
        _sim_with_drains(jsim, jtraces), **kw)
    assert [(e.step, e.mesh_shape, e.sim_time, e.kind) for e in ours] == \
        [(e.step, e.mesh_shape, e.sim_time, e.kind) for e in ref]
    if kw["n_steps"] == 20 and kw["n_devices"] == 4 and "max_events" \
            not in kw:
        assert ours and [e.step for e in ours] == sorted(
            {e.step for e in ours})


def test_schedule_from_sim_never_reconfiguring_trace():
    assert schedule_from_sim(tsim.simulate(_golden_trace(), "FM"),
                             n_devices=4, n_steps=20) == []


def _dcfg():
    return DataConfig(vocab_size=16, seq_len=4, global_batch=2)


def test_run_refuses_stale_newer_checkpoint(tmp_path):
    stale = tmp_path / "step_00000099"
    stale.mkdir()
    (stale / "manifest.json").write_text('{"step": 99}')
    drv = ElasticDriver(object(), optim.AdamWConfig(), _dcfg(),
                        base_dir=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="stale"):
        drv.run(8, [ReconfigEvent(step=2, mesh_shape=(2, 2))])


def test_driver_rejects_bad_mode_steps_and_world(tmp_path):
    with pytest.raises(ValueError, match="mode"):
        ElasticDriver(object(), optim.AdamWConfig(), _dcfg(),
                      base_dir=str(tmp_path), mode="teleport",
                      device="cpu")
    drv = ElasticDriver(object(), optim.AdamWConfig(), _dcfg(),
                        base_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        drv.run(8, [ReconfigEvent(step=2, mesh_shape=(2, 2)),
                    ReconfigEvent(step=2, mesh_shape=(4, 1))])
    with pytest.raises(ValueError, match="past the run"):
        drv.run(8, [ReconfigEvent(step=8, mesh_shape=(2, 2))])
    with pytest.raises(ValueError, match="factorization"):
        drv.run(8, [ReconfigEvent(step=2, mesh_shape=(3, 1))],
                initial_shape=(2, 2))
    # one process is no job of 4 ranks
    with pytest.raises(ValueError, match="job of 4 ranks"):
        drv.run(8, [ReconfigEvent(step=2, mesh_shape=(4, 1))])


def test_driver_without_device_raises_without_card(monkeypatch, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticDriver(object(), optim.AdamWConfig(), _dcfg(),
                      base_dir=str(tmp_path))


def _leaves(mod, n_pods=2, hosts=4):
    return [mod.TpuLeaf(pod=p, host=h, chip=0)
            for p in range(n_pods) for h in range(hosts)]


@pytest.mark.parametrize("failed,mp", [((), 1), (((0, 1),), 1),
                                       (((0, 1), (1, 3)), 2),
                                       (((0, 0), (0, 1), (0, 2)), 4)])
def test_remesh_plan_matches_reference(tmp_path, failed, mp):
    ckpt_lib.save_sharded(ckpt_lib.step_dir(str(tmp_path), 5), 5,
                          {"w": np.arange(4, dtype=np.float32)})
    ours = elastic.plan_elastic_remesh(_leaves(elastic), failed,
                                       model_parallel=mp,
                                       ckpt_base_dir=str(tmp_path))
    ref = jelastic.plan_elastic_remesh(_leaves(jleaves), failed,
                                       model_parallel=mp,
                                       ckpt_base_dir=str(tmp_path))
    assert [l.uuid for l in ours.surviving] == \
        [l.uuid for l in ref.surviving]
    assert (ours.mesh_shape, ours.axis_names, ours.dropped_hosts) == \
        (ref.mesh_shape, ref.axis_names, ref.dropped_hosts)
    assert ours.handoff == elastic.CheckpointHandoff(**vars(ref.handoff))
    assert ours.handoff.sharded and ours.handoff.step == 5


def test_remesh_without_commit_refused_and_repack_degrades(tmp_path):
    leaves = [TpuLeaf(0, h, 0) for h in range(4)]
    with pytest.raises(RuntimeError, match="no committed checkpoint"):
        elastic.plan_elastic_remesh(leaves, (), model_parallel=1,
                                    ckpt_base_dir=str(tmp_path))
    plan = elastic.repack_on_failure(leaves, [(0, 1)],
                                     ckpt_base_dir=str(tmp_path))
    assert plan.handoff is None and plan.mesh_shape == (3, 1)
    assert elastic.repack_on_failure(leaves, [(0, h) for h in range(4)]) \
        is None
    assert TpuLeaf(1, 2, 3).uuid == jleaves.TpuLeaf(1, 2, 3).uuid


# ------------------------------------------------------ 4 ranks, a driver

def _spec(tmp, runs):
    cfg = jax_reduced_config(jax_get_config(ARCH))
    weights = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax_build_model(cfg, remat=False).init(jax.random.key(0))))
    return {"cfg": reduced_config(get_config(ARCH)),
            "weights": {n: t.numpy() for n, t in weights.items()},
            "data": dict(vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=8),
            "accum": 1, "bucket_bytes": 64 << 10, "n_steps": N_STEPS,
            "ocfg": {"a": dict(peak_lr=1e-3, warmup_steps=2,
                               total_steps=N_STEPS)},
            "runs": {name: dict(run, base=str(tmp / name))
                     for name, run in runs.items()}}


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("driver")
    sim = schedule_from_sim(_sim_with_drains(), n_devices=4,
                            n_steps=N_STEPS, initial_shape=(2, 2),
                            max_events=1)
    runs = {"ref": dict(schedule=[], final_save=True),
            "handoff": dict(schedule=SCHEDULE, final_save=True),
            "drain": dict(schedule=[(4, (4, 1))], mode="drain",
                          final_save=True),
            "sim": dict(schedule=[(e.step, e.mesh_shape) for e in sim]),
            "ref_ef": dict(schedule=[], ef=True),
            "handoff_ef": dict(schedule=[(3, (1, 4))], ef=True)}
    spec = _spec(tmp, runs)
    res = run_ranks(R.driver_ranks, 4, args=(spec,), deadline_s=300,
                    threads=1)
    return spec, res, sim


@pytest.mark.parametrize("name", ["handoff", "drain", "sim"])
def test_handoffs_continue_bitwise(driven, name):
    spec, res, sim = driven
    for rank in range(4):
        ref, out = res[rank]["ref"], res[rank][name]
        assert out["losses"] == ref["losses"], (rank, name)
        assert out["digest"] == ref["digest"], (rank, name)
        sched = spec["runs"][name]["schedule"]
        assert [tuple(m["to_shape"]) for m in out["measurements"]] == \
            [tuple(s) for _, s in sched]
        for m in out["measurements"]:
            assert m["verified"] and m["mode"] == \
                spec["runs"][name].get("mode", "handoff")
            assert m["save_s"] > 0 and m["restore_s"] > 0
            assert m["setup_s"] > 0 and m["first_step_s"] > 0
            assert m["save_bytes"] > 0 and m["state_bytes"] > 0
    if name == "sim":
        assert sim and len(res[0]["sim"]["measurements"]) == 1


def test_handoff_grids_and_final_checkpoint(driven):
    spec, res, _ = driven
    assert res[0]["handoff"]["shapes"] == [(2, 2)] * 2 + [(4, 1)] * 2 + \
        [(1, 4)] * 2 + [(2, 2)] * 2
    base = {n: spec["runs"][n]["base"] for n in ("ref", "handoff")}
    final = {n: R.files_digest(ckpt_lib.step_dir(b, N_STEPS))
             for n, b in base.items()}
    assert final["handoff"] == final["ref"]
    assert ckpt_lib.committed_steps(base["handoff"]) == [2, 4, 6, N_STEPS]


def test_int8_error_feedback_handoff_bitwise(driven):
    _, res, _ = driven
    for rank in range(4):
        assert res[rank]["handoff_ef"]["losses"] == \
            res[rank]["ref_ef"]["losses"]
        assert res[rank]["handoff_ef"]["measurements"][0]["verified"]
    assert res[0]["ref_ef"]["losses"] != res[0]["ref"]["losses"]


# -------------------------------------------------- kill and resume

CHILD = """
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
spec = R.load_spec(%r)
out = run_ranks(R.driver_ranks, 4, args=(spec,), deadline_s=200,
                threads=1)[0]["run"]
print('START', out['start'])
for i, loss in enumerate(out['losses'], start=out['start']):
    print('LOSS %%d %%r' %% (i, loss))
print('DRIVER_DONE')
"""

# (point, hit, committed step the relaunch must resume from)
KILL_POINTS = [
    ("sharded.manifest", 2, 2),  # handoff 2's commit window: tmp only
    ("driver.first_step", 3, 4),  # first step of grid segment 3
]


@pytest.mark.parametrize("point,hit,resume_from", KILL_POINTS,
                         ids=[p for p, _, _ in KILL_POINTS])
def test_kill_and_resume_bitwise(tmp_path, driven, point, hit,
                                 resume_from):
    spec, res, _ = driven
    base = str(tmp_path / "run")
    run = dict(schedule=SCHEDULE, final_save=True, base=base)

    def child(resume, plan=None):
        path = str(tmp_path / f"spec_{resume}.pkl")
        R.dump_spec(dict(spec, runs={"run": dict(run, resume=resume)}),
                    path)
        return harness.run_child(CHILD % path, plan=plan, timeout=300)

    killed = child(False, FaultPlan([FaultSpec(point, "crash", hit=hit)]))
    harness.expect_rank_sigkill(killed)
    # never a torn dir: whatever latest_step names is committed
    assert ckpt_lib.latest_step(base) == resume_from
    out = harness.expect_clean(child(True))
    assert "DRIVER_DONE" in out
    assert re.search(rf"^START {resume_from}$", out, re.M), out
    got = {int(k): float(v) for k, v in re.findall(r"LOSS (\d+) (\S+)",
                                                   out)}
    ref = res[0]["ref"]["losses"]
    assert sorted(got) == list(range(resume_from, N_STEPS))
    assert all(got[s] == ref[s] for s in got), (got, ref)
    # the resumed run's final commit is byte-identical to the reference
    assert R.files_digest(ckpt_lib.step_dir(base, N_STEPS)) == \
        R.files_digest(ckpt_lib.step_dir(spec["runs"]["ref"]["base"],
                                         N_STEPS))
    # the dead job's in-flight tmp debris was swept by a later commit
    assert [d for d in os.listdir(base)
            if ".tmp-" in d or ".old-" in d] == []


# ------------------------------------------------------------ launcher

def test_launcher_runs_the_driver_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--steps", "4", "--batch", "8", "--seq",
          "16", "--data-parallel", "2", "--reconfig-at", "2:2x1",
          "--ckpt-dir", str(tmp_path), "--no-resume"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("  mesh ")[1] for ln in lines[:4]] == \
        ["(1, 2)"] * 2 + ["(2, 1)"] * 2
    assert lines[4].startswith("reconfig@2: (1, 2)->(2, 1) [handoff]")
    assert lines[4].endswith("verified=True")


@pytest.mark.parametrize("argv,match", [
    (["--reconfig-at", "2:2x1"], "needs --data-parallel"),
    (["--data-parallel", "2", "--reconfig-at", "2:2x1", "--overlap"],
     "overlap"),
    (["--data-parallel", "2", "--reconfig-at", "2:2x1",
      "--cross-pod-mode", "hier"], "hier_bucketed_zero1"),
    (["--data-parallel", "2", "--reconfig-at", "2:2x1",
      "--slow-compress-bits", "8"], "int8"),
    (["--data-parallel", "2", "--reconfig-at", "2-2x1"], "bad"),
    (["--data-parallel", "2", "--reconfig-at", "2:4x1"],
     "not a factorization"),
    (["--data-parallel", "2", "--reconfig-at", "9:2x1", "--steps", "4"],
     "past the run")])
def test_launcher_rejects_bad_reconfig_flags(argv, match):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu"] + argv)

