"""The port's fault-injection plane + crash-safe recovery
(``repro_torch.faults``), case for case ``tests/test_faults.py``.

Host-side coverage: plan/retry semantics, the save_sharded crash matrix
(SIGKILL at every injection point -> latest_step never names a torn
dir), CRC quarantine with committed-history fallback, debris GC, and
the launcher's recovery-flag guards; beside them, what only the port has
to show: one serialized plan arms either package, and a SIGKILL of one
rank of a 4-rank gloo save takes the job down and leaves no torn step.
The driver's kill-and-resume points live in test_torch_elastic.py.
"""
import errno
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import ckpt as ckpt_lib
from repro_torch import faults as F
from repro_torch.checkpoint import CorruptCheckpointError, committed_steps
from repro_torch.faults import harness
from repro_torch.faults.recovery import (restore_with_fallback,
                                         walk_committed)


def _tree():
    return {"w": np.arange(64, dtype=np.float32),
            "b": np.float32(2.0),
            "k": np.arange(6, dtype=np.int32).reshape(2, 3)}


def _save(base, step, tree=None, **kw):
    ckpt_lib.save_sharded(ckpt_lib.step_dir(base, step), step,
                          tree if tree is not None else _tree(), **kw)


def _dead_pid():
    """A pid guaranteed dead: a child that already exited."""
    out = subprocess.run(
        [sys.executable, "-c", "import os; print(os.getpid())"],
        capture_output=True, text=True, check=True)
    return int(out.stdout.strip())


# ---------------------------------------------------------------- plan

def test_plan_fires_on_nth_arrival_for_times_window():
    plan = F.FaultPlan([F.FaultSpec("p", "eio", hit=2, times=2)])
    with F.install(plan):
        F.maybe_fire("p")                      # arrival 1: clean
        for _ in range(2):                     # arrivals 2, 3: fault
            with pytest.raises(OSError) as ei:
                F.maybe_fire("p")
            assert ei.value.errno == errno.EIO
        F.maybe_fire("p")                      # arrival 4: clean again
    assert [f.count for f in plan.fired] == [2, 3]


def test_plan_no_active_plan_is_noop():
    F.maybe_fire("anything")                   # must never raise


def test_plan_env_roundtrip():
    plan = F.FaultPlan([F.FaultSpec("a", "crash", hit=3)], seed=7)
    back = F.FaultPlan.from_env(plan.to_env())
    assert back.specs == plan.specs and back.seed == 7


def test_plan_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        F.FaultSpec("p", "meteor")


def test_bitflip_corrupts_past_npy_header(tmp_path):
    path = str(tmp_path / "x.npy")
    arr = np.arange(256, dtype=np.float32)
    np.save(path, arr)
    plan = F.FaultPlan([F.FaultSpec("w", "bitflip", nbytes=4)], seed=0)
    with F.install(plan):
        F.maybe_fire("w", path=path)
    loaded = np.load(path)                     # header intact: parses
    assert loaded.shape == arr.shape
    assert not np.array_equal(loaded, arr)     # payload corrupted


# --------------------------------------------------------------- retry

def test_retry_absorbs_transient_window_within_budget():
    plan = F.FaultPlan([F.FaultSpec("io", "enospc", hit=1, times=2)])
    pol = F.RetryPolicy(max_retries=2, base_delay_s=0)
    calls = []
    with F.install(plan):
        pol.call(lambda: calls.append(F.maybe_fire("io")))
    assert len(calls) == 1                     # succeeded on attempt 3


def test_retry_exhausted_reraises():
    plan = F.FaultPlan([F.FaultSpec("io", "eio", hit=1, times=5)])
    pol = F.RetryPolicy(max_retries=2, base_delay_s=0)
    with F.install(plan), pytest.raises(OSError):
        pol.call(lambda: F.maybe_fire("io"))


def test_retry_never_retries_corruption():
    pol = F.RetryPolicy(max_retries=5, base_delay_s=0)
    calls = []

    def bad():
        calls.append(1)
        raise CorruptCheckpointError("bad crc")

    with pytest.raises(CorruptCheckpointError):
        pol.call(bad)
    assert len(calls) == 1


# ----------------------------------------------------- committed steps

def test_committed_steps_history_sorted_and_verified(tmp_path):
    base = str(tmp_path)
    for step in (30, 10, 20):
        _save(base, step)
    # wreckage that must all be invisible: torn tmp dir, empty dir,
    # manifest that doesn't parse, manifest whose step lies
    os.makedirs(tmp_path / "step_00000040.tmp-123")
    os.makedirs(tmp_path / "step_00000050")
    (tmp_path / "step_00000060").mkdir()
    (tmp_path / "step_00000060" / "manifest.json").write_text("{not json")
    (tmp_path / "step_00000070").mkdir()
    (tmp_path / "step_00000070" / "manifest.json").write_text(
        json.dumps({"step": 999}))
    assert committed_steps(base) == [10, 20, 30]
    assert ckpt_lib.latest_step(base) == 30


# ----------------------------------------- save_sharded crash matrix

CRASH_POINTS = ["sharded.write", "sharded.written", "sharded.manifest",
                "sharded.committed"]


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_save_crash_matrix_new_step(tmp_path, point):
    """SIGKILL at any injection point of a new-step save: latest_step is
    either the old committed step or the new one, never a torn dir, and
    whatever it names restores."""
    base = str(tmp_path)
    code = """
import numpy as np
from repro_torch import ckpt as C
from repro_torch.faults import FaultPlan, FaultSpec, install
base = %r
tree = {"w": np.arange(64, dtype=np.float32), "b": np.float32(2.0),
        "k": np.arange(6, dtype=np.int32).reshape(2, 3)}
C.save_sharded(C.step_dir(base, 10), 10, tree)
with install(FaultPlan([FaultSpec(%r, "crash")])):
    C.save_sharded(C.step_dir(base, 20), 20, tree)
print("SURVIVED")
""" % (base, point)
    res = harness.run_child(code)
    harness.expect_sigkill(res)
    last = ckpt_lib.latest_step(base)
    assert last in (10, 20), f"torn step visible after crash at {point}"
    step, tree = ckpt_lib.restore_auto(
        ckpt_lib.step_dir(base, last), _tree())
    assert step == last
    np.testing.assert_array_equal(tree["w"], _tree()["w"])


@pytest.mark.parametrize("point", ["sharded.pre_rename_aside",
                                   "sharded.between_renames"])
def test_save_crash_matrix_same_step_resave(tmp_path, point):
    """The same-step re-save crash windows: a kill before the rename-
    aside keeps step 10 committed; a kill between the renames hides it
    (falls back to step 5) but never exposes a torn dir."""
    base = str(tmp_path)
    code = """
import numpy as np
from repro_torch import ckpt as C
from repro_torch.faults import FaultPlan, FaultSpec, install
base = %r
tree = {"w": np.arange(64, dtype=np.float32), "b": np.float32(2.0),
        "k": np.arange(6, dtype=np.int32).reshape(2, 3)}
C.save_sharded(C.step_dir(base, 5), 5, tree)
C.save_sharded(C.step_dir(base, 10), 10, tree)
with install(FaultPlan([FaultSpec(%r, "crash")])):
    C.save_sharded(C.step_dir(base, 10), 10, tree)
print("SURVIVED")
""" % (base, point)
    res = harness.run_child(code)
    harness.expect_sigkill(res)
    last = ckpt_lib.latest_step(base)
    if point == "sharded.pre_rename_aside":
        assert last == 10
    else:
        # step 10 was moved aside pre-commit: fall back to step 5; the
        # .old-* bytes survive until the next save's debris sweep
        assert last in (5, 10)
    step, _tree_out = ckpt_lib.restore_auto(
        ckpt_lib.step_dir(base, last), _tree())
    assert step == last


# ----------------------------------------------------------- debris GC

def test_gc_debris_collects_dead_pid_leftovers(tmp_path):
    base = str(tmp_path)
    _save(base, 10)
    dead = _dead_pid()
    planted_old = tmp_path / f"step_00000010.old-{dead}"
    planted_tmp = tmp_path / f"step_00000020.tmp-{dead}"
    live = tmp_path / f"step_00000030.tmp-{os.getpid()}"
    quarantined = tmp_path / f"step_00000005.quarantined-{dead}"
    for d in (planted_old, planted_tmp, live, quarantined):
        d.mkdir()
        (d / "junk.npy").write_bytes(b"x")
    _save(base, 40)                            # sweep rides the commit
    assert not planted_old.exists(), ".old-* of a dead pid must be GCed"
    assert not planted_tmp.exists(), ".tmp-* of a dead pid must be GCed"
    assert live.exists(), "a live writer's tmp dir must be left alone"
    assert quarantined.exists(), "quarantined dirs are evidence, not GCed"
    assert committed_steps(base) == [10, 40]


def test_gc_debris_direct_call(tmp_path):
    dead = _dead_pid()
    d = tmp_path / f"step_00000001.old-{dead}"
    d.mkdir()
    removed = ckpt_lib.gc_debris(str(tmp_path))
    assert removed == [str(d)] and not d.exists()


# ------------------------------------------- quarantine + fallback

def _corrupt_one_shard(step_path: str):
    """Flip payload bytes of one .npy so its CRC fails but np.load works."""
    files = sorted(f for f in os.listdir(step_path) if f.endswith(".npy"))
    path = os.path.join(step_path, files[0])
    with open(path, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        tail = f.read(4)
        f.seek(-4, os.SEEK_END)
        f.write(bytes(b ^ 0xFF for b in tail))


def test_corrupt_newest_falls_back_with_report(tmp_path):
    base = str(tmp_path)
    _save(base, 10)
    _save(base, 20)
    _corrupt_one_shard(ckpt_lib.step_dir(base, 20))
    with pytest.raises(CorruptCheckpointError, match="checksum"):
        ckpt_lib.restore_sharded(ckpt_lib.step_dir(base, 20), _tree())
    step, tree, rep = restore_with_fallback(base, _tree())
    assert step == 10
    np.testing.assert_array_equal(tree["w"], _tree()["w"])
    assert rep.fell_back and rep.restored_step == 10
    assert [q.step for q in rep.quarantined] == [20]
    assert rep.attempted == [20, 10]
    # quarantined on disk: renamed out of the committed namespace
    assert not os.path.isdir(ckpt_lib.step_dir(base, 20))
    assert os.path.isdir(rep.quarantined[0].quarantined_to)
    assert ckpt_lib.latest_step(base) == 10


def test_truncated_shard_falls_back_too(tmp_path):
    base = str(tmp_path)
    _save(base, 10)
    _save(base, 20)
    sdir = ckpt_lib.step_dir(base, 20)
    files = sorted(f for f in os.listdir(sdir) if f.endswith(".npy"))
    path = os.path.join(sdir, files[0])
    os.truncate(path, os.path.getsize(path) // 2)
    step, _tree_out, rep = restore_with_fallback(base, _tree())
    assert step == 10 and [q.step for q in rep.quarantined] == [20]


def test_unrecoverable_corruption_fails_loudly(tmp_path):
    base = str(tmp_path)
    for s in (10, 20):
        _save(base, s)
        _corrupt_one_shard(ckpt_lib.step_dir(base, s))
    with pytest.raises(CorruptCheckpointError, match="every committed"):
        restore_with_fallback(base, _tree())


def test_no_commit_fails_loudly(tmp_path):
    with pytest.raises(CorruptCheckpointError, match="no committed"):
        restore_with_fallback(str(tmp_path), _tree())


def test_fallback_respects_quarantine_off(tmp_path):
    base = str(tmp_path)
    _save(base, 10)
    _save(base, 20)
    _corrupt_one_shard(ckpt_lib.step_dir(base, 20))
    step, _t, rep = restore_with_fallback(base, _tree(),
                                          quarantine_on_disk=False)
    assert step == 10
    assert rep.quarantined[0].quarantined_to is None
    assert os.path.isdir(ckpt_lib.step_dir(base, 20))  # left in place


def test_walk_committed_max_fallbacks(tmp_path):
    base = str(tmp_path)
    for s in (10, 20, 30):
        _save(base, s)
        _corrupt_one_shard(ckpt_lib.step_dir(base, s))

    def attempt(step, path):
        return ckpt_lib.restore_sharded(path, _tree())

    with pytest.raises(CorruptCheckpointError):
        walk_committed(base, attempt, max_fallbacks=1,
                       quarantine_on_disk=False)


# ------------------------------------ injected faults on the I/O path

def test_transient_read_fault_retried_then_restores(tmp_path):
    base = str(tmp_path)
    _save(base, 10)
    plan = F.FaultPlan([F.FaultSpec("sharded.read", "eio", hit=1)])
    with F.install(plan):
        with pytest.raises(OSError):
            ckpt_lib.restore_sharded(ckpt_lib.step_dir(base, 10), _tree())
    plan = F.FaultPlan([F.FaultSpec("sharded.read", "eio", hit=1)])
    with F.install(plan):
        step, tree = ckpt_lib.restore_sharded(
            ckpt_lib.step_dir(base, 10), _tree(),
            retry=F.RetryPolicy(max_retries=1, base_delay_s=0))
    assert step == 10 and plan.fired


def test_transient_write_fault_retried_whole_protocol(tmp_path):
    base = str(tmp_path)
    plan = F.FaultPlan([F.FaultSpec("sharded.write", "enospc", hit=2)])
    with F.install(plan):
        _save(base, 10, retry=F.RetryPolicy(max_retries=1,
                                            base_delay_s=0))
    assert committed_steps(base) == [10]
    step, tree = ckpt_lib.restore_auto(ckpt_lib.step_dir(base, 10),
                                       _tree())
    np.testing.assert_array_equal(tree["k"], _tree()["k"])


def test_write_fault_without_retry_surfaces_and_commits_nothing(tmp_path):
    base = str(tmp_path)
    plan = F.FaultPlan([F.FaultSpec("sharded.write", "enospc", hit=1)])
    with F.install(plan), pytest.raises(OSError):
        _save(base, 10)
    assert committed_steps(base) == []


def test_async_writer_surfaces_injected_fault_at_join(tmp_path):
    sdir = ckpt_lib.step_dir(str(tmp_path), 10)
    plan = F.FaultPlan([F.FaultSpec("sharded.manifest", "enospc")])
    with F.install(plan):
        t = ckpt_lib.save_sharded(sdir, 10, _tree(), blocking=False)
        with pytest.raises(OSError):
            t.join()
    assert committed_steps(str(tmp_path)) == []


def test_bitflip_post_crc_caught_only_by_reader(tmp_path):
    """bitflip at sharded.written corrupts AFTER the CRC was computed:
    the save commits happily; the reader's checksum is the only
    defense — exactly the case quarantine+fallback exists for."""
    base = str(tmp_path)
    _save(base, 10)
    plan = F.FaultPlan([F.FaultSpec("sharded.written", "bitflip",
                                    hit=1, nbytes=8)], seed=3)
    with F.install(plan):
        _save(base, 20)
    assert committed_steps(base) == [10, 20]   # save saw nothing wrong
    step, _t, rep = restore_with_fallback(base, _tree())
    assert step == 10 and [q.step for q in rep.quarantined] == [20]


# ------------------------------------------------------ legacy format

def test_legacy_manifest_fault_leaves_no_commit(tmp_path):
    from repro_torch import checkpoint as legacy
    sdir = ckpt_lib.step_dir(str(tmp_path), 10)
    plan = F.FaultPlan([F.FaultSpec("legacy.manifest", "enospc")])
    with F.install(plan), pytest.raises(OSError):
        legacy.save(sdir, 10, _tree())
    assert committed_steps(str(tmp_path)) == []


# ------------------------------------------------- launcher flag guards

def _main_with(argv):
    from repro_torch.launch.train import main
    main(["--device", "cpu"] + argv)


def test_launcher_rejects_fallback_without_resume():
    with pytest.raises(SystemExit, match="fallback-on-corrupt"):
        _main_with(["--no-resume", "--fallback-on-corrupt"])


def test_launcher_rejects_retries_without_resume():
    with pytest.raises(SystemExit, match="max-restore-retries"):
        _main_with(["--no-resume", "--max-restore-retries", "3"])


def test_launcher_rejects_negative_retries():
    with pytest.raises(SystemExit, match=">= 0"):
        _main_with(["--max-restore-retries", "-1"])


# ------------------------------------------- namespaced (cluster) plans

def test_plans_to_env_arms_only_matching_job(monkeypatch):
    from repro_torch.faults import plan as plan_mod

    env = F.plans_to_env({
        "j1": F.FaultPlan([F.FaultSpec("p", "eio")], seed=7),
        "j2": F.FaultPlan([F.FaultSpec("q", "enospc")], seed=9),
    })
    monkeypatch.setenv(F.ENV_VAR, env)
    prev = plan_mod._ACTIVE
    try:
        got = F.install_from_env("j1")
        assert got is not None and got.seed == 7
        assert [s.point for s in got.specs] == ["p"]
        assert F.active_plan() is got
        with pytest.raises(OSError):
            F.maybe_fire("p")
    finally:
        plan_mod._ACTIVE = prev


def test_plans_to_env_untargeted_job_arms_nothing(monkeypatch):
    from repro_torch.faults import plan as plan_mod

    env = F.plans_to_env({"j1": F.FaultPlan([F.FaultSpec("p", "eio")])})
    monkeypatch.setenv(F.ENV_VAR, env)
    prev = plan_mod._ACTIVE
    try:
        plan_mod._ACTIVE = None
        assert F.install_from_env("other") is None
        assert F.active_plan() is None
        F.maybe_fire("p")                     # neighbor: must not raise
        # no job id at all (no $REPRO_JOB_ID either): also nothing
        assert F.install_from_env() is None
    finally:
        plan_mod._ACTIVE = prev


def test_install_from_env_job_id_defaults_to_env_var(monkeypatch):
    from repro_torch.faults import plan as plan_mod

    env = F.plans_to_env({"me": F.FaultPlan([F.FaultSpec("p", "eio")])})
    monkeypatch.setenv(F.ENV_VAR, env)
    monkeypatch.setenv(F.JOB_ENV_VAR, "me")
    prev = plan_mod._ACTIVE
    try:
        got = F.install_from_env()
        assert got is not None and [s.point for s in got.specs] == ["p"]
    finally:
        plan_mod._ACTIVE = prev


def test_install_from_env_legacy_format_arms_unconditionally(monkeypatch):
    from repro_torch.faults import plan as plan_mod

    plan = F.FaultPlan([F.FaultSpec("p", "eio")], seed=3)
    monkeypatch.setenv(F.ENV_VAR, plan.to_env())
    prev = plan_mod._ACTIVE
    try:
        got = F.install_from_env("any-job-id")
        assert got is not None and got.seed == 3
    finally:
        plan_mod._ACTIVE = prev


# ------------------------------------------- one plan arms either package

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_one_serialized_plan_arms_either_package(monkeypatch, writer):
    from repro.faults import plan as jplan
    from repro_torch.faults import plan as tplan
    src, dst = (jplan, tplan) if writer == "reference" else (tplan, jplan)
    plan = src.FaultPlan([src.FaultSpec("p", "eio", hit=2, times=2)],
                         seed=5)
    assert src.ENV_VAR == dst.ENV_VAR and src.JOB_ENV_VAR == dst.JOB_ENV_VAR
    monkeypatch.setenv(dst.ENV_VAR, plan.to_env())
    prev = dst._ACTIVE
    try:
        got = dst.install_from_env()
        assert got.seed == 5 and got.to_env() == plan.to_env()
        dst.maybe_fire("p")
        with pytest.raises(OSError):
            dst.maybe_fire("p")
    finally:
        dst._ACTIVE = prev
    env = src.plans_to_env({"j": plan})
    assert env == dst.plans_to_env({"j": dst.FaultPlan.from_env(
        plan.to_env())})


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
def test_file_faults_damage_as_the_reference(tmp_path, kind):
    """The same spec and seed damage the same bytes in either package."""
    from repro.faults import plan as jplan
    from repro_torch.faults import plan as tplan
    arr = np.arange(512, dtype=np.float32)
    out = []
    for i, mod in enumerate((jplan, tplan)):
        path = str(tmp_path / f"x{i}.npy")
        np.save(path, arr)
        p = mod.FaultPlan([mod.FaultSpec("w", kind, nbytes=6)], seed=11)
        with mod.install(p):
            mod.maybe_fire("w", path=path)
        with open(path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


# ------------------------------------ a rank of a gloo save killed

GRID_CHILD = """
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
run_ranks(R.grid_save_ranks, 4, args=(%r, %r, %d), deadline_s=120,
          threads=1)
"""


@pytest.mark.parametrize("point,hit", [("sharded.manifest", 1),
                                       ("sharded.write", 2)],
                         ids=["manifest_rank0", "write_every_rank"])
def test_grid_save_killed_takes_the_job_down(tmp_path, point, hit):
    """SIGKILL one rank (rank 0 at the commit marker; every rank at its
    second file): the job goes down at once, latest_step names the
    previous commit, and the next save of a new job sweeps the dead
    writer's temp dir."""
    from repro_torch.parallel.launch import run_ranks
    from tests import _torch_ranks as R
    base = str(tmp_path)
    res = harness.run_child(GRID_CHILD % (base, point, hit), timeout=200)
    harness.expect_rank_sigkill(res)
    assert ckpt_lib.latest_step(base) == 10
    assert any(".tmp-" in d for d in os.listdir(base))
    step, tree = ckpt_lib.restore_auto(
        ckpt_lib.step_dir(base, 10),
        {"w": np.zeros(64, np.float32), "b": np.float32(0)})
    np.testing.assert_array_equal(tree["w"], np.arange(64,
                                                       dtype=np.float32))
    steps = run_ranks(R.grid_save_ranks, 4, args=(base, None, 30),
                      deadline_s=120, threads=1)
    assert steps == [[10, 30]] * 4
    assert sorted(os.listdir(base)) == ["step_00000010", "step_00000030"]
