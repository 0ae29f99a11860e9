"""The port's simulator side (``repro_torch.core``'s modes, simulator,
metrics, registry, executor and aggregation, and
``repro_torch.configs.paper_workloads``) against the JAX package's, on the
CPU, bitwise.

Two layers:

- the reference's own cases of these modules (``tests/test_simulator.py``,
  ``test_sim_failures.py``, ``test_policy_modes.py``, ``test_registry.py``,
  ``test_trace_replay_golden.py``, ``test_sched_bakeoff_golden.py`` and
  the two schedule/launch cases of ``test_system.py``), each run as
  written against both packages and over its own parameters
  (``tests/_torch_reference.py``);
- the same inputs through both packages, the outputs compared with ``==``
  and by ``repr`` (which tells -0.0 from 0.0 and sees dict order): every
  field of ``SimResult`` over the modes, policies, reconfiguration cost
  models, placements, quotas, failures, ground truth, cluster shapes and
  trace families; the mode comparisons; the registry's failures and
  topologies; the executor's pod specs and transports; aggregation's
  leaf orders, and its layouts against the reference ``Mesh``'s device
  order (8 fake host devices in a subprocess).

The simulator is plain Python floats and numpy random streams, so no
tolerance applies.  ``JobExecutor.launch`` hashes a host id with Python's
``hash``, which differs from process to process: the two packages are
compared within one process and no hash value is pinned.
"""
import dataclasses
import json
import types

import numpy as np
import pytest

from repro.configs import paper_workloads as jpw
from repro.core import aggregation as jagg
from repro.core import executor as jexec
from repro.core import jct_model as jjct
from repro.core import leaves as jleaves
from repro.core import metrics as jmetrics
from repro.core import modes as jmodes
from repro.core import registry as jreg
from repro.core import simulator as jsim
from repro.core import traces as jtraces
from repro_torch.configs import paper_workloads as tpw
from repro_torch.core import aggregation as tagg
from repro_torch.core import executor as texec
from repro_torch.core import jct_model as tjct
from repro_torch.core import leaves as tleaves
from repro_torch.core import metrics as tmetrics
from repro_torch.core import modes as tmodes
from repro_torch.core import registry as treg
from repro_torch.core import simulator as tsim
from repro_torch.core import traces as ttraces
from tests._torch_reference import (PACKAGES, case_params, reference_cases,
                                    run_case)
from tests.conftest import run_multidevice

J = types.SimpleNamespace(sim=jsim, traces=jtraces, jct=jjct, modes=jmodes,
                          metrics=jmetrics, reg=jreg, exec=jexec,
                          leaves=jleaves, agg=jagg)
T = types.SimpleNamespace(sim=tsim, traces=ttraces, jct=tjct, modes=tmodes,
                          metrics=tmetrics, reg=treg, exec=texec,
                          leaves=tleaves, agg=tagg)


def _same(fn):
    """``fn`` of each package: equal, and equal by ``repr``."""
    ref, port = fn(J), fn(T)
    assert repr(port) == repr(ref)
    return ref, port


# ------------------------------------------------ the reference's cases

# file -> the cases of it that hold the control plane (None: all of them);
# test_system.py's SSM and mLSTM property cases hold models
REFERENCE_FILES = {
    "test_simulator": None, "test_sim_failures": None,
    "test_policy_modes": None, "test_registry": None,
    "test_trace_replay_golden": None, "test_sched_bakeoff_golden": None,
    "test_system": ("test_end_to_end_schedule_launch_communicate",
                    "test_one_to_many_spans_gpus_c3_lifted")}
_MODULES = {(n, p): reference_cases(n, p)
            for n in REFERENCE_FILES for p in PACKAGES}


def _cases():
    out = []
    for name, only in REFERENCE_FILES.items():
        mod = _MODULES[(name, "repro")]
        for case in sorted(vars(mod)):
            if not case.startswith("test_") or (only and case not in only):
                continue
            for params in case_params(getattr(mod, case)):
                tag = "-".join(str(v) for v in params.values())
                out.append((name, case, params,
                            f"{name}::{case}" + (f"[{tag}]" if tag else "")))
    return out


CASES = _cases()


def test_reference_files_have_their_cases():
    counts = {n: sum(1 for m, *_ in CASES if m == n)
              for n in REFERENCE_FILES}
    assert counts == {"test_simulator": 12, "test_sim_failures": 12,
                      "test_policy_modes": 10, "test_registry": 11,
                      "test_trace_replay_golden": 9,
                      "test_sched_bakeoff_golden": 18, "test_system": 2}
    # both golden tables run whole
    assert sum(1 for m, c, *_ in CASES
               if c == "test_trace_replay_matches_golden") == len(
        _MODULES[("test_trace_replay_golden", "repro")].GOLDEN)
    assert sum(1 for m, c, *_ in CASES if c == "test_bakeoff_cell_golden") \
        == len(_MODULES[("test_sched_bakeoff_golden", "repro")].GOLDEN)
    # the port's run reads the port's modules, the reference's its own
    port = {n: _MODULES[(n, "repro_torch")] for n in REFERENCE_FILES}
    assert port["test_simulator"].simulate is tsim.simulate
    assert port["test_simulator"].ModeComparison is tmetrics.ModeComparison
    assert port["test_sim_failures"].repack_on_failure.__module__ \
        == "repro_torch.elastic"
    assert port["test_sim_failures"].ckpt_lib.__name__ == "repro_torch.ckpt"
    assert port["test_policy_modes"].DynamicMIG is tmodes.DynamicMIG
    assert port["test_registry"].build_topology is treg.build_topology
    assert port["test_system"].JobExecutor is texec.JobExecutor
    assert _MODULES[("test_simulator", "repro")].simulate is jsim.simulate


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("name,case,params", [c[:3] for c in CASES],
                         ids=[c[3] for c in CASES])
def test_reference_case(name, case, params, package, tmp_path):
    run_case(_MODULES[(name, package)], case, tmp_path, params)


# ------------------------------------------------------ the simulator

def _row(r):
    """Every field of a ``SimResult``, its reconfiguration records as
    tuples."""
    row = {}
    for f in dataclasses.fields(r):
        v = getattr(r, f.name)
        if f.name == "reconfig_events":
            v = [dataclasses.astuple(e) for e in v]
        row[f.name] = v
    return row


def test_result_types_have_the_reference_fields():
    for cls in ("SimResult", "ReconfigRecord", "FailureModel"):
        assert [f.name for f in dataclasses.fields(getattr(tsim, cls))] \
            == [f.name for f in dataclasses.fields(getattr(jsim, cls))]
    assert [f.name for f in dataclasses.fields(tmodes.ReconfigPlan)] \
        == [f.name for f in dataclasses.fields(jmodes.ReconfigPlan)]
    for c in ("RECONFIGURE_S", "CKPT_SAVE_S", "CKPT_LOAD_S",
              "POD_CHURN_S"):
        assert repr(getattr(tmodes, c)) == repr(getattr(jmodes, c))


# measured-shaped handoff records (``HandoffMeasurement.to_dict``), as the
# elastic driver writes them
MEASURED = [dict(save_s=4.6, restore_s=5.7, setup_s=0.2, compile_s=0.31,
                 save_bytes=4_530_000_000, restore_bytes=4_530_000_000),
            dict(save_s=6.5, restore_s=6.3, setup_s=0.8, compile_s=0.05,
                 save_bytes=4_530_000_000, restore_bytes=4_530_000_000),
            dict(save_s=5.1, restore_s=5.9, setup_s=0.4, compile_s=0.12,
                 save_bytes=4_530_000_000, restore_bytes=4_530_000_000)]


def _cost(P, kind):
    if kind == "measured":
        return P.jct.ReconfigCostModel.from_measurements(MEASURED)
    if kind == "measured_coord":
        return P.jct.ReconfigCostModel.from_measurements(MEASURED,
                                                         coord_s=2.5)
    return P.jct.ReconfigCostModel(mode=kind)


def _trace(P, spec):
    family, seed = spec[0], spec[1]
    if family == "fleet":
        return P.traces.generate_fleet_trace(spec[2], seed=seed,
                                             mean_interarrival=10.0,
                                             max_size=spec[3])
    src, size_dist, mix, kw = spec[2:]
    return P.traces.generate_trace(
        P.traces.TraceCategory(src, size_dist, mix), seed=seed, **kw)


GOLDEN_TRACE = ("cat", 7, "philly", "balanced", "mixed",
                dict(double=False, max_size=4))
TRACES = {
    "golden": GOLDEN_TRACE,
    "helios_large_train": ("cat", 1, "helios_earth", "large", "train",
                           dict(double=True, max_size=4)),
    "venus_small_mixed": ("cat", 3, "helios_venus", "small", "mixed",
                          dict(double=False, max_size=None)),
    "alibaba_balanced_inference": ("cat", 0, "alibaba", "balanced",
                                   "inference", dict(max_size=4)),
    "philly_tenants": ("cat", 2, "philly", "balanced", "mixed",
                       dict(max_size=4, n_tenants=3)),
    "fleet": ("fleet", 5, 300, 4),
}

# (trace, mode, simulate keywords), each named
FM_FAIL = dict(mtbf_s=3 * 3600.0, ckpt_interval_s=600.0)
SIM_GRID = {}
for _t in ("golden", "helios_large_train", "venus_small_mixed",
           "alibaba_balanced_inference"):
    for _m in ("FM", "SM", "DM"):
        for _p in ("fifo", "backfill"):
            SIM_GRID[f"{_t}/{_m}/{_p}"] = (_t, _m, dict(policy=_p))
SIM_GRID.update({
    "golden/DM/fifo/handoff": ("golden", "DM",
                               dict(reconfig_mode="handoff")),
    "golden/DM/backfill/handoff": ("golden", "DM", dict(
        policy="backfill", reconfig_mode="handoff")),
    "golden/DM/fifo/drain_model": ("golden", "DM",
                                   dict(reconfig_mode="drain",
                                        reconfig_cost="drain")),
    "golden/DM/fifo/measured": ("golden", "DM",
                                dict(reconfig_cost="measured")),
    "golden/DM/backfill/measured": ("golden", "DM", dict(
        policy="backfill", reconfig_mode="handoff",
        reconfig_cost="measured")),
    "helios_large_train/DM/fifo/measured_coord": (
        "helios_large_train", "DM", dict(reconfig_cost="measured_coord")),
    "venus_small_mixed/DM/backfill/handoff": (
        "venus_small_mixed", "DM", dict(policy="backfill",
                                        reconfig_mode="handoff")),
    "golden/FM/fifo/frag_aware": ("golden", "FM",
                                  dict(placement="frag_aware")),
    "golden/FM/backfill/frag_aware": ("golden", "FM", dict(
        policy="backfill", placement="frag_aware", n_hosts=4)),
    "golden/FM/fifo/packed": ("golden", "FM", dict(round_robin=False)),
    "golden/FM/backfill/depth3": ("golden", "FM", dict(
        policy="backfill", backfill_depth=3)),
    "philly_tenants/FM/backfill/quotas": ("philly_tenants", "FM", dict(
        policy="backfill", tenant_quotas={"t0": 4, "t1": 6})),
    "philly_tenants/DM/fifo/quotas": ("philly_tenants", "DM", dict(
        tenant_quotas={"t2": 4})),
    "philly_tenants/SM/backfill/quotas": ("philly_tenants", "SM", dict(
        policy="backfill", tenant_quotas={"t0": 4, "t1": 4, "t2": 4})),
    "golden/DM/fifo/failures": ("golden", "DM",
                                dict(failure_model=FM_FAIL)),
    "golden/DM/fifo/failures_handoff": ("golden", "DM", dict(
        failure_model=FM_FAIL, reconfig_cost="measured")),
    "golden/FM/backfill/failures": ("golden", "FM", dict(
        policy="backfill", failure_model=FM_FAIL, seed=3)),
    "golden/SM/fifo/failures_bounded": ("golden", "SM", dict(
        failure_model=dict(mtbf_s=900.0, ckpt_interval_s=300.0,
                           max_failures=4))),
    "helios_large_train/FM/fifo/failures_4hosts": (
        "helios_large_train", "FM", dict(failure_model=FM_FAIL,
                                         n_hosts=4, seed=1)),
    "golden/FM/fifo/ground_truth": ("golden", "FM",
                                    dict(ground_truth=True, seed=4)),
    "golden/DM/backfill/ground_truth": ("golden", "DM", dict(
        policy="backfill", ground_truth=True, seed=9)),
    "golden/DM/fifo/ground_truth_failures": ("golden", "DM", dict(
        ground_truth=True, failure_model=FM_FAIL, seed=2)),
    "golden/SM/fifo/uncalibrated": ("golden", "SM", dict(calibrate=False)),
    "golden/FM/fifo/2x4": ("golden", "FM", dict(n_hosts=2,
                                                gpus_per_host=4)),
    "golden/DM/fifo/3x1": ("golden", "DM", dict(n_hosts=3,
                                                gpus_per_host=1)),
    "fleet/FM/backfill": ("fleet", "FM", dict(policy="backfill",
                                              n_hosts=8)),
    "fleet/FM/fifo/frag_aware": ("fleet", "FM", dict(
        placement="frag_aware", n_hosts=8)),
    "fleet/DM/fifo": ("fleet", "DM", dict(n_hosts=8)),
    "fleet/DM/backfill/measured": ("fleet", "DM", dict(
        policy="backfill", n_hosts=8, reconfig_cost="measured")),
    "fleet/SM/backfill/quotas": ("fleet", "SM", dict(
        policy="backfill", n_hosts=8, tenant_quotas={"t0": 4, "t3": 5})),
})


def _simulate(P, trace, mode, kw):
    kw = dict(kw)
    if isinstance(kw.get("reconfig_cost"), str):
        kw["reconfig_cost"] = _cost(P, kw["reconfig_cost"])
    if "failure_model" in kw:
        kw["failure_model"] = P.sim.FailureModel(**kw["failure_model"])
    jobs = _trace(P, TRACES[trace])
    before = [repr(dataclasses.astuple(j)) for j in jobs]
    r = P.sim.simulate(jobs, mode, **kw)
    # simulate replays copies: the caller's jobs are untouched
    assert [repr(dataclasses.astuple(j)) for j in jobs] == before
    return r


@pytest.mark.parametrize("name", sorted(SIM_GRID))
def test_simulate_matches_reference(name):
    trace, mode, kw = SIM_GRID[name]
    ref, port = (_row(_simulate(P, trace, mode, kw)) for P in (J, T))
    assert port == ref
    assert repr(port) == repr(ref)


def test_grid_exercises_each_path():
    """The grid above reaches drains, handoffs, failures and repacks."""
    def row(name):
        trace, mode, kw = SIM_GRID[name]
        return _simulate(T, trace, mode, kw)
    assert row("golden/DM/fifo/drain_model").n_drains > 0
    assert row("golden/DM/fifo/measured").n_handoffs > 0
    hand = row("golden/DM/fifo/failures_handoff")
    assert hand.n_failures > 0 and hand.n_recoveries > 0
    assert row("golden/SM/fifo/failures_bounded").n_failures <= 4
    assert row("philly_tenants/FM/backfill/quotas").n_jobs == len(
        _trace(T, TRACES["philly_tenants"]))


@pytest.mark.parametrize("kw", [
    dict(mode="DM", placement="frag_aware"),
    dict(mode="SM", placement="frag_aware"),
    dict(mode="FM", placement="packed"),
    dict(mode="DM", reconfig_mode="drain", reconfig_cost="measured"),
    dict(mode="DM", reconfig_mode="handoff", reconfig_cost="drain"),
    dict(mode="DM", reconfig_mode="instant"),
    dict(mode="XM")], ids=lambda kw: "-".join(map(str, kw.values())))
def test_simulate_refusals_match_reference(kw):
    def refusal(P):
        k = dict(kw)
        mode = k.pop("mode")
        if isinstance(k.get("reconfig_cost"), str):
            k["reconfig_cost"] = _cost(P, k["reconfig_cost"])
        try:
            P.sim.simulate(_trace(P, GOLDEN_TRACE), mode, **k)
        except Exception as e:     # noqa: BLE001 — compared across packages
            return type(e).__name__, str(e)
        return None
    ref, _ = _same(refusal)
    assert ref is not None


def test_failure_model_refusals_match_reference():
    for kw in (dict(mtbf_s=0.0), dict(mtbf_s=1.0, ckpt_interval_s=0.0),
               dict(mtbf_s=1.0, max_failures=0)):
        def refusal(P):
            try:
                P.sim.FailureModel(**kw)
            except ValueError as e:
                return str(e)
        assert _same(refusal)[0] is not None


def test_double_run_is_bit_identical_in_the_port():
    """One replay run twice: an equal result, field for field."""
    for name in ("golden/DM/fifo/measured", "golden/DM/fifo/failures",
                 "golden/FM/fifo/ground_truth"):
        trace, mode, kw = SIM_GRID[name]
        a, b = (_row(_simulate(T, trace, mode, kw)) for _ in range(2))
        assert repr(a) == repr(b)


# -------------------------------------------------------------- modes

def _plan_row(res):
    if res is None:
        return None
    if isinstance(res, (jmodes.ReconfigPlan, tmodes.ReconfigPlan)):
        return ("plan", res.host_id, res.gpu_id, res.job.job_id,
                res.affected_jobs, res.duration, res.base_duration)
    return ("placement", res.job_id, res.transport, res.one_to_one,
            [(i.uuid, i.profile, i.host_id, i.gpu_id) for i in
             res.instances])


@pytest.mark.parametrize("mode", ["FM", "SM", "DM", "FM-frag"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mode_decisions_match_reference(mode, seed):
    """A stream of place / apply / release decisions on one cluster."""
    def decisions(P):
        rng = np.random.default_rng(seed)
        name, kw = (("FM", dict(placement="frag_aware"))
                    if mode == "FM-frag" else (mode, {}))
        m = P.modes.make_mode(name, **kw)
        c = P.leaves.Cluster(n_hosts=2, gpus_per_host=2)
        m.setup(c)
        if name == "DM":
            m.register_inference(["j3", "j7"])
        live, out = [], []
        for k in range(24):
            if live and rng.random() < 0.35:
                pl = live.pop(int(rng.integers(len(live))))
                m.release(pl, c)
                out.append(("release", pl.job_id))
                continue
            size = int(rng.choice([1, 2, 3, 4, 6, 8]))
            kind = "inference" if k in (3, 7) else "train"
            job = P.sim.Job(f"j{k}", "resnet50", kind, size, 64, 900.0)
            res = m.try_place(job, c)
            out.append(_plan_row(res))
            if isinstance(res, P.modes.ReconfigPlan):
                res = m.apply_reconfig(res, c)
                out.append(_plan_row(res))
            if res is not None:
                live.append(res)
        out.append(sorted(i.uuid for i in c.idle_instances()))
        return out
    _same(decisions)


# ------------------------------------------------------------ metrics

def test_mode_comparisons_match_reference():
    def ratios(P):
        out = []
        for seed in range(3):
            jobs = P.traces.generate_trace(
                P.traces.TraceCategory("helios_earth", "large", "train"),
                seed=seed, double=True, max_size=4)
            fm, dm, sm = (P.sim.simulate(jobs, m) for m in ("FM", "DM",
                                                            "SM"))
            out += [P.metrics.ModeComparison.of(fm, dm),
                    P.metrics.ModeComparison.of(sm, dm)]
        # a zero denominator gives nan, as in the reference
        empty = P.sim.SimResult("DM", 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0,
                                {}, {})
        nan = P.metrics.ModeComparison.of(fm, empty)
        return ([dataclasses.astuple(r) for r in out],
                dataclasses.astuple(nan),
                P.metrics.summarize(out), P.metrics.summarize(out[:1]))
    ref, _ = _same(ratios)
    assert all(np.isnan(x) for x in ref[1])


def test_paper_workloads_match_reference():
    for name in jpw.__all__:
        assert repr(getattr(tpw, name)) == repr(getattr(jpw, name))
    assert tpw.__all__ == jpw.__all__


# ----------------------------------------------------------- registry

def _peers(P, rng, n):
    """``n`` ranks on 1-2 hosts of 1-3 GPUs, some sharing an instance,
    some without a MIG id."""
    out = []
    for r in range(n):
        host = 100 + int(rng.integers(2))
        bus = f"00:{0x4B + int(rng.integers(3)):02X}:00.0"
        mig = (None if rng.random() < 0.15
               else f"MIG-{int(rng.integers(4 * n))}")
        out.append(P.reg.PeerInfo(r, 0, host, r + 1, bus, mig))
    return out


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:         # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(6))
def test_registry_matches_reference(seed):
    def registry(P):
        rng = np.random.default_rng(seed)
        out = []
        for n in (1, 2, 3, 5, 8):
            peers = _peers(P, rng, n)
            out.append([dataclasses.astuple(p) for p in peers])
            for aware in (False, True):
                out.append(_outcome(P.reg.peer_discovery, peers,
                                    mig_aware=aware))
                nodes = P.reg.build_topology(peers,
                                             synthetic_labeling=aware)
                out.append([dataclasses.astuple(x) for x in nodes])
                for synth in (False, True):
                    got = _outcome(P.reg.form_communicator, peers,
                                   mig_aware=aware,
                                   synthetic_labeling=synth)
                    if got[0] == "ok":
                        got = ("ok", [dataclasses.astuple(x)
                                      for x in got[1]])
                    out.append(got)
            out.append([P.reg.select_transport(a, b) for a in peers
                        for b in peers])
        for label in ("00:4B:00.0", "00:4B:00.1", "00:4C:00.7", "4B.12",
                      "no-dot"):
            out.append((P.reg.restore_bus_id(label),
                        P.reg.is_synthetic(label),
                        _outcome(P.reg.driver_call_guard, label)))
        for env in ({}, {"NVIDIA_VISIBLE_DEVICES": "MIG-x"},
                    {"NVIDIA_VISIBLE_DEVICES": ""},
                    {"NCCL_MIG_ID": "MIG-y"}):
            out.append(dataclasses.astuple(P.reg.env_to_peer(
                3, env, host_hash=7, pid_hash=9,
                pcie_bus_id="00:4B:00.0")))
        return out
    _same(registry)


# ----------------------------------------------------------- executor

@pytest.mark.parametrize("shape,sizes", [
    ((1, 2), (4, 1, 2, 6)), ((2, 2), (8, 3, 2)), ((1, 1), (1, 2, 4)),
    ((3, 2), (6, 6, 1, 4))], ids=["1x2", "2x2", "1x1", "3x2"])
def test_executor_matches_reference(shape, sizes):
    """FM places each job; the executor's pod spec, peers and transports,
    MIG-aware and stock, are the reference's (but for the entry point,
    which is each package's own launcher)."""
    def launches(P):
        c = P.leaves.Cluster(n_hosts=shape[0], gpus_per_host=shape[1])
        fm = P.modes.FlexMIG()
        fm.setup(c)
        ex = P.exec.JobExecutor()
        out = []
        for k, size in enumerate(sizes):
            job = P.sim.Job(f"job-{k}", "bert-base", "train", size, 32,
                            1200.0)
            pl = fm.try_place(job, c)
            if pl is None:
                out.append(None)
                continue
            pod = ex.pod_spec(job, pl)
            out.append((pod.job_id, pod.env, pod.n_workers))
            for aware in (True, False):
                got = _outcome(ex.launch, job, pl, mig_aware=aware)
                if got[0] == "ok":
                    la = got[1]
                    got = ("ok", la.pod.env, [dataclasses.astuple(p)
                                              for p in la.peers],
                           la.transports)
                out.append(got)
        return out
    ref, _ = _same(launches)
    assert any(r is not None and r[0] == "ok" for r in ref)
    assert texec.PodSpec("j", {}, 1).entrypoint \
        == "python -m repro_torch.launch.train"


# -------------------------------------------------------- aggregation

def _leaf_sets():
    """Named leaf sets of 8: one host, several hosts, uneven hosts, two
    pods; each in a shuffled order."""
    rng = np.random.default_rng(0)
    sets = {
        "one_host": [(0, 0, c) for c in range(8)],
        "four_hosts": [(0, h, c) for h in range(4) for c in range(2)],
        "uneven": [(0, 0, 0), (0, 0, 1), (0, 0, 2), (0, 1, 3), (0, 2, 0),
                   (0, 2, 1), (0, 3, 2), (0, 3, 3)],
        "two_pods": [(p, h, c) for p in range(2) for h in range(2)
                     for c in range(2)],
    }
    return {k: [v[i] for i in rng.permutation(len(v))]
            for k, v in sets.items()}


LEAF_SETS = _leaf_sets()
SHAPES = {"8": ((8,), ("data",)), "2x4": ((2, 4), ("pod", "data")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ORDERS = ("grouped", "round_robin", "packed")
PERM = [3, 0, 6, 1, 7, 2, 5, 4]      # explicit devices: a permutation


def _leaves(P, spec):
    return [P.leaves.TpuLeaf(*t) for t in spec]


def test_leaf_orders_match_reference():
    def orders(P):
        out = []
        rng = np.random.default_rng(1)
        for name, spec in LEAF_SETS.items():
            leaves = _leaves(P, spec)
            out.append([l.uuid for l in P.agg.round_robin_order(leaves)])
            out.append([l.uuid for l in P.agg.packed_order(leaves)])
            out.append([l.uuid for l in P.agg.grouped_order(leaves)])
            for n in (1, 3, 8, 9):
                busy = {leaves[int(i)].uuid
                        for i in rng.choice(8, 2, replace=False)}
                for b in (None, busy):
                    out.append(_outcome(
                        lambda: [l.uuid for l in P.agg.choose_leaves(
                            leaves, n, busy=b)]))
        return out
    _same(orders)


REF_MESHES = """
import json, jax
from repro.core.aggregation import leaves_to_mesh
from repro.core.leaves import TpuLeaf
spec = json.loads(%r)
out = {}
for name, leaves in spec["sets"].items():
    leaves = [TpuLeaf(*t) for t in leaves]
    for sname, (shape, axes) in spec["shapes"].items():
        for order in spec["orders"]:
            for explicit in (False, True):
                devs = ([jax.devices()[p] for p in spec["perm"]]
                        if explicit else None)
                m = leaves_to_mesh(leaves, tuple(shape), tuple(axes),
                                   devices=devs, order=order)
                out[f"{name}/{sname}/{order}/{explicit}"] = dict(
                    ids=[d.id for d in m.devices.flat],
                    shape=list(m.devices.shape),
                    axes=list(m.axis_names))
print("MESHES " + json.dumps(out))
"""


def test_layouts_match_the_reference_meshes():
    """Each layout holds, at every position, the device the reference's
    ``Mesh`` holds there (8 fake host devices; a rank ``k`` of the port
    stands for the reference's ``jax.devices()[k]``)."""
    spec = dict(sets=LEAF_SETS, shapes=SHAPES, orders=ORDERS, perm=PERM)
    out = run_multidevice(REF_MESHES % json.dumps(spec), n_devices=8)
    ref = json.loads(out.split("MESHES ", 1)[1])
    assert len(ref) == len(LEAF_SETS) * len(SHAPES) * len(ORDERS) * 2
    for key, want in ref.items():
        name, sname, order, explicit = key.split("/")
        shape, axes = SHAPES[sname]
        lay = tagg.leaves_to_mesh(
            _leaves(T, LEAF_SETS[name]), shape, axes,
            devices=PERM if explicit == "True" else None, order=order)
        assert isinstance(lay, tagg.LeafLayout)
        assert list(lay.devices.flat) == want["ids"], key
        assert list(lay.devices.shape) == want["shape"], key
        assert list(lay.axis_names) == want["axes"], key
        assert lay.shape == dict(zip(axes, shape))
    with pytest.raises(AssertionError):
        tagg.leaves_to_mesh(_leaves(T, LEAF_SETS["one_host"]), (3, 2),
                            ("a", "b"))
    with pytest.raises(ValueError, match="axis names"):
        tagg.leaves_to_mesh(_leaves(T, LEAF_SETS["one_host"]), (2, 4),
                            ("a",))
