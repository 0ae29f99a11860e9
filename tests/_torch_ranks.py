"""Rank functions of the port's multi-rank tests.

``repro_torch.parallel.launch.run_ranks`` spawns its ranks, and spawn
imports the module of the function it runs: these live here, apart from
the test modules, so that a rank imports torch and the port and not jax.
Each takes (rank, world, spec) and returns plain numbers, numpy arrays and
digests for the parent to hold against the reference.
"""
import hashlib

import numpy as np
import torch

# the grids of tests/test_bucketing.py::test_bucketed_schedule_matches_flat
GRIDS = {"data1": ((1,), ("data",)), "data2": ((2,), ("data",)),
         "pod2_data2": ((2, 2), ("pod", "data")), "data4": ((4,), ("data",)),
         "pod2": ((2,), ("pod",))}
# (compress bits, error feedback)
SETTINGS = {"f32": (0, False), "bf16": (16, False), "int8": (8, False),
            "int8_ef": (8, True)}


def to_torch(a: np.ndarray, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(dtype) if dtype is not None else t


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        h.update(name.encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replica_grid(shape, names, rank, world):
    """The grid of ``shape`` this rank belongs to, among world / n replicas
    of it over consecutive ranks (every rank builds all of them)."""
    from repro_torch.parallel.mesh import make_rank_grid
    n = int(np.prod(shape))
    mine = None
    for k in range(world // n):
        g = make_rank_grid(shape, names, ranks=range(k * n, (k + 1) * n))
        if g.member:
            mine = g
    return mine


def collective_ranks(rank, world, spec):
    """Every grid of GRIDS and setting of SETTINGS: the bucketed reduce
    (serial and overlapped), its norm and gathered tree, the per-tensor
    hierarchical mean and the deterministic reduce, on the inputs of grid
    rank i (``spec["inputs"][i]``)."""
    from repro_torch.collectives import bucketing as BK
    from repro_torch.collectives import deterministic as det
    from repro_torch.collectives.hierarchical import hier_all_reduce_mean
    dtypes = {n: getattr(torch, d) for n, d in spec["dtypes"].items()}
    out = {}
    for gname, (shape, names) in GRIDS.items():
        grid = replica_grid(shape, names, rank, world)
        i = grid.rank
        fast, slow = grid.axis("data"), grid.axis("pod")
        nf = fast.size if fast is not None else 1
        tree = {n: to_torch(a, dtypes[n])
                for n, a in spec["inputs"][gname][i].items()}
        layout = BK.plan_buckets(tree, bucket_bytes=spec["bucket_bytes"],
                                 align=nf, family=None)
        buckets = BK.flatten_to_buckets(layout, tree)
        sync = tuple(grid.axis(a) for a in names)
        for sname, (bits, ef) in SETTINGS.items():
            res = spec["residuals"][gname][i] if ef else None
            key = f"{gname}/{sname}"
            for overlap in (False, True):
                if ef:
                    shards, new_res = BK.hier_reduce_bucket_shards(
                        buckets, fast_axis=fast, slow_axis=slow,
                        compress_bits=bits, overlap=overlap,
                        residuals=[to_torch(r) for r in res["hier"]])
                else:
                    shards = BK.hier_reduce_bucket_shards(
                        buckets, fast_axis=fast, slow_axis=slow,
                        compress_bits=bits, overlap=overlap)
                tag = "_overlap" if overlap else ""
                out[f"{key}/shards{tag}"] = [s.numpy() for s in shards]
                if ef:
                    out[f"{key}/residuals{tag}"] = [r.numpy()
                                                    for r in new_res]
            out[f"{key}/gnorm"] = BK.shard_global_norm(shards, fast).numpy()
            full = BK.all_gather_buckets(shards, fast_axis=fast)
            back = BK.unflatten_from_buckets(layout, full,
                                             dtype=torch.float32)
            out[f"{key}/tree"] = {n: t.numpy() for n, t in back.items()}
            if not ef:
                out[f"{key}/per_tensor"] = {
                    n: hier_all_reduce_mean(
                        t.float(), fast_axis=fast, slow_axis=slow,
                        compress_bits=bits).numpy()
                    for n, t in tree.items()}
            dfull, dres = det.det_reduce_bucket_full(
                buckets, sync_axes=sync, compress_bits=bits,
                residuals=[to_torch(r) for r in res["det"]] if ef else None)
            out[f"{key}/det_full"] = [b.numpy() for b in dfull]
            if ef:
                out[f"{key}/det_residuals"] = [r.numpy() for r in dres]
        out[f"{gname}/grid_rank"] = i
        out[f"{gname}/reductions"] = _reductions(grid, tree["a"], sync)
    return out


def _reductions(grid, x, sync):
    """The named collectives over the grid's axes, on one f32 tensor."""
    from repro_torch import parallel as PX
    from repro_torch.collectives.hierarchical import make_hier_all_reduce
    out = {"psum": PX.psum(x, sync).numpy(),
           "pmean": PX.pmean(x, sync).numpy(),
           "pmax": PX.pmax(x, sync).numpy(),
           "hier_mean": make_hier_all_reduce(grid)(x).numpy(),
           "flat_mean": make_hier_all_reduce(grid, flat=True)(x).numpy(),
           "index": {a: PX.axis_index(grid.axis(a)) for a in grid.axis_names},
           "size": {a: PX.axis_size(grid.axis(a)) for a in grid.axis_names}}
    for a in grid.axis_names:
        out[f"gather_{a}"] = PX.all_gather(x, grid.axis(a)).numpy()
        out[f"gather_flat_{a}"] = PX.all_gather_flat(
            x.reshape(-1), grid.axis(a)).numpy()
    return out


# ---------------------------------------------------------------- training

def _model(spec, dtype):
    from repro_torch.models.registry import build_model
    model = build_model(spec["cfg"], device="cpu", seed=None, remat=False,
                        dtype=dtype)
    model.load_state_dict({n: to_torch(a) for n, a in spec["weights"].items()},
                          strict=True)
    return model


def _batches(spec, n):
    from repro_torch.data import DataConfig, SyntheticCorpus
    corpus = SyntheticCorpus(DataConfig(**spec["data"]))
    return [{k: to_torch(v) for k, v in corpus.batch(i).items()}
            for i in range(n)]


def _run(spec, run, grid):
    """One training run on ``grid``: per step loss, grad norm and the
    digest of this rank's params; the digest of its residuals at the end."""
    from repro_torch import optim, train
    dtype = getattr(torch, run.get("dtype", "float32"))
    model = _model(spec, dtype)
    ocfg = optim.AdamWConfig(**spec["ocfg"][run.get("ocfg", "a")])
    opts = dict(run.get("opts", {}))
    state_opts = {k: opts[k] for k in ("bucket_bytes", "slow_error_feedback",
                                       "deterministic_reduce") if k in opts}
    params, state = train.init_train_state(
        model, ocfg, seed=None, grid=grid, cross_pod_mode=run["mode"],
        **state_opts)
    step = train.make_train_step(model, ocfg, accum=spec["accum"],
                                 device="cpu", grid=grid,
                                 cross_pod_mode=run["mode"], **opts)
    rows = []
    for b in _batches(spec, run["steps"]):
        params, state, m = step(params, state, b)
        rows.append((m["loss"].item(), m["grad_norm"].item(),
                     digest(params)))
    out = {"loss": [r[0] for r in rows], "grad_norm": [r[1] for r in rows],
           "digests": [r[2] for r in rows]}
    if isinstance(state, train.EFState):
        res = state.residuals
        out["residual_digest"] = digest({str(k): r
                                         for k, r in enumerate(res)})
        out["residual_abs_sum"] = float(sum(r.abs().sum() for r in res))
    return out


def _trainer(spec, grid):
    """``Trainer`` on ``grid`` from the bridged weights, every step
    logged: ``spec["trainer_steps"]`` steps (3 by default)."""
    from repro_torch import optim, train
    from repro_torch.data import DataConfig
    model = _model(spec, torch.float32)
    tcfg = train.TrainerConfig(n_steps=spec.get("trainer_steps", 3),
                               log_every=1, accum=spec["accum"],
                               cross_pod_mode="hier_bucketed_zero1")
    out = train.Trainer(model, optim.AdamWConfig(**spec["ocfg"]["a"]), tcfg,
                        DataConfig(**spec["data"]), device="cpu",
                        grid=grid).run(seed=None, resume=False)
    return {"loss": [h["loss"] for h in out["history"]],
            "digest": digest(out["params"])}


def sync_train_ranks(rank, world, spec):
    """Every run of ``spec["runs"]`` on its grid; then the Trainer."""
    grids = {}
    out = {}
    for name, run in spec["runs"].items():
        shape, names = run.get("grid", ((2, 2), ("pod", "data")))
        key = (tuple(shape), tuple(names))
        if key not in grids:
            grids[key] = replica_grid(shape, names, rank, world)
        out[name] = _run(spec, run, grids[key])
    out["trainer"] = _trainer(spec, grids[((2, 2), ("pod", "data"))])
    return out


def fail_on_rank_one(rank, world):
    return 1 / (1 - rank)


def sleep(rank, world):
    import time
    time.sleep(60)


# ----------------------------------------------------------- checkpoints

def files_digest(path):
    """{file name: sha256 of its bytes} of a directory."""
    import os
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _zero1(spec, grid, det, model=None):
    """(model, params, state, layout) of the ZeRO-1 + error-feedback state
    on ``grid`` from the bridged weights (the state as init gives it)."""
    from repro_torch import optim, train
    model = model or _model(spec, getattr(torch, spec["dtype"]))
    ocfg = optim.AdamWConfig(**spec["ocfg"]["a"])
    kw = dict(bucket_bytes=spec["bucket_bytes"], deterministic_reduce=det)
    params, state = train.init_train_state(
        model, ocfg, seed=None, grid=grid,
        cross_pod_mode="hier_bucketed_zero1", slow_error_feedback=True,
        **kw)
    layout = train.make_bucket_layout(params, grid,
                                      bucket_bytes=spec["bucket_bytes"],
                                      deterministic=det)
    return model, params, state, layout


def _truth_state(truth, params, state, grid):
    """This rank's boxes of the reference's saved (truth) state."""
    from repro_torch import optim, train
    fast, slow = grid.axis("data"), grid.axis("pod")
    F, i = fast.size, fast.index

    def box(a, parts, idx):
        n = a.shape[0] // parts
        return to_torch(a[idx * n:(idx + 1) * n].copy())

    opt = optim.BucketedOptState(
        step=int(truth["step"]),
        **{k: tuple(box(a, F, i) for a in truth[k])
           for k in ("mu", "nu", "master")})
    res = tuple(box(a, grid.size, grid.rank) for a in truth["residuals"])
    return params, train.EFState(opt, res)


def _restore_on(spec, name, grid, model):
    """The reference's checkpoint ``name`` restored on ``grid``: this
    rank's boxes and the params' digest."""
    from repro_torch import ckpt
    from repro_torch.ckpt.state import (restore_policy, state_from_tree,
                                        state_tree)
    det = name.startswith("det")
    _, params, state, layout = _zero1(spec, grid, det, model)
    template = state_tree(params, state, grid=grid)
    step, tree = ckpt.restore_auto(spec["dirs"][name], template,
                                   policy=restore_policy(template),
                                   layout=layout, mesh=grid)
    params, state = state_from_tree(tree, list(params))
    return {"step": step, "opt_step": state.opt.step,
            "params": digest(params),
            **{k: [t.numpy() for t in getattr(state.opt, k)]
               for k in ("mu", "nu", "master")},
            "residuals": [t.numpy() for t in state.residuals],
            "fast_index": grid.axis("data").index}


def _continuation(spec, grids, ef):
    """Bitwise resharding: 6 steps on (2,2) against 3 on (2,2), a sharded
    save, a restore on (4,1) and on (1,4) and 3 more steps on each."""
    import os
    from repro_torch import ckpt, optim, train
    from repro_torch.ckpt.state import state_from_tree, state_tree
    ocfg = optim.AdamWConfig(**spec["ocfg"]["a"])
    opts = dict(bucket_bytes=spec["bucket_bytes"],
                deterministic_reduce=True, slow_error_feedback=ef)
    batches = _batches(spec, 6)

    def setup(grid):
        # a model of its own from the bridged weights: the step updates
        # the params, which share the model's storage, in place
        model = _model(spec, torch.float32)
        params, state = train.init_train_state(
            model, ocfg, seed=None, grid=grid,
            cross_pod_mode="hier_bucketed_zero1", **opts)
        step = train.make_train_step(
            model, ocfg, accum=spec["accum"], device="cpu", grid=grid,
            cross_pod_mode="hier_bucketed_zero1",
            slow_compress_bits=8 if ef else 0, **opts)
        layout = train.make_bucket_layout(
            params, grid, bucket_bytes=spec["bucket_bytes"],
            deterministic=True)
        return params, state, step, layout

    def steps(step, params, state, lo, hi):
        losses = []
        for b in batches[lo:hi]:
            params, state, m = step(params, state, b)
            losses.append(m["loss"].item())
        return losses, params, state

    params, state, step, layout = setup(grids[(2, 2)])
    ref, ref_p, _ = steps(step, params, state, 0, 6)
    params, state, step, layout = setup(grids[(2, 2)])
    first, params, state = steps(step, params, state, 0, 3)
    sdir = ckpt.step_dir(spec["base"] + ("_ef" if ef else ""), 3)
    ckpt.save_sharded(sdir, 3, state_tree(params, state, grid=grids[(2, 2)]),
                      layout=layout, mesh=grids[(2, 2)])
    # no rank wrote a full bucket: each file of a flat state is 1/F of it
    man = ckpt.read_manifest(sdir)
    extents = {k: sorted({s.index[0][1] - s.index[0][0] for s in e.shards}
                         | {e.shape[0]})
               for k, e in man.leaves.items() if e.kind == "sharded"}
    out = {"ref": ref, "first": first, "extents": extents,
           "files": sorted(os.listdir(sdir))}
    for shape in ((4, 1), (1, 4)):
        params, state, step, layout2 = setup(grids[shape])
        template = state_tree(params, state, grid=grids[shape])
        rstep, tree = ckpt.restore_sharded(sdir, template, layout=layout2,
                                           mesh=grids[shape])
        params, state = state_from_tree(tree, list(params))
        cont, params, _ = steps(step, params, state, 3, 6)
        out[shape] = {"step": rstep, "cont": cont,
                      "bitwise": digest(params) == digest(ref_p),
                      "local": (state.opt if ef else state).master[0]
                      .shape[0]}
    return out


def _grid_trainer(spec, grid):
    """The Trainer on ``grid`` (zero1, async sharded saves every 2 steps):
    an uninterrupted 4-step run, 2 steps and resume to 4, and the gathered
    format; then a corrupt newest step and the fallback."""
    import os
    from repro_torch import ckpt, optim, train
    from repro_torch.data import DataConfig

    def run(n, ckpt_dir, resume, every=2, **kw):
        model = _model(spec, torch.float32)
        tcfg = train.TrainerConfig(
            n_steps=n, log_every=1, accum=spec["accum"], ckpt_every=every,
            ckpt_dir=ckpt_dir, cross_pod_mode="hier_bucketed_zero1",
            bucket_bytes=spec["bucket_bytes"], **kw)
        out = train.Trainer(model, optim.AdamWConfig(**spec["ocfg"]["a"]),
                            tcfg, DataConfig(**spec["data"]), device="cpu",
                            grid=grid).run(seed=None, resume=resume)
        return ([h["loss"] for h in out["history"]], digest(out["params"]),
                out["recovery"])

    base = spec["trainer_base"]
    ref = run(4, base + "/ref", False, every=100)
    out = {"ref": ref[:2]}
    for fmt, sharded in (("sharded", True), ("gathered", False)):
        d = f"{base}/{fmt}"
        run(2, d, False, save_sharded=sharded)
        got = run(4, d, True, every=100)
        out[fmt] = {"losses": got[0], "digest": got[1],
                    "steps": ckpt.committed_steps(d)}
    # corrupt step 4 of the sharded run on one rank's file only: every
    # rank falls back to step 2, rank 0 alone quarantines
    d = f"{base}/fallback"
    run(4, d, False)
    grid_group_barrier(grid)
    sdir = ckpt.step_dir(d, 4)
    if grid.rank == 0:
        name = sorted(f for f in os.listdir(sdir) if ".s1." in f)[0]
        with open(os.path.join(sdir, name), "r+b") as f:
            f.seek(-4, os.SEEK_END)
            tail = f.read(4)
            f.seek(-4, os.SEEK_END)
            f.write(bytes(b ^ 0xFF for b in tail))
    grid_group_barrier(grid)
    got = run(4, d, True, every=100, fallback_on_corrupt=True)
    rep = got[2]
    out["fallback"] = {"losses": got[0], "digest": got[1],
                       "restored": rep.restored_step,
                       "quarantined": [(q.step, q.quarantined_to)
                                       for q in rep.quarantined],
                       "steps": ckpt.committed_steps(d)}
    return out


def grid_group_barrier(grid):
    import torch.distributed as dist
    dist.barrier(group=grid.group)


def ckpt_ranks(rank, world, spec):
    """The checkpoint tests' gloo job: the reference's ZeRO-1 checkpoints
    restored on (2,2), (4,1) and (1,4); the same state saved by the port
    on (2,2); bitwise resharding; the Trainer on a grid."""
    import numpy as np
    from repro_torch import ckpt
    from repro_torch.ckpt.state import state_tree
    grids = {s: replica_grid(s, ("pod", "data"), rank, world)
             for s in ((2, 2), (4, 1), (1, 4))}
    model = _model(spec, getattr(torch, spec["dtype"]))
    out = {"restore": {}, "saved": {}}
    for name in spec["dirs"]:
        for shape, grid in grids.items():
            out["restore"][(name, shape)] = _restore_on(spec, name, grid,
                                                        model)
        truth = dict(np.load(spec["truth"][name]))
        truth = {"step": truth["step"],
                 **{k: [truth[f"{k}{b}"] for b in range(int(truth["nb"]))]
                    for k in ("mu", "nu", "master", "residuals")}}
        _, params, state, layout = _zero1(spec, grids[(2, 2)],
                                          name.startswith("det"), model)
        params, state = _truth_state(truth, params, state, grids[(2, 2)])
        sdir = spec["port_dirs"][name]
        ckpt.save_sharded(sdir, int(truth["step"]),
                          state_tree(params, state, grid=grids[(2, 2)]),
                          layout=layout, mesh=grids[(2, 2)])
        if rank == 0:
            out["saved"][name] = files_digest(sdir)
    out["continuation"] = {ef: _continuation(spec, grids, ef)
                           for ef in (False, True)}
    out["trainer"] = _grid_trainer(spec, grids[(2, 2)])
    return out


def grid_save_ranks(rank, world, base, point, hit):
    """A (2,2) grid saves step 10, then step 20 with ``point`` armed to
    SIGKILL this process at arrival ``hit`` (``point`` None: no fault,
    step ``hit`` instead)."""
    import numpy as np
    from repro_torch import ckpt
    from repro_torch.checkpoint import Shard
    from repro_torch.faults import FaultPlan, FaultSpec, install
    grid = replica_grid((2, 2), ("pod", "data"), rank, world)
    fast, slow = grid.axis("data"), grid.axis("pod")
    full = np.arange(64, dtype=np.float32)
    tree = {"w": Shard(torch.from_numpy(full[fast.index * 32:
                                              (fast.index + 1) * 32].copy()),
                       2, fast.index, slow.index == 0, ("data",)),
            "b": np.float32(2.0)}
    if point is None:
        ckpt.save_sharded(ckpt.step_dir(base, hit), hit, tree, mesh=grid)
        return ckpt.committed_steps(base)
    ckpt.save_sharded(ckpt.step_dir(base, 10), 10, tree, mesh=grid)
    with install(FaultPlan([FaultSpec(point, "crash", hit=hit)])):
        ckpt.save_sharded(ckpt.step_dir(base, 20), 20, tree, mesh=grid)
    return "SURVIVED"


# ------------------------------------------------------- the elastic driver

def driver_ranks(rank, world, spec):
    """Every run of ``spec["runs"]`` through ``ElasticDriver`` in this
    rank: losses, grids, measurements, the params' digest."""
    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.elastic_driver import ElasticDriver, ReconfigEvent
    from repro_torch.faults import install_from_env
    install_from_env()          # a kill harness's plan, when it set one
    out = {}
    for name, run in spec["runs"].items():
        # each run from the bridged weights: a run's in-place steps update
        # the model's own params
        model = _model(spec, torch.float32)
        drv = ElasticDriver(
            model, optim.AdamWConfig(**spec["ocfg"]["a"]),
            DataConfig(**spec["data"]), base_dir=run["base"],
            bucket_bytes=spec["bucket_bytes"], accum=spec["accum"],
            mode=run.get("mode", "handoff"),
            error_feedback=run.get("ef", False), device="cpu")
        res = drv.run(spec["n_steps"],
                      [ReconfigEvent(step=s, mesh_shape=tuple(m))
                       for s, m in run["schedule"]],
                      initial_shape=(2, 2), seed=None,
                      resume=run.get("resume", False),
                      final_save=run.get("final_save", False))
        out[name] = {"losses": res.losses, "shapes": res.mesh_shapes,
                     "start": res.start_step,
                     "measurements": [m.to_dict() for m in res.measurements],
                     "digest": digest(res.params),
                     "state_bytes": res.state_bytes,
                     "restored": (res.recovery.restored_step
                                  if res.recovery is not None else None)}
    return out


# ------------------------------------------------------ the cluster worker

def bridged_segment_ranks(rank, world, spec, weights):
    """The cluster worker's segment (``repro_torch.cluster.worker``, its
    model, optimizer, data and driver) from ``weights`` bridged from the
    reference's init, where the worker draws them from the spec's seed:
    losses and the params' digest."""
    import torch
    from repro_torch.cluster.worker import segment_config, segment_driver
    from repro_torch.models.registry import build_model
    model = build_model(segment_config(spec), device="cpu", seed=None,
                        remat=False)
    model.load_state_dict(weights, strict=True)
    drv = segment_driver(spec, model, torch.device("cpu"))
    res = drv.run(spec["run_to"], (), initial_shape=tuple(spec["shape"]),
                  seed=None, final_save=False)
    return {"losses": res.losses, "digest": digest(res.params)}


def dump_spec(spec, path):
    """A rank spec to a file, for a child process (pickle)."""
    import pickle
    with open(path, "wb") as f:
        pickle.dump(spec, f)


def load_spec(path):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


# ------------------------------------------------- tensor parallelism

def _tp_model(cfg, weights):
    """The dense model of ``cfg`` in f32 with remat (the reference's
    default), from ``weights``."""
    from repro_torch.models.registry import build_model
    model = build_model(cfg, device="cpu", seed=None, dtype=torch.float32,
                        remat=True)
    model.load_state_dict({n: to_torch(a) for n, a in weights.items()},
                          strict=True)
    return model


class _Shapes:
    """Records, while on, the heads that reach the attention core and the
    width of the MLP's gated hidden (``F.silu``'s input)."""

    def __init__(self):
        import torch.nn.functional as F
        from repro_torch.models import layers as L
        self.attention, self.ff, self.on = [], [], False
        full, silu = L.full_attention, F.silu

        def attention(q, k, v, **kw):
            if self.on:
                self.attention.append((q.shape[2], k.shape[2]))
            return full(q, k, v, **kw)

        def gate(x, *a, **kw):
            if self.on:
                self.ff.append(x.shape[-1])
            return silu(x, *a, **kw)

        L.full_attention, F.silu = attention, gate


def _tp_run(spec, cfg_name, shape, accum, grid, shapes):
    """One configuration on one grid: two ``xla`` steps; the gradient
    (``make_grid_loss_and_grad``) of each step's batch at the reference's
    params of that step, the rank's shares on the way; a prefill and a few
    decode steps."""
    from repro_torch import optim, train
    from repro_torch.serve import local_rows, make_prefill_step, \
        make_serve_step
    from repro_torch.sharding import make_rules
    c = spec["configs"][cfg_name]
    cfg, weights = c["cfg"], c["weights"]
    batches = [{k: to_torch(v) for k, v in b.items()} for b in c["batches"]]
    model = _tp_model(cfg, weights)
    ocfg = optim.AdamWConfig(**spec["ocfg"])
    params, state = train.init_train_state(model, ocfg, seed=None, grid=grid)
    step = train.make_train_step(model, ocfg, accum=accum, device="cpu",
                                 grid=grid)
    out = {"loss": [], "grad_norm": [], "digests": []}
    for b in batches:
        params, state, m = step(params, state, b)
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
        out["digests"].append(digest(params))
    out["params"] = {n: p.numpy().copy() for n, p in params.items()}
    # each step's gradient from the reference's params at that step
    out["grads"] = []
    for i, (w, b) in enumerate(zip(c["step_weights"], batches)):
        model = _tp_model(cfg, w)
        shapes.attention.clear()
        shapes.ff.clear()
        shapes.on = True
        loss, grads = train.make_grid_loss_and_grad(
            model, accum=accum, grid=grid)(
                {n: p.detach() for n, p in model.named_parameters()}, b)
        shapes.on = False
        out["grads"].append((loss.item(),
                             {n: g.numpy() for n, g in grads.items()}))
        if i == 0:
            out["attention"] = sorted(set(shapes.attention))
            out["ff"] = sorted(set(shapes.ff))
    # serving from the bridged weights again (the steps moved the model's)
    model = _tp_model(cfg, weights)
    tokens = to_torch(c["prompt"])
    out["prefill"] = make_prefill_step(model, device="cpu",
                                       grid=grid)(tokens).numpy()
    serve = make_serve_step(model, device="cpu", grid=grid)
    rows = local_rows(tokens.shape[0], make_rules(grid))
    cache = model.init_cache(rows.stop - rows.start, c["max_seq"])
    out["decode"] = [serve(cache, tokens[:, i:i + 1], i)[0].numpy()
                     for i in range(c["decode_steps"])]
    return out


def _tp_trainer(spec, grid, n_steps, ckpt_dir, *, ckpt_every, resume):
    from repro_torch import optim, train
    from repro_torch.data import DataConfig
    c = spec["configs"]["base"]
    model = _tp_model(c["cfg"], c["weights"])
    tcfg = train.TrainerConfig(n_steps=n_steps, ckpt_every=ckpt_every,
                               ckpt_dir=ckpt_dir, log_every=1,
                               accum=spec["trainer_accum"],
                               async_ckpt=False)
    out = train.Trainer(model, optim.AdamWConfig(**spec["ocfg"]), tcfg,
                        DataConfig(**spec["trainer_data"]), device="cpu",
                        grid=grid).run(seed=None, resume=resume)
    return {"loss": [h["loss"] for h in out["history"]],
            "digest": digest(out["params"]),
            "params": {n: p.numpy().copy()
                       for n, p in out["params"].items()}}


def tp_ranks(rank, world, spec):
    """Every run of ``spec["runs"]`` (configuration, grid shape, accum) on
    its (data, model) grid; then the Trainer on (2, 2): a run that saves
    at step 1 and its resume to step 2."""
    from repro_torch.parallel.mesh import make_rank_grid
    grids = {tuple(s): make_rank_grid(s, ("data", "model"))
             for s in ((1, 4), (2, 2))}
    shapes = _Shapes()
    out = {"coords": {s: (g.axis("data").index if g.axis("data") else 0,
                          g.axis("model").index) for s, g in grids.items()}}
    for cfg_name, shape, accum in spec["runs"]:
        out[(cfg_name, tuple(shape))] = _tp_run(
            spec, cfg_name, shape, accum, grids[tuple(shape)], shapes)
    g22, d = grids[(2, 2)], spec["ckpt_dir"]
    out["trainer"] = {
        "saved": _tp_trainer(spec, g22, 1, d, ckpt_every=1, resume=False),
        "resumed": _tp_trainer(spec, g22, 2, d, ckpt_every=100,
                               resume=True)}
    return out


# ------------------------------------------ the sequence-sharded decode

def _tree_to_torch(tree):
    """A nested dict of (numpy array, dtype name) -> torch tensors; bf16
    arrives as its uint16 bits."""
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    a, dtype = tree
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _seq_attention(spec, rules):
    """The port's ``sharded_decode_attention`` on this rank's slice of the
    spec's cache at each position; and on a cache whose length the drop
    rule keeps whole, every rank holding all of it."""
    from repro_torch.models.attention import sharded_decode_attention
    from repro_torch.sharding import part
    a = spec["attention"]
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    seq = part(k.shape[1], "kv_seq", rules)
    out = {"seq": (seq.lo, seq.hi, seq.n)}
    out["sharded"] = [sharded_decode_attention(
        q, k[:, seq.slice], v[:, seq.slice], p, seq_len=k.shape[1],
        rules=rules).numpy() for p in a["positions"]]
    kd, vd = (torch.from_numpy(a["drop"][n]) for n in ("k", "v"))
    out["drop"] = [sharded_decode_attention(
        q, kd, vd, p, seq_len=kd.shape[1], rules=rules).numpy()
        for p in a["drop"]["positions"]]
    return out


def _changed(now, before):
    """The positions (dim 2 of every leaf of a KV cache) at which ``now``
    differs from ``before`` in any bit."""
    diff = (now.view(torch.int16) != before.view(torch.int16))
    return sorted(set(torch.nonzero(diff.flatten(0, 1).any(0).any(-1).any(
        -1)).flatten().tolist()))


def _seq_run(spec, name, flags, shape, grid):
    """A model's decode steps on this rank's block of the spec's global
    cache, each from the cache as it was before the first (the entry a
    step writes, and the recurrent states it moves, put back): the rank's
    logits block, the positions of its slice each step changed, and the
    entries it wrote."""
    from repro_torch.models.attention import SEQ_LEN
    from repro_torch.models.registry import build_model
    from repro_torch.serve import make_serve_step
    from repro_torch.sharding import part, use_rules
    m = spec["models"][name]
    model = build_model(m["cfg"], device="cpu", seed=None,
                        dtype=torch.float32, remat=False)
    model.load_state_dict({n: to_torch(a) for n, a in m["weights"].items()},
                          strict=True)
    step = make_serve_step(model, device="cpu", grid=grid, **flags)
    with use_rules(step.rules):
        cache = model.init_cache(*m["batch_seq"])
    kv = [k for k in ("k", "v", "attn_k", "attn_v") if k in cache]
    out = {"shapes": {k: tuple(cache[k].shape) for k in kv},
           "seq_len": cache[SEQ_LEN],
           "seq": tuple(getattr(part(m["batch_seq"][1], "kv_seq",
                                     step.rules), a) for a in ("lo", "hi")),
           "logits": [], "changed": [], "entries": [], "states": []}
    # the rank's block of the global cache: its rows and kv_seq slice of
    # the K/V leaves, the recurrent states whole
    rows = part(m["batch_seq"][0], "kv_batch", step.rules).slice
    seq = slice(*out["seq"])
    for k, t in _tree_to_torch(m["cache"]).items():
        if isinstance(t, dict):
            for n, s in t.items():
                cache[k][n].copy_(s)
        else:
            cache[k].copy_(t[:, rows, seq])
    pristine = {k: v.clone() for k, v in cache.items() if k != SEQ_LEN
                and not isinstance(v, dict)}
    states = {k: {n: t.clone() for n, t in v.items()}
              for k, v in cache.items() if isinstance(v, dict)}
    lo = out["seq"][0]
    for pos, tokens in zip(m["positions"], m["tokens"]):
        logits, cache = step(cache, torch.from_numpy(tokens), pos)
        out["logits"].append(logits.numpy().copy())
        out["changed"].append({k: _changed(cache[k], pristine[k])
                               for k in kv})
        out["states"].append(digest({f"{k}.{n}": t for k, tree in
                                     states.items() for n, t in
                                     cache[k].items()}))
        if out["seq"][0] <= pos < out["seq"][1]:
            out["entries"].append({k: cache[k][:, :, pos - lo].float()
                                   .numpy().copy() for k in kv})
        else:
            out["entries"].append(None)
        for k, t in pristine.items():
            cache[k].copy_(t)
        for k, tree in states.items():
            for n, t in tree.items():
                cache[k][n].copy_(t)
    return out


def seq_decode_ranks(rank, world, spec):
    """The port's flash-decode on 4 ranks: the attention alone under each
    of ``spec["attention"]["grids"]``' rules, then every run of
    ``spec["runs"]`` (model, rule flags, grid shape) through
    ``make_serve_step``."""
    from repro_torch.parallel.mesh import make_rank_grid
    from repro_torch.sharding import make_rules
    grids = {tuple(s): make_rank_grid(s, ("data", "model"))
             for s in ((1, 4), (2, 2), (4, 1))}
    out = {"coords": {s: (g.axis("data").index if g.axis("data") else 0,
                          g.axis("model").index if g.axis("model") else 0)
                      for s, g in grids.items()}}
    for key, flags, shape in spec["attention"]["grids"]:
        out[("attention", key)] = _seq_attention(
            spec, make_rules(grids[tuple(shape)], **flags))
    for name, flags, shape in spec["runs"]:
        out[(name, tuple(shape))] = _seq_run(spec, name, flags, shape,
                                             grids[tuple(shape)])
    return out
