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
    logged."""
    from repro_torch import optim, train
    from repro_torch.data import DataConfig
    model = _model(spec, torch.float32)
    tcfg = train.TrainerConfig(n_steps=3, log_every=1, accum=spec["accum"],
                               cross_pod_mode="hier_bucketed_zero1")
    out = train.Trainer(model, optim.AdamWConfig(**spec["ocfg"]["a"]), tcfg,
                        DataConfig(**spec["data"]), device="cpu",
                        grid=grid).run(seed=None)
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
