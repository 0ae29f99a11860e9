"""Training step factory and training loop of the port (counterpart of
``repro/train.py``).

``make_train_step`` builds step(params, opt_state, batch) -> (params,
opt_state, metrics) with microbatch gradient accumulation over an f32 view
of the parameters, then AdamW (``optim.apply``), which updates the state
in place as the reference's donated step does.  Parameters are a dict of
tensors by name (``init_train_state``) that share the model's storage, so
a step moves the model's own weights too; the model is called on them
through ``torch.func.functional_call``.  Per-layer remat is the model's
(``TransformerLM.remat``).

Every ``cross_pod_mode`` of the reference is here (``CROSS_POD_MODES``).
On a rank grid (``parallel.mesh.RankGrid``; each rank a process of a gloo
job, ``parallel.launch``) every rank calls the step on the same global
batch and keeps its rows, as the reference's ``shard_map`` over the sync
axes gives them.  The manual-sync modes (``hier``, ``hier_bucketed``,
``hier_bucketed_zero1``) sync the gradients through
``collectives.hierarchical`` and ``collectives.bucketing``: reduce-scatter
over the fast axis (``data``, host shared memory), the 1/F shard across
the slow axis (``pod``), all-gather over the fast axis.  The ``"xla"``
mode also runs on a ``(data, model)`` grid, under the rules of
``repro_torch.sharding``: rows over ``data``, the dense model
tensor-parallel over ``model`` (:func:`make_grid_loss_and_grad`).

``Trainer`` runs the step over ``SyntheticCorpus`` batches with the
reference's prefetch, heartbeat, straggler record and history, periodic
checkpoints (sharded or gathered, async), and resume with retries and the
corrupt-step fallback; on a grid each rank runs its own ``Trainer`` and
the ranks save and restore together (``repro_torch.ckpt``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch import optim
from repro_torch import parallel as PX
from repro_torch.collectives import bucketing
from repro_torch.collectives import deterministic as det
from repro_torch.collectives.hierarchical import (flat_all_reduce_mean,
                                                  hier_all_reduce_mean)
from repro_torch.data import DataConfig, Prefetcher, SyntheticCorpus
from repro_torch.elastic import HeartbeatMonitor, StragglerDetector
from repro_torch.models.registry import (check_on_device, grid_rules,
                                         resolve_device)
from repro_torch.parallel.collectives import STATS
from repro_torch.parallel.mesh import (Axis, RankGrid, axes_size,
                                       grad_sync_axes)
from repro_torch.sharding import batch_axes, tensor_axes, use_rules

Tree = Dict[str, torch.Tensor]

MANUAL_SYNC_MODES = ("hier", "hier_bucketed", "hier_bucketed_zero1")
BUCKETED_SYNC_MODES = ("hier_bucketed", "hier_bucketed_zero1")
CROSS_POD_MODES = ("xla", "compressed") + MANUAL_SYNC_MODES


class EFState(NamedTuple):
    """Optimizer state + int8 error-feedback residuals.

    ``residuals`` holds, per bucket, the part of this rank's (fast-axis
    reduce-scattered) gradient shard the int8 slow hop could not
    represent, carried across steps so the quantization noise telescopes
    (``collectives.compression.compressed_psum_mean_ef``).  Quantization
    error is per-rank state: each rank keeps its own.
    """

    opt: Any                       # OptState | BucketedOptState
    residuals: Tuple[torch.Tensor, ...]


def _split_micro(batch: Tree, accum: int) -> Tree:
    """(B, ...) -> (accum, B // accum, ...): microbatch i takes rows
    [i·B/accum, (i+1)·B/accum)."""
    return {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))
            for k, v in batch.items()}


class _LossAndGrad(nn.Module):
    """Runs the model's loss and its backward in one call, so that both run
    under the tensors ``functional_call`` substitutes for the parameters:
    remat's recompute in the backward reads the parameters again."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Tree, leaves):
        loss, _ = self.model.loss(batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)


def make_loss_and_grad(model: nn.Module, *, accum: int):
    """Returns fn(params, batch) -> (loss, grads): the mean loss over
    ``accum`` microbatches and the mean of their f32 gradients.

    Differentiates with respect to an f32 view of the params (each leaf
    cast back to its storage dtype inside the loss, so the forward is
    unchanged), so gradients materialise and accumulate in f32: each
    microbatch's gradient of a bf16 leaf is not rounded to bf16 before
    accumulation (the reference's accum-invariance)."""
    wrapper = _LossAndGrad(model)

    def fn(params: Tree, batch: Tree) -> Tuple[torch.Tensor, Tree]:
        micro = _split_micro(batch, accum)
        names = list(params)
        params32 = [params[n].detach().float().requires_grad_()
                    for n in names]
        grads = [torch.zeros_like(p) for p in params32]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params32[0].device)
        for i in range(accum):
            mb = {k: v[i] for k, v in micro.items()}
            cast = {f"model.{n}": q.to(params[n].dtype)
                    for n, q in zip(names, params32)}
            loss, g = torch.func.functional_call(wrapper, cast,
                                                 (mb, params32))
            for acc, gi in zip(grads, g):
                acc += gi
            loss_sum += loss
            # the next microbatch's casts and gradients replace these
            del cast, g
        inv = 1.0 / accum
        return loss_sum * inv, {n: g * inv for n, g in zip(names, grads)}

    return fn


def _fast_size(grid: Optional[RankGrid]) -> int:
    fast_axis, _ = grad_sync_axes(grid)
    return grid.shape[fast_axis] if (grid is not None and fast_axis) else 1


def make_bucket_layout(params_or_shapes, grid: Optional[RankGrid] = None, *,
                       bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
                       deterministic: bool = False,
                       family: str = "dense") -> bucketing.BucketLayout:
    """The bucket layout the bucketed train modes derive for this grid.

    Alignment is the fast-axis size so reduce-scatter divides every bucket
    evenly; ``deterministic=True`` aligns instead to
    ``lcm(fast, DETERMINISTIC_ALIGN)``, so the padded bucket sizes are the
    same for every grid factorization whose fast size divides the
    constant.  ``params_or_shapes`` is the port's tensors by name (weights,
    or meta tensors for shapes alone); the layout is the reference's
    (``collectives.bucketing``).
    """
    fast = _fast_size(grid)
    align = det.det_align(fast) if deterministic else fast
    return bucketing.plan_buckets(params_or_shapes, bucket_bytes=bucket_bytes,
                                  align=align, family=family)


def init_slow_residuals(params_or_shapes, grid: Optional[RankGrid] = None, *,
                        bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
                        deterministic: bool = False, family: str = "dense"
                        ) -> Tuple[torch.Tensor, ...]:
    """This rank's zero error-feedback residuals for
    ``slow_error_feedback=True``: one flat f32 tensor per bucket of the
    layout the train step derives, the shape of the rank's fast-axis
    reduce-scattered bucket shard (the reference's global ``S * bucket``
    array sharded over (slow, fast)).  With ``deterministic=True`` each
    rank quantizes its own full-bucket contribution, so its residual is a
    whole bucket (the reference's ``R * bucket``, sharded): invariant under
    grid re-factorization."""
    layout = make_bucket_layout(params_or_shapes, grid,
                                bucket_bytes=bucket_bytes,
                                deterministic=deterministic, family=family)
    device = next(iter(params_or_shapes.values())).device
    n = 1 if deterministic else _fast_size(grid)
    return tuple(torch.zeros(c // n, dtype=torch.float32, device=device)
                 for c in layout.bucket_sizes)


def wrap_ef_state(params, opt_state, grid: Optional[RankGrid] = None, *,
                  bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
                  deterministic: bool = False,
                  family: str = "dense") -> EFState:
    """An optimizer state with zero error-feedback residuals, for
    ``slow_error_feedback=True``."""
    return EFState(opt_state, init_slow_residuals(
        params, grid, bucket_bytes=bucket_bytes,
        deterministic=deterministic, family=family))


def init_sharded_zero1(ocfg: optim.AdamWConfig, params: Tree,
                       layout: bucketing.BucketLayout,
                       grid: Optional[RankGrid] = None
                       ) -> optim.BucketedOptState:
    """This rank's ZeRO-1 state: its contiguous 1/F slice of every bucket
    (F the fast axis's size), built one bucket at a time, so the rank
    never holds the full-model f32 state that ZeRO-1 exists to avoid."""
    assert ocfg.use_master, "bucketed ZeRO-1 state requires f32 masters"
    fast_axis, _ = grad_sync_axes(grid)
    ax = grid.axis(fast_axis) if grid is not None else None
    nf, idx = PX.axis_size(ax), PX.axis_index(ax)
    master = []
    for b, c in enumerate(layout.bucket_sizes):
        full = bucketing.flatten_bucket(layout, params, b)
        size = c // nf
        master.append(full[idx * size:(idx + 1) * size].clone()
                      if nf > 1 else full)
        del full
    return optim.BucketedOptState(
        step=0, mu=tuple(torch.zeros_like(m) for m in master),
        nu=tuple(torch.zeros_like(m) for m in master),
        master=tuple(master))


class _SyncGrid(NamedTuple):
    """A step's view of its grid: the fast and slow axes (None when absent
    or when the grid has one rank), the sync axes outer to inner, their
    rank count and this rank's linear index over them."""

    fast: Optional[Axis]
    slow: Optional[Axis]
    axes: Tuple[Axis, ...]
    n: int
    index: int


def _sync_grid(grid: Optional[RankGrid],
               axes: Tuple[str, ...] = ("pod", "data")) -> _SyncGrid:
    """The step's view of the grid axes named in ``axes`` (the batch's):
    its rows split over them, its gradients and loss mean-reduced over
    them."""
    names = tuple(a for a in (grid.axis_names if grid is not None else ())
                  if a in axes)
    n = axes_size(grid, names)
    if n == 1:
        # degenerate (single-rank) grid: no collective runs
        return _SyncGrid(None, None, (), 1, 0)
    if not grid.member:
        raise ValueError(f"this process is not a rank of {grid}")
    sync = tuple(grid.axis(a) for a in names)
    index = 0
    for ax in sync:
        index = index * ax.size + ax.index
    return _SyncGrid(grid.axis("data") if "data" in names else None,
                     grid.axis("pod") if "pod" in names else None, sync, n,
                     index)


def _local_rows(batch: Tree, sg: _SyncGrid) -> Tree:
    """Rank r's rows [r·B/R, (r+1)·B/R) of the global batch, as the
    reference's shard_map over ``P(sync_axes)`` gives them."""
    if sg.n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % sg.n:
            raise ValueError(f"global batch {v.shape[0]} does not split "
                             f"over {sg.n} ranks")
        b = v.shape[0] // sg.n
        out[k] = v[sg.index * b:(sg.index + 1) * b]
    return out


def _timed(key: str, device: torch.device, fn, *args):
    """fn(*args), its time (the device synchronised) added to the
    collectives' ``STATS`` under ``key``."""
    t0 = time.perf_counter()
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    STATS.add(key, time.perf_counter() - t0)
    return out


def _make_manual_sync_step(model: nn.Module, ocfg: optim.AdamWConfig, *,
                           accum: int, grid: Optional[RankGrid], mode: str,
                           bucket_bytes: int, slow_compress_bits: int,
                           overlap: bool, slow_error_feedback: bool,
                           deterministic_reduce: bool,
                           device: torch.device):
    """The manual-sync steps (``repro/train.py:237-455``), run by every rank
    of ``grid`` on the global batch, each keeping its rows.

    With no grid (or a 1-rank one) every collective is the identity and the
    same code runs locally.  ``overlap`` pipelines consecutive buckets'
    syncs (bitwise-identical results, ``hier_reduce_bucket_shards``).
    ``slow_error_feedback`` carries int8 quantization residuals across
    steps; the step's opt-state argument is then an :class:`EFState`.
    ``deterministic_reduce`` swaps the hierarchical reduce for the
    grid-factorization-invariant gather + fixed-tree fold
    (``collectives.deterministic``): losses, grad norms and updates are
    then bitwise identical across every (pod, data) factorization of the
    same rank count.

    The reference checks its mesh here (``grad_sync_axes`` and
    ``_check_manual_sync_rules``, ``repro/train.py:217-234``): a grid with
    a ``model`` axis above 1 is refused, as params cannot stay replicated
    under tensor parallelism inside a manual sync.
    """
    grad_sync_axes(grid)
    sg = _sync_grid(grid)
    ef, dt = slow_error_feedback, deterministic_reduce
    lg = layout = blg = None
    if mode == "hier":
        lg = make_loss_and_grad(model, accum=accum)
    else:
        layout = make_bucket_layout(dict(model.named_parameters()), grid,
                                    bucket_bytes=bucket_bytes,
                                    deterministic=dt,
                                    family=model.cfg.family)
        blg = bucketing.make_bucket_loss_and_grad(model, layout,
                                                  accum=accum)

    def mean_loss(loss):
        if not sg.axes:
            return loss
        if dt:
            return det.det_mean(loss, sg.axes)
        return PX.psum(loss, sg.axes) / sg.n

    def reduce_buckets(gbuckets, residuals):
        """The (optionally pipelined, optionally EF) per-bucket reduce ->
        (shards, new_residuals); residuals are ``()`` without EF."""
        out = bucketing.hier_reduce_bucket_shards(
            gbuckets, fast_axis=sg.fast, slow_axis=sg.slow,
            compress_bits=slow_compress_bits, overlap=overlap,
            residuals=residuals if ef else None)
        return out if ef else (out, ())

    def det_reduce(gbuckets, residuals):
        """Deterministic reduce -> (full buckets, gnorm, new_residuals):
        the grad norm is local arithmetic on the full meaned buckets, so
        both are bitwise grid-factorization-invariant."""
        full, new_res = det.det_reduce_bucket_full(
            gbuckets, sync_axes=sg.axes, compress_bits=slow_compress_bits,
            residuals=residuals if ef else None)
        return full, det.det_global_norm(full), new_res

    def bucket_grads(params, batch):
        return _timed("loss_and_grad", device, blg,
                      bucketing.flatten_to_buckets(layout, params), batch)

    def hier_step(params, opt_state, batch):
        loss, grads = _timed("loss_and_grad", device, lg, params, batch)
        if sg.axes:
            grads = {n: hier_all_reduce_mean(
                g, fast_axis=sg.fast, slow_axis=sg.slow,
                compress_bits=slow_compress_bits) for n, g in grads.items()}
        params, opt_state, om = _timed("optimizer", device, optim.apply,
                                       ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": mean_loss(loss), **om}

    def bucketed_step(params, opt_state, batch):
        inner_opt, residuals = ((opt_state.opt, opt_state.residuals) if ef
                                else (opt_state, ()))
        loss, gbuckets = bucket_grads(params, batch)
        if dt:
            full, gnorm, new_res = det_reduce(gbuckets, residuals)
        else:
            shards, new_res = reduce_buckets(gbuckets, residuals)
            gnorm = bucketing.shard_global_norm(shards, sg.fast)
            full = bucketing.all_gather_buckets(shards, fast_axis=sg.fast)
        del gbuckets
        grads = bucketing.unflatten_from_buckets(layout, full,
                                                 dtype=torch.float32)
        params, inner_opt, om = _timed(
            "optimizer", device, lambda: optim.apply(
                ocfg, params, grads, inner_opt, gnorm=gnorm))
        opt_state = EFState(inner_opt, new_res) if ef else inner_opt
        return params, opt_state, {"loss": mean_loss(loss), **om}

    def zero1_step(params, state, batch):
        opt_state, residuals = ((state.opt, state.residuals) if ef
                                else (state, ()))
        # forward from the (replicated) storage params, not from an
        # all-gather of the masters: params are the previous step's
        # gathered masters cast to storage dtype, and the forward casts
        # the buckets to storage dtype anyway, so loss and grads are
        # bit-identical, and the fast tier carries one full-model gather
        # per step (updated params) instead of two
        loss, gbuckets = bucket_grads(params, batch)
        if dt:
            full, gnorm, new_res = det_reduce(gbuckets, residuals)
            shards = det.det_fast_shards(full, sg.fast)
        else:
            shards, new_res = reduce_buckets(gbuckets, residuals)
            gnorm = bucketing.shard_global_norm(shards, sg.fast)
        del gbuckets
        new_state, om = _timed("optimizer", device, lambda: optim.apply_flat(
            ocfg, shards, opt_state, gnorm=gnorm))
        new_pb = bucketing.all_gather_buckets(new_state.master,
                                              fast_axis=sg.fast)
        # the gathered masters go into the params' own storage
        bucketing.unflatten_into(layout, new_pb, params)
        del new_pb
        if ef:
            new_state = EFState(new_state, new_res)
        return params, new_state, {"loss": mean_loss(loss), **om}

    body = {"hier": hier_step, "hier_bucketed": bucketed_step,
            "hier_bucketed_zero1": zero1_step}[mode]

    def step(params, opt_state, batch):
        return body(params, opt_state, _local_rows(batch, sg))

    return step


def make_train_step(model: nn.Module, ocfg: optim.AdamWConfig, *,
                    accum: int = 1, device=None,
                    grid: Optional[RankGrid] = None,
                    cross_pod_mode: str = "xla",
                    bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
                    slow_compress_bits: int = 0, overlap: bool = False,
                    slow_error_feedback: bool = False,
                    deterministic_reduce: bool = False):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"}) on ``device`` (the card unless the caller
    passes ``device="cpu"``), where the model must lie.  ``batch`` is the
    global batch; on a rank grid every rank is given the same one and
    trains on its rows.

    ``cross_pod_mode``: ``"xla"`` is accumulated loss-and-grad, then
    AdamW; on a grid of more than one rank the gradients and the loss are
    made whole and mean-reduced over its batch axes first
    (:func:`make_grid_loss_and_grad`).  It runs under the grid's rules,
    ``sharding.make_rules(grid)``: on a ``(data, model)`` grid the dense
    model is tensor-parallel over ``model``, while params and AdamW state
    stay whole on every rank, the reference ``Trainer``'s layout.
    ``"compressed"`` is the same step on a grid of one pod, and refused on
    more than one, as in the reference.  ``"hier"``, ``"hier_bucketed"`` and
    ``"hier_bucketed_zero1"`` are the manual-sync modes, with the
    reference's options: ``overlap`` (bucketed modes) pipelines bucket
    i+1's fast reduce-scatter under bucket i's slow hop, bitwise identical;
    ``slow_compress_bits`` 16 or 8 compresses the slow hop;
    ``slow_error_feedback`` (bucketed modes, with 8 bits) carries each
    rank's int8 residual across steps, the state then an :class:`EFState`
    (:func:`wrap_ef_state`); ``deterministic_reduce`` (bucketed modes, not
    with ``overlap``) makes the step bitwise identical across (pod, data)
    factorizations of the same rank count.
    """
    if cross_pod_mode not in CROSS_POD_MODES:
        raise ValueError(f"unknown cross_pod_mode {cross_pod_mode!r}; "
                         f"known: {CROSS_POD_MODES}")
    if ((overlap or slow_error_feedback or deterministic_reduce)
            and cross_pod_mode not in BUCKETED_SYNC_MODES):
        raise ValueError(
            f"overlap/slow_error_feedback/deterministic_reduce apply to "
            f"the bucketed sync modes {BUCKETED_SYNC_MODES}, not "
            f"{cross_pod_mode!r}")
    if slow_error_feedback and slow_compress_bits != 8:
        raise ValueError(
            "slow_error_feedback carries int8 quantization residuals; "
            f"it requires slow_compress_bits=8 (got {slow_compress_bits})")
    if deterministic_reduce and overlap:
        raise ValueError(
            "deterministic_reduce has no two-tier pipeline to overlap; "
            "pick one of overlap / deterministic_reduce")
    if (cross_pod_mode == "compressed" and grid is not None
            and grid.shape.get("pod", 1) > 1):
        raise NotImplementedError(
            "cross_pod_mode='compressed' is not supported on multi-pod "
            "meshes (XLA aborts on its partial shard_map under the "
            "pinned jax); use cross_pod_mode='hier_bucketed' with "
            "slow_compress_bits=8 for the int8 cross-pod hop")
    dev = resolve_device(device)
    check_on_device(model, dev)
    if cross_pod_mode in MANUAL_SYNC_MODES:
        return _make_manual_sync_step(
            model, ocfg, accum=accum, grid=grid, mode=cross_pod_mode,
            bucket_bytes=bucket_bytes,
            slow_compress_bits=slow_compress_bits, overlap=overlap,
            slow_error_feedback=slow_error_feedback,
            deterministic_reduce=deterministic_reduce, device=dev)
    lg = make_grid_loss_and_grad(model, accum=accum, grid=grid)

    def step(params: Tree, opt_state: optim.OptState, batch: Tree):
        loss, grads = lg(params, batch)
        params, opt_state, om = optim.apply(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


def make_grid_loss_and_grad(model: nn.Module, *, accum: int,
                            grid: Optional[RankGrid] = None):
    """Returns fn(params, global batch) -> (loss, grads): the ``"xla"``
    step's loss and gradient on ``grid`` under its rules
    (``registry.grid_rules``), complete and the same on every rank, as the
    reference's single-device loss-and-grad of the global batch.

    Each rank runs :func:`make_loss_and_grad` on its rows (split over the
    rules' batch axes, ``data``; every ``model`` rank of a data index sees
    the same rows) under the rules, so a dense model computes its share of
    each layer.  Its gradients are then summed over the tensor-parallel
    axes: a leaf read through the rank's slice holds zeros outside it, a
    partial sum (``wk``, ``wv``) holds the rank's part, and a leaf that a
    computation used whole is counted on one rank
    (``parallel.tensor.replicated``).  Then gradients and loss are
    mean-reduced over the batch axes, per tensor, one flat all-reduce an
    axis, as SPMD does in the reference."""
    rules = grid_rules(model, grid)
    sg = _sync_grid(grid, batch_axes(rules))
    tp = tensor_axes(rules)
    lg = make_loss_and_grad(model, accum=accum)

    def fn(params: Tree, batch: Tree) -> Tuple[torch.Tensor, Tree]:
        with use_rules(rules):
            loss, grads = lg(params, _local_rows(batch, sg))
        for n in grads:         # leaf by leaf: one leaf's copy at a time
            if tp:
                grads[n] = PX.psum(grads[n], tp)
            if sg.axes:
                grads[n] = flat_all_reduce_mean(grads[n], axes=sg.axes)
        if sg.axes:
            loss = PX.psum(loss, sg.axes) / sg.n
        return loss, grads

    return fn


def init_train_state(model: nn.Module, ocfg: optim.AdamWConfig, *,
                     seed: Optional[int] = 0,
                     grid: Optional[RankGrid] = None,
                     cross_pod_mode: str = "xla",
                     bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
                     slow_error_feedback: bool = False,
                     deterministic_reduce: bool = False):
    """(params, opt_state) for a mode: the model's weights drawn from
    ``seed`` (on the model's device; every rank draws the same), or kept
    as they are with ``seed=None`` (weights loaded with
    ``load_state_dict``, e.g. bridged from the reference), as a dict of
    tensors by name that shares the model's storage (the step updates it
    in place); and the optimizer
    state the mode's step takes: AdamW's, this rank's
    ``BucketedOptState`` shards over the step's own layout for
    ``hier_bucketed_zero1``, wrapped in an :class:`EFState` for
    ``slow_error_feedback``.  (The reference also returns shardings and the
    layout; the port has no shardings, and ``make_bucket_layout`` gives
    the layout.)"""
    if seed is not None:
        dev = next(model.parameters()).device
        model.init(torch.Generator(device=dev).manual_seed(seed))
    params = {n: p.detach() for n, p in model.named_parameters()}
    family = model.cfg.family
    if cross_pod_mode == "hier_bucketed_zero1":
        layout = make_bucket_layout(params, grid, bucket_bytes=bucket_bytes,
                                    deterministic=deterministic_reduce,
                                    family=family)
        opt_state = init_sharded_zero1(ocfg, params, layout, grid)
    else:
        opt_state = optim.init(ocfg, params)
    if slow_error_feedback:
        opt_state = wrap_ef_state(params, opt_state, grid,
                                  bucket_bytes=bucket_bytes,
                                  deterministic=deterministic_reduce,
                                  family=family)
    return params, opt_state


def batch_to(batch, device) -> Tree:
    """A numpy batch of the corpus as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    accum: int = 1
    async_ckpt: bool = True
    heartbeat_timeout_s: float = 60.0
    cross_pod_mode: str = "xla"
    bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES
    slow_compress_bits: int = 0
    overlap: bool = False
    slow_error_feedback: bool = False
    deterministic_reduce: bool = False
    # sharded (per-rank shard + manifest) checkpoint format; False falls
    # back to the legacy gathered per-leaf format (repro_torch.checkpoint)
    save_sharded: bool = True
    # recovery knobs (repro_torch.faults): bounded exponential-backoff
    # retries for transient I/O during checkpoint save/restore, and
    # whether a corrupt committed step at resume is quarantined on disk
    # with fallback to the previous committed step (RecoveryReport
    # returned in the run output) instead of raising
    max_restore_retries: int = 0
    fallback_on_corrupt: bool = False


class Trainer:
    def __init__(self, model: nn.Module, ocfg: optim.AdamWConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig, *,
                 device=None, grid: Optional[RankGrid] = None,
                 failure_hook: Optional[Callable[[int], bool]] = None):
        """Trains ``model`` on ``device``, the card unless the caller
        passes ``device="cpu"``; on ``grid`` (every rank of it runs its own
        ``Trainer``), with ``tcfg``'s gradient sync.  ``failure_hook(step)``
        returning true raises an injected failure before that step."""
        self.device = resolve_device(device)
        self.model = model
        self.ocfg = ocfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.grid = grid
        self.failure_hook = failure_hook
        self.heartbeat = HeartbeatMonitor(
            timeout_s=tcfg.heartbeat_timeout_s)
        self.straggler = StragglerDetector()
        self.step_fn = make_train_step(
            model, ocfg, accum=tcfg.accum, device=self.device, grid=grid,
            cross_pod_mode=tcfg.cross_pod_mode,
            bucket_bytes=tcfg.bucket_bytes,
            slow_compress_bits=tcfg.slow_compress_bits,
            overlap=tcfg.overlap,
            slow_error_feedback=tcfg.slow_error_feedback,
            deterministic_reduce=tcfg.deterministic_reduce)
        self.history: list = []
        # one record per committed checkpoint: its step, the seconds of
        # the host copy (training waits for it) and of the whole save,
        # until its writer was joined
        self.checkpoints: list = []
        self._open: Optional[dict] = None

    def _init_state(self, seed: Optional[int]):
        tcfg = self.tcfg
        params, opt_state = init_train_state(
            self.model, self.ocfg, seed=seed, grid=self.grid,
            cross_pod_mode=tcfg.cross_pod_mode,
            bucket_bytes=tcfg.bucket_bytes,
            slow_error_feedback=tcfg.slow_error_feedback,
            deterministic_reduce=tcfg.deterministic_reduce)
        self._layout = None
        if tcfg.cross_pod_mode == "hier_bucketed_zero1":
            self._layout = make_bucket_layout(
                params, self.grid, bucket_bytes=tcfg.bucket_bytes,
                deterministic=tcfg.deterministic_reduce,
                family=self.model.cfg.family)
        return params, opt_state

    def _tree(self, params, opt_state):
        from repro_torch.ckpt.state import state_tree
        return state_tree(params, opt_state, family=self.model.cfg.family,
                          grid=self.grid)

    def _restore(self, params, opt_state):
        """(start step, params, opt_state, recovery report) from the
        latest committed checkpoint of ``ckpt_dir``, or the state as given
        when there is none."""
        from repro_torch import ckpt as ckpt_lib
        from repro_torch.ckpt.state import restore_policy, state_from_tree
        from repro_torch.faults.recovery import restore_with_fallback
        from repro_torch.faults.retry import RetryPolicy
        tcfg = self.tcfg
        last = ckpt_lib.latest_step(tcfg.ckpt_dir)
        if last is None:
            return 0, params, opt_state, None
        retry = RetryPolicy(max_retries=tcfg.max_restore_retries)
        template = self._tree(params, opt_state)
        policy = restore_policy(template)
        recovery = None
        if tcfg.fallback_on_corrupt:
            start, tree, recovery = restore_with_fallback(
                tcfg.ckpt_dir, template, policy=policy, layout=self._layout,
                retry=retry, mesh=self.grid)
        else:
            start, tree = ckpt_lib.restore_auto(
                ckpt_lib.step_dir(tcfg.ckpt_dir, last), template,
                policy=policy, layout=self._layout, retry=retry,
                mesh=self.grid)
        del template
        params, opt_state = state_from_tree(tree, order=list(params))
        return start, params, opt_state, recovery

    def _save(self, step: int, params, opt_state):
        """Commit checkpoint ``step``; returns the writer thread (async) or
        None."""
        from repro_torch import checkpoint as legacy_ckpt
        from repro_torch import ckpt as ckpt_lib
        tcfg = self.tcfg
        sdir = ckpt_lib.step_dir(tcfg.ckpt_dir, step)
        tree = self._tree(params, opt_state)
        t0 = time.perf_counter()
        if tcfg.save_sharded:
            pending = ckpt_lib.save_sharded(
                sdir, step, tree, layout=self._layout, mesh=self.grid,
                blocking=not tcfg.async_ckpt)
        else:
            pending = legacy_ckpt.save(sdir, step, tree,
                                       blocking=not tcfg.async_ckpt,
                                       mesh=self.grid)
        self._open = {"step": step, "host_copy_s": time.perf_counter() - t0,
                      "t0": t0}
        return pending

    def _join(self, pending) -> None:
        """Join the writer of the last checkpoint (re-raising its failure)
        and record its time."""
        if self._open is None:
            return
        if pending is not None:
            pending.join()
        rec, self._open = self._open, None
        rec["save_s"] = time.perf_counter() - rec.pop("t0")
        self.checkpoints.append(rec)

    def run(self, *, seed: Optional[int] = 0, resume: bool = True
            ) -> Dict[str, Any]:
        """Trains ``n_steps`` from the weights of ``seed`` (``None``: the
        model's weights as they are), or, with ``resume``, from the latest
        committed checkpoint of ``ckpt_dir`` when there is one (with the
        retries and the corrupt-step fallback of the config).  Commits a
        checkpoint after every ``ckpt_every``-th step.  Returns {"params",
        "opt_state", "history", "stragglers", "recovery"}.  On a grid every
        rank draws the global batch (one corpus shard) and the step keeps
        its rows."""
        tcfg, dev = self.tcfg, self.device
        params, opt_state = self._init_state(seed)
        start, recovery = 0, None
        if resume:
            start, params, opt_state, recovery = self._restore(params,
                                                               opt_state)
        worker = self.grid.rank if self.grid is not None else 0
        prefetch = Prefetcher(SyntheticCorpus(self.data_cfg),
                              start_step=start)
        pending = None
        try:
            for step in range(start, tcfg.n_steps):
                if self.failure_hook and self.failure_hook(step):
                    raise RuntimeError(f"injected failure at step {step}")
                t0 = time.perf_counter()
                _, batch = prefetch.next()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch_to(batch, dev))
                if dev.type == "cuda":
                    # the step's time, not the time to enqueue it
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                self.heartbeat.beat(worker=worker, t=time.time())
                self.straggler.record(dt)
                if step % tcfg.log_every == 0:
                    self.history.append(
                        {"step": step,
                         "loss": float(metrics["loss"]),
                         "sec_per_step": dt})
                if (step + 1) % tcfg.ckpt_every == 0:
                    self._join(pending)
                    pending = self._save(step + 1, params, opt_state)
        finally:
            self._join(pending)
            prefetch.close()
        return {"params": params, "opt_state": opt_state,
                "history": self.history,
                "stragglers": self.straggler.summary(),
                "recovery": recovery}
