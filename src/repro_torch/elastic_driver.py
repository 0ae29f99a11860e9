"""End-to-end elastic preemption/repack driver of the port (counterpart of
``repro/elastic_driver.py``).

Closes the loop between the repo's two halves: the cluster simulator
charges reconfiguration events a cost, and this driver *executes* those
events for real on the port's training runtime.  A reconfiguration
schedule (typically derived from a simulated trace's reconfig events via
:func:`schedule_from_sim`) names, per event, the training step at which
the job is repacked and the new (pod, data) grid factorization.  For each
event the driver runs the full cycle the paper's software-coordinated
handoff describes:

1. committed sharded save on the old (pod, data) grid
   (:func:`repro_torch.ckpt.save_sharded` — per-rank shards + manifest,
   atomic temp-dir-rename commit);
2. :func:`repro_torch.elastic.plan_elastic_remesh` with the checkpoint
   base dir — the handoff refuses to proceed without a committed
   checkpoint and names the step dir the re-meshed job restores from;
3. the old grid's state is freed, the new grid built (``make_rank_grid``
   on the same gloo world, every rank in the same order) and the
   checkpoint reshard-restored onto it
   (:func:`repro_torch.ckpt.restore_sharded` — pure offset arithmetic, no
   rank gathers a full bucket);
4. continue training.

The driver runs in every rank of a gloo world of pod·data ranks
(``parallel.launch.run_ranks``); each returns its own result.  With
``deterministic_reduce`` (always on here: the driver trains
``hier_bucketed_zero1`` with the grid-factorization-invariant reduce)
the continued run is *bitwise identical* to an uninterrupted run,
asserted at every handoff: ``verify=True`` additionally checks that the
restored state is the saved state, by per-leaf digests
(``ckpt.state.state_digest``) taken on the old grid before the save and
on the new one after the restore — the two grids' states are never on
the card at once.

Every phase's wallclock is measured (:class:`HandoffMeasurement`), the
card synchronised, so the simulator's handoff cost can be calibrated from
measured, not assumed, reconfiguration time.

``mode='drain'`` executes the incumbent cycle instead — a gathered
legacy checkpoint save and a full (non-resharding) restore — so both
operational models can be priced from measurements.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import checkpoint as legacy_ckpt
from repro_torch import ckpt as ckpt_lib
from repro_torch import optim
from repro_torch.ckpt.state import (state_bytes, state_digest,
                                    state_from_tree, state_tree)
from repro_torch.core.leaves import TpuLeaf
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.elastic import plan_elastic_remesh
from repro_torch.faults.plan import maybe_fire
from repro_torch.faults.recovery import RecoveryReport, walk_committed
from repro_torch.faults.retry import NO_RETRY, RetryPolicy
from repro_torch.models.registry import resolve_device
from repro_torch.parallel.mesh import make_rank_grid
from repro_torch.train import (batch_to, init_train_state,
                               make_bucket_layout, make_train_step)


def factorizations(n_devices: int) -> List[Tuple[int, int]]:
    """All (pod, data) factorizations of ``n_devices``, pod ascending."""
    if n_devices < 1:
        raise ValueError("need at least one device")
    return [(p, n_devices // p) for p in range(1, n_devices + 1)
            if n_devices % p == 0]


@dataclasses.dataclass(frozen=True)
class ReconfigEvent:
    """One repack: before executing training step ``step``, hand the job
    off to the ``mesh_shape`` (pod, data) factorization."""
    step: int
    mesh_shape: Tuple[int, int]
    sim_time: float = 0.0         # when the source sim event fired
    kind: str = "handoff"

    def __post_init__(self):
        if self.step < 1:
            raise ValueError(
                f"reconfig step must be >= 1 (there is nothing to hand "
                f"off before the first step), got {self.step}")
        if len(self.mesh_shape) != 2 or min(self.mesh_shape) < 1:
            raise ValueError(f"bad mesh shape {self.mesh_shape!r}")


def schedule_from_sim(result, *, n_devices: int, n_steps: int,
                      initial_shape: Optional[Tuple[int, int]] = None,
                      max_events: Optional[int] = None
                      ) -> List[ReconfigEvent]:
    """Map a simulator result's job-suspending reconfiguration events onto
    a training run's steps (duck-typed: anything with ``reconfig_events``
    — each with ``t``, ``n_affected`` and ``kind`` — and ``makespan``, as
    ``repro_torch.core.simulator.SimResult`` has).

    Event times are scaled from the simulated span onto ``[1,
    n_steps - 1]`` (order-preserving, deduplicated); target
    factorizations cycle through ``factorizations(n_devices)``, always
    differing from the mesh they leave.  Deterministic: the same sim
    result yields the same schedule.
    """
    recs = sorted((r for r in result.reconfig_events if r.n_affected > 0),
                  key=lambda r: r.t)
    if max_events is not None:
        recs = recs[:max_events]
    if not recs or n_steps < 2:
        return []
    t_end = max(result.makespan, recs[-1].t, 1e-9)
    facs = factorizations(n_devices)
    prev = tuple(initial_shape) if initial_shape is not None else facs[0]
    out: List[ReconfigEvent] = []
    used = set()
    fi = 0
    for r in recs:
        step = 1 + int(round(r.t / t_end * (n_steps - 2)))
        step = min(max(step, 1), n_steps - 1)
        while step in used and step < n_steps - 1:
            step += 1
        if step in used:
            continue                      # schedule is full
        cand = prev
        for _ in range(len(facs)):
            cand = facs[fi % len(facs)]
            fi += 1
            if cand != prev:
                break
        if cand == prev:
            continue                      # single-factorization device count
        out.append(ReconfigEvent(step=step, mesh_shape=cand,
                                 sim_time=r.t, kind=r.kind))
        used.add(step)
        prev = cand
    return out


@dataclasses.dataclass
class HandoffMeasurement:
    """Measured wallclock of one executed reconfiguration cycle."""
    step: int
    from_shape: Tuple[int, int]
    to_shape: Tuple[int, int]
    mode: str                     # "handoff" | "drain"
    save_s: float
    restore_s: float
    first_step_s: float           # first step on the new grid
    setup_s: float = 0.0          # new-grid state build (grid + init)
    compile_s: float = 0.0        # first_step_s minus steady step time
    # bytes of the committed step dir: every rank's shards, which the
    # ranks write and read concurrently
    save_bytes: int = 0
    restore_bytes: int = 0
    state_bytes: int = 0          # logical size of the saved state
    verified: bool = False        # restored state == saved state bitwise

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["from_shape"] = list(self.from_shape)
        d["to_shape"] = list(self.to_shape)
        return d


@dataclasses.dataclass
class ElasticRunResult:
    losses: List[float]
    measurements: List[HandoffMeasurement]
    mesh_shapes: List[Tuple[int, int]]    # factorization per step
    params: Any
    opt_state: Any
    steady_step_s: float
    start_step: int = 0                   # > 0 on a restart-resume
    recovery: Optional[RecoveryReport] = None
    # boundary timings for runs that are one *segment* of a longer job
    state_bytes: int = 0                  # logical training-state size
    first_step_s: float = 0.0             # first executed step
    final_save_s: float = 0.0             # final_save wallclock
    final_save_bytes: int = 0
    resume_restore_s: float = 0.0         # resume: restore wallclock
    resume_restore_bytes: int = 0
    resume_setup_s: float = 0.0           # resume: new-grid state build


@dataclasses.dataclass
class _MeshCtx:
    shape: Tuple[int, int]
    grid: Any
    layout: Any
    params: Any
    state: Any
    step_fn: Any


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def _world() -> Tuple[int, Any]:
    """(the job's rank count, its process group): (1, None) outside a
    gloo job."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.group.WORLD
    return 1, None


class ElasticDriver:
    """Executes a reconfiguration schedule on a real training run, in every
    rank of a gloo world of pod·data ranks (one process alone for 1·1).

    The training configuration is pinned to the elastic-capable mode:
    ``hier_bucketed_zero1`` + ``deterministic_reduce`` (sharded f32
    state, factorization-invariant losses), optionally with the int8
    error-feedback slow hop.  ``device``: the card unless the caller
    passes ``"cpu"``; the model must lie there.
    """

    def __init__(self, model, ocfg: optim.AdamWConfig,
                 data_cfg: DataConfig, *, base_dir: str,
                 bucket_bytes: int = 64 << 10, accum: int = 1,
                 mode: str = "handoff", error_feedback: bool = False,
                 verify: bool = True, retry: RetryPolicy = NO_RETRY,
                 fallback_on_corrupt: bool = False, device=None):
        if mode not in ("handoff", "drain"):
            raise ValueError(f"unknown driver mode {mode!r}")
        self.model = model
        self.ocfg = ocfg
        self.data_cfg = data_cfg
        self.base_dir = base_dir
        self.bucket_bytes = bucket_bytes
        self.accum = accum
        self.mode = mode
        self.ef = error_feedback
        self.verify = verify
        # recovery knobs: transient-I/O retry for every checkpoint
        # save/restore this driver performs, and whether a corrupt
        # committed step at resume quarantines + falls back to the
        # previous one instead of raising
        self.retry = retry
        self.fallback_on_corrupt = fallback_on_corrupt
        self.device = resolve_device(device)
        # set by _restore_into; on a resumed run the last successful
        # restore attempt's timings are the segment's receiving-half cost
        self._resume_timing: Optional[Dict[str, Any]] = None

    # ----------------------------------------------------------- setup
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _setup(self, shape: Tuple[int, int], seed: Optional[int]
               ) -> _MeshCtx:
        grid = make_rank_grid(tuple(shape), ("pod", "data"))
        kw = dict(bucket_bytes=self.bucket_bytes, deterministic_reduce=True)
        params, state = init_train_state(
            self.model, self.ocfg, seed=seed, grid=grid,
            cross_pod_mode="hier_bucketed_zero1",
            slow_error_feedback=self.ef, **kw)
        layout = make_bucket_layout(params, grid,
                                    bucket_bytes=self.bucket_bytes,
                                    deterministic=True,
                                    family=self.model.cfg.family)
        step_fn = make_train_step(
            self.model, self.ocfg, accum=self.accum, device=self.device,
            grid=grid, cross_pod_mode="hier_bucketed_zero1",
            slow_compress_bits=8 if self.ef else 0,
            slow_error_feedback=self.ef, **kw)
        self._sync()
        return _MeshCtx(tuple(shape), grid, layout, params, state, step_fn)

    def _tree(self, ctx: _MeshCtx):
        return state_tree(ctx.params, ctx.state,
                          family=self.model.cfg.family, grid=ctx.grid)

    @staticmethod
    def _leaves(shape: Tuple[int, int]) -> List[TpuLeaf]:
        return [TpuLeaf(pod=p, host=d, chip=0)
                for p in range(shape[0]) for d in range(shape[1])]

    @staticmethod
    def _free(ctx: _MeshCtx) -> None:
        """Drop a grid's state (before the next grid's is built)."""
        ctx.params = ctx.state = ctx.step_fn = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    # ------------------------------------------------------ save/restore
    def _save(self, ctx: _MeshCtx, step: int) -> None:
        """Commit ``ctx``'s state as checkpoint ``step`` (the state
        *before* executing training step ``step``); every rank calls it."""
        sdir = ckpt_lib.step_dir(self.base_dir, step)
        maybe_fire("driver.pre_save")
        tree = self._tree(ctx)
        if self.mode == "handoff":
            ckpt_lib.save_sharded(sdir, step, tree, layout=ctx.layout,
                                  mesh=ctx.grid, blocking=True,
                                  retry=self.retry)
        else:
            legacy_ckpt.save(sdir, step, tree, blocking=True,
                             mesh=ctx.grid)

    def _load(self, path: str, ctx: _MeshCtx, *, layout) -> int:
        """Restore ``path`` into ``ctx`` (format-dispatched, reshard-
        capable); returns the checkpoint's step."""
        order = list(ctx.params)
        template = self._tree(ctx)
        ctx.params = ctx.state = None
        rstep, tree = ckpt_lib.restore_auto(path, template, layout=layout,
                                            retry=self.retry,
                                            mesh=ctx.grid)
        del template
        ctx.params, ctx.state = state_from_tree(tree, order)
        self._sync()
        return rstep

    def _restore_into(self, path: str, step: int, shape: Tuple[int, int],
                      seed: int) -> _MeshCtx:
        """Build a fresh grid context for ``shape`` and restore committed
        step ``step`` into it.

        Times both phases into ``_resume_timing`` — on a resumed run this
        restore is the *receiving* half of a cross-process handoff."""
        t0 = time.perf_counter()
        ctx = self._setup(shape, seed)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rstep = self._load(path, ctx, layout=ctx.layout
                           if self.mode == "handoff" else None)
        self._resume_timing = {
            "setup_s": setup_s,
            "restore_s": time.perf_counter() - t0,
            "restore_bytes": _dir_bytes(path),
        }
        if rstep != step:
            raise ckpt_lib.CorruptCheckpointError(
                f"checkpoint at {path!r} records step {rstep}, directory "
                f"name says {step}")
        return ctx

    # --------------------------------------------------------- handoff
    def _handoff(self, ctx: _MeshCtx, event: ReconfigEvent, step: int,
                 seed: int) -> Tuple[_MeshCtx, HandoffMeasurement]:
        sdir = ckpt_lib.step_dir(self.base_dir, step)
        state_bytes_ = state_bytes(self._tree(ctx))

        # the handoff below restores the *latest committed* step in
        # base_dir; a stale newer checkpoint (a previous run's leftovers)
        # would silently win over the save we are about to make
        stale = ckpt_lib.latest_step(self.base_dir)
        if stale is not None and stale > step:
            raise RuntimeError(
                f"checkpoint dir {self.base_dir!r} already holds a "
                f"committed step {stale} > current step {step}; the "
                f"handoff would restore that stale state — use a fresh "
                f"directory for this elastic run")
        # the saved state's fingerprint, on the old grid (the two grids'
        # states never share the card)
        before = state_digest(self._tree(ctx), ctx.grid) \
            if self.verify else None

        t0 = time.perf_counter()
        self._save(ctx, step)
        save_s = time.perf_counter() - t0
        save_bytes = _dir_bytes(sdir)

        # the remesh plan validates the commit: it refuses a handoff
        # with no committed checkpoint, and names the step dir to
        # restore from
        plan = plan_elastic_remesh(self._leaves(ctx.shape), (),
                                   model_parallel=1,
                                   ckpt_base_dir=self.base_dir)
        if plan.handoff is None or plan.handoff.step != step:
            raise RuntimeError(
                f"remesh handoff names step "
                f"{getattr(plan.handoff, 'step', None)}, expected the "
                f"step {step} just committed")
        if plan.handoff.sharded != (self.mode == "handoff"):
            raise RuntimeError(
                f"checkpoint format mismatch: handoff.sharded="
                f"{plan.handoff.sharded} under driver mode {self.mode!r}")
        old_shape = ctx.shape
        self._free(ctx)

        # building the new grid and its state is real handoff work — time
        # it so the calibrated cost does not undercount the cycle
        t0 = time.perf_counter()
        new = self._setup(event.mesh_shape, seed)
        setup_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        rstep = self._load(plan.handoff.step_dir, new,
                           layout=new.layout if self.mode == "handoff"
                           else None)
        restore_s = time.perf_counter() - t0
        assert rstep == step, (rstep, step)
        maybe_fire("driver.post_restore")

        verified = False
        if self.verify:
            # the bitwise handoff invariant: the resharded state is the
            # saved state, bit for bit (by digest, on every rank)
            after = state_digest(self._tree(new), new.grid)
            if not all(legacy_ckpt.Job(_world()[1]).all_gather(
                    after == before)):
                raise RuntimeError(
                    f"handoff not bitwise: {old_shape} -> "
                    f"{event.mesh_shape} at step {step}")
            verified = True

        return new, HandoffMeasurement(
            step=step, from_shape=old_shape, to_shape=new.shape,
            mode=self.mode, save_s=save_s, restore_s=restore_s,
            first_step_s=0.0, setup_s=setup_s, save_bytes=save_bytes,
            restore_bytes=save_bytes, state_bytes=state_bytes_,
            verified=verified)

    # ----------------------------------------------------------- resume
    def _resume(self, shape_at, seed: int
                ) -> Tuple[Optional[_MeshCtx], int,
                           Optional[RecoveryReport]]:
        """Restore the newest usable committed step from ``base_dir``.

        Checkpoint step ``k`` holds the state *before* executing step
        ``k`` (both the handoff saves and the periodic saves follow this
        convention), so the resumed run continues at step ``k`` on
        ``shape_at(k)``.  With ``fallback_on_corrupt`` a corrupt newest
        step is quarantined on disk and the walk falls back through
        history (every rank in step); otherwise the first failure
        propagates.  No committed step at all means the crash predated
        the first commit — start from scratch (the caller's fresh-start
        path).
        """
        steps = ckpt_lib.committed_steps(self.base_dir)
        if not steps:
            return None, 0, None

        def attempt(step: int, path: str) -> _MeshCtx:
            return self._restore_into(path, step, shape_at(step), seed)

        if self.fallback_on_corrupt:
            ctx, report = walk_committed(self.base_dir, attempt,
                                         quarantine_on_disk=True,
                                         mesh=_world()[1])
            return ctx, report.restored_step, report
        step = steps[-1]
        ctx = attempt(step, ckpt_lib.step_dir(self.base_dir, step))
        report = RecoveryReport(self.base_dir, attempted=[step],
                                restored_step=step)
        return ctx, step, report

    # -------------------------------------------------------------- run
    def run(self, n_steps: int,
            schedule: Sequence[ReconfigEvent] = (), *,
            initial_shape: Tuple[int, int] = (2, 2),
            seed: Optional[int] = 0, resume: bool = False, save_every: int = 0,
            final_save: bool = False) -> ElasticRunResult:
        """Train ``n_steps``, executing every scheduled reconfiguration.

        An empty ``schedule`` is the uninterrupted reference run — same
        code path, so bitwise comparisons between the two are symmetric.
        Every grid's state starts from the weights of ``seed`` (``None``:
        the model's weights as they are).

        ``save_every=k`` commits a periodic checkpoint before every k-th
        step (skipped where a handoff already saves); ``final_save``
        commits the end-of-run state as step ``n_steps``.
        ``resume=True`` is the restart path: restore the newest usable
        committed step (see :meth:`_resume`), skip the schedule's
        already-executed events, and continue — with
        ``deterministic_reduce`` the continuation is bitwise identical
        to the uninterrupted run, which is what makes SIGKILL-anywhere
        recovery provable rather than hopeful.
        """
        events: Dict[int, ReconfigEvent] = {}
        for e in schedule:
            if e.step in events:
                raise ValueError(f"duplicate reconfig step {e.step}")
            if e.step >= n_steps:
                raise ValueError(
                    f"reconfig step {e.step} is past the run "
                    f"(n_steps={n_steps}); it would silently never fire")
            if (e.mesh_shape[0] * e.mesh_shape[1]
                    != initial_shape[0] * initial_shape[1]):
                # same rank count R is what makes the deterministic
                # reduce — and therefore the continuation — bitwise
                raise ValueError(
                    f"reconfig target {e.mesh_shape} is not a "
                    f"factorization of the run's "
                    f"{initial_shape[0] * initial_shape[1]} ranks")
            events[e.step] = e

        def shape_at(step: int) -> Tuple[int, int]:
            # factorization in force when executing `step`: the initial
            # shape folded over every event at or before it (an event at
            # step k repacks BEFORE executing k)
            shape = tuple(initial_shape)
            for s in sorted(events):
                if s <= step:
                    shape = tuple(events[s].mesh_shape)
            return shape

        start_step = 0
        recovery: Optional[RecoveryReport] = None
        ctx: Optional[_MeshCtx] = None
        if resume:
            self._check_world(initial_shape)
            ctx, start_step, recovery = self._resume(shape_at, seed)
            if start_step >= n_steps > 0 and ctx is not None:
                raise RuntimeError(
                    f"resume found committed step {start_step} at or "
                    f"past the end of the run (n_steps={n_steps}) — "
                    f"nothing left to execute")
            # events at or before the resumed step already ran (the
            # resumed checkpoint is their product)
            events = {s: e for s, e in events.items() if s > start_step}
        elif events:
            # fail before building anything: a previous run's committed
            # checkpoint past the first event would win the handoff's
            # latest_step lookup over the save this run makes
            stale = ckpt_lib.latest_step(self.base_dir)
            if stale is not None and stale > min(events):
                raise RuntimeError(
                    f"checkpoint dir {self.base_dir!r} already holds a "
                    f"committed step {stale} past the first reconfig "
                    f"event (step {min(events)}); the handoff would "
                    f"restore that stale state — use a fresh directory "
                    f"for this elastic run (or pass resume=True to "
                    f"continue it)")
        self._check_world(initial_shape)
        corpus = SyntheticCorpus(self.data_cfg)
        if ctx is None:
            ctx = self._setup(shape_at(start_step) if resume
                              else initial_shape, seed)
        losses: List[float] = []
        shapes: List[Tuple[int, int]] = []
        measurements: List[HandoffMeasurement] = []
        step_times: List[float] = []      # non-first steps per segment
        run_first_step_s = 0.0            # very first executed step
        first_step = True
        for step in range(start_step, n_steps):
            if step in events:
                ctx, m = self._handoff(ctx, events[step], step, seed)
                measurements.append(m)
                first_step = True
            elif (save_every and step > start_step
                    and step % save_every == 0):
                # periodic commit of the pre-step state; a handoff at
                # this step already saved it
                self._save(ctx, step)
            batch = batch_to(corpus.batch(step), self.device)
            if first_step:
                maybe_fire("driver.first_step")
            t0 = time.perf_counter()
            ctx.params, ctx.state, metrics = ctx.step_fn(
                ctx.params, ctx.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if first_step:
                if measurements and measurements[-1].first_step_s == 0.0:
                    measurements[-1].first_step_s = dt
                if step == start_step:
                    run_first_step_s = dt
                first_step = False
            else:
                step_times.append(dt)
            losses.append(loss)
            shapes.append(ctx.shape)
        final_save_s = 0.0
        final_save_bytes = 0
        if final_save:
            t0 = time.perf_counter()
            self._save(ctx, n_steps)
            final_save_s = time.perf_counter() - t0
            final_save_bytes = _dir_bytes(
                ckpt_lib.step_dir(self.base_dir, n_steps))
        # the first step on a new grid pays its allocations and first
        # collectives: its excess over the steady step
        steady = statistics.median(step_times) if step_times else 0.0
        for m in measurements:
            m.compile_s = max(0.0, m.first_step_s - steady)
        rt = (self._resume_timing or {}) if resume else {}
        return ElasticRunResult(losses=losses, measurements=measurements,
                                mesh_shapes=shapes, params=ctx.params,
                                opt_state=ctx.state,
                                steady_step_s=steady,
                                start_step=start_step, recovery=recovery,
                                state_bytes=state_bytes(self._tree(ctx)),
                                first_step_s=run_first_step_s,
                                final_save_s=final_save_s,
                                final_save_bytes=final_save_bytes,
                                resume_restore_s=rt.get("restore_s", 0.0),
                                resume_restore_bytes=rt.get(
                                    "restore_bytes", 0),
                                resume_setup_s=rt.get("setup_s", 0.0))

    @staticmethod
    def _check_world(initial_shape: Tuple[int, int]) -> None:
        """The job must have pod·data ranks."""
        world, _ = _world()
        if world != initial_shape[0] * initial_shape[1]:
            raise ValueError(
                f"the driver runs in every rank of a job of "
                f"{initial_shape[0] * initial_shape[1]} ranks "
                f"({initial_shape}), this job has {world}")
