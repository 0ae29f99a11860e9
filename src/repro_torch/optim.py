"""AdamW of the port with a warmup-cosine schedule and global-norm clipping
(counterpart of ``repro/optim.py``'s ``init`` and ``apply``).

Parameters, gradients and moments are dicts of tensors by parameter name
(``dict(model.named_parameters())``'s keys).  The update runs in f32 under
``torch.no_grad()``, leaf by leaf, in the reference's order of operations;
it is functional as the reference's: ``apply`` returns new tensors and
modifies none it was given.  The schedule and the bias corrections are
scalars of the step count, which stays on the host (a Python int), so
they are computed there in f32 arithmetic (numpy float32) and a step on
the card waits for nothing.  ``BucketedOptState``, ``init_bucketed`` and
``apply_flat`` are the flat-bucket state and update of the
``hier_bucketed_zero1`` mode; ``apply_flat`` shares ``apply``'s
elementwise update, which is what makes that mode bitwise equal to
``hier_bucketed``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: int                      # completed steps
    mu: Tree
    nu: Tree
    master: Optional[Tree]         # f32 master weights (None if disabled)


class BucketedOptState(NamedTuple):
    """ZeRO-1-style optimizer state over flat f32 buckets.

    ``mu``/``nu``/``master`` are tuples of 1-D f32 tensors, one per bucket
    of a ``collectives.bucketing.BucketLayout``.  On a rank grid each rank
    holds only its contiguous 1/F shard of every bucket (F the fast axis's
    size), and the ``hier_bucketed_zero1`` step updates them there.
    """

    step: int                      # completed steps
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]
    master: Tuple[torch.Tensor, ...]   # f32 masters (always present)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    use_master: bool = True


def lr_schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate after ``step`` completed steps, in f32 arithmetic
    as the reference's (``lr_schedule(0) == 0``: warmup ramps from 0)."""
    f = np.float32
    step = f(step)
    warm = step / f(max(cfg.warmup_steps, 1))
    prog = (step - f(cfg.warmup_steps)) / f(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = np.clip(prog, f(0.0), f(1.0))
    # Python floats fold in double before they meet an f32 value, as the
    # reference's weakly typed constants do
    cos = f(cfg.min_lr_frac) + f((1 - cfg.min_lr_frac) * 0.5) * (
        f(1) + np.cos(f(np.pi) * prog))
    return float(f(cfg.peak_lr) * (warm if step < cfg.warmup_steps
                                   else cos))


def init(cfg: AdamWConfig, params: Tree) -> OptState:
    """Zero moments and, with ``use_master``, f32 masters that are copies of
    the params: never aliases, also for f32 leaves."""
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    master = ({n: p.detach().to(torch.float32, copy=True)
               for n, p in params.items()} if cfg.use_master else None)
    return OptState(step=0, mu=zeros,
                    nu={n: z.clone() for n, z in zeros.items()},
                    master=master)


def init_bucketed(cfg: AdamWConfig, params: Tree, layout
                  ) -> BucketedOptState:
    """Bucketed (flat f32) state for the shard-resident optimizer mode:
    *full* buckets (``train.init_sharded_zero1`` builds one rank's
    shards).  Masters are mandatory in this mode: they are the source of
    truth the params are re-gathered from."""
    from repro_torch.collectives.bucketing import flatten_to_buckets
    assert cfg.use_master, "bucketed ZeRO-1 state requires f32 masters"
    # flatten_to_buckets returns new buffers: masters never alias params
    master = flatten_to_buckets(layout, params)
    return BucketedOptState(
        step=0, mu=tuple(torch.zeros_like(b) for b in master),
        nu=tuple(torch.zeros_like(b) for b in master), master=master)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [g.float().square().sum() for g in tree.values()]
    return torch.stack(leaves).sum().sqrt()


def _clip_scale(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    # a division, not the reciprocal times clip_norm that a Python scalar
    # over a tensor computes
    clip = torch.full_like(gnorm, cfg.clip_norm)
    return torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)


def _adamw_update(cfg: AdamWConfig, g, m, v, base, *, lr: float, b1c: float,
                  b2c: float, scale: torch.Tensor):
    """One elementwise AdamW update -> (m, v, new_w), all f32: the single
    source of the update math, in the reference's order of operations."""
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g.square()
    mh = m / b1c
    vh = v / b2c
    new_w = base - lr * (mh / (vh.sqrt() + cfg.eps)
                         + cfg.weight_decay * base)
    return m, v, new_w


def _step_scalars(cfg: AdamWConfig, completed: int):
    """(lr, b1c, b2c) of the update after ``completed`` steps: the
    0-based schedule, evaluated at the count of completed steps (the first
    update only seeds the moments), and the bias corrections."""
    step = completed + 1
    f = np.float32
    return (lr_schedule(cfg, completed),
            float(f(1) - f(cfg.b1) ** f(step)),
            float(f(1) - f(cfg.b2) ** f(step)))


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Tree, grads: Tree, state: OptState, *,
          gnorm: Optional[torch.Tensor] = None
          ) -> Tuple[Tree, OptState, Dict[str, object]]:
    """One AdamW step.  Returns (new_params, new_state, {"lr",
    "grad_norm"}).  ``gnorm`` lets callers that already hold the global
    norm (the bucketed sync modes, from reduce-scattered shards) supply
    the clipping norm instead of re-deriving it from ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(cfg, gnorm)
    step = state.step + 1
    lr, b1c, b2c = _step_scalars(cfg, state.step)
    new_params, mu, nu, master = {}, {}, {}, {}
    for n, p in params.items():
        base = state.master[n] if state.master is not None else p.float()
        mu[n], nu[n], new_w = _adamw_update(
            cfg, grads[n], state.mu[n], state.nu[n], base, lr=lr, b1c=b1c,
            b2c=b2c, scale=scale)
        # a copy even for f32 leaves: params never alias the masters
        new_params[n] = new_w.to(p.dtype, copy=True)
        master[n] = new_w
    new_state = OptState(step, mu, nu,
                         master if state.master is not None else None)
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def apply_flat(cfg: AdamWConfig, grads, state: BucketedOptState, *,
               gnorm: torch.Tensor
               ) -> Tuple[BucketedOptState, Dict[str, object]]:
    """Shard-resident AdamW over flat f32 bucket (shards).

    ``grads`` is a tuple of flat f32 buffers aligned element for element
    with ``state``'s buckets: on a rank grid, each rank's reduce-scattered
    shard of the globally meaned gradient.  ``gnorm`` must be the *global*
    norm (``bucketing.shard_global_norm``); clipping and the schedule are
    then those of :func:`apply`, and every other op is elementwise, so the
    update is bitwise identical to the replicated path.  Returns
    (new_state, metrics); the caller re-gathers params from
    ``new_state.master``.
    """
    scale = _clip_scale(cfg, gnorm)
    lr, b1c, b2c = _step_scalars(cfg, state.step)
    mu, nu, master = [], [], []
    for g, m, v, w in zip(grads, state.mu, state.nu, state.master):
        m, v, new_w = _adamw_update(cfg, g, m, v, w, lr=lr, b1c=b1c,
                                    b2c=b2c, scale=scale)
        mu.append(m)
        nu.append(v)
        master.append(new_w)
    new_state = BucketedOptState(state.step + 1, tuple(mu), tuple(nu),
                                 tuple(master))
    return new_state, {"lr": lr, "grad_norm": gnorm}
