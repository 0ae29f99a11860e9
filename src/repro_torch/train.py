"""Training step factory and training loop of the port (counterpart of
``repro/train.py``'s single-device path).

``make_train_step`` builds step(params, opt_state, batch) -> (params,
opt_state, metrics) with microbatch gradient accumulation over an f32 view
of the parameters, then AdamW (``optim.apply``).  Parameters are a dict of
tensors by name (``init_train_state``); the model is called on them through
``torch.func.functional_call``, so its own ``nn.Parameter``s are left as
they are.  Per-layer remat is the model's (``TransformerLM.remat``).

Of the reference's ``cross_pod_mode``s only ``"xla"`` is ported: on one
device it is the plain step.  The manual-sync modes and their options (the
collective layer and the two-tier sync) are ROADMAP.md queue 1 items 5-6.

``Trainer`` runs the step over ``SyntheticCorpus`` batches with the
reference's prefetch, heartbeat, straggler record and history.  Checkpoint
save, resume and recovery (and the failure hook that drives recovery) come
with the sharded checkpoint, ROADMAP.md queue 1 item 7; until then
``TrainerConfig`` has none of their fields.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import optim
from repro_torch.data import DataConfig, Prefetcher, SyntheticCorpus
from repro_torch.elastic import HeartbeatMonitor, StragglerDetector
from repro_torch.models.registry import check_on_device, resolve_device

Tree = Dict[str, torch.Tensor]


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
        inv = 1.0 / accum
        return loss_sum * inv, {n: g * inv for n, g in zip(names, grads)}

    return fn


def make_train_step(model: nn.Module, ocfg: optim.AdamWConfig, *,
                    accum: int = 1, device=None,
                    cross_pod_mode: str = "xla"):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"}): accumulated loss-and-grad, then AdamW,
    on ``device`` (the card unless the caller passes ``device="cpu"``),
    where the model must lie.  Only ``cross_pod_mode="xla"`` is
    ported."""
    if cross_pod_mode != "xla":
        raise NotImplementedError(
            f"cross_pod_mode {cross_pod_mode!r} is not ported yet: "
            "ROADMAP.md queue 1 items 5-6 (the collective layer, the "
            "manual-sync train modes)")
    check_on_device(model, resolve_device(device))
    lg = make_loss_and_grad(model, accum=accum)

    def step(params: Tree, opt_state: optim.OptState, batch: Tree):
        loss, grads = lg(params, batch)
        params, opt_state, om = optim.apply(ocfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


def init_train_state(model: nn.Module, ocfg: optim.AdamWConfig, *,
                     seed: Optional[int] = 0
                     ) -> Tuple[Tree, optim.OptState]:
    """(params, opt_state): the model's weights drawn from ``seed`` (on the
    model's device), or kept as they are with ``seed=None`` (weights loaded
    with ``load_state_dict``, e.g. bridged from the reference), as a dict of
    tensors by name that shares the model's storage, and AdamW's state."""
    if seed is not None:
        dev = next(model.parameters()).device
        model.init(torch.Generator(device=dev).manual_seed(seed))
    params = {n: p.detach() for n, p in model.named_parameters()}
    return params, optim.init(ocfg, params)


def batch_to(batch, device) -> Tree:
    """A numpy batch of the corpus as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    """The reference's fields for the single-device loop; checkpointing's
    (``ckpt_every``, ``ckpt_dir``, ``async_ckpt``, ``save_sharded``, the
    recovery knobs) come with ROADMAP.md queue 1 item 7, and the
    manual-sync modes' with items 5-6."""
    n_steps: int = 100
    log_every: int = 10
    accum: int = 1
    heartbeat_timeout_s: float = 60.0


class Trainer:
    def __init__(self, model: nn.Module, ocfg: optim.AdamWConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig, *,
                 device=None):
        """Trains ``model`` on ``device``, the card unless the caller
        passes ``device="cpu"``."""
        self.device = resolve_device(device)
        self.model = model
        self.ocfg = ocfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.heartbeat = HeartbeatMonitor(
            timeout_s=tcfg.heartbeat_timeout_s)
        self.straggler = StragglerDetector()
        self.step_fn = make_train_step(model, ocfg, accum=tcfg.accum,
                                       device=self.device)
        self.history: list = []

    def run(self, *, seed: Optional[int] = 0) -> Dict[str, Any]:
        """Trains ``n_steps`` from the weights of ``seed`` (``None``: the
        model's weights as they are).  Returns {"params", "opt_state",
        "history", "stragglers", "recovery"}; "recovery" is None until
        checkpoint recovery is ported."""
        tcfg, dev = self.tcfg, self.device
        params, opt_state = init_train_state(self.model, self.ocfg,
                                             seed=seed)
        prefetch = Prefetcher(SyntheticCorpus(self.data_cfg))
        try:
            for step in range(tcfg.n_steps):
                t0 = time.perf_counter()
                _, batch = prefetch.next()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch_to(batch, dev))
                if dev.type == "cuda":
                    # the step's time, not the time to enqueue it
                    torch.cuda.synchronize(dev)
                dt = time.perf_counter() - t0
                self.heartbeat.beat(worker=0, t=time.time())
                self.straggler.record(dt)
                if step % tcfg.log_every == 0:
                    self.history.append(
                        {"step": step,
                         "loss": float(metrics["loss"]),
                         "sec_per_step": dt})
        finally:
            prefetch.close()
        return {"params": params, "opt_state": opt_state,
                "history": self.history,
                "stragglers": self.straggler.summary(),
                "recovery": None}
