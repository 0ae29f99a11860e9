"""Serving substrate of the port: batched decode with KV caches and a
request batcher (counterpart of ``repro/serve.py``).

``make_prefill_step`` is the bulk forward over whole prompts;
``make_serve_step`` the one-token decode; ``BatchedServer`` continuous
batching over a fixed slot count with greedy sampling.  All three run on
the card unless the caller passes ``device="cpu"``.

They take any model of the registry (the dense ``TransformerLM``, the
hybrid ``ZambaLM``, the ``XLSTMLM``) and know nothing of its cache's
structure: the model makes the cache and its decode step updates it.

On a rank grid (``grid``, every rank of which calls the step on the same
global tokens) the steps run under the grid's rules, the reference's
``launch/mesh.py::production_rules(grid, seq_shard=..., long_ctx=...)``,
as the reference's take its mesh rules: each rank keeps its rows of the
batch (``batch``, over the data axes) and, for the dense model, its share
of every layer (``heads``, ``ff``, ``vocab`` over ``model``).  A step
returns the rank's block of the logits, its rows and its vocab columns.
The decode step's ``seq_shard`` splits its cache's sequence (``kv_seq``)
over ``model``, ``long_ctx`` over ``(data, model)`` and keeps the batch
whole on every rank; the dense model and the hybrid then decode by
flash-decode (``models/attention.py::sharded_decode_attention``).  Its
cache is the rank's block of the global cache: its rows, its ``kv_seq``
slice and every key/value head (``model.init_cache`` under the step's
``rules``).  A prefill has no cache to split and takes neither flag.
``BatchedServer`` is single-rank (ROADMAP.md queue 1 item 9).

``BatchedServer`` keeps the JAX server's behaviour, quirks included, so its
tokens can be held against the reference: decode runs in lockstep on one
global position; a request that takes over a slot does not reset that
slot's cache (every row attends to ``arange(S) < pos + 1``, so it sees the
previous occupant's KV entries, and a hybrid or xLSTM model's slot carries
on from the previous occupant's recurrent and conv states); empty slots
feed token 0 and write to the cache; ``run_until_drained`` stops silently
at ``pos >= max_seq - 1``.
"""
from __future__ import annotations

import dataclasses
import queue
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.registry import (check_on_device, grid_rules,
                                         resolve_device)
from repro_torch.sharding import MeshRules, part, use_rules


def local_rows(batch_size: int, rules: Optional[MeshRules]) -> slice:
    """The rows of a global batch of ``batch_size`` that this rank serves
    under ``rules``."""
    return part(batch_size, "batch", rules).slice


def make_serve_step(model, *, device=None, grid=None, seq_shard=False,
                    long_ctx=False):
    """Returns step(cache, tokens (B,1), pos) -> (logits (B,1,V), cache);
    the cache is updated in place.  Logits are f32 for the dense model and
    in the model's dtype for the others, as in the reference.

    On a grid, under ``production_rules(grid, seq_shard=seq_shard,
    long_ctx=long_ctx)`` (``step.rules``): ``tokens`` are the global batch,
    the logits the rank's block (its rows, its vocab columns) and the cache
    the rank's block of the global cache: its rows, its ``kv_seq`` slice
    (the whole sequence where the rules do not split it, or where the
    drop rule keeps it whole) and every key/value head.  Make it with
    ``model.init_cache(B, S)`` under ``use_rules(step.rules)``; a global
    cache's block is its ``sharding.part(S, "kv_seq", step.rules)`` slice
    (and its ``kv_batch`` rows).  Only the rank whose slice holds ``pos``
    writes the new entry."""
    dev = resolve_device(device)
    check_on_device(model, dev)
    rules = grid_rules(model, grid, seq_shard=seq_shard, long_ctx=long_ctx)

    def step(cache, tokens, pos: int):
        rows = local_rows(tokens.shape[0], rules)
        with torch.inference_mode(), use_rules(rules):
            return model.decode_step(cache, tokens[rows].to(dev), pos)

    step.rules = rules
    return step


def make_prefill_step(model, *, device=None, grid=None):
    """Returns step(tokens (B,S)) -> logits (B,S,V): the full-sequence
    forward (logits dtype as ``make_serve_step``'s).  On a grid, under
    ``production_rules(grid)``, the rank's block of the logits."""
    dev = resolve_device(device)
    check_on_device(model, dev)
    rules = grid_rules(model, grid)

    def step(tokens):
        rows = local_rows(tokens.shape[0], rules)
        with torch.inference_mode(), use_rules(rules):
            return model.forward_logits(tokens[rows].to(dev))

    step.rules = rules
    return step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (L,) int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Slot-based continuous batching (greedy sampling).

    Prompts are fed token by token through the decode step (prefill by
    decode, as in the JAX server; ``make_prefill_step`` is the bulk
    prefill).
    """

    def __init__(self, model, *, max_batch: int = 4, max_seq: int = 256,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.step_fn = make_serve_step(model, device=self.device)
        self.cache = model.init_cache(max_batch, max_seq)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = [0] * max_batch
        self.pending: "queue.Queue[Request]" = queue.Queue()
        self.completed: List[Request] = []
        self.pos = 0                # global position (lockstep decode)

    def submit(self, req: Request) -> None:
        self.pending.put(req)

    def _fill_slots(self) -> None:
        for i in range(self.max_batch):
            if self.slots[i] is None and not self.pending.empty():
                self.slots[i] = self.pending.get()
                self.slot_pos[i] = 0

    def _current_tokens(self) -> np.ndarray:
        toks = np.zeros((self.max_batch, 1), np.int64)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            p = self.slot_pos[i]
            if p < len(req.prompt):
                toks[i, 0] = req.prompt[p]
            elif req.out:
                toks[i, 0] = req.out[-1]
        return toks

    def step(self) -> None:
        self._fill_slots()
        if all(s is None for s in self.slots):
            return
        toks = torch.from_numpy(self._current_tokens())
        logits, self.cache = self.step_fn(self.cache, toks, self.pos)
        nxt = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(req.prompt):
                req.out.append(int(nxt[i]))
                if len(req.out) >= req.max_new:
                    req.done = True
                    self.completed.append(req)
                    self.slots[i] = None
        self.pos += 1

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if (self.pending.empty()
                    and all(s is None for s in self.slots)):
                break
            if self.pos >= self.max_seq - 1:
                break
            self.step()
