"""Deterministic synthetic LM data pipeline of the port (a copy of
``repro/data.py``, which the port may not import: batches are bitwise those
of the reference for the same (seed, step, shard)).

Zipf-distributed token streams with document packing; per-host sharded
loading (each data-parallel host materializes only its shard) and a
background prefetch thread — the substrate a real cluster run would swap
for a tokenized corpus reader.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_a: float = 1.2
    mean_doc_len: int = 256
    eos_id: int = 0
    seed: int = 1234


class SyntheticCorpus:
    """Deterministic (seed, step, shard) -> batch generator."""

    def __init__(self, cfg: DataConfig, *, shard: int = 0,
                 n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.shard, 0xC0FFEE))
        n_tok = self.local_batch * (cfg.seq_len + 1)
        toks = rng.zipf(cfg.zipf_a, size=n_tok).astype(np.int64)
        toks = (toks % (cfg.vocab_size - 1)) + 1        # reserve 0 for EOS
        # document packing: EOS every ~mean_doc_len tokens
        doc_ends = rng.geometric(1.0 / cfg.mean_doc_len, size=n_tok // 16)
        pos = np.cumsum(doc_ends)
        pos = pos[pos < n_tok]
        toks[pos] = cfg.eos_id
        toks = toks.reshape(self.local_batch, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "targets": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with a bounded queue."""

    def __init__(self, corpus: SyntheticCorpus, depth: int = 2,
                 start_step: int = 0):
        self.corpus = corpus
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.corpus.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> Tuple[int, Dict[str, np.ndarray]]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
