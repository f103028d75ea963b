"""Deterministic synthetic LM data pipeline: a copy of the reference's
``data/pipeline.py`` (numpy only, unchanged).

Determinism is a first-class requirement here: the MultiVic execution
model schedules everything at compile time, and fault-tolerant restart
(runtime/) must resume the EXACT token stream from a step counter alone.
The dataset is therefore a pure function (step, host) -> batch, with a
background prefetch thread layered on top.  Batches are numpy int32;
the trainer turns them into ``torch.long`` tensors on its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 1234
    # synthetic structure: token t+1 depends on token t (so a model can
    # actually learn it and the loss decreases in integration tests)
    structure: str = "markov"   # markov | uniform
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLMDataset:
    """Pure-function batches: batch_at(step) is reproducible forever."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.num_hosts == 0
        self.local_batch = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(cfg.seed)
        # fixed random permutation as the markov transition
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, step, c.host_id, 0xD1CE))
        shape = (self.local_batch, c.seq_len + 1)
        if c.structure == "uniform":
            toks = rng.integers(0, c.vocab_size, shape, dtype=np.int32)
        else:
            first = rng.integers(0, c.vocab_size, (self.local_batch, 1),
                                 dtype=np.int32)
            toks = np.empty(shape, np.int32)
            toks[:, 0] = first[:, 0]
            noise = rng.random(shape) < 0.1   # 10% noise tokens
            rand = rng.integers(0, c.vocab_size, shape, dtype=np.int32)
            for t in range(1, shape[1]):
                nxt = self._perm[toks[:, t - 1]]
                toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def make_train_iterator(cfg: DataConfig, start_step: int = 0,
                        prefetch: int = 2) -> Iterator[dict]:
    """Background-thread prefetching iterator starting at start_step
    (checkpoint-restart aware)."""
    ds = SyntheticLMDataset(cfg)
    q: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    class _It:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _It()
