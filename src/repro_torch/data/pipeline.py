"""Token data pipeline: deterministic synthetic corpus, host-sharded,
with background prefetch.

The corpus is a seeded Zipf-ish token stream with local structure
(Markov bigram mixing) so the ~100M-model training example shows a real
loss curve, not memorized noise.  Every batch is derived from
``(seed, step)`` alone — restart-safe: after checkpoint restore the
pipeline regenerates exactly the batches it would have produced
(``state_dict``/``load_state`` carry the step counter).

Sharding: each data-parallel host generates only its slice of the global
batch (``host_index``/``host_count``), the standard per-host input
pipeline for multi-pod training.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    prefetch: int = 2
    zipf_a: float = 1.2
    mix: float = 0.7          # bigram-structure mixing weight


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.step = 0
        self._local = cfg.global_batch // cfg.host_count
        # fixed bigram successor table: token t prefers (t*a+b)%V zone
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        self._succ = rng.integers(0, cfg.vocab,
                                  size=(min(cfg.vocab, 4096),), dtype=np.int64)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._zipf = p / p.sum()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch -----------------------------------------------------
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_index))
        b, s = self._local, cfg.seq_len
        zipf_draw = rng.choice(cfg.vocab, size=(b, s + 1), p=self._zipf)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = zipf_draw[:, 0]
        follow = rng.random((b, s)) < cfg.mix
        for t in range(1, s + 1):
            prev = toks[:, t - 1] % len(self._succ)
            structured = (self._succ[prev] + (t % 7)) % cfg.vocab
            toks[:, t] = np.where(follow[:, t - 1], structured,
                                  zipf_draw[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    # -- iteration + prefetch -----------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._queue is None:
            self._start_prefetch()
        batch = self._queue.get()
        self.step += 1
        return batch

    def _start_prefetch(self) -> None:
        self._queue = queue.Queue(maxsize=self.cfg.prefetch)
        start = self.step

        def worker():
            step = start
            while not self._stop.is_set():
                b = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._queue.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._queue = None
        self._thread = None
        self._stop = threading.Event()

    # -- restart-safe state -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "corpus seed mismatch"
        self.close()
        self.step = int(state["step"])
