"""Deterministic sharded synthetic-token pipeline with bounded prefetch.

A copy of the reference's ``repro/data/pipeline.py`` (pure NumPy; the port
imports nothing of ``repro``): the same ``SeedSequence([seed, step,
host_id])`` draws give the same batches.

Determinism contract: batch(step, host) is a pure function of (seed, step,
host) — resuming from a checkpoint at step N reproduces the exact stream, and
elastic re-sharding (host count change) re-partitions batches without
replaying state. That property is what makes checkpoint/restart exact.

Straggler mitigation: the prefetch queue is bounded; a slow host only ever
stalls itself `depth` batches back, and `skip_slow` lets the caller drop a
batch that missed its deadline (the train loop logs and continues — the
standard large-fleet policy of sacrificing a batch over stalling the step).
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens (stand-in for a tokenized corpus)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        # zipf-like marginal over the vocab, cheap to sample
        u = rng.random((self.local_batch, self.seq_len + 1))
        toks = np.minimum(
            (self.vocab * u**3).astype(np.int32), self.vocab - 1
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Bounded background prefetch over a step-indexed source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self, timeout: float | None = None, skip_slow: bool = False):
        """Returns (step, batch). With skip_slow, a timeout returns None
        instead of blocking (the caller decides to reuse/skip)."""
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            if skip_slow:
                return None
            raise

    def close(self):
        self._stop.set()
