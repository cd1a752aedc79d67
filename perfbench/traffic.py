"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes the run's inputs from ``--seed``.

A mix of ``"kind": "prefill"`` is a closed backlog of prompts, formed into
groups by the serving Engine's admission rule (a frozen copy of
``repro_torch/serve/engine.py::Engine.run``): first in, first out, groups of
``slots`` requests, each left-padded with ``pad_token`` to its group's
longest prompt, and further to a whole multiple of ``pad_multiple`` where
the configuration's serving group sets one (a departure from the Engine:
the program's SSD scan refuses a length that is not a whole multiple of its
chunk). The prompt lengths are a fixed set, the quantiles of the
mix's length distribution, dealt into groups once by the mix's
``layout_seed``, and sent in that order cycle after cycle; a run's seed
orders the requests of each group and draws the tokens. So every seed sends
the same work, and a window of a given length ends at the same place in it.

A mix of ``"kind": "train"`` is a stream of batches: a frozen copy of the
program's ``data/pipeline.SyntheticTokens`` (Zipf-like tokens from
``SeedSequence([seed, step, host])``), fed ahead by a bounded prefetch
thread as the program's ``Trainer`` does.
"""
from __future__ import annotations

import dataclasses
import json
import math
import queue
import statistics
import threading
from pathlib import Path

import numpy as np


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


# ----------------------------------------------------------------------------
# Prefill backlog
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class Group:
    rids: list  # request ids, in row order
    lengths: list  # real prompt tokens of each row
    tokens: np.ndarray  # (slots, S) int64, left-padded

    @property
    def real_tokens(self) -> int:
        return int(sum(self.lengths))

    @property
    def shape(self) -> tuple:
        return tuple(self.tokens.shape)


def prompt_lengths(mix: dict) -> list[int]:
    """The cycle's prompt lengths: quantiles (i + 1/2) / n of the lognormal,
    rounded up to a whole token and clipped into [min, max]."""
    spec = mix["lengths"]
    if spec["dist"] != "lognormal":
        raise ValueError(f"traffic: unknown length distribution {spec['dist']!r}")
    n = mix["cycle_requests"]
    z = statistics.NormalDist()
    out = []
    for i in range(n):
        raw = spec["median"] * math.exp(spec["sigma"] * z.inv_cdf((i + 0.5) / n))
        out.append(min(max(math.ceil(raw), spec["min"]), spec["max"]))
    return out


def layout(mix: dict) -> list[list[int]]:
    """The cycle's groups of lengths, dealt once from ``layout_seed``."""
    lengths = prompt_lengths(mix)
    slots = mix["slots"]
    if len(lengths) % slots:
        raise ValueError("traffic: cycle_requests must be a multiple of slots")
    order = np.random.default_rng(mix["layout_seed"]).permutation(len(lengths))
    dealt = [lengths[i] for i in order]
    return [dealt[i:i + slots] for i in range(0, len(dealt), slots)]


def padded_length(longest: int, pad_multiple: int = 1) -> int:
    """A group's padded length S: its longest prompt, rounded up to a whole
    multiple of ``pad_multiple``."""
    return -(-longest // pad_multiple) * pad_multiple


def group_shapes(mix: dict, pad_multiple: int = 1) -> list[tuple]:
    """Every (slots, S) shape the mix's groups take, largest first."""
    return sorted({(mix["slots"], padded_length(max(g), pad_multiple)) for g in layout(mix)},
                  key=lambda s: -s[1])


def engine_groups(prompts: list, slots: int, pad_token: int, pad_multiple: int = 1):
    """The Engine's admission rule on (rid, prompt) pairs in arrival order:
    FIFO groups of up to ``slots``, each row left-padded with ``pad_token`` to
    the group's longest prompt (rounded up to a whole multiple of
    ``pad_multiple``). Yields (rids, lengths, tokens (B, S))."""
    for i in range(0, len(prompts), slots):
        group = prompts[i:i + slots]
        S = padded_length(max(len(p) for _, p in group), pad_multiple)
        toks = np.full((len(group), S), pad_token, np.int64)
        for row, (_, p) in enumerate(group):
            toks[row, S - len(p):] = p
        yield [r for r, _ in group], [len(p) for _, p in group], toks


class Backlog:
    """The run's groups, made on demand: group g is in cycle g // groups a
    cycle. ``vocab`` bounds the uniform token ids; ``pad_multiple`` is the
    configuration's (1: the Engine's rule as it is)."""

    def __init__(self, mix: dict, seed: int, vocab: int, pad_multiple: int = 1):
        if mix["kind"] != "prefill":
            raise ValueError(f"traffic: {mix['kind']!r} is not a prefill mix")
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.pad_multiple = int(pad_multiple)
        self._layout = layout(mix)
        self.groups_per_cycle = len(self._layout)

    def group(self, g: int) -> Group:
        lengths = list(self._layout[g % self.groups_per_cycle])
        rng = np.random.default_rng([self.seed, 1, g])
        lengths = [lengths[i] for i in rng.permutation(len(lengths))]
        slots = self.mix["slots"]
        prompts = [(g * slots + row, rng.integers(0, self.vocab, n, dtype=np.int64))
                   for row, n in enumerate(lengths)]
        (rids, lens, toks), = engine_groups(prompts, slots, self.mix["pad_token"],
                                            self.pad_multiple)
        return Group(rids=rids, lengths=lens, tokens=toks)


def pad_share(mix: dict, pad_multiple: int = 1) -> float:
    """Share of the padded tokens of a cycle that are pads."""
    groups = layout(mix)
    padded = sum(len(g) * padded_length(max(g), pad_multiple) for g in groups)
    return 1.0 - sum(map(sum, groups)) / padded


# ----------------------------------------------------------------------------
# Training batches: frozen copies of the program's SyntheticTokens and prefetch
# ----------------------------------------------------------------------------
class SyntheticTokens:
    """Zipf-ish synthetic LM tokens (a copy of the program's
    ``data/pipeline.SyntheticTokens``): batch(step) is a pure function of
    (seed, step, host)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, seed: int = 0,
                 n_hosts: int = 1, host_id: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab = vocab
        self.seq_len = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host_id = host_id

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_id]))
        u = rng.random((self.local_batch, self.seq_len + 1))
        toks = np.minimum((self.vocab * u**3).astype(np.int32), self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Bounded background prefetch over a step-indexed source (a copy of the
    program's ``data/pipeline.Prefetcher``), with ``close`` joining its
    thread."""

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

    def next(self, timeout: float | None = None):
        return self.q.get(timeout=timeout)

    def close(self):
        self._stop.set()
        self._thread.join()


def train_source(mix: dict, seed: int, vocab: int) -> SyntheticTokens:
    if mix["kind"] != "train":
        raise ValueError(f"traffic: {mix['kind']!r} is not a train mix")
    return SyntheticTokens(vocab, mix["seq_len"], mix["batch"], seed=int(seed))
