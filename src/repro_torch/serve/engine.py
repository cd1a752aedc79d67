"""Batched serving engine: prefill, then greedy decode over a decode cache (the
KV cache of attention, the conv/SSM state of Mamba2) over a fixed number of
batch slots, with the reference's semantics
(``repro/serve/engine.py``): requests are admitted in groups of up to
``slots``, left-padded with token 0 (no pad mask), prefilled by ``apply_lm``,
the prompt replayed through decode steps to fill the cache, and decoded
greedily until every request of the group has ``max_new`` tokens or the
cache's ``max_len`` is reached. The decode step runs eagerly, and the whole
run under ``torch.inference_mode()`` (no autograd graph).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Runtime, last_position, whole
from repro_torch.models.model import apply_decode, apply_lm, init_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Fixed-slot batching over a shared KV cache. ``runtime=None`` is
    float32 compute on the CUDA device (RuntimeError without one). A runtime
    with a mesh serves over it: every rank runs the engine on the same
    requests (its parameters' and caches' shards), and every rank's requests
    get the same tokens."""

    def __init__(self, cfg: ModelConfig, params, runtime: Runtime | None = None,
                 slots: int = 4, max_len: int = 256):
        self.cfg = cfg
        self.params = params
        self.runtime = runtime or Runtime(compute_dtype=torch.float32)
        self.slots = slots
        self.max_len = max_len
        self.queue: deque[Request] = deque()

    def submit(self, req: Request):
        self.queue.append(req)

    def _decode(self, params, tokens, caches, index: int):
        logits, new_caches = apply_decode(params, self.cfg, self.runtime, tokens, caches, index)
        nxt = torch.argmax(whole(last_position(logits))[:, 0, :], dim=-1).to(torch.int32)
        return nxt, new_caches

    @torch.inference_mode()
    def run(self, max_steps: int = 512) -> list[Request]:
        """Admit up to ``slots`` requests, prefill them as a batch, decode
        until all are done, repeat."""
        dev = self.runtime.device
        finished = []
        while self.queue and max_steps > 0:
            group = [self.queue.popleft() for _ in range(min(self.slots, len(self.queue)))]
            S = max(len(r.prompt) for r in group)
            B = len(group)
            toks = np.zeros((B, S), np.int32)
            for i, r in enumerate(group):
                toks[i, S - len(r.prompt):] = r.prompt  # simple left pad with 0
            caches = init_cache(self.cfg, self.runtime, B, self.max_len,
                                dtype=self.runtime.compute_dtype)
            cur = torch.as_tensor(toks, device=dev)
            logits, _ = apply_lm(self.params, self.cfg, self.runtime, cur)
            # replay the prompt through decode steps to fill the cache
            for t in range(S):
                nxt, caches = self._decode(self.params, cur[:, t:t + 1], caches, t)
            last = whole(last_position(logits))[:, 0, :]
            next_tok = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
            for step in range(max(r.max_new for r in group)):
                max_steps -= 1
                for i, r in enumerate(group):
                    if not r.done:
                        r.out.append(int(next_tok[i]))
                        if len(r.out) >= r.max_new:
                            r.done = True
                if all(r.done for r in group) or S + step + 1 >= self.max_len:
                    break
                nxt, caches = self._decode(
                    self.params, torch.as_tensor(next_tok, device=dev)[:, None], caches, S + step
                )
                next_tok = nxt.cpu().numpy()
            finished += group
        return finished
