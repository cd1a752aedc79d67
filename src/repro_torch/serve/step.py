"""Serving steps: prefill (forward, last-position logits) and decode (one
token against a KV cache), as ``repro/serve/step.py``. Both run under
``torch.inference_mode()``: the parameters are trainable, and serving
builds no autograd graph. On a mesh (``runtime.mesh``) every rank calls them
with the same inputs and gets the whole batch's logits and tokens."""
from __future__ import annotations

import torch

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Runtime, last_position, whole
from repro_torch.models.model import apply_decode, apply_lm


def make_prefill_step(cfg: ModelConfig, runtime: Runtime):
    @torch.inference_mode()
    def prefill_step(lm, batch):
        with telemetry.span("serve/prefill"):
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            logits, _ = apply_lm(lm, cfg, runtime, batch["tokens"], extra)
            return whole(last_position(logits))[:, 0, :]

    return prefill_step


def make_decode_step(cfg: ModelConfig, runtime: Runtime):
    @torch.inference_mode()
    def decode_step(lm, batch, caches):
        extra = {k: v for k, v in batch.items() if k not in ("tokens", "index")}
        logits, new_caches = apply_decode(
            lm, cfg, runtime, batch["tokens"], caches, batch["index"], extra
        )
        last = whole(last_position(logits))[:, 0, :]
        next_token = torch.argmax(last, dim=-1).to(torch.int32)
        return next_token, last, new_caches

    return decode_step
