"""Training step (``repro/train/step.py``): microbatched gradient
accumulation, the model's forward with each layer rematerialised (see
``models/model.py``), and the optimizer update.

The reference's int8 error-feedback cross-pod all-reduce
(``compress_allreduce_pod``) needs a device mesh; the port runs on one device
and leaves it out (ROADMAP, multi-GPU).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Runtime
from repro_torch.models.model import lm_loss
from repro_torch.train.optimizer import Optimizer

F32 = torch.float32


def _split(x, mb: int):
    """``x`` (NumPy array or tensor) cut into ``mb`` equal, contiguous parts
    along its batch axis, as the reference's reshape to (mb, B // mb, ...)."""
    n = x.shape[0] // mb
    return [x[i * n:(i + 1) * n] for i in range(mb)]


def make_train_step(cfg: ModelConfig, runtime: Runtime, optimizer: Optimizer,
                    microbatches: int | None = None):
    """Returns train_step(lm, opt_state, batch) -> (lm, opt_state, metrics),
    which updates ``lm``'s parameters in place.

    batch: dict(tokens (B, S) int, labels (B, S) int [, patches | frames]),
    NumPy arrays or tensors. With ``mb`` microbatches (the config's unless
    given) the batch is cut into ``mb`` parts along B, each part's gradient
    is summed in float32 and the sum divided by ``mb``, and the loss is the
    parts' mean; then metrics' ``nll`` is that loss and ``aux`` 0, as the
    reference sets them. ``grad_norm`` is the float32 global L2 norm of the
    gradient the optimizer takes."""
    mb = microbatches if microbatches is not None else cfg.microbatches

    def loss_fn(lm, micro):
        extra = {k: v for k, v in micro.items() if k not in ("tokens", "labels")}
        return lm_loss(lm, cfg, runtime, micro["tokens"], micro["labels"], extra)

    def train_step(lm, opt_state, batch):
        params = dict(lm.named_parameters())
        for p in params.values():
            p.grad = None
        acc = {}  # float32 sums of the gradients of parameters in another dtype
        if mb <= 1:
            loss, metrics = loss_fn(lm, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            parts = {k: _split(v, mb) for k, v in batch.items()}
            loss = torch.zeros((), dtype=F32, device=runtime.device)
            for i in range(mb):
                part_loss, _ = loss_fn(lm, {k: v[i] for k, v in parts.items()})
                part_loss.backward()
                loss = loss + part_loss.detach()
                for name, p in params.items():
                    if p.dtype != F32 and p.grad is not None:
                        acc[name] = p.grad.to(F32) + acc.get(name, 0.0)
                        p.grad = None
            loss = loss / mb
            metrics = {"nll": loss, "aux": torch.zeros((), dtype=F32, device=runtime.device)}
        grads = {}
        for name, p in params.items():
            g = acc.get(name, p.grad)
            g = torch.zeros(p.shape, dtype=F32, device=p.device) if g is None else g.to(F32)
            grads[name] = g.div_(mb) if mb > 1 else g  # g is the step's own sum
            p.grad = None
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        optimizer.update(grads, opt_state, params)
        return lm, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step
