"""Optimizers of the reference (``repro/train/optimizer.py``) in PyTorch:
AdamW, and Adafactor (factored second moments, no first moment) for the
models above 200B parameters, where AdamW's state would not fit.

Parameters, gradients and state are dicts keyed by parameter name (as
``lm.named_parameters()`` gives them). ``update`` writes the new values into
the parameters' and the state's tensors in place (the reference returns new
trees; at gemma-2b's width a second copy of 10 GB of parameters would not
pay) and returns both.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (params, state), in place
    name: str = "opt"


def _step_tensor(params) -> torch.Tensor:
    device = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW: float32 moments m and v, bias correction, weight decay
    decoupled from the gradient; each parameter updated in float32 and
    stored in its own dtype."""

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)

        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "step": _step_tensor(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(F32)
        c1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
        for name, p in params.items():
            g = grads[name].to(F32)
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_((1 - b1) * g)  # b1·m + (1 - b1)·g
            v.mul_(b2).add_((1 - b2) * g * g)
            denom = (v / c2).sqrt_().add_(eps)
            p32 = p.to(F32)
            delta = (m / c1).div_(denom).add_(weight_decay * p32)
            p.copy_(p32 - lr * delta)
        state["step"] = step
        return params, state

    return Optimizer(init=init, update=update, name="adamw")


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              weight_decay: float = 0.0, clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), no first
    moment: row and column means ``vr``/``vc`` where both of the last two
    dimensions are at least 8, the full ``v`` elsewhere; the update clipped
    to RMS ``clip_threshold``."""

    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8

    def init(params):
        def per(p):
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}

        return {"s": {n: per(p) for n, p in params.items()}, "step": _step_tensor(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(F32)
        beta = 1.0 - t ** (-decay)
        for name, p in params.items():
            g = grads[name].to(F32)
            s = state["s"][name]
            g2 = g * g + eps
            if "vr" in s:
                s["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                s["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                denom = s["vr"].mean(dim=-1, keepdim=True)
                r = (s["vr"] / torch.clamp(denom, min=eps))[..., None]
                u = g / torch.sqrt(torch.clamp(r * s["vc"][..., None, :], min=eps))
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                u = g / torch.sqrt(torch.clamp(s["v"], min=eps))
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p32 = p.to(F32)
            p_new = p32 - lr * u
            if weight_decay:
                p_new = p_new - lr * weight_decay * p32
            p.copy_(p_new)
        state["step"] = step
        return params, state

    return Optimizer(init=init, update=update, name="adafactor")


def for_config(cfg, lr: float = 3e-4) -> Optimizer:
    """AdamW below 200B total params; Adafactor above (memory budget)."""
    if cfg.total_params() > 2e11:
        return adafactor(lr=lr)
    return adamw(lr=lr)
