"""Optimizers of the reference (``repro/train/optimizer.py``) in PyTorch:
AdamW, and Adafactor (factored second moments, no first moment) for the
models above 200B parameters, where AdamW's state would not fit.

Parameters, gradients and state are dicts keyed by parameter name (as
``lm.named_parameters()`` gives them). ``update`` writes the new values into
the parameters' and the state's tensors in place (the reference returns new
trees; at gemma-2b's width a second copy of 10 GB of parameters would not
pay) and returns both.

On a device mesh the parameters and gradients are ``DTensor``s: the state
is laid out in their placements (Adafactor's row and column moments in the
placements the parameter's leave them) and every update runs on the local
shards. What spans a split dim is reduced over the mesh dims that split it:
Adafactor's means of g² and of its row moment, and the update's RMS.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.layers import _is_dtensor
from repro_torch.models.layers import local_shard as _local

F32 = torch.float32


def _zeros(p, shape=None, pls=None):
    """Float32 zeros of ``shape`` (default: ``p``'s) on ``p``'s device; for a
    ``DTensor`` ``p``, a ``DTensor`` in placements ``pls`` (default: ``p``'s)
    whose local shard only is allocated."""
    shape = torch.Size(p.shape if shape is None else shape)
    if not _is_dtensor(p):
        return torch.zeros(shape, dtype=F32, device=p.device)
    from torch.distributed.tensor import DTensor

    mesh, pls = p.device_mesh, tuple(p.placements if pls is None else pls)
    local = list(shape)
    for i, pl in enumerate(pls):
        if pl.is_shard():
            local[pl.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=F32, device=p.to_local().device), mesh,
                              pls, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _split_groups(p, dims):
    """The process groups of the mesh dims that split any of tensor dims
    ``dims`` of ``p`` (none for a plain tensor)."""
    if not _is_dtensor(p):
        return []
    dims = {d % p.ndim for d in dims}
    return [p.device_mesh.get_group(i) for i, pl in enumerate(p.placements)
            if pl.is_shard() and pl.dim in dims]


def _sum(t, groups):
    import torch.distributed as dist

    for group in groups:
        dist.all_reduce(t, group=group)
    return t


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
        return {"m": {n: _zeros(p) for n, p in params.items()},
                "v": {n: _zeros(p) for n, p in params.items()},
                "step": _step_tensor(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(F32)
        c1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
        c2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
        for name, p in params.items():
            g = _local(grads[name]).to(F32)
            m, v, p = _local(state["m"][name]), _local(state["v"][name]), _local(p)
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

    def _moment_placements(p):
        """The placements of ``vr`` (p without its last dim) and ``vc`` (p
        without its second-last dim) of a ``DTensor`` ``p``."""
        from torch.distributed.tensor import Replicate, Shard

        nd, vr, vc = p.ndim, [], []
        for pl in p.placements:
            d = pl.dim if pl.is_shard() else None
            vr.append(Replicate() if d in (None, nd - 1) else pl)
            vc.append(Replicate() if d in (None, nd - 2) else Shard(d - (d == nd - 1)))
        return vr, vc

    def init(params):
        def per(p):
            if _factored(p.shape):
                vr, vc = _moment_placements(p) if _is_dtensor(p) else (None, None)
                return {"vr": _zeros(p, p.shape[:-1], vr),
                        "vc": _zeros(p, p.shape[:-2] + p.shape[-1:], vc)}
            return {"v": _zeros(p)}

        return {"s": {n: per(p) for n, p in params.items()}, "step": _step_tensor(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"] + 1
        t = step.to(F32)
        beta = 1.0 - t ** (-decay)
        for name, param in params.items():
            g = _local(grads[name]).to(F32)
            s = {k: _local(v) for k, v in state["s"][name].items()}
            p = _local(param)
            g2 = g * g + eps
            if "vr" in s:
                n_last, n_second = param.shape[-1], param.shape[-2]
                # the means over a split dim: sums over its ranks, then / its size
                mean_r = _sum(g2.sum(dim=-1), _split_groups(param, [-1])) / n_last
                mean_c = _sum(g2.sum(dim=-2), _split_groups(param, [-2])) / n_second
                s["vr"].mul_(beta).add_((1 - beta) * mean_r)
                s["vc"].mul_(beta).add_((1 - beta) * mean_c)
                denom = _sum(s["vr"].sum(dim=-1, keepdim=True),
                             _split_groups(param, [-2])) / n_second
                r = (s["vr"] / torch.clamp(denom, min=eps))[..., None]
                u = g / torch.sqrt(torch.clamp(r * s["vc"][..., None, :], min=eps))
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                u = g / torch.sqrt(torch.clamp(s["v"], min=eps))
            # the RMS of the whole update
            ms = _sum((u * u).sum(), _split_groups(param, range(param.ndim))) / param.numel()
            rms = torch.sqrt(ms + 1e-12)
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
