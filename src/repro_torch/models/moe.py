"""Mixture-of-Experts block of the reference's model substrate
(``repro/models/moe.py``), in PyTorch, in the reference's ``local`` mode:
router and top-k, then a capacity-based scatter into per-expert buffers
(E, C, d), the batched expert product, and the gather back.

The reference's ``a2a`` and ``replicated`` modes spread the experts over a
device mesh; the port runs on one device, where the reference takes this
mode too (``mesh is None``). Tokens past an expert's capacity fall through
with a zero update; ``cf = E / top_k`` is dropless.

Parameters keep the reference's leaves: ``router`` (d, E) in float32 whatever
the model's dtype (cast to the compute dtype before the product, as the
reference does), ``w_gate`` / ``w_up`` (E, d, f) and ``w_down`` (E, f, d).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Runtime, _param

F32 = torch.float32
_ROUTE_SINKS: list[list] = []  # lists collecting expert ids, see recording_routes
_ROUTE_SOURCES: list = []  # iterators of expert ids to use, see replaying_routes


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        m = cfg.moe
        d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
        self.router = _param((d, E), device, F32)
        self.w_gate = _param((E, d, f), device, dtype)
        self.w_up = _param((E, d, f), device, dtype)
        self.w_down = _param((E, f, d), device, dtype)


@contextlib.contextmanager
def recording_routes():
    """Yields a list that collects the expert ids (B, S, k) of every
    ``apply_moe`` call made inside the block, in call order (one entry per
    MoE layer of a forward)."""
    sink: list = []
    _ROUTE_SINKS.append(sink)
    try:
        yield sink
    finally:
        # by identity: list.remove would drop the first *equal* sink, another
        # open (and equally empty) block's
        _ROUTE_SINKS[:] = [other for other in _ROUTE_SINKS if other is not sink]


@contextlib.contextmanager
def replaying_routes(routes):
    """Inside the block, ``apply_moe`` takes its expert ids from ``routes``
    (one (B, S, k) tensor per call, in call order, as ``recording_routes``
    collects them) instead of its router's top-k, with the router's
    probabilities at those ids as their weights. Two numerical routes of one
    model can so be compared with the same routing."""
    _ROUTE_SOURCES.append(iter(routes))
    try:
        yield
    finally:
        _ROUTE_SOURCES.pop()


def replaying() -> bool:
    """Whether ``apply_moe`` takes its expert ids from a ``replaying_routes``
    block here."""
    return bool(_ROUTE_SOURCES)


@contextlib.contextmanager
def recomputing(routes=None):
    """Inside the block no ``recording_routes`` block records expert ids, and
    ``apply_moe`` takes them from ``routes`` where given (as
    ``replaying_routes``): the recompute of a checkpointed layer is not
    another forward, and it takes the route its forward took (the same
    top-k, or the ids its forward replayed), whose gradient it gives."""
    sinks = _ROUTE_SINKS[:]
    _ROUTE_SINKS.clear()
    try:
        with replaying_routes(routes) if routes is not None else contextlib.nullcontext():
            yield
    finally:
        _ROUTE_SINKS[:] = sinks


def _capacity(n_tokens: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * k * cf / E))
    return max(8 * ((c + 7) // 8), 8)


def _top_k(probs, k: int):
    """The k largest along the last axis, largest first, equal values in the
    order of their index (as ``jax.lax.top_k``; ``torch.topk`` orders ties
    otherwise, and router logits in bf16 tie often)."""
    pk, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return pk[..., :k], ids[..., :k]


def _dispatch_positions(ids_flat, E: int):
    """Position of each (token, k) slot within its expert's buffer, in
    token-major order: ids_flat (T·k,) -> (T·k,) int64."""
    one_hot = F.one_hot(ids_flat, E)
    pos = torch.cumsum(one_hot, dim=0) - one_hot
    return (pos * one_hot).sum(dim=-1)


def _expert_ffn(xe, w_gate, w_up, w_down, act: str, dt):
    """xe: (E, C, d); weights (E, d, f) / (E, f, d)."""
    gate = torch.bmm(xe, w_gate.to(dt))
    up = torch.bmm(xe, w_up.to(dt))
    if act == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.silu(gate) * up
    return torch.bmm(h, w_down.to(dt))


def _moe_block_local(x2, ids, pk, w_gate, w_up, w_down, E, k, C, act, dt):
    """Scatter -> expert products -> gather on one device. x2: (T, d); ids,
    pk: (T, k). A dropped slot adds zeros at position 0 of its expert (the
    reference's ``.at[e, pos].add``), so it never overwrites the token kept
    there."""
    T, d = x2.shape
    pos = _dispatch_positions(ids.reshape(-1), E).reshape(T, k)
    keep = pos < C
    slot = torch.where(keep, pos, 0)
    xe = torch.zeros((E, C, d), dtype=x2.dtype, device=x2.device)
    for i in range(k):
        xe.index_put_((ids[:, i], slot[:, i]), torch.where(keep[:, i, None], x2, 0),
                      accumulate=True)
    ye = _expert_ffn(xe, w_gate, w_up, w_down, act, dt)
    y = torch.zeros((T, d), dtype=ye.dtype, device=ye.device)
    for i in range(k):
        y_i = ye[ids[:, i], slot[:, i]]
        y = y + torch.where(keep[:, i, None], y_i, 0) * pk[:, i, None].to(dt)
    return y


def apply_moe(p: MoE, x, cfg: ModelConfig, runtime: Runtime, cf: float = 1.25):
    """Returns (y (B, S, d), aux): aux is the Switch load-balance loss
    E · Σ_e f_e · P_e in float32."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    B, S, d = x.shape
    dt = runtime.compute_dtype

    logits = torch.einsum("bsd,de->bse", x, p.router.to(dt)).to(F32)
    probs = torch.softmax(logits, dim=-1)
    if _ROUTE_SOURCES:
        ids = next(_ROUTE_SOURCES[-1]).to(probs.device)
        pk = torch.gather(probs, -1, ids)
    else:
        pk, ids = _top_k(probs, k)
    pk = pk / torch.clamp(pk.sum(-1, keepdim=True), min=1e-9)
    for sink in _ROUTE_SINKS:
        sink.append(ids)

    f_e = F.one_hot(ids, E).to(F32).sum(dim=2).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e)

    C = _capacity(B * S, k, E, cf)
    y = _moe_block_local(x.reshape(-1, d), ids.reshape(-1, k), pk.reshape(-1, k),
                         p.w_gate, p.w_up, p.w_down, E, k, C, cfg.act, dt)
    return y.reshape(B, S, d), aux
