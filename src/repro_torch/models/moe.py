"""Mixture-of-Experts block of the reference's model substrate
(``repro/models/moe.py``), in PyTorch: router and top-k, then the dispatch,
expert products and combine in one of the reference's three modes:

  local       one device (or a model axis of 1): a capacity-based scatter
              into per-expert buffers (E, C, d), the batched expert product,
              and the gather back.
  a2a         on a mesh, where the tokens of a data shard divide the model
              axis (prefill): each model rank takes its block of the
              tokens, scatters them into fixed-capacity (E, C_loc, d)
              buffers, exchanges them by a tiled all-to-all so that each
              rank holds its E / n experts' slots from every rank, runs its
              experts, returns the results by the inverse all-to-all,
              combines its tokens, and the blocks are all-gathered.
  replicated  decode-sized token counts: every model rank dispatches all the
              tokens of its data shard to its local experts (global ids
              mapped to local slots, other experts' slots dropped), and the
              partial results are all-reduced over the model axis.

The reference writes the last two as ``shard_map`` bodies; here they are the
same code on each rank's local shards with the same collectives on the model
axis's process group. Tokens past an expert's capacity fall through with a
zero update; ``cf = E / top_k`` is dropless (and the modes then agree).

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
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import (Runtime, _param, batch_axes, batch_mean,
                                       batch_rows, enter_split, local_weights, matmul,
                                       model_all_gather, model_all_reduce, model_all_to_all,
                                       model_rank)

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
    T = x2.shape[0]
    pos = _dispatch_positions(ids.reshape(-1), E).reshape(T, k)
    keep = pos < C
    slot = torch.where(keep, pos, 0)
    ye = _expert_ffn(_scatter(x2, ids, slot, keep, E, C), w_gate, w_up, w_down, act, dt)
    return _combine(ye, ids, slot, keep, pk, dt)


def _scatter(x2, ids, slot, keep, n_exp: int, C: int):
    """Each kept (token, slot) of x2 (T, d) into its expert's buffer at its
    position: (n_exp, C, d)."""
    buf = torch.zeros((n_exp, C, x2.shape[1]), dtype=x2.dtype, device=x2.device)
    for i in range(ids.shape[1]):
        buf.index_put_((ids[:, i], slot[:, i]), torch.where(keep[:, i, None], x2, 0),
                       accumulate=True)
    return buf


def _combine(ye, ids, slot, keep, pk, dt):
    """Each token's kept slots gathered from the experts' outputs ye (n_exp,
    C, d), weighted by pk: (T, d)."""
    y = torch.zeros((ids.shape[0], ye.shape[-1]), dtype=ye.dtype, device=ye.device)
    for i in range(ids.shape[1]):
        y_i = ye[ids[:, i], slot[:, i]]
        y = y + torch.where(keep[:, i, None], y_i, 0) * pk[:, i, None].to(dt)
    return y


def moe_mode(cfg: ModelConfig, runtime: Runtime, batch: int, seq: int) -> str:
    """The reference's choice: ``local`` without a model axis, ``a2a`` where
    the tokens of a data shard divide the model axis, else
    ``replicated``."""
    n = runtime.model_axis_size
    if runtime.mesh is None or n <= 1:
        return "local"
    shape = mesh_shape(runtime.mesh)
    data_shards = math.prod(shape[a] for a in runtime.data_axes)
    t_loc = max(batch // data_shards, 1) * seq
    return "a2a" if t_loc % n == 0 and t_loc >= n else "replicated"


def _moe_mesh(p: MoE, x, ids, pk, cfg: ModelConfig, runtime: Runtime, cf: float, batch: int):
    """The ``a2a`` / ``replicated`` dispatch of ``x`` (this rank's rows of a
    batch of ``batch``, whole over the model axis) with its routes; returns
    y in ``x``'s layout. ``x`` and the routing weights ``pk`` enter the
    ranks' split work through ``enter_split``, and each exchange has its
    inverse as its backward."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    B, S, d = x.shape
    dt = runtime.compute_dtype
    n, j = runtime.model_axis_size, model_rank(runtime)
    shape = mesh_shape(runtime.mesh)
    data_shards = math.prod(shape[a] for a in runtime.data_axes)
    rows = batch_axes(runtime, batch)
    if E % n:
        raise ValueError(f"moe: {E} experts do not split over a model axis of {n}")
    if rows and tuple(rows) != tuple(runtime.data_axes):
        raise NotImplementedError(
            f"moe: a batch of {batch} split over only {rows} of the data axes "
            f"{runtime.data_axes}; the reference's shard_map takes all of them or none")
    E_loc = E // n
    w_gate, w_up, w_down = local_weights([(w, 0, dt, False)
                                          for w in (p.w_gate, p.w_up, p.w_down)], runtime)
    x, pk = enter_split(x, runtime), enter_split(pk, runtime)
    x2, ids2, pk2 = x.reshape(-1, d), ids.reshape(-1, k), pk.reshape(-1, k)
    tb = x2.shape[0]

    if moe_mode(cfg, runtime, batch, S) == "a2a":
        if batch % data_shards:
            raise ValueError(f"moe a2a: a batch of {batch} does not split over the "
                             f"{data_shards} data shards")
        t_my = tb // n
        C_loc = _capacity(t_my, k, E, cf)
        mine = slice(j * t_my, (j + 1) * t_my)
        x_my, ids_my, pk_my = x2[mine], ids2[mine], pk2[mine]
        pos = _dispatch_positions(ids_my.reshape(-1), E).reshape(t_my, k)
        keep = pos < C_loc
        slot = torch.where(keep, pos, 0)
        buf = _scatter(x_my, ids_my, slot, keep, E, C_loc)
        # exchange: (E = n·E_loc, C_loc, d) -> (E_loc, n·C_loc, d), sources in rank order
        recv = model_all_to_all(buf, runtime).reshape(n, E_loc, C_loc, d)
        recv = recv.transpose(0, 1).reshape(E_loc, n * C_loc, d)
        ye = _expert_ffn(recv, w_gate, w_up, w_down, cfg.act, dt)
        back = ye.reshape(E_loc, n, C_loc, d).transpose(0, 1).contiguous()
        back = model_all_to_all(back, runtime).reshape(E, C_loc, d)
        y_my = _combine(back, ids_my, slot, keep, pk_my, dt)
        return model_all_gather(y_my, runtime, 0).reshape(B, S, d)

    # replicated: all this data shard's tokens to this rank's experts, psum
    C = _capacity(max(max(batch // data_shards, 1) * S, 1), k, E, cf)
    local_ids = ids2 - j * E_loc
    is_mine = (local_ids >= 0) & (local_ids < E_loc)
    ids_loc = torch.where(is_mine, local_ids, 0)
    pos = _dispatch_positions(ids_loc.reshape(-1), E_loc).reshape(tb, k)
    keep = (pos < C) & is_mine
    slot = torch.where(keep, pos, 0)
    ye = _expert_ffn(_scatter(x2, ids_loc, slot, keep, E_loc, C), w_gate, w_up, w_down,
                     cfg.act, dt)
    return model_all_reduce(_combine(ye, ids_loc, slot, keep, pk2, dt), runtime).reshape(B, S, d)


def apply_moe(p: MoE, x, cfg: ModelConfig, runtime: Runtime, cf: float = 1.25,
              batch: int | None = None):
    """Returns (y (B, S, d), aux): aux is the Switch load-balance loss
    E · Σ_e f_e · P_e in float32. On a mesh ``x`` holds this rank's rows of
    a batch of ``batch`` (default: ``x``'s own), and replayed routes of the
    whole batch are cut to those rows."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    B, S, d = x.shape
    batch = B if batch is None else batch
    dt = runtime.compute_dtype

    if runtime.mesh is None:
        logits = torch.einsum("bsd,de->bse", x, p.router.to(dt)).to(F32)
    else:
        logits = matmul(x, p.router, runtime, 1).to(F32)
    probs = torch.softmax(logits, dim=-1)
    if _ROUTE_SOURCES:
        ids = next(_ROUTE_SOURCES[-1]).to(probs.device)
        if ids.shape[0] != B:  # the whole batch's routes, on a mesh
            ids = ids[batch_rows(runtime, ids.shape[0])]
        pk = torch.gather(probs, -1, ids)
    else:
        pk, ids = _top_k(probs, k)
    pk = pk / torch.clamp(pk.sum(-1, keepdim=True), min=1e-9)
    for sink in _ROUTE_SINKS:
        sink.append(ids)

    f_e = F.one_hot(ids, E).to(F32).sum(dim=2).mean(dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    if runtime.mesh is not None:  # the means over the whole batch
        f_e, p_e = batch_mean(torch.stack([f_e, p_e]), runtime, batch)
    aux = E * torch.sum(f_e * p_e)

    if runtime.mesh is not None and runtime.model_axis_size > 1:
        return _moe_mesh(p, x, ids, pk, cfg, runtime, cf, batch), aux
    C = _capacity(B * S, k, E, cf)
    y = _moe_block_local(x.reshape(-1, d), ids.reshape(-1, k), pk.reshape(-1, k),
                         p.w_gate, p.w_up, p.w_down, E, k, C, cfg.act, dt)
    return y.reshape(B, S, d), aux
