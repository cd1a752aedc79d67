"""Core layers of the model substrate: norms, RoPE, GQA/MQA self- and
cross-attention (prefill and cross-attention through the flash kernel behind
``kernels.ops``, decode over a KV cache), gated MLPs.

Parameters keep the reference's layouts (``repro/models/layers.py``): q/k/v
projections (d, heads, hd), the output projection (heads, hd, d), MLP
matrices (d, d_ff) and (d_ff, d). Compute runs in ``Runtime.compute_dtype``
with float32 norms, RoPE angles and softmax. Parameters are trainable
``nn.Parameter``s: code that writes into one does so under
``torch.no_grad()``, and the serving entry points run under
``torch.inference_mode()`` so that a forward there builds no graph.

On a device mesh (``Runtime.mesh``, a ``DeviceMesh`` with the reference's
axis names; one process a rank, every rank running the same program on the
same inputs) the reference's GSPMD partitioning becomes explicit code on each
rank's shards. Parameters are ``DTensor``s in their storage layout
(``sharding.rules``); a layer redistributes each weight it needs to the
layout its computation takes (``local_weight``, the reference's
``with_sharding_constraint`` on the weight) and multiplies the local shards,
issuing on the model axis's process group the collectives that GSPMD would:
all-reduces of partial products, all-gathers of sequence blocks, the max and
sum of the flash-decode softmax. Activations are local tensors: the rank's
batch rows (the data axes, where they divide the batch), whole over the
model axis between blocks. The flash and SSD kernels run on the local
shards and never see a ``DTensor``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import mesh_shape

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model apply. ``device=None`` is the
    CUDA device (RuntimeError without one), or the rank's device on a mesh.
    ``attn_backend="auto"`` runs the model's kernels (the flash kernel of
    attention, the SSD chunk kernel of Mamba) on CUDA tensors;
    ``"reference"`` runs their plain versions. ``mesh`` (a ``DeviceMesh``;
    None: one device), ``data_axes``, ``model_axis`` (None: pure data
    parallel, no tensor axis) and ``seq_shard_acts`` are the reference's
    (``launch.specs.make_runtime`` sets them from a config).
    ``seq_shard_acts`` only describes the runtime: the port's blocks keep
    the residual stream whole over the model axis (ROADMAP's deviations), so
    it changes nothing the model computes."""

    device: Any = None
    compute_dtype: torch.dtype = torch.bfloat16
    attn_backend: str = "auto"
    mesh: Any = None
    data_axes: tuple = ("data",)
    model_axis: str | None = "model"
    seq_shard_acts: bool = False

    def __post_init__(self):
        device = self.device
        if device is None and self.mesh is not None and self.mesh.device_type != "cuda":
            device = self.mesh.device_type
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None and self.mesh is not None:
            device = torch.device("cuda", torch.cuda.current_device())
        object.__setattr__(self, "device", device)
        if self.attn_backend not in ("auto", "reference"):
            raise ValueError(f"attn_backend must be 'auto' or 'reference', "
                             f"got {self.attn_backend!r}")

    @property
    def model_axis_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return mesh_shape(self.mesh)[self.model_axis]


# ----------------------------------------------------------------------------
# Mesh helpers: shards, collectives on an axis, weights in a compute layout
# ----------------------------------------------------------------------------
def _maybe(axes, dim: int, shape: dict):
    """The longest prefix of ``axes`` whose sizes' product divides ``dim``
    (and is > 1), or None (the reference's ``launch/specs.py::_maybe``)."""
    for k in range(len(axes), 0, -1):
        sub = tuple(axes[:k])
        n = math.prod(shape[a] for a in sub)
        if n > 1 and dim % n == 0 and dim >= n:
            return sub
    return None


def batch_axes(runtime: Runtime, batch: int) -> tuple:
    """The data axes that shard a batch of ``batch`` rows: the longest
    prefix of ``runtime.data_axes`` that divides it (none: every rank holds
    the whole batch)."""
    if runtime.mesh is None:
        return ()
    return _maybe(runtime.data_axes, batch, mesh_shape(runtime.mesh)) or ()


def batch_rows(runtime: Runtime, batch: int) -> slice:
    """This rank's rows of a batch of ``batch`` (all of them off a mesh)."""
    axes = batch_axes(runtime, batch)
    if not axes:
        return slice(0, batch)
    shape = mesh_shape(runtime.mesh)
    idx = 0
    for a in axes:
        idx = idx * shape[a] + runtime.mesh.get_local_rank(a)
    size = batch // math.prod(shape[a] for a in axes)
    return slice(idx * size, (idx + 1) * size)


def model_rank(runtime: Runtime) -> int:
    """This rank's index on the model axis (0 without one)."""
    if runtime.model_axis_size <= 1:
        return 0
    return runtime.mesh.get_local_rank(runtime.model_axis)


def _wire(t):
    """Sums over ranks run in float32 where the tensor is a narrower float
    (one rounding fewer); gathers and all-to-alls move the tensor as it
    is."""
    return t.to(F32) if t.dtype in (torch.bfloat16, torch.float16) else t.contiguous()


def model_all_reduce(y, runtime: Runtime, op=dist.ReduceOp.SUM):
    """Sum (or ``op``) of ``y`` over the model axis, in float32 for narrower
    floats, returned in ``y``'s dtype."""
    if runtime.model_axis_size <= 1:
        return y
    w = _wire(y)
    dist.all_reduce(w, op=op, group=runtime.mesh.get_group(runtime.model_axis))
    return w.to(y.dtype)


def model_all_gather(y, runtime: Runtime, dim: int):
    """The model axis's blocks of ``y`` concatenated along ``dim`` in rank
    order."""
    n = runtime.model_axis_size
    if n <= 1:
        return y
    w = y.contiguous().reshape(1, *y.shape)
    out = torch.empty((n, *y.shape), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(out, w, group=runtime.mesh.get_group(runtime.model_axis))
    return torch.cat(out.unbind(0), dim=dim)


def batch_mean(t, runtime: Runtime, batch: int):
    """The mean over the batch shards of a per-shard mean ``t`` (equal shard
    sizes): summed over each axis that shards a batch of ``batch`` rows."""
    axes = batch_axes(runtime, batch)
    if not axes:
        return t
    w = _wire(t)
    for a in axes:
        dist.all_reduce(w, group=runtime.mesh.get_group(a))
    shape = mesh_shape(runtime.mesh)
    return (w / math.prod(shape[a] for a in axes)).to(t.dtype)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def model_shard_dim(w, runtime: Runtime):
    """The dim of ``w`` that its storage splits over the model axis, or None."""
    if runtime.model_axis_size <= 1 or not _is_dtensor(w):
        return None
    pl = w.placements[w.device_mesh.mesh_dim_names.index(runtime.model_axis)]
    return pl.dim if pl.is_shard() else None


def _gather_mesh_dim(local, mesh, i: int, dim: int):
    """The blocks of ``local`` along tensor dim ``dim`` from the ranks of mesh
    dim ``i``, concatenated in rank order (an all-gather on its group)."""
    n = mesh.size(i)
    w = local.contiguous().reshape(1, *local.shape)
    out = torch.empty((n, *local.shape), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(out, w, group=mesh.get_group(i))
    return torch.cat(out.unbind(0), dim=dim)


def _swap_mesh_dim(local, mesh, i: int, old: int, new: int):
    """This rank's block split along tensor dim ``old`` over mesh dim ``i``
    turned into its block split along ``new`` instead: block k of ``new``
    goes to rank k, and the blocks received are joined along ``old`` (an
    all-to-all on the mesh dim's group; each rank sends and receives 1/n of
    the tensor's share, where a gather would move all of it)."""
    n = mesh.size(i)
    send = torch.stack(local.chunk(n, dim=new))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(i))
    return torch.cat(recv.unbind(0), dim=old)


def redistribute(w, pls):
    """``DTensor`` ``w`` laid out as placements ``pls`` (``Shard`` /
    ``Replicate``), through explicit collectives: an all-gather on each mesh
    dim whose split goes away (innermost first); an all-to-all on each mesh
    dim whose split only moves to another tensor dim (no other mesh dim
    splitting either), an all-gather and a slice where one does; then each
    rank's slice for each new split. The reference's
    ``with_sharding_constraint`` on a stored weight. (DTensor's own
    ``redistribute`` issues functional collectives, which the gloo backend
    does not run on CUDA tensors: they crash the process. These are the ones
    gloo has, and NCCL runs them the same.)"""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = w.device_mesh
    cur, want = list(w.placements), list(pls)
    if cur == want:
        return w
    local = w.to_local()

    def gather(i):
        nonlocal local
        inner = [j for j in range(i + 1, mesh.ndim)
                 if cur[j].is_shard() and cur[j].dim == cur[i].dim]
        if inner:
            raise NotImplementedError(f"redistribute: mesh dim {i} splits tensor dim "
                                      f"{cur[i].dim} inside mesh dims {inner}")
        local = _gather_mesh_dim(local, mesh, i, cur[i].dim)
        cur[i] = Replicate()

    for i in reversed(range(mesh.ndim)):
        if cur[i].is_shard() and not want[i].is_shard():
            gather(i)
    for i in reversed(range(mesh.ndim)):
        if cur[i].is_shard() and cur[i] != want[i]:
            if any(p.is_shard() and p.dim in (cur[i].dim, want[i].dim)
                   for j, p in enumerate(cur) if j != i):
                gather(i)
            else:  # one split for another on this mesh dim
                local = _swap_mesh_dim(local, mesh, i, cur[i].dim, want[i].dim)
                cur[i] = want[i]
    for i in range(mesh.ndim):
        if want[i].is_shard() and not cur[i].is_shard():
            local = local.chunk(mesh.size(i), dim=want[i].dim)[mesh.get_local_rank(i)]
            cur[i] = want[i]
    return DTensor.from_local(local.contiguous(), mesh, tuple(want), run_check=False,
                              shape=w.shape, stride=w.stride())


def transposed(w):
    """A 2-D weight's transpose (a ``DTensor``'s from its local shard: no
    collective)."""
    if not _is_dtensor(w):
        return w.T
    from torch.distributed.tensor import DTensor, Shard

    pls = tuple(Shard(1 - p.dim) if p.is_shard() else p for p in w.placements)
    shape = torch.Size((w.shape[1], w.shape[0]))
    return DTensor.from_local(w.to_local().T, w.device_mesh, pls, run_check=False,
                              shape=shape, stride=(shape[1], 1))


def last_position(t):
    """``t[:, -1:]`` of logits (B, S, V); of a ``DTensor``, from its local
    shard (S is never split)."""
    if not _is_dtensor(t):
        return t[:, -1:]
    from torch.distributed.tensor import DTensor

    shape = torch.Size((t.shape[0], 1, t.shape[2]))
    return DTensor.from_local(t.to_local()[:, -1:].contiguous(), t.device_mesh, t.placements,
                              run_check=False, shape=shape, stride=(shape[2], shape[2], 1))


def local_weight(w, runtime: Runtime, shard: int | None = None):
    """This rank's block of weight ``w`` in a compute layout: whole on every
    mesh axis but the model axis, where it is split along dim ``shard`` (or
    whole with ``shard=None``). A ``DTensor`` is redistributed to that layout
    (the gathers of its storage shards); a plain tensor (every rank holding
    all of it) is sliced."""
    n = runtime.model_axis_size
    if not _is_dtensor(w):
        if shard is None or n <= 1:
            return w
        return w.chunk(n, dim=shard)[model_rank(runtime)]
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    want = [Replicate()] * mesh.ndim
    if shard is not None and n > 1:
        want[mesh.mesh_dim_names.index(runtime.model_axis)] = Shard(shard % w.ndim)
    return redistribute(w, want).to_local()


def _contract(x, w, nc: int):
    """x (..., *w.shape[:nc]) times w over those nc dims -> (..., *w.shape[nc:])."""
    lead = x.shape[:x.dim() - nc]
    k = math.prod(w.shape[:nc])
    return (x.reshape(-1, k) @ w.reshape(k, -1)).reshape(*lead, *w.shape[nc:])


def _partial_is_cheaper(x, w, nc: int, n: int) -> bool:
    """Whether summing the partial products (~2 x rows x outputs, float32)
    moves fewer bytes than moving the weight's split to an output dim (its
    share, in its dtype): true at a decode step's few rows, false at a
    prefill's vocabulary projection."""
    rows = x.numel() // math.prod(w.shape[:nc])
    outs = math.prod(w.shape[nc:])
    return 2 * rows * outs * 4 <= w.numel() * w.element_size() // n


def matmul(x, w, runtime: Runtime, nc: int = 1, out_shard: int | None = None):
    """``x @ w`` over ``w``'s first ``nc`` dims in the compute dtype, for an
    ``x`` that is whole (the same) on every rank of the model axis. Where
    ``w``'s storage splits a contraction dim over the model axis and the
    product is small (``_partial_is_cheaper``), each rank multiplies its
    slice of it and the partial products are summed over the axis (the
    serving layout's small all-reduces, no weight moves); else ``w`` is
    moved to the layout needed. Returns the whole product, or
    with ``out_shard`` = a dim of ``w`` past the contraction, this rank's
    block of the product along that dim."""
    dt = runtime.compute_dtype
    n = runtime.model_axis_size
    c = model_shard_dim(w, runtime)
    n_out = w.dim() - nc
    if c is not None and c < nc and _partial_is_cheaper(x, w, nc, n):
        size = w.shape[c] // n
        xs = x.narrow(x.dim() - nc + c, model_rank(runtime) * size, size)
        y = model_all_reduce(_contract(xs, local_weight(w, runtime, c).to(dt), nc), runtime)
        if out_shard is not None:
            y = y.chunk(n, dim=y.dim() - n_out + out_shard - nc)[model_rank(runtime)]
        return y
    return _contract(x, local_weight(w, runtime, out_shard).to(dt), nc)


def matmuls(x, ws, runtime: Runtime, out_shard: int | None = None):
    """``[matmul(x, w, runtime, 1, out_shard) for w in ws]``, the partial
    products of weights split on their first dim summed in one all-reduce (a
    decode step's q/k/v and gate/up projections in the serving layout)."""
    if runtime.model_axis_size <= 1 or any(
            model_shard_dim(w, runtime) != 0
            or not _partial_is_cheaper(x, w, 1, runtime.model_axis_size) for w in ws):
        return [matmul(x, w, runtime, 1, out_shard) for w in ws]
    dt, n, j = runtime.compute_dtype, runtime.model_axis_size, model_rank(runtime)
    size = ws[0].shape[0] // n
    xs = x.narrow(x.dim() - 1, j * size, size)
    parts = [_contract(xs, local_weight(w, runtime, 0).to(dt), 1) for w in ws]
    flat = model_all_reduce(torch.cat([p.reshape(*x.shape[:-1], -1) for p in parts], -1),
                            runtime)
    sizes = [math.prod(p.shape[x.dim() - 1:]) for p in parts]
    outs = [f.reshape(p.shape) for f, p in zip(flat.split(sizes, -1), parts)]
    if out_shard is None:
        return outs
    return [y.chunk(n, dim=y.dim() - w.dim() + out_shard)[j] for y, w in zip(outs, ws)]


def matmul_split(h, w, runtime: Runtime, c: int, nc: int = 1):
    """``h @ w`` where ``h`` holds this rank's block of contraction dim ``c``
    (of ``w``'s first ``nc``) of the model axis: the local product of the
    matching block of ``w``, summed over the axis."""
    wl = local_weight(w, runtime, c).to(runtime.compute_dtype)
    return model_all_reduce(_contract(h, wl, nc), runtime)


def as_global(local, runtime: Runtime, spec: tuple, shape):
    """A ``DTensor`` of global ``shape`` whose shards (this rank's ``local``)
    lie as ``spec`` names (the reference's PartitionSpec as a tuple of axis
    names)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import placements

    return DTensor.from_local(local, runtime.mesh, placements(spec, runtime.mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def distribute(full, mesh, pls):
    """A ``DTensor`` with placements ``pls`` from ``full``, a tensor every rank
    holds the same (SPMD): each rank keeps its own slices, no collective."""
    from torch.distributed.tensor import DTensor

    local = full
    for i, pl in enumerate(pls):
        if pl.is_shard():
            local = local.chunk(mesh.size(i), dim=pl.dim)[mesh.get_local_rank(i)]
    return DTensor.from_local(local.clone(), mesh, tuple(pls), run_check=False,
                              shape=full.shape, stride=full.stride())


def _param(shape, device, dtype, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device))


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------
class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.w = _param((cfg.d_model,), device, dtype, 0.0 if cfg.norm_plus_one else 1.0)


def whole(w):
    """A parameter's (or the logits') whole value: a ``DTensor`` gathered (no
    collective where it is replicated, as 1-D parameters are), a tensor as
    it is."""
    if not _is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    return redistribute(w, [Replicate()] * w.device_mesh.ndim).to_local()


def apply_norm(p: Norm, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.to(F32)
    w = whole(p.w).to(F32)
    if cfg.norm_plus_one:
        w = 1.0 + w
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * w
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * w
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
def rope_embed(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integers, broadcastable."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    ang = positions[..., None].to(F32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        self.wq = _param((d, cfg.n_heads, hd), device, dtype)
        self.wk = _param((d, cfg.kv_heads, hd), device, dtype)
        self.wv = _param((d, cfg.kv_heads, hd), device, dtype)
        self.wo = _param((cfg.n_heads, hd, d), device, dtype)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads, hd), device, dtype)
            self.bk = _param((cfg.kv_heads, hd), device, dtype)
            self.bv = _param((cfg.kv_heads, hd), device, dtype)


def apply_attention(p: Attention, x, cfg: ModelConfig, runtime: Runtime, *, positions,
                    causal: bool = True, memory=None, cache=None, use_rope: bool = True):
    """Returns (out (B,S,d), new_cache or None). ``memory`` (B, S_src, d),
    already normed, is the source of k/v for cross-attention, which is never
    causal and takes no RoPE. ``cache`` is dict(k=(B,KV,T,hd), v=...,
    index=int); this step's k/v are written into its tensors in place (the
    reference returns updated copies). On a mesh ``x`` and ``memory`` hold
    this rank's batch rows, and ``cache`` this rank's shard (see
    ``_attention_mesh``)."""
    if runtime.mesh is not None:
        return _attention_mesh(p, x, cfg, runtime, positions=positions, causal=causal,
                               memory=memory, cache=cache, use_rope=use_rope)
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    dt = runtime.compute_dtype
    kv_src = memory if memory is not None else x

    q = torch.einsum("bsd,dnh->bsnh", x, p.wq.to(dt))
    k = torch.einsum("bsd,dnh->bsnh", kv_src, p.wk.to(dt))
    v = torch.einsum("bsd,dnh->bsnh", kv_src, p.wv.to(dt))
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if use_rope and memory is None:
        q = rope_embed(q, positions, cfg.rope_theta)
        k = rope_embed(k, positions, cfg.rope_theta)

    KV = cfg.kv_heads
    G = cfg.n_heads // KV
    qg = q.reshape(B, S, KV, G, hd)
    new_cache = None
    if cache is not None and S > 1:
        # prefill-fill: write the fresh k/v into the cache at [0, S), then
        # compute flash attention below as if the cache were absent
        cache["k"][:, :, :S] = k.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][:, :, :S] = v.transpose(1, 2).to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "index": cache["index"]}
        cache = None
    if cache is not None:
        # decode: write this step's k/v at cache["index"] (clamped into the
        # cache, as dynamic_update_slice does), attend over the prefix
        index = int(cache["index"])
        start = min(max(index, 0), cache["k"].shape[2] - S)
        _cache_write(cache, k.transpose(1, 2), v.transpose(1, 2), start)
        new_cache = {"k": cache["k"], "v": cache["v"], "index": cache["index"]}
        out = _decode_attention(qg, cache, index, runtime, dt)
    else:
        out5 = kops.flash_attention(qg, k, v, causal=causal and memory is None,
                                    backend=runtime.attn_backend)
        out = out5.reshape(B, S, cfg.n_heads, hd).to(dt)

    y = torch.einsum("bsnh,nhd->bsd", out, p.wo.to(dt))
    return y, new_cache


def _cache_write(cache, k, v, start: int):
    """Write k/v (B, KV, S, hd) at global positions [start, start + S) of a
    cache shard that holds positions [t0, t0 + T_loc): only the rank whose
    slice holds a position writes it (the owner-shard update), and no
    collective moves the cache."""
    kc, vc, t0 = cache["k"], cache["v"], cache.get("t0", 0)
    T_loc, S = kc.shape[2], k.shape[2]
    lo, hi = max(start, t0), min(start + S, t0 + T_loc)
    if lo < hi:
        kc[:, :, lo - t0:hi - t0] = k[:, :, lo - start:hi - start].to(kc.dtype)
        vc[:, :, lo - t0:hi - t0] = v[:, :, lo - start:hi - start].to(vc.dtype)


def _decode_attention(qg, cache, index: int, runtime: Runtime, dt):
    """Attention of this step's queries qg (B, S, KV, G, hd) over the cache's
    positions <= index. With the cache's T split over the model axis
    (``cache["t_shards"]`` > 1), each rank scores its slice and the softmax's
    max and sum, then the weighted values, are reduced over the axis
    (flash-decode): the weights are the whole-T softmax's, rounded to the
    compute dtype as on one device."""
    kk = cache["k"].to(dt).to(F32)  # (B, KV, T_loc, hd); f32 products as preferred_element_type
    vv = cache["v"].to(dt).to(F32)
    hd = kk.shape[-1]
    t0, T_loc = cache.get("t0", 0), kk.shape[2]
    s = torch.einsum("bskgh,bkth->bkgst", qg.to(F32), kk) * hd**-0.5
    valid = torch.arange(t0, t0 + T_loc, device=s.device) <= index
    s = torch.where(valid, s, -torch.inf)
    if cache.get("t_shards", 1) > 1:
        m = model_all_reduce(s.amax(dim=-1, keepdim=True), runtime, dist.ReduceOp.MAX)
        e = torch.exp(s - m)  # (B, KV, G, S, T_loc)
        o = torch.einsum("bkgst,bkth->bkgsh", e.to(dt).to(F32), vv)
        ol = model_all_reduce(torch.cat([o, e.sum(dim=-1, keepdim=True)], dim=-1), runtime)
        o = (ol[..., :-1] / ol[..., -1:]).permute(0, 3, 1, 2, 4)  # (B, S, KV, G, hd)
    else:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,bkth->bskgh", w.to(dt).to(F32), vv)
    B, S, KV, G, _ = qg.shape
    return o.reshape(B, S, KV * G, hd).to(dt)


def _bias(b, runtime: Runtime, shard: int | None = None):
    return local_weight(b, runtime, shard).to(runtime.compute_dtype)


def _attention_mesh(p: Attention, x, cfg: ModelConfig, runtime: Runtime, *, positions,
                    causal: bool, memory, cache, use_rope: bool):
    """``apply_attention`` on a mesh, as GSPMD partitions the reference's
    (``repro/models/layers.py:226-262``). ``x`` (and ``memory``) hold this
    rank's batch rows, whole over the model axis; so does the output. The
    attention's shard mode (``cfg.attn_shard_mode``) splits its work over the
    model axis:

    sequence  each rank takes its block of S / n query rows against all keys
              (the causal mask offset by the block's first row), and the
              blocks' outputs are gathered;
    heads     the KV heads split over the axis (or, where they do not divide
              it, each group's G query heads): each rank attends with its
              heads and the output projections' partial sums are reduced.

    A decode step (``cache`` with S == 1) projects q/k/v whole, writes k/v
    into the owner shard of the cache, whose T may be split over the model
    axis (``cache["t0"]`` its first position, ``cache["t_shards"]`` the
    split), and attends flash-decode style (``_decode_attention``). A prefill
    with a cache writes every position's k/v the same way."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    dt = runtime.compute_dtype
    KV = cfg.kv_heads
    G = cfg.n_heads // KV
    n = runtime.model_axis_size
    j = model_rank(runtime)
    kv_src = memory if memory is not None else x
    rope = use_rope and memory is None

    def project(src, w, b, out_shard=None):
        y = matmul(src, w, runtime, 1, out_shard)
        return y if b is None else y + _bias(b, runtime, None if out_shard is None else 0)

    bq, bk, bv = ((p.bq, p.bk, p.bv) if cfg.qkv_bias else (None, None, None))
    if cache is not None and S == 1:  # self-attention only: cross-attention keeps no cache
        q, k, v = (y if b is None else y + _bias(b, runtime)
                   for y, b in zip(matmuls(x, (p.wq, p.wk, p.wv), runtime), (bq, bk, bv)))
        if rope:
            q = rope_embed(q, positions, cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        index = int(cache["index"])
        T_full = cache["k"].shape[2] * cache.get("t_shards", 1)
        _cache_write(cache, k.transpose(1, 2), v.transpose(1, 2),
                     min(max(index, 0), T_full - S))
        out = _decode_attention(q.reshape(B, S, KV, G, hd), cache, index, runtime, dt)
        y = matmul(out, p.wo, runtime, 2)
        new_cache = {k_: cache[k_] for k_ in ("k", "v", "index")}
        return y, new_cache

    mode = cfg.attn_shard_mode(n)
    flash = dict(causal=causal and memory is None, backend=runtime.attn_backend)
    if n > 1 and mode == "sequence" and memory is None and S % n == 0:
        Sb = S // n
        r0 = j * Sb
        wq = local_weight(p.wq, runtime).to(dt)
        q = torch.einsum("bsd,dnh->bsnh", x[:, r0:r0 + Sb], wq)
        if bq is not None:
            q = q + _bias(bq, runtime)
        k = project(x, p.wk, bk)
        v = project(x, p.wv, bv)
        if rope:
            q = rope_embed(q, positions[..., r0:r0 + Sb], cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, Sb, KV, G, hd), k, v, offset=r0, **flash)
        wo = local_weight(p.wo, runtime).to(dt)
        y = model_all_gather(torch.einsum("bsnh,nhd->bsd", out.reshape(B, Sb, -1, hd), wo),
                             runtime, dim=1)
        k_all, v_all = k, v
    elif n > 1 and KV % n == 0:
        q = project(x, p.wq, bq, out_shard=1)  # this rank's KV / n groups of heads
        k = project(kv_src, p.wk, bk, out_shard=1)
        v = project(kv_src, p.wv, bv, out_shard=1)
        if rope:
            q = rope_embed(q, positions, cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, S, KV // n, G, hd), k, v, **flash)
        y = matmul_split(out.reshape(B, S, -1, hd), p.wo, runtime, 0, nc=2)
        k_all, v_all = (model_all_gather(t, runtime, 2) if cache is not None else None
                        for t in (k, v))
    elif n > 1 and G % n == 0:
        gs = slice(j * (G // n), (j + 1) * (G // n))  # this rank's query heads of each group
        wq = local_weight(p.wq, runtime).to(dt).reshape(-1, KV, G, hd)[:, :, gs]
        q = torch.einsum("bsd,dkgh->bskgh", x, wq)
        if bq is not None:
            q = q + _bias(bq, runtime).reshape(KV, G, hd)[:, gs]
        k = project(kv_src, p.wk, bk)
        v = project(kv_src, p.wv, bv)
        if rope:
            q = rope_embed(q.reshape(B, S, -1, hd), positions, cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, S, KV, G // n, hd), k, v, **flash)
        wo = local_weight(p.wo, runtime).to(dt).reshape(KV, G, hd, -1)[:, gs]
        y = model_all_reduce(torch.einsum("bskgh,kghd->bsd", out, wo), runtime)
        k_all, v_all = k, v
    else:
        q = project(x, p.wq, bq)
        k = project(kv_src, p.wk, bk)
        v = project(kv_src, p.wv, bv)
        if rope:
            q = rope_embed(q, positions, cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, S, KV, G, hd), k, v, **flash)
        y = matmul(out.reshape(B, S, -1, hd), p.wo, runtime, 2)
        k_all, v_all = k, v
    new_cache = None
    if cache is not None:  # prefill-fill: every position's k/v into the owner shards
        _cache_write(cache, k_all.transpose(1, 2), v_all.transpose(1, 2), 0)
        new_cache = {k_: cache[k_] for k_ in ("k", "v", "index")}
    return y, new_cache


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_ff
        self.w_up = _param((d, d_ff), device, dtype)
        self.w_down = _param((d_ff, d), device, dtype)
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = _param((d, d_ff), device, dtype)


def apply_mlp(p: MLP, x, cfg: ModelConfig, runtime: Runtime):
    """Gated (or ReLU) MLP. On a mesh its hidden dim d_ff splits over the
    model axis (the reference's ``up`` / ``h`` constraints): each rank
    computes its block of d_ff and the down projection's partial sums are
    reduced."""
    dt = runtime.compute_dtype
    if runtime.mesh is not None:
        gated = cfg.act in ("swiglu", "geglu")
        up, *gate = matmuls(x, (p.w_up, p.w_gate) if gated else (p.w_up,), runtime, out_shard=1)
        if cfg.act == "swiglu":
            h = torch.nn.functional.silu(gate[0]) * up
        elif cfg.act == "geglu":
            h = torch.nn.functional.gelu(gate[0], approximate="tanh") * up
        else:
            h = torch.relu(up)
        return matmul_split(h, p.w_down, runtime, 0)
    up = x @ p.w_up.to(dt)
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(x @ p.w_gate.to(dt)) * up
    elif cfg.act == "geglu":
        h = torch.nn.functional.gelu(x @ p.w_gate.to(dt), approximate="tanh") * up
    else:
        h = torch.relu(up)
    return h @ p.w_down.to(dt)
