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

import contextlib
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
    """A copy of ``t`` to sum over ranks: in float32 where ``t`` is a
    narrower float (one rounding fewer), contiguous."""
    return t.to(F32) if t.dtype in (torch.bfloat16, torch.float16) else t.contiguous().clone()


def _all_reduce(t, group, op=dist.ReduceOp.SUM):
    """Sum (or ``op``) of ``t`` over ``group``, in float32 for narrower
    floats, returned in ``t``'s dtype (``t`` itself is left as it is)."""
    w = _wire(t)
    dist.all_reduce(w, op=op, group=group)
    return w.to(t.dtype)


def _all_gather(t, group, n: int, dim: int):
    """The group's blocks of ``t`` concatenated along ``dim`` in rank order."""
    w = t.contiguous().reshape(1, *t.shape)
    out = torch.empty((n, *t.shape), dtype=w.dtype, device=w.device)
    dist.all_gather_into_tensor(out, w, group=group)
    return torch.cat(out.unbind(0), dim=dim)


def _all_to_all(t, group):
    """Tiled all-to-all: block i of ``t``'s dim 0 goes to rank i of ``group``,
    and block i of the result came from rank i."""
    w = t.contiguous()
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return out


# Each collective of the model's forward is an autograd Function whose
# backward is its adjoint, so that a loss computed on a mesh has the gradient
# of the same loss on one device. The convention: a tensor that is whole (the
# same) on every rank of the model axis gets the whole gradient on every rank;
# a tensor that differs between them (a rank's block, or its partial sum) gets
# the gradient of that rank's value. Work that the model ranks split (their
# heads, d_ff block, query block or experts) starts from a whole activation
# through ``enter_split``, whose backward sums the ranks' partial gradients
# (Megatron's f), and ends in ``model_all_reduce`` (partial sums, identity
# backward) or ``model_all_gather`` (blocks, the rank's slice backward).
class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, op, sum_backward):
        ctx.group, ctx.sum_backward = group, sum_backward
        return _all_reduce(y, group, op)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group) if ctx.sum_backward else g), None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, n, j, dim):
        ctx.n, ctx.j, ctx.dim = n, j, dim
        return _all_gather(y, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.j], None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):  # the tiled all-to-all is its own adjoint
        return _all_to_all(g, ctx.group), None


def _model_group(runtime: Runtime):
    return runtime.mesh.get_group(runtime.model_axis)


def model_all_reduce(y, runtime: Runtime, op=dist.ReduceOp.SUM, sum_backward: bool = False):
    """Sum (or ``op``) of ``y`` over the model axis, in float32 for narrower
    floats, returned in ``y``'s dtype. Its backward passes the (whole)
    gradient on, or with ``sum_backward`` (the sum feeds work the ranks
    split) sums the ranks' gradients."""
    if runtime.model_axis_size <= 1:
        return y
    return _Sum.apply(y, _model_group(runtime), op, sum_backward)


def model_all_gather(y, runtime: Runtime, dim: int):
    """The model axis's blocks of ``y`` concatenated along ``dim`` in rank
    order; the backward takes this rank's block of the gradient."""
    n = runtime.model_axis_size
    if n <= 1:
        return y
    return _Gather.apply(y, _model_group(runtime), n, model_rank(runtime), dim)


def enter_split(x, runtime: Runtime):
    """``x`` (whole on the model axis) as the input of work the model ranks
    split: the identity, whose backward sums the ranks' gradients over the
    axis (Megatron's f)."""
    if runtime.model_axis_size <= 1:
        return x
    return _Enter.apply(x, _model_group(runtime))


def model_all_to_all(t, runtime: Runtime):
    """Tiled all-to-all over the model axis (``_all_to_all``); its backward
    is the same exchange of the gradient."""
    return _AllToAll.apply(t, _model_group(runtime))


def batch_mean(t, runtime: Runtime, batch: int):
    """The mean over the batch shards of a per-shard mean ``t`` (equal shard
    sizes): summed over each axis that shards a batch of ``batch`` rows and
    divided by their count. The mean is the same on every rank, and its
    gradient is (the backward's identity sums) divided by the count on each
    shard."""
    axes = batch_axes(runtime, batch)
    if not axes:
        return t
    for a in axes:
        t = _Sum.apply(t, runtime.mesh.get_group(a), dist.ReduceOp.SUM, False)
    shape = mesh_shape(runtime.mesh)
    return t / math.prod(shape[a] for a in axes)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_shard(t):
    """A ``DTensor``'s local shard (the tensor itself: writing into it
    writes the ``DTensor``), or the tensor."""
    return t.to_local() if _is_dtensor(t) else t


def model_shard_dim(w, runtime: Runtime):
    """The dim of ``w`` that its storage splits over the model axis, or None."""
    if runtime.model_axis_size <= 1 or not _is_dtensor(w):
        return None
    pl = w.placements[w.device_mesh.mesh_dim_names.index(runtime.model_axis)]
    return pl.dim if pl.is_shard() else None


def _dtype_groups(ts):
    """The indices of ``ts`` grouped by dtype (one flat buffer a collective)."""
    groups: dict = {}
    for k, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(k)
    return groups.values()


def _flat_all_gather(ts, group, n: int, dims):
    """``[_all_gather(t, group, n, dim) for t, dim in zip(ts, dims)]``, one
    collective for the tensors of each dtype."""
    out = [None] * len(ts)
    for idx in _dtype_groups(ts):
        flat = torch.cat([ts[k].reshape(-1) for k in idx]).reshape(1, -1)
        got = torch.empty((n, flat.shape[1]), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(got, flat, group=group)
        off = 0
        for k in idx:
            m = ts[k].numel()
            out[k] = torch.cat(got[:, off:off + m].reshape(n, *ts[k].shape).unbind(0), dim=dims[k])
            off += m
    return out


def _flat_reduce_scatter(ts, group, n: int, dims):
    """This rank's block (of ``n``, in group rank order) along ``dims[k]`` of
    the sum of each ``ts[k]`` over ``group``, one collective a dtype."""
    out = [None] * len(ts)
    for idx in _dtype_groups(ts):
        moved = [ts[k].movedim(dims[k], 0) for k in idx]
        flat = torch.cat([t.reshape(n, -1) for t in moved], dim=1).contiguous()
        got = torch.empty(flat.shape[1], dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(got, flat.reshape(-1), group=group)
        off = 0
        for k, t in zip(idx, moved):
            m = t.numel() // n
            out[k] = got[off:off + m].reshape(t.shape[0] // n, *t.shape[1:]).movedim(0, dims[k])
            off += m
    return out


def _flat_all_to_all(ts, group, n: int, olds, news):
    """Each ``ts[k]``, this rank's block split along ``olds[k]`` over the
    group, turned into its block split along ``news[k]``: block i of
    ``news[k]`` goes to rank i and the blocks received are joined along
    ``olds[k]`` (one tiled all-to-all a dtype; each rank sends and receives
    1/n of its share, where a gather would move all of it)."""
    out = [None] * len(ts)
    for idx in _dtype_groups(ts):
        sends = [torch.stack(ts[k].chunk(n, dim=news[k])) for k in idx]
        got = _all_to_all(torch.cat([t.reshape(n, -1) for t in sends], dim=1), group)
        off = 0
        for k, t in zip(idx, sends):
            m = t[0].numel()
            out[k] = torch.cat(got[:, off:off + m].reshape(t.shape).unbind(0), dim=olds[k])
            off += m
    return out


def _flat_all_reduce(ts, group):
    """The sum of each ``ts[k]`` over ``group``, one collective a dtype."""
    out = [None] * len(ts)
    for idx in _dtype_groups(ts):
        flat = torch.cat([ts[k].reshape(-1) for k in idx])
        dist.all_reduce(flat, group=group)
        for k, part in zip(idx, flat.split([ts[k].numel() for k in idx])):
            out[k] = part.reshape(ts[k].shape)
    return out


def _relayout(locs, mesh, curs, wants):
    """The shards ``locs`` of tensors laid out as placements ``curs`` moved to
    placements ``wants`` through explicit collectives, the tensors' moves on
    one mesh dim batched into one collective: an all-gather on each mesh dim
    whose split goes away (innermost first); an all-to-all on each mesh dim
    whose split only moves to another tensor dim (no other mesh dim
    splitting either), an all-gather and a slice where one does; then each
    rank's slice for each new split. Returns (the new shards, the steps
    taken: ("gather", mesh dim, [(k, tensor dim)]), ("swap", mesh dim, [(k,
    old, new)]), ("slice", mesh dim, [(k, tensor dim)])), which
    ``_relayout_adjoint`` undoes."""
    from torch.distributed.tensor import Replicate

    locs, curs, steps = list(locs), [list(c) for c in curs], []
    every = range(len(locs))

    def gather(i, ks):
        for k in ks:
            inner = [j for j in range(i + 1, mesh.ndim)
                     if curs[k][j].is_shard() and curs[k][j].dim == curs[k][i].dim]
            if inner:
                raise NotImplementedError(f"redistribute: mesh dim {i} splits tensor dim "
                                          f"{curs[k][i].dim} inside mesh dims {inner}")
        dims = [curs[k][i].dim for k in ks]
        for k, t in zip(ks, _flat_all_gather([locs[k] for k in ks], mesh.get_group(i),
                                             mesh.size(i), dims)):
            locs[k], curs[k][i] = t, Replicate()
        steps.append(("gather", i, list(zip(ks, dims))))

    for i in reversed(range(mesh.ndim)):
        ks = [k for k in every if curs[k][i].is_shard() and not wants[k][i].is_shard()]
        if ks:
            gather(i, ks)
    for i in reversed(range(mesh.ndim)):
        moving = [k for k in every if curs[k][i].is_shard() and curs[k][i] != wants[k][i]]
        crossed = [k for k in moving if any(p.is_shard() and p.dim in (curs[k][i].dim,
                                                                        wants[k][i].dim)
                                            for j, p in enumerate(curs[k]) if j != i)]
        if crossed:
            gather(i, crossed)
        swaps = [(k, curs[k][i].dim, wants[k][i].dim) for k in moving if k not in crossed]
        if swaps:  # one split for another on this mesh dim
            moved = _flat_all_to_all([locs[k] for k, _, _ in swaps], mesh.get_group(i),
                                     mesh.size(i), [o for _, o, _ in swaps],
                                     [w for _, _, w in swaps])
            for (k, _, _), t in zip(swaps, moved):
                locs[k], curs[k][i] = t, wants[k][i]
            steps.append(("swap", i, swaps))
    for i in range(mesh.ndim):
        ks = [k for k in every if wants[k][i].is_shard() and not curs[k][i].is_shard()]
        for k in ks:
            locs[k] = locs[k].chunk(mesh.size(i), dim=wants[k][i].dim)[mesh.get_local_rank(i)]
            curs[k][i] = wants[k][i]
        if ks:
            steps.append(("slice", i, [(k, wants[k][i].dim) for k in ks]))
    return locs, steps


def _relayout_adjoint(gs, mesh, steps, partials):
    """The gradients of ``_relayout``'s inputs from the gradients ``gs`` of
    its outputs: the steps undone in reverse order (a slice by an
    all-gather, an all-to-all by the inverse one, an all-gather by this
    rank's slice), batched as they were. On the mesh dims in ``partials[k]``
    the ranks' gradients of tensor k are partial sums (their uses of the
    value differ: other batch rows, other query rows): they are summed
    there, an all-gather's adjoint becoming a reduce-scatter. Sums run in
    float32."""
    gs = [_wire(g) if partials[k] else g for k, g in enumerate(gs)]
    gathered = [set() for _ in gs]
    for kind, i, items in steps:
        for k, *_ in items:
            if kind == "gather":
                gathered[k].add(i)
    for i in range(mesh.ndim):
        ks = [k for k in range(len(gs)) if i in partials[k] and i not in gathered[k]]
        for k, g in zip(ks, _flat_all_reduce([gs[k] for k in ks], mesh.get_group(i)) if ks else ()):
            gs[k] = g
    for kind, i, items in reversed(steps):
        group, n = mesh.get_group(i), mesh.size(i)
        if kind == "slice":
            done = _flat_all_gather([gs[k] for k, _ in items], group, n, [d for _, d in items])
        elif kind == "swap":
            done = _flat_all_to_all([gs[k] for k, _, _ in items], group, n,
                                    [w for _, _, w in items], [o for _, o, _ in items])
        else:
            summed = [(k, d) for k, d in items if i in partials[k]]
            sliced = [(k, d) for k, d in items if i not in partials[k]]
            for k, d in sliced:
                gs[k] = gs[k].chunk(n, dim=d)[mesh.get_local_rank(i)]
            items = summed
            done = _flat_reduce_scatter([gs[k] for k, _ in items], group, n,
                                        [d for _, d in items]) if items else []
        for (k, *_), g in zip(items, done):
            gs[k] = g
    return [g.contiguous() for g in gs]


class _LocalWeights(torch.autograd.Function):
    """``DTensor`` parameters' local shards (each cast to its ``dtypes``
    entry first, so that a narrower compute dtype halves the bytes the
    gathers move) moved to placements ``wants``; the backward returns each
    gradient as a ``DTensor`` in its parameter's own placements, summed over
    the mesh dims of its ``partials`` entry."""

    @staticmethod
    def forward(ctx, plan, *ws):
        wants, dtypes, partials = plan
        mesh = ws[0].device_mesh
        locs = [w.to_local() if dt is None else w.to_local().to(dt) for w, dt in zip(ws, dtypes)]
        outs, ctx.steps = _relayout(locs, mesh, [w.placements for w in ws], wants)
        ctx.mesh, ctx.partials = mesh, partials
        ctx.meta = [(w.placements, w.shape, w.stride(), w.dtype) for w in ws]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        from torch.distributed.tensor import DTensor

        grads = _relayout_adjoint(list(gs), ctx.mesh, ctx.steps, ctx.partials)
        return (None, *(DTensor.from_local(g.to(dt), ctx.mesh, pls, run_check=False,
                                           shape=shape, stride=stride)
                         for g, (pls, shape, stride, dt) in zip(grads, ctx.meta)))


class _RowLookup(torch.autograd.Function):
    """``embedding(tokens, table)`` of this rank's ``tokens`` where mesh dim
    ``i`` (a batch axis) splits the table's rows: the tokens of the dim's
    ranks are gathered, each rank looks them up in its own rows (the others
    zero), and the sums are reduce-scattered back to the ranks whose tokens
    they are; no part of the table moves. The backward gathers the rows'
    gradients and adds them into the rank's own rows, summed over the other
    batch axes ``others`` (whose ranks hold other tokens and the same
    rows)."""

    @staticmethod
    def forward(ctx, w, tokens, i, others, dtype):
        mesh = w.device_mesh
        n, group = mesh.size(i), mesh.get_group(i)
        local = w.to_local()
        toks = _all_gather(tokens, group, n, 0)
        idx = toks - mesh.get_local_rank(i) * local.shape[0]
        inside = (idx >= 0) & (idx < local.shape[0])
        idx = torch.where(inside, idx, 0)
        part = torch.where(inside[..., None], torch.nn.functional.embedding(idx, local.to(dtype)),
                           0)
        ctx.save_for_backward(idx, inside)
        ctx.meta = (mesh, i, others, w.placements, w.shape, w.stride(), w.dtype, local.shape)
        return _flat_reduce_scatter([_wire(part)], group, n, [0])[0].to(dtype)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        idx, inside = ctx.saved_tensors
        mesh, i, others, pls, shape, stride, dtype, local_shape = ctx.meta
        g = _all_gather(_wire(g), mesh.get_group(i), mesh.size(i), 0)
        grad = torch.zeros(local_shape, dtype=g.dtype, device=g.device)
        grad.index_add_(0, idx[inside], g[inside])
        for k in others:
            grad = _all_reduce(grad, mesh.get_group(k))
        return (DTensor.from_local(grad.to(dtype), mesh, pls, run_check=False, shape=shape,
                                   stride=stride), None, None, None, None)


def row_lookup_dim(w, runtime: Runtime):
    """The mesh dim whose split of ``w``'s rows ``row_lookup`` can keep: the
    one mesh dim splitting dim 0, a data axis of the runtime, while any
    other split of ``w`` is the model axis's of dim 1. None otherwise."""
    if not _is_dtensor(w):
        return None
    names = w.device_mesh.mesh_dim_names
    rows = [k for k, pl in enumerate(w.placements) if pl.is_shard() and pl.dim == 0]
    rest = [names[k] for k, pl in enumerate(w.placements) if pl.is_shard() and pl.dim != 0]
    if len(rows) != 1 or names[rows[0]] not in runtime.data_axes:
        return None
    return rows[0] if rest in ([], [runtime.model_axis]) else None


def row_lookup(w, tokens, runtime: Runtime, dtype=None):
    """``embedding(tokens, w)`` in ``dtype`` (default ``w``'s) for this rank's
    ``tokens``, ``w`` split over rows as ``row_lookup_dim`` says (the result
    holds this rank's block of dim 1 where the model axis splits it):
    ``_RowLookup``."""
    i = row_lookup_dim(w, runtime)
    names = w.device_mesh.mesh_dim_names
    others = tuple(names.index(a) for a in runtime.data_axes if a in names and a != names[i])
    return _RowLookup.apply(w, tokens, i, others, dtype or w.dtype)


def redistribute(w, pls):
    """``DTensor`` ``w`` laid out as placements ``pls`` (``Shard`` /
    ``Replicate``) through explicit collectives (``_relayout``): the
    reference's ``with_sharding_constraint`` on a stored weight. (DTensor's
    own ``redistribute`` issues functional collectives, which the gloo
    backend does not run on CUDA tensors: they crash the process. These are
    the ones gloo has, and NCCL runs them the same.) Not differentiable:
    a layer takes its weights through ``local_weight``."""
    from torch.distributed.tensor import DTensor

    if list(w.placements) == list(pls):
        return w
    (local,), _ = _relayout([w.to_local()], w.device_mesh, [w.placements], [pls])
    return DTensor.from_local(local.contiguous(), w.device_mesh, tuple(pls), run_check=False,
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


def local_weight(w, runtime: Runtime, shard: int | None = None, dtype=None,
                 summed: bool = False):
    """This rank's block of weight ``w`` in a compute layout, cast to
    ``dtype`` (None: its own): whole on every mesh axis but the model axis,
    where it is split along dim ``shard`` (or whole with ``shard=None``). A
    ``DTensor`` is cast, then redistributed to that layout (the gathers of
    its storage shards); a plain tensor (every rank holding all of it) is
    sliced.

    The gradient of a ``DTensor`` comes back in its storage layout, summed
    over ``runtime.data_axes`` (whose ranks hold other batch rows: the model
    cuts them to those that split the batch) and, with ``summed``, over the
    model axis too: a whole weight used in work the model ranks split (their
    query rows, their heads of a group). A weight the ranks use alike (a
    norm's, a replicated product's) or of which each rank uses its own block
    is not summed there."""
    return local_weights([(w, shard, dtype, summed)], runtime)[0]


def local_weights(specs, runtime: Runtime):
    """``[local_weight(w, runtime, shard, dtype, summed) for w, shard, dtype,
    summed in specs]``, the weights' moves on each mesh dim batched into one
    collective (a block fetches its weights together: one all-gather a mesh
    dim instead of one a weight, and so for their gradients)."""
    from torch.distributed.tensor import Replicate, Shard

    n = runtime.model_axis_size
    out, dts = [None] * len(specs), []
    for k, (w, shard, dtype, _) in enumerate(specs):
        if _is_dtensor(w):
            dts.append(k)
            continue
        if shard is not None and n > 1:
            w = w.chunk(n, dim=shard)[model_rank(runtime)]
        out[k] = w if dtype is None else w.to(dtype)
    if not dts:
        return out
    names = list(specs[dts[0]][0].device_mesh.mesh_dim_names)
    wants, dtypes, partials = [], [], []
    for k in dts:
        w, shard, dtype, summed = specs[k]
        want = [Replicate()] * len(names)
        if shard is not None and n > 1:
            want[names.index(runtime.model_axis)] = Shard(shard % w.ndim)
        partial = ()
        if torch.is_grad_enabled() and w.requires_grad:
            axes = list(runtime.data_axes) + ([runtime.model_axis] if summed and n > 1 else [])
            partial = tuple(names.index(a) for a in axes if a in names)
        wants.append(tuple(want))
        dtypes.append(dtype)
        partials.append(partial)
    plan, ws = (wants, dtypes, partials), [specs[k][0] for k in dts]
    got = _HELD.fetch(plan, ws) if _HELD is not None else None
    if got is None:
        got = _LocalWeights.apply(plan, *ws)
    for k, t in zip(dts, got):
        out[k] = t
    return out


class HeldWeights:
    """The weights ``local_weights`` moved during a train step, held for
    the step's later uses of them (the layer's recompute in the backward,
    the next microbatches), while their bytes stay within ``budget``: a
    block's weights move once a step instead of twice a microbatch. Each
    held weight is a leaf whose gradients accumulate in float32 over its
    uses; ``flush`` moves the sums to the parameters' storage layout once
    (``_relayout_adjoint``: the same collectives as ``_LocalWeights``'
    backward, one set a step) and adds them to the parameters' ``.grad``.
    Weights past the budget take ``_LocalWeights`` each use, as without a
    hold."""

    def __init__(self, budget: float):
        self.budget, self.bytes, self.entries = budget, 0, {}

    def fetch(self, plan, ws):
        key = (torch.is_grad_enabled(), tuple(id(w) for w in ws), *(tuple(p) for p in plan))
        entry = self.entries.get(key)
        if entry is not None:
            return entry["leaves"]
        wants, dtypes, partials = plan
        mesh = ws[0].device_mesh
        size = sum(w.numel() * (dt or w.dtype).itemsize
                   // math.prod(mesh.size(i) for i, p in enumerate(want) if p.is_shard())
                   for w, dt, want in zip(ws, dtypes, wants))
        if self.bytes + size > self.budget:
            return None
        with torch.no_grad():
            locs = [w.to_local() if dt is None else w.to_local().to(dt)
                    for w, dt in zip(ws, dtypes)]
            outs, steps = _relayout(locs, mesh, [w.placements for w in ws], wants)
        entry = {"ws": ws, "steps": steps, "partials": partials, "acc": [None] * len(ws),
                 "leaves": tuple(t.detach().requires_grad_(w.requires_grad
                                                           and torch.is_grad_enabled())
                                 for t, w in zip(outs, ws))}
        for k, leaf in enumerate(entry["leaves"]):
            if leaf.requires_grad:
                leaf.register_post_accumulate_grad_hook(self._accumulate(entry["acc"], k))
        self.bytes += size
        self.entries[key] = entry
        return entry["leaves"]

    @staticmethod
    def _accumulate(acc, k):
        def hook(leaf):
            g = leaf.grad.to(F32)
            acc[k] = g if acc[k] is None else acc[k] + g
            leaf.grad = None
        return hook

    def flush(self):
        """Adds each held weight's summed gradient, in its parameter's
        storage layout (a ``DTensor``), to the parameter's ``.grad``. The
        entries whose moves took the same steps (kinds on mesh dims: a
        model's blocks of one kind) move back together, one collective a
        step for all of them."""
        from torch.distributed.tensor import DTensor

        groups: dict = {}
        for entry in self.entries.values():
            if any(a is not None for a in entry["acc"]):
                sig = (id(entry["ws"][0].device_mesh),
                       *((kind, i) for kind, i, _ in entry["steps"]))
                groups.setdefault(sig, []).append(entry)
        for entries in groups.values():
            ws, gs, partials = [], [], []
            steps = [(kind, i, []) for kind, i, _ in entries[0]["steps"]]
            for entry in entries:
                for (_, _, items), (_, _, mine) in zip(steps, entry["steps"]):
                    items.extend((k + len(ws), *rest) for k, *rest in mine)
                ws += entry["ws"]
                partials += entry["partials"]
                gs += [a if a is not None else torch.zeros(t.shape, dtype=F32, device=t.device)
                       for a, t in zip(entry["acc"], entry["leaves"])]
                entry["acc"][:] = [None] * len(entry["ws"])  # the hooks' list
            mesh = ws[0].device_mesh
            for w, g in zip(ws, _relayout_adjoint(gs, mesh, steps, partials)):
                if not w.requires_grad:
                    continue
                d = DTensor.from_local(g.to(w.dtype), mesh, w.placements, run_check=False,
                                       shape=w.shape, stride=w.stride())
                w.grad = d if w.grad is None else w.grad + d


_HELD: HeldWeights | None = None


@contextlib.contextmanager
def held_weights(budget: float):
    """Within: ``local_weights`` holds the weights it moves (``HeldWeights``,
    up to ``budget`` bytes a rank); yields the hold, whose ``flush`` the
    caller runs after the last backward."""
    global _HELD
    if _HELD is not None:
        raise RuntimeError("held_weights: a hold is already open")
    _HELD = HeldWeights(budget)
    try:
        yield _HELD
    finally:
        _HELD = None


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


def matmul(x, w, runtime: Runtime, nc: int = 1, out_shard: int | None = None,
           entered: bool = False):
    """``x @ w`` over ``w``'s first ``nc`` dims in the compute dtype, for an
    ``x`` that is whole (the same) on every rank of the model axis. Where
    ``w``'s storage splits a contraction dim over the model axis and the
    product is small (``_partial_is_cheaper``), each rank multiplies its
    slice of it and the partial products are summed over the axis (the
    serving layout's small all-reduces, no weight moves); else ``w`` is
    moved to the layout needed. Returns the whole product, or
    with ``out_shard`` = a dim of ``w`` past the contraction, this rank's
    block of the product along that dim.

    Gradients: ``x`` whole, the product's gradient whole where it is whole;
    with ``entered`` ``x`` comes from ``enter_split`` and the product feeds
    work the model ranks split, so that only partial gradients flow
    (``local_weight``'s ``summed``)."""
    dt = runtime.compute_dtype
    n = runtime.model_axis_size
    c = model_shard_dim(w, runtime)
    n_out = w.dim() - nc
    if c is not None and c < nc and _partial_is_cheaper(x, w, nc, n):
        size = w.shape[c] // n
        xs = (x if entered else enter_split(x, runtime)).narrow(x.dim() - nc + c,
                                                              model_rank(runtime) * size, size)
        y = model_all_reduce(_contract(xs, local_weight(w, runtime, c, dt), nc), runtime,
                             sum_backward=entered or out_shard is not None)
        if out_shard is not None:
            y = y.chunk(n, dim=y.dim() - n_out + out_shard - nc)[model_rank(runtime)]
        return y
    if out_shard is not None and not entered:
        x = enter_split(x, runtime)
    wl = local_weight(w, runtime, out_shard, dt, summed=entered and out_shard is None)
    return _contract(x, wl, nc)


def matmuls(x, ws, runtime: Runtime, out_shard: int | None = None, entered: bool = False):
    """``[matmul(x, w, runtime, 1, out_shard, entered) for w in ws]``, the
    partial products of weights split on their first dim summed in one
    all-reduce (a decode step's q/k/v and gate/up projections in the serving
    layout), or where none sums partial products, the weights moved
    together (``local_weights``)."""
    n = runtime.model_axis_size
    partial = [model_shard_dim(w, runtime) == 0 and _partial_is_cheaper(x, w, 1, n)
               for w in ws]
    if n <= 1 or not all(partial):
        if out_shard is not None and not entered:  # one f for all the products
            x, entered = enter_split(x, runtime), True
        if any(partial):
            return [matmul(x, w, runtime, 1, out_shard, entered) for w in ws]
        return [_contract(x, wl, 1) for wl in local_weights(
            [(w, out_shard, runtime.compute_dtype, entered and out_shard is None) for w in ws],
            runtime)]
    dt, n, j = runtime.compute_dtype, runtime.model_axis_size, model_rank(runtime)
    size = ws[0].shape[0] // n
    xs = (x if entered else enter_split(x, runtime)).narrow(x.dim() - 1, j * size, size)
    parts = [_contract(xs, local_weight(w, runtime, 0, dt), 1) for w in ws]
    flat = model_all_reduce(torch.cat([p.reshape(*x.shape[:-1], -1) for p in parts], -1),
                            runtime, sum_backward=entered or out_shard is not None)
    sizes = [math.prod(p.shape[x.dim() - 1:]) for p in parts]
    outs = [f.reshape(p.shape) for f, p in zip(flat.split(sizes, -1), parts)]
    if out_shard is None:
        return outs
    return [y.chunk(n, dim=y.dim() - w.dim() + out_shard)[j] for y, w in zip(outs, ws)]


def matmul_split(h, w, runtime: Runtime, c: int, nc: int = 1):
    """``h @ w`` where ``h`` holds this rank's block of contraction dim ``c``
    (of ``w``'s first ``nc``) of the model axis: the local product of the
    matching block of ``w``, summed over the axis."""
    wl = local_weight(w, runtime, c, runtime.compute_dtype)
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


def apply_norm(p: Norm, x, cfg: ModelConfig, eps: float = 1e-6, runtime: Runtime | None = None):
    """The block's norm in float32. On a mesh (``runtime``) its weight comes
    through ``local_weight`` (every rank uses it alike)."""
    xf = x.to(F32)
    w = (whole(p.w) if runtime is None else local_weight(p.w, runtime)).to(F32)
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


def _bias(b, runtime: Runtime, shard: int | None = None, summed: bool = False):
    return local_weight(b, runtime, shard, runtime.compute_dtype, summed)


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
    with a cache writes every position's k/v the same way.

    Where the model ranks split the work (the first three modes), ``x`` and
    ``memory`` enter it through ``enter_split`` and the output leaves it
    through the gather of the query blocks or the sum of the partial
    products, so that the gradients are those of one device."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    dt = runtime.compute_dtype
    KV = cfg.kv_heads
    G = cfg.n_heads // KV
    n = runtime.model_axis_size
    j = model_rank(runtime)
    kv_src = memory if memory is not None else x
    rope = use_rope and memory is None

    def project(src, w, b, out_shard=None, entered=False):
        y = matmul(src, w, runtime, 1, out_shard, entered)
        if b is None:
            return y
        return y + _bias(b, runtime, None if out_shard is None else 0,
                         summed=entered and out_shard is None)

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
    if n > 1 and (mode == "sequence" and memory is None and S % n == 0
                  or KV % n == 0 or G % n == 0):
        # the model ranks split the work: x (and memory) enter it through f,
        # and the weights every rank uses whole get their gradients summed
        x = enter_split(x, runtime)
        kv_src = x if memory is None else enter_split(memory, runtime)
    if n > 1 and mode == "sequence" and memory is None and S % n == 0:
        Sb = S // n
        r0 = j * Sb
        ws = [w for w in (p.wq, p.wk, p.wv, p.wo, bq, bk, bv) if w is not None]
        wq, wk, wv, wo, *bs = local_weights([(w, None, dt, True) for w in ws], runtime)
        q = torch.einsum("bsd,dnh->bsnh", x[:, r0:r0 + Sb], wq)
        k = torch.einsum("bsd,dnh->bsnh", x, wk)
        v = torch.einsum("bsd,dnh->bsnh", x, wv)
        if bs:
            q, k, v = q + bs[0], k + bs[1], v + bs[2]
        if rope:
            q = rope_embed(q, positions[..., r0:r0 + Sb], cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, Sb, KV, G, hd), k, v, offset=r0, **flash)
        y = model_all_gather(torch.einsum("bsnh,nhd->bsd", out.reshape(B, Sb, -1, hd), wo),
                             runtime, dim=1)
        k_all, v_all = k, v
    elif n > 1 and KV % n == 0:  # this rank's KV / n groups of heads
        if memory is None:
            q, k, v = matmuls(x, (p.wq, p.wk, p.wv), runtime, out_shard=1, entered=True)
        else:
            q = matmul(x, p.wq, runtime, 1, 1, entered=True)
            k, v = matmuls(kv_src, (p.wk, p.wv), runtime, out_shard=1, entered=True)
        if bq is not None:
            bq, bk, bv = local_weights([(b, 0, dt, False) for b in (bq, bk, bv)], runtime)
            q, k, v = q + bq, k + bk, v + bv
        if rope:
            q = rope_embed(q, positions, cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, S, KV // n, G, hd), k, v, **flash)
        y = matmul_split(out.reshape(B, S, -1, hd), p.wo, runtime, 0, nc=2)
        k_all, v_all = (model_all_gather(t, runtime, 2) if cache is not None else None
                        for t in (k, v))
    elif n > 1 and G % n == 0:
        gs = slice(j * (G // n), (j + 1) * (G // n))  # this rank's query heads of each group
        wq, wo, *bs = local_weights([(w, None, dt, True) for w in (p.wq, p.wo, bq)
                                     if w is not None], runtime)
        q = torch.einsum("bsd,dkgh->bskgh", x, wq.reshape(-1, KV, G, hd)[:, :, gs])
        if bs:
            q = q + bs[0].reshape(KV, G, hd)[:, gs]
        k = project(kv_src, p.wk, bk, entered=True)
        v = project(kv_src, p.wv, bv, entered=True)
        if rope:
            q = rope_embed(q.reshape(B, S, -1, hd), positions, cfg.rope_theta)
            k = rope_embed(k, positions, cfg.rope_theta)
        out = kops.flash_attention(q.reshape(B, S, KV, G // n, hd), k, v, **flash)
        y = model_all_reduce(torch.einsum("bskgh,kghd->bsd", out,
                                          wo.reshape(KV, G, hd, -1)[:, gs]), runtime)
        k_all, v_all = k, v
    else:  # every rank computes the whole attention
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
    reduced. ``x`` enters that split through ``enter_split`` (in
    ``matmuls``)."""
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
