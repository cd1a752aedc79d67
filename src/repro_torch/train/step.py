"""Training step (``repro/train/step.py``): microbatched gradient
accumulation, the model's forward with each layer rematerialised (see
``models/model.py``), and the optimizer update; and the reference's int8
error-feedback cross-pod gradient all-reduce (``compress_allreduce_pod``).

On a device mesh (``runtime.mesh``) the step runs on every rank with the
same global batch: the model takes the rank's rows, the loss is the whole
batch's, and each parameter's gradient is a ``DTensor`` in the parameter's
placements, built from the rank's local gradient (``models/layers.py``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Runtime, _is_dtensor
from repro_torch.models.layers import local_shard as _local
from repro_torch.models.model import lm_loss
from repro_torch.train.optimizer import Optimizer

F32 = torch.float32


def _like(p, local):
    """``local`` (this rank's shard of a value shaped as ``p``) as a
    ``DTensor`` in ``p``'s placements, no collective; ``local`` itself
    where ``p`` is a plain tensor."""
    if not _is_dtensor(p):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=torch.empty(p.shape, device="meta").stride())


def _split(x, mb: int):
    """``x`` (NumPy array or tensor) cut into ``mb`` equal, contiguous parts
    along its batch axis, as the reference's reshape to (mb, B // mb, ...)."""
    n = x.shape[0] // mb
    return [x[i * n:(i + 1) * n] for i in range(mb)]


def global_norm(grads) -> torch.Tensor:
    """The float32 L2 norm of a dict of gradients: each leaf's local sum of
    squares, summed over the mesh dims that split the leaf (one all-reduce
    per mesh group of leaves), so that a leaf every rank holds whole counts
    once."""
    with telemetry.span("train/global_norm"):
        total = torch.zeros((), dtype=F32)
        sums: dict = {}
        for g in grads.values():
            loc = _local(g).to(F32)
            ss = torch.sum(loc * loc)
            total = total.to(ss.device)
            if not _is_dtensor(g):
                total = total + ss
                continue
            dims = tuple(i for i, pl in enumerate(g.placements) if pl.is_shard())
            key = (id(g.device_mesh), dims)
            mesh, acc = sums.get(key, (g.device_mesh, 0.0))
            sums[key] = (mesh, acc + ss)
        for (_, dims), (mesh, ss) in sums.items():
            for i in dims:
                dist.all_reduce(ss, group=mesh.get_group(i))
            total = total + ss
        return torch.sqrt(total)


HOLD_SHARE = 0.25  # of the card's memory a mesh step may hold moved weights in


def hold_budget(runtime: Runtime) -> float:
    """The bytes a rank may hold moved weights in during a mesh step
    (``layers.held_weights``): HOLD_SHARE of a card's memory; unbounded on
    the host."""
    if runtime.device.type != "cuda":
        return float("inf")
    return HOLD_SHARE * torch.cuda.get_device_properties(runtime.device).total_memory


def make_train_step(cfg: ModelConfig, runtime: Runtime, optimizer: Optimizer,
                    microbatches: int | None = None):
    """Returns train_step(lm, opt_state, batch) -> (lm, opt_state, metrics),
    which updates ``lm``'s parameters in place.

    batch: dict(tokens (B, S) int, labels (B, S) int [, patches | frames]),
    NumPy arrays or tensors, the global batch on every rank of a mesh. With
    ``mb`` microbatches (the config's unless given) the batch is cut into
    ``mb`` parts along B (microbatch i its rows i·B/mb ..., of which a rank
    takes its own), each part's gradient is summed in float32 and the sum
    divided by ``mb``, and the loss is the parts' mean; then metrics' ``nll``
    is that loss and ``aux`` 0, as the reference sets them. ``grad_norm`` is
    the float32 global L2 norm of the gradient the optimizer takes
    (``global_norm``).

    On a mesh the weights the layers move are held for the step
    (``layers.held_weights``, up to ``hold_budget`` bytes a rank): each
    moves once a step, not in each microbatch's forward and recompute, and
    its gradient moves back to its storage layout once, summed over the
    microbatches in float32."""
    mb = microbatches if microbatches is not None else cfg.microbatches

    def loss_fn(lm, micro):
        extra = {k: v for k, v in micro.items() if k not in ("tokens", "labels")}
        return lm_loss(lm, cfg, runtime, micro["tokens"], micro["labels"], extra)

    def step(lm, opt_state, batch):
        params = dict(lm.named_parameters())
        for p in params.values():
            p.grad = None
        acc = {}  # float32 sums of the (local) gradients of parameters in another dtype

        def take_grads():
            for name, p in params.items():
                if p.dtype != F32 and p.grad is not None:
                    acc[name] = _local(p.grad).to(F32) + acc.get(name, 0.0)
                    p.grad = None

        with (L.held_weights(hold_budget(runtime)) if runtime.mesh is not None
              else contextlib.nullcontext()) as held:
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
                    take_grads()
                loss = loss / mb
                metrics = {"nll": loss, "aux": torch.zeros((), dtype=F32, device=runtime.device)}
            if held is not None:
                held.flush()
                if mb > 1:
                    take_grads()
        grads = {}
        for name, p in params.items():
            g = acc.get(name, None if p.grad is None else _local(p.grad))
            g = torch.zeros(_local(p).shape, dtype=F32, device=_local(p).device) if g is None \
                else g.to(F32)
            grads[name] = _like(p, g.div_(mb) if mb > 1 else g)  # g is the step's own sum
            p.grad = None
        gnorm = global_norm(grads)
        optimizer.update(grads, opt_state, params)
        return lm, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    def train_step(lm, opt_state, batch):
        with telemetry.span("train/step"):
            return step(lm, opt_state, batch)

    return train_step


# ----------------------------------------------------------------------------
# int8 error-feedback compressed cross-pod gradient all-reduce
# ----------------------------------------------------------------------------
def compress_allreduce_pod(grads, mesh, error_state, axis: str = "pod"):
    """Quantize each gradient leaf to int8 (per-tensor scale), all-reduce the
    int8 payload across pods, dequantize, and carry the quantization error to
    the next step (error feedback), as the reference's: per leaf g + error,
    scale = max(max |g|, 1e-12) / 127, q = clip(round(g / scale), -127, 127)
    as int8 (round half to even), the new error g - q·scale; the sum of q as
    int32 over the ``axis`` group, times the mean of the pods' scales, over
    the pod count. ``grads`` and ``error_state`` are (nested) dicts of
    tensors or ``DTensor``s on ``mesh``; a ``DTensor`` leaf's max |g| is
    taken over its whole value (a max over the other mesh dims that split
    it). Returns (the reduced gradients, the new error state)."""
    group = mesh.get_group(axis)
    npods = mesh.size(mesh.mesh_dim_names.index(axis))
    pod_dim = mesh.mesh_dim_names.index(axis)

    def div(a, b):
        # by a tensor: CUDA divides by a Python number as a product with its
        # reciprocal, which rounds 1/127 once more than the formula
        return a / torch.full((), b, dtype=a.dtype, device=a.device)

    def one(g, err):
        g32 = _local(g).to(F32) + _local(err)
        amax = g32.abs().max()
        if _is_dtensor(g):
            for i, pl in enumerate(g.placements):
                if pl.is_shard() and i != pod_dim:
                    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
        scale = div(torch.clamp(amax, min=1e-12), 127.0)
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_err = g32 - q.to(F32) * scale
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        ssum = scale.clone()
        dist.all_reduce(ssum, group=group)  # the pods' scales differ: their mean
        red = div(qsum.to(F32) * div(ssum, npods), npods)
        return _like(g, red), _like(g, new_err)

    def walk(g, err):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], err[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
        return one(g, err)

    return walk(grads, error_state)
