"""Multi-pod dry-run of the port (``repro/launch/dryrun.py``): one step of
every (arch x shape x mesh) cell traced on fake tensors, as rank 0 of a fake
process group of 256 (single_pod, (16, 16)) or 512 (multi_pod, (2, 16, 16))
ranks. Nothing is allocated and nothing is launched: the step runs eagerly
under ``FakeTensorMode``, the flash and SSD kernels as their operators
(``torch.ops.repro_torch.flash_fwd`` / ``ssd_chunk_fwd``, whose fake versions
give the shapes), every collective answered at once by the "fake" backend.
Each cell records a row with the reference's keys: FLOPs
(``FlopCounterMode``), bytes each operator reads and writes, the collectives'
result bytes by kind, one repeat of each stage, peak memory (``MemTracker``),
the analytic minimum traffic and the three roofline terms.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out results/dryrun_torch.json
  (``--device cpu`` traces fake CPU tensors on a CPU mesh: no card needed. The
  default, ``cuda``, traces fake CUDA tensors on a CUDA mesh, as the ranks of
  a deployment hold them, and needs the card's host: the mesh takes card 0.)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.launch import specs as S

# Roofline constants of one card, from NVIDIA's H100 SXM5 data sheet (the
# NVIDIA H100 80GB HBM3 at its 700 W limit): dense bf16 tensor-core peak,
# HBM3 rate, NVLink 4 rate each way.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# The reference's decode layout rule (repro/launch/dryrun.py:262-270): the
# weights sharded over 'model' only where the weights' model shard plus the
# cache's share of a device stay under this many bytes. A rule of the
# reference's (set for its pod), not a size of the card.
MODEL_ONLY_RULE_BYTES = 14e9

KERNEL_OPS = ("flash_fwd", "ssd_chunk_fwd")  # the port's operators in namespace repro_torch

# c10d functions of the port's collectives (each counted by its result bytes,
# the reference's per-device payload convention) and the reference's HLO
# kind of each; recv / irecv stand for a collective-permute (the port issues
# none), barrier moves nothing
C10D_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "recv": "collective-permute",
    "irecv": "collective-permute",
    "barrier": None,
}


# ----------------------------------------------------------------------------
# Counters of a trace
# ----------------------------------------------------------------------------
def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


_aten = torch.ops.aten
# operators that allocate without reading or writing (no bytes), and those
# that fill their result without reading their tensor arguments (its bytes)
_ALLOCATING = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided}
_FILLING = {_aten.zeros, _aten.zeros_like, _aten.ones, _aten.ones_like, _aten.full,
            _aten.full_like, _aten.new_zeros, _aten.new_ones, _aten.new_full, _aten.fill_,
            _aten.zero_, _aten.scalar_tensor, _aten.arange}


class OpBytes(TorchDispatchMode):
    """Sums the bytes each operator reads and writes (its tensor arguments
    and results; views and allocations move nothing, a fill only writes) and
    counts the calls of the port's kernel operators. An unfused upper bound
    of the traffic, as XLA-CPU's "bytes accessed" is (the reference's
    ``hlo_bytes``). DTensor operations are left to DTensor, which runs them
    as local operations that are counted."""

    def __init__(self):
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.bytes = 0
        self.kernel_ops = dict.fromkeys(KERNEL_OPS, 0)
        self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "repro_torch":
            name = func._opname
            self.kernel_ops[name] = self.kernel_ops.get(name, 0) + 1
        packet = func.overloadpacket
        if func.is_view or packet in _ALLOCATING or not _tensor_bytes(out):
            return out  # a view, an allocation, or a query of metadata
        if packet not in _FILLING:
            self.bytes += _tensor_bytes((args, kwargs))
        self.bytes += _tensor_bytes(out)
        return out


@contextlib.contextmanager
def recording_collectives():
    """Records the c10d collectives issued inside (``torch.distributed``'s
    functions of ``C10D_KINDS``, wrapped meanwhile): yields {function name:
    [calls, result bytes]}. The result is the tensor a collective writes:
    all_reduce's tensor, the output of all_gather_into_tensor /
    reduce_scatter_tensor / all_to_all_single, recv's buffer."""
    calls: dict = {}
    originals = {name: getattr(dist, name) for name in C10D_KINDS}

    def recorded(name, fn):
        def call(*args, **kwargs):
            t = args[0] if args else next(iter(kwargs.values()), None)
            entry = calls.setdefault(name, [0, 0])
            entry[0] += 1
            if isinstance(t, torch.Tensor):
                entry[1] += t.numel() * t.element_size()
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(dist, name, recorded(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def collective_bytes(calls: dict) -> dict:
    """The reference's ``collective_bytes`` of the recorded calls
    (``recording_collectives``): result bytes summed per HLO kind
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``; kinds not issued left out) and their ``total``."""
    out: dict[str, float] = {}
    for name, (_, nbytes) in calls.items():
        kind = C10D_KINDS[name]
        if kind is not None:
            out[kind] = out.get(kind, 0.0) + float(nbytes)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


class _Counters:
    """The running counters of one trace (FLOPs, operator bytes, collective
    bytes) and their deltas attributed to the block being traced: ``switch``
    hands the counts since the last switch to the current label."""

    def __init__(self, flops, op_bytes, calls):
        self.flops, self.op_bytes, self.calls = flops, op_bytes, calls
        self.label = None
        self.last = self.snapshot()
        self.by_label: dict = {}

    def snapshot(self):
        coll = sum(b for name, (_, b) in self.calls.items() if C10D_KINDS[name] is not None)
        return (self.flops.get_total_flops(), self.op_bytes.bytes, coll)

    def switch(self, label):
        now = self.snapshot()
        if self.label is not None:
            acc = self.by_label.setdefault(self.label, [0, 0, 0])
            for i, (a, b) in enumerate(zip(now, self.last)):
                acc[i] += a - b
        self.label, self.last = label, now


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


class _Mark(torch.autograd.Function):
    """A mark on a block's input, (label, None), or output, (None, label):
    its forward switches the counts to ``ahead`` (not in a backward's
    recompute, which belongs to the block's backward), its backward to
    ``behind``, so that a block's forward and its backward count for it."""

    @staticmethod
    def forward(ctx, x, counters, ahead, behind):
        if not _in_backward():
            counters.switch(ahead)
        ctx.counters, ctx.behind = counters, behind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.counters.switch(ctx.behind)
        return g, None, None, None


def _layer_labels(lm) -> dict:
    """{id(block): (stage name, layer index)} for every block of ``lm``: the
    stage of ``LM.stage_of``, and the audio encoder's layers as "encoder"."""
    labels = {}
    for i, (layer, (si, _)) in enumerate(zip(lm.layers, lm.stage_of)):
        for block in layer:
            labels[id(block)] = (f"stage{si}", i)
    for i, layer in enumerate(getattr(lm, "encoder", ())):
        for block in layer:
            labels[id(block)] = ("encoder", i)
    return labels


@contextlib.contextmanager
def _marking_blocks(lm, counters):
    """Every block the model applies (``model._apply_block``, wrapped
    meanwhile) between two ``_Mark``s of its layer."""
    from repro_torch.models import model as M

    labels = _layer_labels(lm)
    apply_block = M._apply_block

    def marked(block, x, *args, **kwargs):
        label = labels.get(id(block))
        if label is None:
            return apply_block(block, x, *args, **kwargs)
        y, aux, cache = apply_block(block, _Mark.apply(x, counters, label, None), *args,
                                   **kwargs)
        return _Mark.apply(y, counters, None, label), aux, cache

    M._apply_block = marked
    try:
        yield
    finally:
        M._apply_block = apply_block


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors in ``tree`` (a DTensor by its
    local shard)."""
    from repro_torch.models.layers import local_shard

    out = {}
    leaves, _ = tree_flatten(tree)
    for t in leaves:
        if isinstance(t, torch.nn.Module):
            out.update(_storages([*t.parameters(), *t.buffers()]))
            continue
        if not isinstance(t, torch.Tensor):
            continue
        st = local_shard(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def trace_step(step, args, lm=None, device=None, memory_only=False):
    """Runs ``step(*args)`` once on fake tensors (the caller holds the
    ``FakeTensorMode`` in which ``args`` were made) under the counters: FLOPs
    (``FlopCounterMode``), operator bytes (``OpBytes``), collectives
    (``recording_collectives``), peak memory (``MemTracker``, the inputs
    tracked as held from the start; its peak on ``device``, by default the
    first input tensor's) and, where ``lm`` is given, the counts of each
    layer. Returns a dict: flops, bytes, calls (recorded collectives),
    kernel_ops, layers {(stage, layer): [flops, bytes, coll]}, memory (the
    reference's ``memory_analysis`` keys), peak_bytes, seconds, out (the
    step's fake result). ``memory_only``: MemTracker alone (a quarter
    quicker); the counts come back empty."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    leaves = tree_flatten(list(args))[0]
    inputs = _storages(leaves)
    mem = MemTracker()
    mem.track_external(*[t for t in leaves if isinstance(t, (torch.Tensor, torch.nn.Module))])
    flops, op_bytes = FlopCounterMode(display=False), OpBytes()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        calls = stack.enter_context(recording_collectives())
        stack.enter_context(mem)
        counters = None
        if not memory_only:
            stack.enter_context(flops)
            stack.enter_context(op_bytes)
            counters = _Counters(flops, op_bytes, calls)
            if lm is not None:
                stack.enter_context(_marking_blocks(lm, counters))
        out = step(*args)
        if counters is not None:
            counters.switch(None)
    seconds = time.perf_counter() - t0
    # the peak on the step's device (a meta tensor, which the port makes only
    # to take a layout's strides, holds no memory)
    if device is None:
        device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
    peak = max((snap.get("Total", 0) for dev, snap in mem.get_tracker_snapshot("peak").items()
                if torch.device(dev).type == torch.device(device).type), default=0)
    arg_bytes = sum(inputs.values())
    outputs = {k: v for k, v in _storages(out).items() if k not in inputs}
    memory = {"temp_size_in_bytes": max(peak - arg_bytes, 0),
              "argument_size_in_bytes": arg_bytes,
              "output_size_in_bytes": sum(outputs.values()),
              "generated_code_size_in_bytes": 0}
    return {"flops": float(flops.get_total_flops()), "bytes": float(op_bytes.bytes),
            "calls": {k: list(v) for k, v in calls.items()},
            "kernel_ops": dict(op_bytes.kernel_ops),
            "layers": counters.by_label if counters is not None else {},
            "memory": memory, "peak_bytes": peak, "seconds": seconds, "out": out}


# ----------------------------------------------------------------------------
# The reference's functions
# ----------------------------------------------------------------------------
def model_flops(cfg, shape_name: str) -> float:
    seq, gbs, kind = SHAPES[shape_name]
    n_active = cfg.active_params()
    if kind == "train":
        return 6.0 * n_active * seq * gbs
    if kind == "prefill":
        return 2.0 * n_active * seq * gbs
    return 2.0 * n_active * gbs  # decode: one token per sequence


def effective_config(arch: str, *, remat=None, attn_shard=None, microbatches=None,
                     seq_shard=None):
    cfg = get_config(arch)
    overrides = {}
    if remat is not None:
        overrides["remat_policy"] = remat
    if attn_shard is not None:
        overrides["attn_shard"] = attn_shard
    if microbatches is not None:
        overrides["microbatches"] = microbatches
    if seq_shard is not None:
        overrides["seq_shard_activations"] = seq_shard
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def decode_model_only(cfg, shape_name: str, mesh, serve_dtype: str = "bf16",
                      decode_params: str = "auto") -> bool:
    """Whether a decode cell shards its weights over 'model' only: the
    reference's rule (its dryrun.py:262-270 and :322-327)."""
    from repro_torch.launch.mesh import mesh_shape

    seq, gbs, kind = SHAPES[shape_name]
    if kind != "decode":
        return False
    ms = mesh_shape(mesh)
    chips = math.prod(ms.values())
    model_n = 1 if cfg.pure_dp else ms.get("model", 1)
    p_bytes = 1 if serve_dtype == "f8" else 2
    fits = (p_bytes * cfg.total_params() / max(model_n, 1)
            + cfg.kv_bytes_per_seq(seq) * gbs / chips) < MODEL_ONLY_RULE_BYTES
    return decode_params == "model_only" or (decode_params == "auto" and fits
                                             and not cfg.pure_dp)


def _fake_batch(cfg, shape_name, mesh, runtime):
    """The cell's batch on the runtime's device (fake tensors under the
    caller's ``FakeTensorMode``) with the shapes and dtypes of
    ``specs.batch_specs``,
    whole on every rank (the port's convention: each rank takes its rows); a
    decode step's index is the last position (the step attends over the
    whole cache)."""
    seq = SHAPES[shape_name][0]
    metas, _ = S.batch_specs(cfg, shape_name, mesh, runtime)
    batch = {}
    for name, meta in metas.items():
        if name == "index":
            batch[name] = seq - 1
        else:
            batch[name] = torch.zeros(meta.shape, dtype=meta.dtype, device=runtime.device)
    return batch


def build_lowerable(arch: str, shape_name: str, mesh, *, remat=None, attn_shard=None,
                    microbatches=None, seq_shard=None, cfg=None, serve_dtype="bf16",
                    decode_params="auto"):
    """The cell's step and its inputs, made on fake tensors of the mesh's
    device type: call it inside a
    ``FakeTensorMode`` (``run_cell`` does). Returns (step, args, lm). A train
    cell: float32 parameters laid out by ``tree_shardings``' rule
    (``interop.place_params``), the ``for_config`` optimizer's state and
    ``make_train_step``; prefill: bf16 (or f8) parameters and
    ``make_prefill_step``; decode: the same parameters in the layout of the
    reference's rule (``decode_model_only``), the cache (``init_cache`` on
    the mesh, ``cache_shardings``' layout) and ``make_decode_step``."""
    from repro_torch import interop
    from repro_torch.models.model import LM, init_cache

    if cfg is None:
        cfg = effective_config(arch, remat=remat, attn_shard=attn_shard,
                               microbatches=microbatches, seq_shard=seq_shard)
    seq, gbs, kind = SHAPES[shape_name]
    runtime = S.make_runtime(cfg, mesh)
    dev = runtime.device
    batch = _fake_batch(cfg, shape_name, mesh, runtime)

    if kind == "train":
        from repro_torch.train.optimizer import for_config
        from repro_torch.train.step import make_train_step

        lm = LM(cfg, dev, torch.float32)
        interop.place_params(lm, cfg, mesh, pure_dp=cfg.pure_dp)
        opt = for_config(cfg)
        state = opt.init(dict(lm.named_parameters()))
        return make_train_step(cfg, runtime, opt), (lm, state, batch), lm

    p_dtype = torch.float8_e4m3fn if serve_dtype == "f8" else torch.bfloat16
    lm = LM(cfg, dev, p_dtype)
    model_only = decode_model_only(cfg, shape_name, mesh, serve_dtype, decode_params)
    interop.place_params(lm, cfg, mesh, pure_dp=cfg.pure_dp, model_only=model_only)
    if kind == "prefill":
        from repro_torch.serve.step import make_prefill_step

        return make_prefill_step(cfg, runtime), (lm, batch), lm
    from repro_torch.serve.step import make_decode_step

    caches = init_cache(cfg, runtime, gbs, seq)
    return make_decode_step(cfg, runtime), (lm, batch, caches), lm


def stage_body_metrics(lm, layers: dict) -> list:
    """One repeat of each stage: {stage, repeat, flops, bytes, coll} (the
    reference's entries), from the counts ``trace_step`` attributed to each
    layer; a stage's repeats do the same work, and each entry is their mean.
    The audio encoder's stage is "encoder" where the step ran it. The eager
    trace already ran every repeat, so the totals need no correction by
    them."""
    out = []
    stages: dict = {}
    for (stage, i), counts in layers.items():
        stages.setdefault(stage, []).append(counts)
    for name in sorted(stages, key=lambda s: (s == "encoder", s)):
        rows = stages[name]
        n = len(rows)
        if name == "encoder":
            repeat = len(lm.encoder)
        else:
            si = int(name[len("stage"):])
            repeat = sum(1 for s, _ in lm.stage_of if s == si)
        out.append(dict(stage=name, repeat=repeat,
                        flops=float(sum(r[0] for r in rows) / n),
                        bytes=float(sum(r[1] for r in rows) / n),
                        coll=float(sum(r[2] for r in rows) / n)))
    return out


def trace_cell(arch, shape_name, mesh, *, cfg, serve_dtype="bf16", decode_params="auto",
               memory_only=False):
    """``build_lowerable`` and ``trace_step`` in one ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, lm = build_lowerable(arch, shape_name, mesh, cfg=cfg, serve_dtype=serve_dtype,
                                       decode_params=decode_params)
        return trace_step(fn, args, lm, device=mesh.device_type, memory_only=memory_only), lm


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, verbose=True, serve_dtype="bf16",
             decode_params="auto", device="cuda", **overrides) -> dict:
    """One cell's row: the reference's keys (``lower_s`` the trace's seconds,
    ``compile_s`` 0.0), plus ``kernel_ops`` (the flash and SSD operators'
    calls in the trace), ``collective_calls``, ``device`` and ``card`` (the
    roofline constants' card). A failed cell records ``FAIL: ...`` and its
    traceback."""
    from repro_torch.launch.mesh import fake_world, mesh_shape
    from repro_torch.launch.traffic import min_traffic_bytes

    cfg = effective_config(arch, **overrides)
    ok, why = cell_is_runnable(cfg, shape_name)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        row["status"] = why
        return row
    world = 512 if mesh_kind == "multi_pod" else 256
    seq, gbs, kind = SHAPES[shape_name]
    try:
        with fake_world(world, device_type=device) as mesh:
            ms = mesh_shape(mesh)
            chips = math.prod(ms.values())
            # roofline metrics at one microbatch, as the reference takes them;
            # the production microbatches' memory is traced separately below
            cfg_mb1 = dataclasses.replace(cfg, microbatches=1) if kind == "train" else cfg
            got, lm = trace_cell(arch, shape_name, mesh, cfg=cfg_mb1, serve_dtype=serve_dtype,
                                 decode_params=decode_params)
            mem_production = None
            if kind == "train" and cfg.microbatches > 1:
                mem_production = trace_cell(arch, shape_name, mesh, cfg=cfg,
                                            memory_only=True)[0]["memory"]
        flops_dev, bytes_dev = got["flops"], got["bytes"]
        coll = collective_bytes(got["calls"])
        coll_dev = float(coll["total"])
        bodies = stage_body_metrics(lm, got["layers"])
        model_only = decode_model_only(cfg, shape_name, ms, serve_dtype, decode_params)
        traffic_dev = min_traffic_bytes(cfg, shape_name, ms,
                                        serve_bytes=1.0 if serve_dtype == "f8" else 2.0,
                                        decode_model_only=model_only)
        compute_s = flops_dev / PEAK_FLOPS
        memory_s = traffic_dev / HBM_BW  # analytic min-traffic (launch/traffic.py)
        coll_s = coll_dev / LINK_BW
        dominant = max(("compute", compute_s), ("memory", memory_s), ("collective", coll_s),
                       key=lambda kv: kv[1])[0]
        mf = model_flops(cfg, shape_name)
        row.update(
            status="ok",
            chips=chips,
            global_batch=gbs,
            seq=seq,
            kind=kind,
            lower_s=round(got["seconds"], 1),
            compile_s=0.0,
            hlo_flops_per_device=flops_dev,
            hlo_bytes_per_device=bytes_dev,  # unfused upper bound (OpBytes)
            traffic_bytes_per_device=traffic_dev,  # analytic min-traffic model
            hlo_flops_total=flops_dev * chips,
            hlo_bytes_total=bytes_dev * chips,
            collective_bytes_per_device=coll_dev,
            collective_bytes_total=coll_dev * chips,
            collective_breakdown={k: v for k, v in coll.items() if k != "total"},
            stage_bodies=bodies,
            compute_term_s=compute_s,
            memory_term_s=memory_s,
            collective_term_s=coll_s,
            dominant=dominant,
            model_flops=mf,
            model_flops_ratio=(mf / (flops_dev * chips)) if flops_dev else None,
            params_bytes=2.0 * cfg.total_params() if kind != "train" else
            4.0 * cfg.total_params(),
            kv_bytes_per_seq=cfg.kv_bytes_per_seq(seq),
            memory_analysis=got["memory"],
            memory_analysis_production_mb=mem_production,
            microbatches_production=cfg.microbatches,
            kernel_ops=got["kernel_ops"],
            collective_calls={k: v[0] for k, v in got["calls"].items()},
            device=device,
            card=CARD,
        )
        if verbose:
            ma = row["memory_analysis"]
            print(f"[ok] {arch} {shape_name} {mesh_kind}: trace {got['seconds']:.1f}s | "
                  f"flops/dev {flops_dev:.3e} bytes/dev {bytes_dev:.3e} coll/dev {coll_dev:.3e} | "
                  f"terms c={compute_s*1e3:.2f}ms m={memory_s*1e3:.2f}ms x={coll_s*1e3:.2f}ms "
                  f"-> {dominant} | mem args {ma['argument_size_in_bytes']/1e9:.2f}GB "
                  f"temp {ma['temp_size_in_bytes']/1e9:.2f}GB | ops {got['kernel_ops']}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — a failed cell is a fault to record
        row["status"] = f"FAIL: {type(e).__name__}: {e}"
        row["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh_kind}: {type(e).__name__}: {str(e)[:400]}",
                  flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single_pod", choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--attn-shard", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-shard", default=None, choices=[None, "on", "off"])
    ap.add_argument("--serve-dtype", default="bf16", choices=["bf16", "f8"])
    ap.add_argument("--decode-params", default="auto", choices=["auto", "2d", "model_only"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single_pod", "multi_pod"] if args.mesh == "both" else [args.mesh]

    rows = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                row = run_cell(
                    arch, shape, mesh_kind,
                    remat=args.remat, attn_shard=args.attn_shard,
                    microbatches=args.microbatches,
                    seq_shard=None if args.seq_shard is None else args.seq_shard == "on",
                    serve_dtype=args.serve_dtype, decode_params=args.decode_params,
                    device=args.device,
                )
                rows.append(row)
                if args.out:
                    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                    Path(args.out).write_text(json.dumps(rows, indent=1))
    n_ok = sum(1 for r in rows if r.get("status") == "ok")
    n_skip = sum(1 for r in rows if str(r.get("status", "")).startswith("SKIP"))
    n_fail = len(rows) - n_ok - n_skip
    print(f"\ndry-run: {n_ok} ok, {n_skip} skip, {n_fail} fail / {len(rows)} cells")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
