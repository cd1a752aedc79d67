"""The language model of the reference's model substrate
(``repro/models/model.py``), in PyTorch: all of its families (dense, moe,
hybrid, ssm, vlm, audio).

Entry points, as in the reference:
  init_params(cfg, generator, dtype, device)   -> LM with random weights
  apply_lm(lm, cfg, runtime, tokens, extra)     -> logits (train / prefill forward), aux
  init_cache(cfg, runtime, batch, max_len)      -> decode cache
  apply_decode(lm, cfg, runtime, tokens, cache, index, extra) -> logits, cache
  lm_loss(lm, cfg, runtime, tokens, labels, extra) -> loss, {"nll", "aux"}

``extra`` holds the vlm family's ``patches`` (B, Np, d_vision), the audio
family's ``frames`` (B, F, d) or, for either, a precomputed ``memory`` (B,
S_src, d) (``_encode_memory``). The reference scans each stage over its
repeat count; here every repeat is one entry of ``LM.layers`` (an
``nn.ModuleList`` of its blocks), and the decode cache keeps the reference's
per-stage layout with a leading repeat axis, updated in place. Where the
reference wraps a stage's scan body in ``jax.checkpoint`` (``remat_policy``
not ``"none"``, no cache), each layer runs under
``torch.utils.checkpoint`` when a gradient is being recorded: its
activations are recomputed in the backward, whatever the policy names (the
reference's ``"dots"`` keeps its matmul outputs; the values are the same,
memory and time differ).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, Stage
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models.layers import Runtime

F32 = torch.float32


def encoder_stage(cfg: ModelConfig) -> Stage:
    """The audio family's encoder: non-causal self-attention and an MLP,
    ``enc_layers`` times (the reference builds the same Stage inline)."""
    return Stage(blocks=(("self_attn", {"causal": False}), ("mlp", {})), repeat=cfg.enc_layers)


class Block(nn.Module):
    """One pre-norm residual block: ``norm`` and one of ``attn`` (self- or
    cross-attention) / ``mlp`` / ``moe`` / ``mamba``."""

    def __init__(self, kind: str, opts: dict, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.kind = kind
        self.causal = opts.get("causal", True)
        self.norm = L.Norm(cfg, device, dtype)
        if kind in ("self_attn", "cross_attn"):
            self.attn = L.Attention(cfg, device, dtype)
        elif kind == "mlp":
            self.mlp = L.MLP(cfg, device, dtype)
        elif kind == "moe":
            self.moe = MOE.MoE(cfg, device, dtype)
        elif kind == "mamba":
            self.mamba = MB.Mamba(cfg, device, dtype)
        else:
            raise ValueError(kind)


def _stage_layers(stage: Stage, cfg: ModelConfig, device, dtype) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleList(Block(kind, opts, cfg, device, dtype) for kind, opts in stage.blocks)
        for _ in range(stage.repeat))


class LM(nn.Module):
    """Parameters: ``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V) unless
    tied, and ``layers[i]`` = the blocks of one stage repeat; ``stage_of[i]``
    is (stage index, repeat index) of layer i. The audio family adds
    ``encoder`` (its layers, as ``layers``) and ``enc_norm``, the vlm family
    ``vision_proj`` (d_vision, d). Weights start at zero (norm weights at
    their reference init); ``init_params`` draws them,
    ``interop.params_from_jax`` loads them."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=F32):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L._param((cfg.vocab, cfg.d_model), dev, dtype)
        self.final_norm = L.Norm(cfg, dev, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.vocab), dev, dtype)
        self.layers = nn.ModuleList()
        self.stage_of = []
        for si, stage in enumerate(cfg.stages()):
            self.layers.extend(_stage_layers(stage, cfg, dev, dtype))
            self.stage_of += [(si, r) for r in range(stage.repeat)]
        if cfg.family == "audio":
            self.encoder = _stage_layers(encoder_stage(cfg), cfg, dev, dtype)
            self.enc_norm = L.Norm(cfg, dev, dtype)
        if cfg.family == "vlm":
            self.vision_proj = L._param((cfg.d_vision, cfg.d_model), dev, dtype)


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator, param_dtype=F32,
                device=None) -> LM:
    """An LM with the reference's initialisation (``init_params``: normal
    weights scaled by fan-in, the Mamba conv by 0.1, norm weights, biases
    and the Mamba constants at their reference values; the MoE router in
    float32 whatever ``param_dtype``),
    drawn from ``generator`` in float32 and cast to ``param_dtype``. The
    generator lives on the model's device."""
    lm = LM(cfg, device, param_dtype)

    @torch.no_grad()
    def normal_(p, scale):
        draw = torch.randn(p.shape, generator=generator, dtype=F32, device=p.device)
        p.copy_(draw.mul_(scale))

    d = cfg.d_model
    hd = cfg.resolved_head_dim
    normal_(lm.embed, d**-0.5)
    if not cfg.tie_embeddings:
        normal_(lm.lm_head, d**-0.5)
    layers = list(lm.layers) + list(getattr(lm, "encoder", ()))
    for layer in layers:
        for block in layer:
            if block.kind in ("self_attn", "cross_attn"):
                for name in ("wq", "wk", "wv"):
                    normal_(getattr(block.attn, name), d**-0.5)
                normal_(block.attn.wo, (cfg.n_heads * hd) ** -0.5)
            elif block.kind == "mamba":
                normal_(block.mamba.w_in, d**-0.5)
                normal_(block.mamba.conv_w, 0.1)
                normal_(block.mamba.w_out, block.mamba.w_out.shape[0] ** -0.5)
            elif block.kind == "moe":
                for name in ("router", "w_gate", "w_up"):
                    normal_(getattr(block.moe, name), d**-0.5)
                normal_(block.moe.w_down, cfg.moe.d_ff_expert**-0.5)
            else:
                normal_(block.mlp.w_up, d**-0.5)
                normal_(block.mlp.w_down, cfg.d_ff**-0.5)
                if cfg.act in ("swiglu", "geglu"):
                    normal_(block.mlp.w_gate, d**-0.5)
    if cfg.family == "vlm":
        normal_(lm.vision_proj, cfg.d_vision**-0.5)
    return lm


# ----------------------------------------------------------------------------
# Forward passes
# ----------------------------------------------------------------------------
def _apply_block(block: Block, x, cfg: ModelConfig, runtime: Runtime, *, positions,
                 memory=None, cache=None, batch=None):
    """Returns (x + the block's output, its aux loss or None, its new cache
    or None). On a mesh ``x`` holds this rank's rows of a batch of
    ``batch``."""
    h = L.apply_norm(block.norm, x, cfg, runtime=runtime)
    aux = new_cache = None
    if block.kind == "self_attn":
        y, new_cache = L.apply_attention(block.attn, h, cfg, runtime, positions=positions,
                                         causal=block.causal, cache=cache)
    elif block.kind == "cross_attn":
        y, _ = L.apply_attention(block.attn, h, cfg, runtime, positions=positions,
                                 causal=False, memory=memory, use_rope=False)
    elif block.kind == "mlp":
        y = L.apply_mlp(block.mlp, h, cfg, runtime)
    elif block.kind == "moe":
        y, aux = MOE.apply_moe(block.moe, h, cfg, runtime, cf=cfg.moe_cf, batch=batch)
    else:
        y, new_cache = MB.apply_mamba(block.mamba, h, cfg, runtime, cache=cache)
    return x + y, aux, new_cache


def _apply_layer(layer, x, aux_total, cfg: ModelConfig, runtime: Runtime, positions, memory,
                 batch=None):
    """One stage repeat's blocks (no cache): returns (x, aux_total plus the
    MoE blocks' aux)."""
    for block in layer:
        x, aux, _ = _apply_block(block, x, cfg, runtime, positions=positions, memory=memory,
                                 batch=batch)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _remat_layer(layer, x, aux_total, cfg: ModelConfig, runtime: Runtime, positions, memory,
                 batch=None):
    """``_apply_layer`` under ``torch.utils.checkpoint``: the backward
    recomputes the layer (launching its kernels again). The recompute records
    no expert ids, and where the forward's MoE blocks replayed ids it replays
    the same ones (``moe.recomputing``), so a route is recorded or replayed
    once per forward."""
    routes, calls, replayed = [], [0], MOE.replaying()

    def run(x, aux_total, memory):
        calls[0] += 1
        if calls[0] > 1:
            with MOE.recomputing(routes if replayed else None):
                return _apply_layer(layer, x, aux_total, cfg, runtime, positions, memory,
                                    batch)
        with MOE.recording_routes() as ids:
            out = _apply_layer(layer, x, aux_total, cfg, runtime, positions, memory, batch)
        routes.extend(ids)
        return out

    return checkpoint(run, x, aux_total, memory, use_reentrant=False)


def _apply_layers(layers, x, aux_total, cfg: ModelConfig, runtime: Runtime, positions,
                  memory=None, batch=None):
    """The layers in order, each rematerialised (``_remat_layer``) where the
    config asks for it and a gradient is being recorded."""
    remat = cfg.remat_policy != "none" and torch.is_grad_enabled()
    apply = _remat_layer if remat else _apply_layer
    for layer in layers:
        x, aux_total = apply(layer, x, aux_total, cfg, runtime, positions, memory, batch)
    return x, aux_total


def _embed(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens):
    dt = runtime.compute_dtype
    if runtime.mesh is None:
        x = torch.nn.functional.embedding(tokens, lm.embed).to(dt)
    else:
        x = _embed_mesh(lm.embed, runtime, tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dt, device=x.device)
    return x


def _embed_mesh(embed, runtime: Runtime, tokens):
    """The embedding lookup on a mesh in the compute dtype, from the table's
    storage shards: with the vocabulary split over the model axis each rank
    looks up the tokens in its rows and the (one-hot) results are summed;
    with d split, the rows' blocks are gathered; with the rows split over a
    batch axis, the tokens move instead of the table (``layers.row_lookup``).
    The table's gradient scatters into the rank's rows (its block of d)."""
    c = L.model_shard_dim(embed, runtime)
    dt = runtime.compute_dtype
    if L.row_lookup_dim(embed, runtime) is not None:  # the rows split over a batch axis
        x = L.row_lookup(embed, tokens, runtime, dt)
        return L.model_all_gather(x, runtime, dim=-1) if c == 1 else x
    if c == 0:
        table = L.local_weight(embed, runtime, 0, dt)
        idx = tokens - L.model_rank(runtime) * table.shape[0]
        inside = (idx >= 0) & (idx < table.shape[0])
        x = torch.nn.functional.embedding(torch.where(inside, idx, 0), table)
        return L.model_all_reduce(torch.where(inside[..., None], x, 0), runtime)
    if c == 1:
        x = torch.nn.functional.embedding(tokens, L.local_weight(embed, runtime, 1, dt))
        return L.model_all_gather(x, runtime, dim=-1)
    return torch.nn.functional.embedding(tokens, L.local_weight(embed, runtime, dtype=dt))


def _head(lm: LM, cfg: ModelConfig, runtime: Runtime, x, batch=None):
    """Final norm and the vocabulary projection. On a mesh ``x`` holds this
    rank's rows of a batch of ``batch``, and the logits come back as a
    ``DTensor`` laid out as the reference constrains them: batch over the
    data axes, the vocabulary over the model axis (where it divides)."""
    x = L.apply_norm(lm.final_norm, x, cfg, runtime=runtime)
    dt = runtime.compute_dtype
    if runtime.mesh is not None:
        n = runtime.model_axis_size
        split = n > 1 and cfg.vocab % n == 0
        w = L.transposed(lm.embed) if cfg.tie_embeddings else lm.lm_head
        logits = L.matmul(x, w, runtime, 1, out_shard=1 if split else None)
        spec = (L.batch_axes(runtime, batch) or None, None,
                runtime.model_axis if split else None)
        return L.as_global(logits, runtime, spec, (batch, x.shape[1], cfg.vocab))
    if cfg.tie_embeddings:
        return x @ lm.embed.to(dt).T
    return x @ lm.lm_head.to(dt)


def _tokens(tokens, runtime: Runtime):
    return torch.as_tensor(tokens, device=runtime.device)


def _encode_memory(lm: LM, cfg: ModelConfig, runtime: Runtime, extra_inputs, rows=None):
    """The cross-attention source (B, S_src, d) in the compute dtype, or
    None: vlm projects ``patches``, audio runs the encoder over ``frames`` at
    positions 0..F-1. A precomputed ``memory`` (the encoder output memoised
    at admission, the serving path) short-circuits both. On a mesh, ``rows``
    (this rank's batch rows) are taken from the global inputs."""
    dt, dev = runtime.compute_dtype, runtime.device

    def given(name):
        t = torch.as_tensor(extra_inputs[name], device=dev)
        return t if rows is None else t[rows]

    if "memory" in extra_inputs:
        return given("memory").to(dt)
    if cfg.family == "vlm":
        patches = given("patches").to(dt)
        if runtime.mesh is not None:
            return L.matmul(patches, lm.vision_proj, runtime, 1)
        return torch.einsum("bpv,vd->bpd", patches, lm.vision_proj.to(dt))
    if cfg.family == "audio":
        x = given("frames").to(dt)
        pos = torch.arange(x.shape[1], device=dev)[None, :]
        batch = None if rows is None else len(extra_inputs["frames"])
        x, _ = _apply_layers(lm.encoder, x, torch.zeros((), dtype=F32, device=dev), cfg,
                             runtime, pos, batch=batch)
        return L.apply_norm(lm.enc_norm, x, cfg, runtime=runtime)
    return None


def _batch_runtime(runtime: Runtime, batch: int) -> Runtime:
    """``runtime`` with its data axes cut to those that split a batch of
    ``batch`` rows (``layers.batch_axes``): the ranks of the others hold the
    same rows, so a weight's gradient is summed over the splitting axes only
    (``layers.local_weight``). The forward is the same either way."""
    if runtime.mesh is None:
        return runtime
    axes = tuple(L.batch_axes(runtime, batch))
    if axes == tuple(runtime.data_axes):
        return runtime
    return dataclasses.replace(runtime, data_axes=axes)


def _trunk(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, extra_inputs):
    """The embedding and the layers: (the last layer's output (this rank's
    rows on a mesh), the summed aux, the global batch size)."""
    B, S = tokens.shape
    rows = None if runtime.mesh is None else L.batch_rows(runtime, B)
    x = _embed(lm, cfg, runtime, tokens if rows is None else tokens[rows])
    positions = torch.arange(S, device=x.device)[None, :]
    memory = _encode_memory(lm, cfg, runtime, extra_inputs or {}, rows)
    x, aux_total = _apply_layers(lm.layers, x, torch.zeros((), dtype=F32, device=x.device),
                                 cfg, runtime, positions, memory, B)
    return x, aux_total, B


def apply_lm(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, extra_inputs=None):
    """Full forward (train / prefill): tokens (B, S) -> logits (B, S, V), aux
    (the MoE blocks' load-balance losses summed over the layers; 0 without
    MoE). On a mesh every rank passes the same (global) inputs, computes its
    batch rows, and gets the logits as a ``DTensor`` (``_head``)."""
    tokens = _tokens(tokens, runtime)
    runtime = _batch_runtime(runtime, tokens.shape[0])
    x, aux_total, B = _trunk(lm, cfg, runtime, tokens, extra_inputs)
    return _head(lm, cfg, runtime, x, B), aux_total


# ----------------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------------
def cache_spec(name: str, shape, mesh, axes: tuple, model_n: int) -> tuple:
    """The spec of cache leaf ``name`` of global ``shape`` (the reference's
    ``launch/specs.py::cache_shardings``): batch over the data axes (where
    they divide it), the K/V caches' T, the conv state's channels and the SSM
    state's heads over 'model' (where ``model_n`` > 1 divides them)."""
    from repro_torch.launch.mesh import mesh_shape

    ms = mesh_shape(mesh)
    mdl = "model" if model_n > 1 else None
    if name in ("k", "v"):
        tsp = mdl if (mdl and shape[3] % model_n == 0) else None
        return (None, L._maybe(axes, shape[1], ms), None, tsp, None)
    if name == "conv":
        csp = mdl if (mdl and shape[3] % model_n == 0) else None
        return (None, L._maybe(axes, shape[1], ms), None, csp)
    if name == "ssm":
        hsp = mdl if (mdl and shape[2] % model_n == 0) else None
        return (None, L._maybe(axes, shape[1], ms), hsp, None, None)
    return ()


def cache_model_n(runtime: Runtime) -> int:
    """The model axis size the cache splits over: 1 where the runtime folds
    'model' into the data axes (pure data parallel)."""
    from repro_torch.launch.mesh import mesh_shape

    if "model" in runtime.data_axes:
        return 1
    return mesh_shape(runtime.mesh).get("model", 1)


def _cache_leaf(name, shape, dtype, runtime: Runtime):
    """A zero cache leaf: a tensor, or on a mesh a ``DTensor`` of the global
    ``shape`` whose local shard (only) is allocated."""
    dev = runtime.device
    if runtime.mesh is None:
        return torch.zeros(shape, dtype=dtype, device=dev)
    from repro_torch.launch.mesh import mesh_shape

    ms = mesh_shape(runtime.mesh)
    spec = cache_spec(name, shape, runtime.mesh, runtime.data_axes, cache_model_n(runtime))
    local = list(shape)
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
            local[dim] //= ms[axis]
    return L.as_global(torch.zeros(local, dtype=dtype, device=dev), runtime, spec, shape)


def init_cache(cfg: ModelConfig, runtime: Runtime, batch: int, max_len: int,
               dtype=torch.bfloat16):
    """Cache mirroring the stage structure: caches[f"stage{si}"][f"b{i}"] =
    {"k", "v": (repeat, B, KV, max_len, hd), "index": (repeat,) int32} for
    attention, {"conv": (repeat, B, K-1, Ch) in ``dtype``, "ssm": (repeat, B,
    H, P, N) float32 whatever ``dtype``} for Mamba. Cross-attention keeps no
    cache: it recomputes k/v from the memory at every step, as the
    reference does. On a mesh every leaf is a ``DTensor`` laid out by
    ``cache_spec`` (T of the K/V caches over 'model'), each rank holding its
    shard."""
    hd = cfg.resolved_head_dim
    m = cfg.mamba
    caches = {}
    for si, stage in enumerate(cfg.stages()):
        st = {}
        for i, (kind, _) in enumerate(stage.blocks):
            if kind == "self_attn":
                shape = (stage.repeat, batch, cfg.kv_heads, max_len, hd)
                st[f"b{i}"] = {
                    "k": _cache_leaf("k", shape, dtype, runtime),
                    "v": _cache_leaf("v", shape, dtype, runtime),
                    "index": _cache_leaf("index", (stage.repeat,), torch.int32, runtime),
                }
            elif kind == "mamba":
                d_in, nh = m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)
                st[f"b{i}"] = {
                    "conv": _cache_leaf("conv", (stage.repeat, batch, m.d_conv - 1,
                                                 d_in + 2 * m.d_state), dtype, runtime),
                    "ssm": _cache_leaf("ssm", (stage.repeat, batch, nh, m.head_dim, m.d_state),
                                       F32, runtime),
                }
        caches[f"stage{si}"] = st if st else None
    return caches


def _layer_cache(blk, kind: str, r: int, runtime: Runtime, index: int):
    """Repeat ``r`` of a block's cache as ``apply_attention`` / ``apply_mamba``
    take it, and a function that writes a Mamba state back where it was
    gathered. On a mesh the K/V caches stay this rank's shard (with its first
    position and the split of T); a Mamba state split over 'model' is
    gathered whole (the mixer runs whole on every rank)."""
    if kind == "self_attn":
        k = L.local_shard(blk["k"])[r]
        cache = {"k": k, "v": L.local_shard(blk["v"])[r], "index": index}
        if L._is_dtensor(blk["k"]):
            split = L.model_shard_dim(blk["k"], runtime) == 3
            cache["t_shards"] = runtime.model_axis_size if split else 1
            cache["t0"] = L.model_rank(runtime) * k.shape[2] if split else 0
        return cache, None
    cache, parts = {}, []
    for name in ("conv", "ssm"):
        local = L.local_shard(blk[name])[r]
        dim = L.model_shard_dim(blk[name], runtime) if L._is_dtensor(blk[name]) else None
        if dim is None:
            cache[name] = local
        else:
            cache[name] = L.model_all_gather(local, runtime, dim - 1)
            parts.append((name, local, dim - 1))

    def write_back():
        n, j = runtime.model_axis_size, L.model_rank(runtime)
        for name, local, dim in parts:
            local.copy_(cache[name].chunk(n, dim=dim)[j])

    return cache, write_back


def apply_decode(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, caches, index: int,
                 extra_inputs=None):
    """One decode step. tokens (B, 1); index: the step's position. Writes
    this step's k/v (attention) or conv/ssm states (Mamba) into ``caches`` in
    place and returns (logits (B, 1, V), caches) with every attention layer's
    cache index set to ``index``. Tokens (B, S) with S > 1 at ``index`` 0
    prefill the cache with positions 0..S-1 (the reference's prefill-fill
    branch, whose positions the reference's decode step does not set). On a
    mesh the inputs are global and the caches ``init_cache``'s, as in
    ``apply_lm``."""
    index = int(index)
    tokens = _tokens(tokens, runtime)
    B, S = tokens.shape
    rows = None if runtime.mesh is None else L.batch_rows(runtime, B)
    x = _embed(lm, cfg, runtime, tokens if rows is None else tokens[rows])
    positions = (index + torch.arange(S, device=x.device))[None, :]
    memory = _encode_memory(lm, cfg, runtime, extra_inputs or {}, rows)
    for layer, (si, r) in zip(lm.layers, lm.stage_of):
        st = caches.get(f"stage{si}")
        for i, block in enumerate(layer):
            cache = write_back = None
            if block.kind in ("self_attn", "mamba"):
                cache, write_back = _layer_cache(st[f"b{i}"], block.kind, r, runtime, index)
            x, _, _ = _apply_block(block, x, cfg, runtime, positions=positions, memory=memory,
                                   cache=cache, batch=B)
            if write_back is not None:
                write_back()
    for st in caches.values():
        for blk in (st or {}).values():
            if "index" in blk:  # attention caches only; a Mamba cache has no index
                L.local_shard(blk["index"]).fill_(index)
    return _head(lm, cfg, runtime, x, B), caches


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------
def lm_loss(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, labels, extra_inputs=None,
            aux_coeff: float = 0.01):
    """Mean next-token negative log-likelihood of ``labels`` (B, S) under the
    float32 logits (logsumexp minus the gold logit), plus ``aux_coeff`` times
    the MoE aux. Returns (loss, {"nll", "aux"}). On a mesh every rank passes
    the global inputs and gets the whole loss: the cross-entropy of its rows
    over the vocabulary split on the model axis (``_vocab_parallel_nll``),
    then the mean over the batch shards; no rank holds the whole logits."""
    tokens = _tokens(tokens, runtime)
    B = tokens.shape[0]
    runtime = _batch_runtime(runtime, B)
    x, aux, _ = _trunk(lm, cfg, runtime, tokens, extra_inputs)
    labels = torch.as_tensor(labels, device=runtime.device).long()[L.batch_rows(runtime, B)]
    nll = L.batch_mean(_vocab_parallel_nll(lm, cfg, runtime, x, labels), runtime, B)
    return nll + aux_coeff * aux, {"nll": nll, "aux": aux}


def _vocab_parallel_nll(lm: LM, cfg: ModelConfig, runtime: Runtime, x, labels):
    """The mean negative log-likelihood of this rank's rows ``x`` (the last
    layer's output; all rows off a mesh) with their ``labels``. Where the
    vocabulary splits over the model axis, each rank projects onto its block
    of the head: the row maxima and the sums of exp are reduced over the axis
    (the maxima as constants), and the gold logit comes from the rank whose
    block holds the label."""
    x = L.apply_norm(lm.final_norm, x, cfg, runtime=runtime)
    dt, n = runtime.compute_dtype, runtime.model_axis_size
    split = n > 1 and cfg.vocab % n == 0
    if split:
        x = L.enter_split(x, runtime)
    if cfg.tie_embeddings:
        logits = x @ L.local_weight(lm.embed, runtime, 0 if split else None, dt).T
    else:
        logits = x @ L.local_weight(lm.lm_head, runtime, 1 if split else None, dt)
    logits = logits.to(F32)
    if not split:
        lse = torch.logsumexp(logits, dim=-1)
        return torch.mean(lse - torch.gather(logits, -1, labels[..., None])[..., 0])
    m = L.model_all_reduce(logits.detach().amax(dim=-1), runtime, dist.ReduceOp.MAX)
    lse = m + torch.log(L.model_all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1),
                                           runtime))
    v_loc = logits.shape[-1]
    idx = labels - L.model_rank(runtime) * v_loc
    inside = (idx >= 0) & (idx < v_loc)
    gold = torch.gather(logits, -1, torch.where(inside, idx, 0)[..., None])[..., 0]
    gold = L.model_all_reduce(torch.where(inside, gold, 0.0), runtime)
    return torch.mean(lse - gold)
