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

import torch
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
                 memory=None, cache=None):
    """Returns (x + the block's output, its aux loss or None, its new cache
    or None)."""
    h = L.apply_norm(block.norm, x, cfg)
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
        y, aux = MOE.apply_moe(block.moe, h, cfg, runtime, cf=cfg.moe_cf)
    else:
        y, new_cache = MB.apply_mamba(block.mamba, h, cfg, runtime, cache=cache)
    return x + y, aux, new_cache


def _apply_layer(layer, x, aux_total, cfg: ModelConfig, runtime: Runtime, positions, memory):
    """One stage repeat's blocks (no cache): returns (x, aux_total plus the
    MoE blocks' aux)."""
    for block in layer:
        x, aux, _ = _apply_block(block, x, cfg, runtime, positions=positions, memory=memory)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def _remat_layer(layer, x, aux_total, cfg: ModelConfig, runtime: Runtime, positions, memory):
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
                return _apply_layer(layer, x, aux_total, cfg, runtime, positions, memory)
        with MOE.recording_routes() as ids:
            out = _apply_layer(layer, x, aux_total, cfg, runtime, positions, memory)
        routes.extend(ids)
        return out

    return checkpoint(run, x, aux_total, memory, use_reentrant=False)


def _apply_layers(layers, x, aux_total, cfg: ModelConfig, runtime: Runtime, positions,
                  memory=None):
    """The layers in order, each rematerialised (``_remat_layer``) where the
    config asks for it and a gradient is being recorded."""
    remat = cfg.remat_policy != "none" and torch.is_grad_enabled()
    apply = _remat_layer if remat else _apply_layer
    for layer in layers:
        x, aux_total = apply(layer, x, aux_total, cfg, runtime, positions, memory)
    return x, aux_total


def _embed(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens):
    dt = runtime.compute_dtype
    x = torch.nn.functional.embedding(tokens, lm.embed).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dt, device=x.device)
    return x


def _head(lm: LM, cfg: ModelConfig, runtime: Runtime, x):
    x = L.apply_norm(lm.final_norm, x, cfg)
    dt = runtime.compute_dtype
    if cfg.tie_embeddings:
        return x @ lm.embed.to(dt).T
    return x @ lm.lm_head.to(dt)


def _tokens(tokens, runtime: Runtime):
    return torch.as_tensor(tokens, device=runtime.device)


def _encode_memory(lm: LM, cfg: ModelConfig, runtime: Runtime, extra_inputs):
    """The cross-attention source (B, S_src, d) in the compute dtype, or
    None: vlm projects ``patches``, audio runs the encoder over ``frames`` at
    positions 0..F-1. A precomputed ``memory`` (the encoder output memoised
    at admission, the serving path) short-circuits both."""
    dt, dev = runtime.compute_dtype, runtime.device
    if "memory" in extra_inputs:
        return torch.as_tensor(extra_inputs["memory"], device=dev).to(dt)
    if cfg.family == "vlm":
        patches = torch.as_tensor(extra_inputs["patches"], device=dev).to(dt)
        return torch.einsum("bpv,vd->bpd", patches, lm.vision_proj.to(dt))
    if cfg.family == "audio":
        x = torch.as_tensor(extra_inputs["frames"], device=dev).to(dt)
        pos = torch.arange(x.shape[1], device=dev)[None, :]
        x, _ = _apply_layers(lm.encoder, x, torch.zeros((), dtype=F32, device=dev), cfg,
                             runtime, pos)
        return L.apply_norm(lm.enc_norm, x, cfg)
    return None


def apply_lm(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, extra_inputs=None):
    """Full forward (train / prefill): tokens (B, S) -> logits (B, S, V), aux
    (the MoE blocks' load-balance losses summed over the layers; 0 without
    MoE)."""
    tokens = _tokens(tokens, runtime)
    S = tokens.shape[1]
    x = _embed(lm, cfg, runtime, tokens)
    positions = torch.arange(S, device=x.device)[None, :]
    memory = _encode_memory(lm, cfg, runtime, extra_inputs or {})
    x, aux_total = _apply_layers(lm.layers, x, torch.zeros((), dtype=F32, device=x.device),
                                 cfg, runtime, positions, memory)
    return _head(lm, cfg, runtime, x), aux_total


# ----------------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, runtime: Runtime, batch: int, max_len: int,
               dtype=torch.bfloat16):
    """Cache mirroring the stage structure: caches[f"stage{si}"][f"b{i}"] =
    {"k", "v": (repeat, B, KV, max_len, hd), "index": (repeat,) int32} for
    attention, {"conv": (repeat, B, K-1, Ch) in ``dtype``, "ssm": (repeat, B,
    H, P, N) float32 whatever ``dtype``} for Mamba. Cross-attention keeps no
    cache: it recomputes k/v from the memory at every step, as the
    reference does."""
    hd = cfg.resolved_head_dim
    dev = runtime.device
    m = cfg.mamba
    caches = {}
    for si, stage in enumerate(cfg.stages()):
        st = {}
        for i, (kind, _) in enumerate(stage.blocks):
            if kind == "self_attn":
                shape = (stage.repeat, batch, cfg.kv_heads, max_len, hd)
                st[f"b{i}"] = {
                    "k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev),
                    "index": torch.zeros((stage.repeat,), dtype=torch.int32, device=dev),
                }
            elif kind == "mamba":
                d_in, nh = m.d_inner(cfg.d_model), m.n_heads(cfg.d_model)
                st[f"b{i}"] = {
                    "conv": torch.zeros((stage.repeat, batch, m.d_conv - 1, d_in + 2 * m.d_state),
                                        dtype=dtype, device=dev),
                    "ssm": torch.zeros((stage.repeat, batch, nh, m.head_dim, m.d_state),
                                       dtype=F32, device=dev),
                }
        caches[f"stage{si}"] = st if st else None
    return caches


def apply_decode(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, caches, index: int,
                 extra_inputs=None):
    """One decode step. tokens (B, 1); index: the step's position. Writes
    this step's k/v (attention) or conv/ssm states (Mamba) into ``caches`` in
    place and returns (logits (B, 1, V), caches) with every attention layer's
    cache index set to ``index``."""
    index = int(index)
    tokens = _tokens(tokens, runtime)
    x = _embed(lm, cfg, runtime, tokens)
    positions = torch.full((1, 1), index, device=x.device)
    memory = _encode_memory(lm, cfg, runtime, extra_inputs or {})
    for layer, (si, r) in zip(lm.layers, lm.stage_of):
        st = caches.get(f"stage{si}")
        for i, block in enumerate(layer):
            cache = None
            if block.kind == "self_attn":
                blk = st[f"b{i}"]
                cache = {"k": blk["k"][r], "v": blk["v"][r], "index": index}
            elif block.kind == "mamba":
                blk = st[f"b{i}"]
                cache = {"conv": blk["conv"][r], "ssm": blk["ssm"][r]}
            x, _, _ = _apply_block(block, x, cfg, runtime, positions=positions, memory=memory,
                                   cache=cache)
    for st in caches.values():
        for blk in (st or {}).values():
            if "index" in blk:  # attention caches only; a Mamba cache has no index
                blk["index"].fill_(index)
    return _head(lm, cfg, runtime, x), caches


# ----------------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------------
def lm_loss(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, labels, extra_inputs=None,
            aux_coeff: float = 0.01):
    """Mean next-token negative log-likelihood of ``labels`` (B, S) under the
    float32 logits (logsumexp minus the gold logit), plus ``aux_coeff`` times
    the MoE aux. Returns (loss, {"nll", "aux"})."""
    logits, aux = apply_lm(lm, cfg, runtime, tokens, extra_inputs)
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, dim=-1)
    labels = torch.as_tensor(labels, device=logits.device).long()
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = torch.mean(lse - gold)
    return nll + aux_coeff * aux, {"nll": nll, "aux": aux}
