"""The language model of the reference's model substrate
(``repro/models/model.py``), in PyTorch: the dense and ssm (Mamba2)
families.

Entry points, as in the reference:
  init_params(cfg, generator, dtype, device)   -> LM with random weights
  apply_lm(lm, cfg, runtime, tokens)            -> logits (prefill forward), aux
  init_cache(cfg, runtime, batch, max_len)      -> decode cache
  apply_decode(lm, cfg, runtime, tokens, cache, index) -> logits, cache

The reference scans each stage over its repeat count; here every repeat is
one entry of ``LM.layers`` (an ``nn.ModuleList`` of its blocks), and the
decode cache keeps the reference's per-stage layout with a leading repeat
axis, updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models.layers import Runtime

F32 = torch.float32
PORTED_BLOCKS = ("self_attn", "mlp", "mamba")
# what is still to port, by the ROADMAP item that ports it
REMAINING = "ROADMAP Queue 1, 'Model substrate: remaining blocks'"
NOT_PORTED = {
    "moe": f"the MoE block ({REMAINING})",
    "cross_attn": f"cross-attention ({REMAINING})",
}


def _check_ported(cfg: ModelConfig):
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet ({REMAINING})")
    for stage in cfg.stages():
        for kind, _ in stage.blocks:
            if kind not in PORTED_BLOCKS:
                raise NotImplementedError(f"{cfg.name}: {NOT_PORTED[kind]} is not ported yet")


class Block(nn.Module):
    """One pre-norm residual block: ``norm`` and one of ``attn`` / ``mlp`` /
    ``mamba``."""

    def __init__(self, kind: str, opts: dict, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.kind = kind
        self.causal = opts.get("causal", True)
        self.norm = L.Norm(cfg, device, dtype)
        if kind == "self_attn":
            self.attn = L.Attention(cfg, device, dtype)
        elif kind == "mamba":
            self.mamba = MB.Mamba(cfg, device, dtype)
        else:
            self.mlp = L.MLP(cfg, device, dtype)


class LM(nn.Module):
    """Dense- and ssm-family parameters: ``embed`` (V, d), ``final_norm``, ``lm_head``
    (d, V) unless tied, and ``layers[i]`` = the blocks of one stage repeat.
    ``stage_of[i]`` is (stage index, repeat index) of layer i. Weights start
    at zero (norm weights at their reference init); ``init_params`` draws
    them, ``interop.params_from_jax`` loads them."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=F32):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L._param((cfg.vocab, cfg.d_model), dev, dtype)
        self.final_norm = L.Norm(cfg, dev, dtype)
        if not cfg.tie_embeddings:
            self.lm_head = L._param((cfg.d_model, cfg.vocab), dev, dtype)
        self.layers = nn.ModuleList()
        self.stage_of = []
        for si, stage in enumerate(cfg.stages()):
            for r in range(stage.repeat):
                self.layers.append(nn.ModuleList(
                    Block(kind, opts, cfg, dev, dtype) for kind, opts in stage.blocks))
                self.stage_of.append((si, r))


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator, param_dtype=F32,
                device=None) -> LM:
    """An LM with the reference's initialisation (``init_params``: normal
    weights scaled by fan-in, the Mamba conv by 0.1, norm weights, biases
    and the Mamba constants at their reference values),
    drawn from ``generator`` in float32 and cast to ``param_dtype``. The
    generator lives on the model's device."""
    lm = LM(cfg, device, param_dtype)

    def normal_(p, scale):
        draw = torch.randn(p.shape, generator=generator, dtype=F32, device=p.device)
        p.copy_(draw.mul_(scale))

    d = cfg.d_model
    hd = cfg.resolved_head_dim
    normal_(lm.embed, d**-0.5)
    if not cfg.tie_embeddings:
        normal_(lm.lm_head, d**-0.5)
    for layer in lm.layers:
        for block in layer:
            if block.kind == "self_attn":
                for name in ("wq", "wk", "wv"):
                    normal_(getattr(block.attn, name), d**-0.5)
                normal_(block.attn.wo, (cfg.n_heads * hd) ** -0.5)
            elif block.kind == "mamba":
                normal_(block.mamba.w_in, d**-0.5)
                normal_(block.mamba.conv_w, 0.1)
                normal_(block.mamba.w_out, block.mamba.w_out.shape[0] ** -0.5)
            else:
                normal_(block.mlp.w_up, d**-0.5)
                normal_(block.mlp.w_down, cfg.d_ff**-0.5)
                if cfg.act in ("swiglu", "geglu"):
                    normal_(block.mlp.w_gate, d**-0.5)
    return lm


# ----------------------------------------------------------------------------
# Forward passes
# ----------------------------------------------------------------------------
def _apply_block(block: Block, x, cfg: ModelConfig, runtime: Runtime, *, positions,
                 cache=None):
    h = L.apply_norm(block.norm, x, cfg)
    new_cache = None
    if block.kind == "self_attn":
        y, new_cache = L.apply_attention(block.attn, h, cfg, runtime, positions=positions,
                                         causal=block.causal, cache=cache)
    elif block.kind == "mamba":
        y, new_cache = MB.apply_mamba(block.mamba, h, cfg, runtime, cache=cache)
    else:
        y = L.apply_mlp(block.mlp, h, cfg, runtime)
    return x + y, new_cache


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


def _no_extra(extra_inputs):
    if extra_inputs:
        raise NotImplementedError(
            f"extra inputs {sorted(extra_inputs)} need the vlm/audio families ({REMAINING})")


def apply_lm(lm: LM, cfg: ModelConfig, runtime: Runtime, tokens, extra_inputs=None):
    """Full forward (prefill): tokens (B, S) -> logits (B, S, V), aux (0 for
    the dense and ssm families)."""
    _no_extra(extra_inputs)
    tokens = _tokens(tokens, runtime)
    S = tokens.shape[1]
    x = _embed(lm, cfg, runtime, tokens)
    positions = torch.arange(S, device=x.device)[None, :]
    for layer in lm.layers:
        for block in layer:
            x, _ = _apply_block(block, x, cfg, runtime, positions=positions)
    return _head(lm, cfg, runtime, x), torch.zeros((), dtype=F32, device=x.device)


# ----------------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, runtime: Runtime, batch: int, max_len: int,
               dtype=torch.bfloat16):
    """Cache mirroring the stage structure: caches[f"stage{si}"][f"b{i}"] =
    {"k", "v": (repeat, B, KV, max_len, hd), "index": (repeat,) int32} for
    attention, {"conv": (repeat, B, K-1, Ch) in ``dtype``, "ssm": (repeat, B,
    H, P, N) float32 whatever ``dtype``} for Mamba."""
    _check_ported(cfg)
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
    _no_extra(extra_inputs)
    index = int(index)
    tokens = _tokens(tokens, runtime)
    x = _embed(lm, cfg, runtime, tokens)
    positions = torch.full((1, 1), index, device=x.device)
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
            x, _ = _apply_block(block, x, cfg, runtime, positions=positions, cache=cache)
    for st in caches.values():
        for blk in (st or {}).values():
            if "index" in blk:  # attention caches only; a Mamba cache has no index
                blk["index"].fill_(index)
    return _head(lm, cfg, runtime, x), caches
