"""Analytic minimum HBM-traffic model (per device, per step), copied from
the reference (``repro/launch/traffic.py``; pure Python, equal bit for bit).

Why this exists: `compiled.cost_analysis()['bytes accessed']` on the CPU
backend counts every elementwise intermediate as materialized; a TPU compile
fuses those chains, so the XLA number overstates HBM traffic by ~an order of
magnitude (verified on mamba2: ~9.8 GB/layer reported vs ~1 GB/layer real).
The roofline's memory term therefore uses this documented lower-bound model;
the XLA figure is reported alongside as `hlo_bytes_upper` (the truth on real
hardware lies between, much closer to this model).

Traffic accounting (per device, per step):

train (f32 master params, FSDP over 'data', remat'd backward):
  params  : 2 x P_used x 4  — every device materializes gathered weights in
            fwd and again in the remat'd bwd (P_used = total params for dense;
            MoE experts count only cf*top_k/E of expert weights)
  grads   : P_total x 4 / data_n  — reduce-scattered shard written + read
  optimizer: 6 x P_total x 4 / chips — read m,v,param shard; write all three
  activations: blocks x tokens_loc x d x 2 x C_act (C_act = 12: residual +
            qkv/mlp intermediates, fwd + bwd with remat recompute)
  logits  : tokens_loc x V/model_n x (2 + 4 + 4) — bf16 logits, f32 lse+grad
  embed   : 2 x tokens_loc x d x 4

prefill (bf16 params):
  params  : P_used x 2 (gathered once), activations C_act = 6 (no bwd),
  logits  : tokens_loc x V/model_n x 2, KV write: kv_bytes/(data*model)

decode (bf16 params, KV batch over data / seq over model):
  params  : P_used x 2 — full weights stream through every device each step
  kv      : local KV shard read + this step's write
  logits  : batch_loc x V/model_n x 2
"""
from __future__ import annotations

import math

from repro_torch.configs.base import SHAPES, ModelConfig


def _mesh_factors(cfg: ModelConfig, mesh_shape: dict) -> tuple[int, int, int]:
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    model_n = 1 if cfg.pure_dp else mesh_shape.get("model", 1)
    data_n = chips // model_n
    return chips, data_n, model_n


def _params_used(cfg: ModelConfig) -> float:
    """Params actually touched per step: dense params + dispatched expert rows
    (capacity-bounded: min(E, cf*top_k) of E experts' weights)."""
    total = cfg.total_params()
    if cfg.moe is None:
        return float(total)
    active_frac = min(cfg.moe.top_k * cfg.moe_cf, cfg.moe.n_experts) / cfg.moe.n_experts
    expert_per_block = cfg.moe.n_experts * 3 * cfg.d_model * cfg.moe.d_ff_expert
    n_moe = sum(
        sum(1 for k, _ in st.blocks if k == "moe") * st.repeat for st in cfg.stages()
    )
    return float(total - n_moe * expert_per_block * (1.0 - active_frac))


def _n_blocks(cfg: ModelConfig) -> int:
    n = sum(len(st.blocks) * st.repeat for st in cfg.stages())
    if cfg.family == "audio":
        n += 2 * cfg.enc_layers
    return n


def min_traffic_bytes(cfg: ModelConfig, shape_name: str, mesh_shape: dict,
                      serve_bytes: float = 2.0, decode_model_only: bool = False) -> float:
    seq, gbs, kind = SHAPES[shape_name]
    chips, data_n, model_n = _mesh_factors(cfg, mesh_shape)
    d = cfg.d_model
    V = cfg.vocab
    P_total = float(cfg.total_params())
    P_used = _params_used(cfg)
    blocks = _n_blocks(cfg)

    if kind == "train":
        tokens_loc = gbs * seq / data_n
        params = 2.0 * P_used * 4.0
        grads = P_total * 4.0 / data_n
        opt = 6.0 * P_total * 4.0 / chips
        acts = blocks * tokens_loc * d * 2.0 * 12.0
        logits = tokens_loc * (V / model_n) * (2.0 + 4.0 + 4.0)
        embed = 2.0 * tokens_loc * d * 4.0
        return params + grads + opt + acts + logits + embed

    if kind == "prefill":
        tokens_loc = gbs * seq / data_n
        params = P_used * serve_bytes
        acts = blocks * tokens_loc * d * 2.0 * 6.0
        logits = tokens_loc * (V / model_n) * 2.0
        kv_write = cfg.kv_bytes_per_seq(seq) * gbs / chips
        return params + acts + logits + kv_write

    # decode: with the model-only (row-parallel) serving layout each device
    # reads only ITS weight shard per step; the 2d/FSDP layout streams the
    # gathered full weights through every device.
    batch_loc = gbs / data_n if gbs % data_n == 0 else gbs
    params = P_used * serve_bytes / (model_n if decode_model_only else 1.0)
    kv_read = cfg.kv_bytes_per_seq(seq) * gbs / chips
    logits = batch_loc * (V / model_n) * 2.0
    acts = blocks * batch_loc * d * 2.0 * 6.0
    return params + kv_read + logits + acts
