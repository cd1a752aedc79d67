"""llama4-scout-17b-a16e — [moe] 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    kv_heads=8,
    d_ff=8192,
    vocab=202048,
    moe=MoESpec(n_experts=16, top_k=1, d_ff_expert=8192),
    moe_every=1,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    attn_shard="sequence",  # 40 heads don't split 16-way
    microbatches=2,
)
