"""moonshot-v1-16b-a3b — [moe] 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6 — kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.configs.base import ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    d_ff=1408,
    vocab=163840,
    moe=MoESpec(n_experts=64, top_k=6, d_ff_expert=1408),
    moe_every=1,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    microbatches=2,
)
