"""gemma-2b — [dense] 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, MQA on 2b [arXiv:2403.08295; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    kv_heads=1,  # MQA
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="geglu",
    norm="rmsnorm",
    norm_plus_one=True,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    attn_shard="sequence",  # 8 heads don't split over a 16-way model axis
    microbatches=4,  # 256k-vocab logits dominate activation memory
)
