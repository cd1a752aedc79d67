"""minitron-4b — [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    kv_heads=8,
    d_ff=9216,
    vocab=256000,
    act="relu",  # nemotron uses squared-relu; relu family here
    norm="layernorm",
    rope_theta=10_000.0,
    attn_shard="sequence",  # 24 heads don't split 16-way
    microbatches=4,  # 256k-vocab logits dominate activation memory
)
