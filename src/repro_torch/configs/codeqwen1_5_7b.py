"""codeqwen1.5-7b — [dense] 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=32,
    d_ff=13440,
    vocab=92416,
    act="swiglu",
    norm="rmsnorm",
    qkv_bias=True,  # qwen1.5 attention bias
    rope_theta=1_000_000.0,
    microbatches=2,
)
