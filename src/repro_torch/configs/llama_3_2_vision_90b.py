"""llama-3.2-vision-90b — [vlm] 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision;
unverified].

Every 5th block is a cross-attention block over precomputed image patch
embeddings (n_patches=1601, d_vision=1280); the vision frontend is a STUB per
the assignment (input_specs supplies the embeddings).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=500_000.0,
    n_patches=1601,
    d_vision=1280,
    microbatches=8,
)
