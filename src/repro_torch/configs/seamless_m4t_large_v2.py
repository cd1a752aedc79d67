"""seamless-m4t-large-v2 — [audio] 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Encoder-decoder: 24 decoder blocks (self + cross + MLP) over a 24-layer
encoder consuming precomputed audio frame embeddings (frontend STUB;
frames = seq_len // enc_frames_ratio). Decode shapes exercise the decoder
with a memoized encoder output.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=8192,
    vocab=256206,
    enc_layers=24,
    enc_frames_ratio=4,
    act="relu",
    norm="layernorm",
    rope_theta=10_000.0,
    microbatches=4,  # 256k-vocab logits
)
