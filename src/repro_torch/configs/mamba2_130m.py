"""mamba2-130m — [ssm] 24L d_model=768 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import MambaSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,  # SSD heads = d_inner/head_dim = 1536/64
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    mamba=MambaSpec(d_state=128, d_conv=4, expand=2, head_dim=64),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    microbatches=1,
    # 130M params / 24 SSD heads cannot use a 16-way tensor axis: run pure DP
    # over all 256 chips (the 'model' axis joins the batch axes).
    pure_dp=True,
)
