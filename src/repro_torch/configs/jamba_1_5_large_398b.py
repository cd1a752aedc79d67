"""jamba-1.5-large-398b — [hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

Layout (DESIGN.md §4): 9 scan groups of 8 blocks; block 7 of each group is
attention, blocks 0-6 are Mamba; the MLP of even-indexed blocks is MoE
(16e top-2), odd-indexed blocks use a dense d_ff MLP.
"""
from repro_torch.configs.base import MambaSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=24576,
    vocab=65536,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576),
    moe_every=2,
    mamba=MambaSpec(d_state=128, d_conv=4, expand=2, head_dim=64),
    attn_every=8,  # 1:7 attention:mamba
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    microbatches=8,
)
