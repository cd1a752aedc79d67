"""Architecture config schema.

One `ModelConfig` per assigned architecture (exact dims from the assignment
table) plus reduced variants for CPU smoke tests. The config is the single
source of truth for parameter counting, KV/state-cache sizing, input specs and
stage layout (the scan-over-layers grouping described in DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

BlockKind = Literal["self_attn", "cross_attn", "mlp", "moe", "mamba"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class Stage:
    """A homogeneous scan group: `blocks` python-unrolled inside the scan body,
    repeated `repeat` times via jax.lax.scan."""

    blocks: tuple  # tuple[tuple[BlockKind, dict], ...]
    repeat: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    moe: MoESpec | None = None
    moe_every: int = 1  # a MoE MLP every k-th block (1 = all blocks)
    mamba: MambaSpec | None = None
    attn_every: int = 1  # hybrid: one attention block per `attn_every` blocks
    cross_attn_every: int = 0  # vlm: every k-th block is cross-attention
    act: Literal["swiglu", "geglu", "relu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_plus_one: bool = False  # gemma-style (1 + w) RMSNorm weight
    qkv_bias: bool = False  # qwen-family attention bias
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    rope_theta: float = 10_000.0
    # encoder-decoder (audio family)
    enc_layers: int = 0
    enc_frames_ratio: int = 4  # encoder frames = seq_len // ratio (frontend stub)
    # vlm frontend stub
    n_patches: int = 1601
    d_vision: int = 1280
    # distribution / training knobs (overridable per run)
    remat_policy: str = "dots"
    microbatches: int = 1
    attn_shard: Literal["heads", "sequence", "auto"] = "auto"
    moe_cf: float = 1.25  # expert capacity factor (tests use E/top_k = dropless)
    pure_dp: bool = False  # tiny models: fold 'model' into the batch axes (pure DP)
    # Megatron-style sequence parallelism for the residual stream: the scan
    # carry (B,S,d) is sharded over 'model' on S, cutting the per-layer remat
    # residual 16x (GSPMD inserts the all-gather/reduce-scatter pairs around
    # the TP matmuls). Off automatically for decode (S=1) and pure_dp.
    seq_shard_activations: bool = True

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def attn_shard_mode(self, model_axis: int = 16) -> str:
        """'heads' TP needs a shardable head axis in the grouped (KV, G) layout;
        otherwise fall back to sequence-parallel attention (DESIGN.md §5)."""
        if self.attn_shard != "auto":
            return self.attn_shard
        if model_axis <= 1:
            return "heads"
        g = self.n_heads // max(self.kv_heads, 1)
        if self.kv_heads % model_axis == 0 or g % model_axis == 0:
            return "heads"
        return "sequence"

    # ------------------------------------------------------------------
    # Stage layout (scan grouping)
    # ------------------------------------------------------------------
    def stages(self) -> list[Stage]:
        hd = self.resolved_head_dim
        attn = ("self_attn", {})
        mlp_kind = lambda i: (
            ("moe", {}) if (self.moe is not None and i % self.moe_every == 0) else ("mlp", {})
        )
        if self.family == "ssm":
            return [Stage(blocks=(("mamba", {}),), repeat=self.n_layers)]
        if self.family == "hybrid":
            # jamba grouping: `attn_every` blocks per group, last one attention,
            # MoE on even block indices within the group
            group = []
            for b in range(self.attn_every):
                mixer = attn if b == self.attn_every - 1 else ("mamba", {})
                group.append(mixer)
                group.append(mlp_kind(b))
            return [Stage(blocks=tuple(group), repeat=self.n_layers // self.attn_every)]
        if self.family == "vlm":
            k = self.cross_attn_every
            group = []
            for b in range(k):
                mixer = ("cross_attn", {}) if b == k - 1 else attn
                group.append(mixer)
                group.append(("mlp", {}))
            return [Stage(blocks=tuple(group), repeat=self.n_layers // k)]
        if self.family == "audio":
            # decoder stages only — encoder handled separately in the model
            group = (attn, ("cross_attn", {}), ("mlp", {}))
            return [Stage(blocks=group, repeat=self.n_layers)]
        # dense / moe
        if self.moe is not None and self.moe_every > 1:
            group = []
            for b in range(self.moe_every):
                group.append(attn)
                group.append(mlp_kind(b))
            return [Stage(blocks=tuple(group), repeat=self.n_layers // self.moe_every)]
        return [Stage(blocks=(attn, mlp_kind(0)), repeat=self.n_layers)]

    # ------------------------------------------------------------------
    # Parameter counting (analytic; validated against realized trees in tests)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        qkv = self.d_model * hd * (self.n_heads + 2 * self.kv_heads)
        out = self.n_heads * hd * self.d_model
        bias = hd * (self.n_heads + 2 * self.kv_heads) if self.qkv_bias else 0
        return qkv + out + bias

    def _mlp_params(self, d_ff: int) -> int:
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _moe_params(self) -> int:
        assert self.moe is not None
        return self.d_model * self.moe.n_experts + self.moe.n_experts * self._mlp_params(
            self.moe.d_ff_expert
        ) // 1

    def _mamba_params(self) -> int:
        m = self.mamba or MambaSpec()
        d_in = m.d_inner(self.d_model)
        nh = m.n_heads(self.d_model)
        in_proj = self.d_model * (2 * d_in + 2 * m.d_state + nh)
        conv = m.d_conv * (d_in + 2 * m.d_state)
        out_proj = d_in * self.d_model
        extras = nh * 2 + d_in  # A_log, D, gated-norm weight
        return in_proj + conv + out_proj + extras

    def _block_params(self, kind: BlockKind) -> int:
        norms = self.d_model  # one pre-norm per block
        if kind == "self_attn" or kind == "cross_attn":
            return self._attn_params() + norms
        if kind == "mlp":
            return self._mlp_params(self.d_ff) + norms
        if kind == "moe":
            return self._moe_params() + norms
        if kind == "mamba":
            return self._mamba_params() + norms
        raise ValueError(kind)

    def total_params(self) -> int:
        total = self.vocab * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab * self.d_model  # lm head
        total += self.d_model  # final norm
        for st in self.stages():
            per = sum(self._block_params(k) for k, _ in st.blocks)
            total += per * st.repeat
        if self.family == "audio":  # encoder
            enc_block = self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model
            total += enc_block * self.enc_layers + self.d_model
        if self.family == "vlm":  # vision projection (frontend itself is a stub)
            total += self.d_vision * self.d_model
        return int(total)

    def active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.total_params()
        total = self.total_params()
        expert_all = self.moe.n_experts * self._mlp_params(self.moe.d_ff_expert)
        expert_active = self.moe.top_k * self._mlp_params(self.moe.d_ff_expert)
        n_moe_blocks = sum(
            sum(1 for k, _ in st.blocks if k == "moe") * st.repeat for st in self.stages()
        )
        return int(total - n_moe_blocks * (expert_all - expert_active))

    # ------------------------------------------------------------------
    # Cache sizing (roofline + fleet binding)
    # ------------------------------------------------------------------
    def kv_bytes_per_seq(self, seq_len: int, dtype_bytes: int = 2) -> int:
        hd = self.resolved_head_dim
        n_attn = n_cross = n_mamba = 0
        for st in self.stages():
            for k, _ in st.blocks:
                if k == "self_attn":
                    n_attn += st.repeat
                elif k == "cross_attn":
                    n_cross += st.repeat
                elif k == "mamba":
                    n_mamba += st.repeat
        kv = n_attn * 2 * self.kv_heads * hd * seq_len * dtype_bytes
        # cross-attn KV is over the (fixed) source length, not seq_len
        src = self.n_patches if self.family == "vlm" else seq_len // self.enc_frames_ratio
        kv += n_cross * 2 * self.kv_heads * hd * min(src, seq_len) * dtype_bytes
        if n_mamba:
            m = self.mamba or MambaSpec()
            state = m.n_heads(self.d_model) * m.head_dim * m.d_state
            conv = (m.d_inner(self.d_model) + 2 * m.d_state) * m.d_conv
            kv += n_mamba * (state + conv) * 4  # f32 state
        return int(kv)

    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic (SSM/hybrid) archs — DESIGN.md §4."""
        return self.family in ("ssm", "hybrid")

    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode path (seamless is enc-dec)

    # ------------------------------------------------------------------
    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 2 * max(self.attn_every, self.cross_attn_every, self.moe_every, 1)),
            d_model=128,
            n_heads=4,
            kv_heads=min(self.kv_heads, 2) if self.kv_heads > 1 else 1,
            head_dim=32,
            d_ff=256,
            vocab=512,
            enc_layers=min(self.enc_layers, 2),
            n_patches=16,
            d_vision=64,
        )
        if self.moe is not None:
            moe = MoESpec(
                n_experts=min(self.moe.n_experts, 8), top_k=min(self.moe.top_k, 2), d_ff_expert=128
            )
            changes["moe"] = moe
            changes["moe_cf"] = float(moe.n_experts / moe.top_k)  # dropless for oracles
        if self.mamba is not None:
            changes["mamba"] = MambaSpec(d_state=16, d_conv=4, expand=2, head_dim=16)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


# Shape cells (assignment table): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and not cfg.supports_long_context():
        return False, "SKIP(full-attention)"
    return True, ""
