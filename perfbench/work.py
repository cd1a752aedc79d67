"""The yardstick's arithmetic: the H100's published peaks, and the work that
the benchmark counts for a model and for a kernel's call, from the
configuration and the shapes alone.

Nothing here reads what the program executes: a later change that drops
wasted work leaves these counts as they are. Model FLOPs count the products
a token needs (2 per multiply-add), causal attention and the SSD's masked
products over the entries at or below the diagonal only, and the head at the
positions whose logits are used. A roofline's least time is the larger of
the operations over the peak and the bytes over the memory bandwidth, each
input read once and each output written once.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense (no sparsity), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
# float32 products on the tensor cores: three TF32 products a float32 product
# (495 TFLOP/s TF32 / 3), the route a float32-accurate product can take.
PEAK_F32_PRODUCT_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12


def least_time(flops: float, nbytes: float, peak_flops: float) -> float:
    """Seconds a call needs at the least: operations or bytes, whichever bounds."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_PER_S)


def causal_pairs(n: int) -> int:
    """(query, key) pairs at or below the diagonal of an n x n causal mask."""
    return n * (n + 1) // 2


# ----------------------------------------------------------------------------
# Kernels' calls
# ----------------------------------------------------------------------------
def flash_call(q_shape, k_shape, causal: bool, elem_bytes: int) -> tuple[float, float]:
    """Operations and bytes of one attention call: q (B, Sq, KV, G, hd), k and
    v (B, Skv, KV, hd). Q Kᵀ and P V, 2 hd each per (query, key) pair that
    the mask keeps; q, k, v read once, out (as q) written once."""
    B, Sq, KV, G, hd = q_shape
    Skv = k_shape[1]
    if causal:
        if Sq != Skv:
            raise ValueError(f"causal attention with Sq {Sq} != Skv {Skv}")
        pairs = causal_pairs(Sq)
    else:
        pairs = Sq * Skv
    flops = 4.0 * hd * B * KV * G * pairs
    nbytes = elem_bytes * (2 * B * Sq * KV * G * hd + 2 * B * Skv * KV * hd)
    return flops, nbytes


def ssd_step_flops(B: int, S: int, H: int, P: int, N: int, Q: int) -> float:
    """The SSD intra-chunk step's products (the chunk kernel's work): C Bᵀ
    once per chunk (B and C are shared by the heads), the masked scores times
    x per head, and each chunk's state xᵀ (B ⊙ decay) per head."""
    nc = S // Q
    pairs = causal_pairs(Q)
    scores = 2.0 * N * pairs
    per_head = 2.0 * P * pairs + 2.0 * Q * P * N
    return B * nc * (scores + H * per_head)


def ssd_rest_flops(B: int, S: int, H: int, P: int, N: int, Q: int) -> float:
    """The rest of the chunked scan: the states carried between chunks and the
    off-diagonal term C · state per head."""
    nc = S // Q
    return B * nc * H * (2.0 * P * N + 2.0 * Q * N * P)


def ssd_chunks_call(x_shape, n: int, chunk: int) -> tuple[float, float]:
    """The whole chunked scan (``ops.ssd_chunks``): xh (B, S, H, P), B and C
    (B, S, N), da (B, S, H) in float32; y (B, S, H, P) and the final state
    (B, H, P, N) out."""
    B, S, H, P = x_shape
    Q = min(chunk, S)
    flops = ssd_step_flops(B, S, H, P, n, Q) + ssd_rest_flops(B, S, H, P, n, Q)
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * n + B * S * H + B * H * P * n)
    return flops, nbytes


def ssd_step_call(x_shape, n: int, chunk: int, backward: bool) -> tuple[float, float]:
    """The chunk step alone (``ops.SSDChunk``), float32: x, B, C, da in; y_diag
    (as x), the chunk states (B, nc, H, P, N) and the cumsum of da (as da)
    out. Its gradient: two products for each of the forward's, the saved
    inputs and the outputs' gradients in, the inputs' gradients out."""
    B, S, H, P = x_shape
    Q = min(chunk, S)
    nc = S // Q
    inputs = B * S * H * P + 2 * B * S * n + B * S * H
    outputs = B * S * H * P + B * nc * H * P * n + B * S * H
    flops = ssd_step_flops(B, S, H, P, n, Q)
    if backward:
        return 2.0 * flops, 4 * (2 * inputs + outputs)
    return flops, 4 * (inputs + outputs)


# ----------------------------------------------------------------------------
# Model FLOPs
# ----------------------------------------------------------------------------
def _layer_kinds(prog: dict) -> list[str]:
    """The block kinds of one model, in order ("attn_moe", "attn_mlp",
    "mamba"), from the configuration's program fields."""
    fam = prog["family"]
    if fam == "ssm":
        return ["mamba"] * prog["n_layers"]
    if fam in ("moe", "dense"):
        if prog.get("moe") and prog.get("moe_every", 1) != 1:
            raise ValueError("model_flops: MoE every k-th block is not counted yet")
        return ["attn_moe" if prog.get("moe") else "attn_mlp"] * prog["n_layers"]
    raise ValueError(f"model_flops: family {fam!r} is not counted yet")


def _per_token_layer(prog: dict, kind: str) -> float:
    """FLOPs of one token through one layer, less attention's and the SSD's
    length-dependent parts."""
    d = prog["d_model"]
    mult = 3 if prog.get("act", "swiglu") in ("swiglu", "geglu") else 2
    if kind == "mamba":
        m = prog["mamba"]
        d_in = m["expand"] * d
        nh = d_in // m["head_dim"]
        ch = d_in + 2 * m["d_state"]
        return 2.0 * d * (2 * d_in + 2 * m["d_state"] + nh) + 2.0 * m["d_conv"] * ch \
            + 2.0 * d_in * d
    hd = prog.get("head_dim") or d // prog["n_heads"]
    attn = 2.0 * d * hd * (prog["n_heads"] + 2 * prog["kv_heads"]) + 2.0 * prog["n_heads"] * hd * d
    if kind == "attn_moe":
        moe = prog["moe"]
        return attn + 2.0 * d * moe["n_experts"] + moe["top_k"] * mult * 2.0 * d * moe["d_ff_expert"]
    return attn + mult * 2.0 * d * prog["d_ff"]


def forward_flops(prog: dict, length: int, chunk: int = 256, head_positions: int = 1) -> float:
    """Model FLOPs of one sequence of ``length`` real tokens through the
    forward pass, the head at ``head_positions`` positions."""
    d = prog["d_model"]
    total = 2.0 * d * prog["vocab"] * head_positions
    for kind in _layer_kinds(prog):
        total += length * _per_token_layer(prog, kind)
        if kind == "mamba":
            m = prog["mamba"]
            d_in = m["expand"] * d
            H, P, N = d_in // m["head_dim"], m["head_dim"], m["d_state"]
            Q = min(chunk, length)
            nc = -(-length // Q)
            # the scan over whole chunks (a last partial chunk counts as whole)
            S = nc * Q
            total += (ssd_step_flops(1, S, H, P, N, Q) + ssd_rest_flops(1, S, H, P, N, Q)) \
                * length / S
        else:
            hd = prog.get("head_dim") or d // prog["n_heads"]
            total += 4.0 * hd * prog["n_heads"] * causal_pairs(length)
    return total


def prefill_flops(prog: dict, length: int, chunk: int = 256) -> float:
    """A prefill of one prompt: the forward over its real tokens, the head at
    its last position."""
    return forward_flops(prog, length, chunk, head_positions=1)


def train_flops(prog: dict, batch: int, seq: int, chunk: int = 256) -> float:
    """A train step: forward and backward (three times the forward), the head
    and the loss at every position; recomputation is not counted."""
    return 3.0 * batch * forward_flops(prog, seq, chunk, head_positions=seq)
