"""Host side of the hand-written CUDA flash-attention forward
(csrc/flash_attention.cu).

The kernel replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``: GQA attention
with an online softmax in float32, the causal mask aligned top-left (or
moved down by ``offset`` rows for a block of a sequence-sharded query), keys and
queries past the sequence masked, output in q's dtype. It takes the model's
layouts directly: q (B, Sq, KV, G, hd), k/v (B, Skv, KV, hd), float32 or
bfloat16, head_dim in {32, 64, 128, 256}. Both dtypes pack the G query heads
of a kv head into one 64-row tile where G divides 64. bfloat16 runs the
wgmma kernel (bf16 tensor cores, TMA-fed K/V), which pairs the q tiles t and
last - t in a block. float32 runs the mma.sync kernel (both products in
error-compensated TF32, three TF32 products per float32 product, K/V
double-buffered by cp.async): one 64-row q tile a block, whose two warp
groups take alternate K/V tiles and merge their online softmaxes at the end,
with the blocks launched heaviest tile first.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use by
``kernels/build.py`` (a plain C launcher, loaded with ``ctypes``); nothing is
compiled or loaded at import time. ``launches`` counts the kernel launches
this process made.

``flash_fwd`` is the kernel as the operator ``torch.ops.repro_torch.flash_fwd``
(``ops.flash_attention`` calls it): a trace on fake tensors (the dry-run,
``launch/dryrun.py``) sees the operator, its fake version gives its output's
shape without a card, and ``flash_fwd_flops`` is its count for torch's FLOP
counter. Only a real launch adds to ``launches``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import build_library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)

launches = 0  # kernel launches by this process (chip_smoke.py resets and reads it)
_lib = None


def build(force: bool = False) -> dict:
    """Compile the kernel (if its content-hashed library is missing or
    ``force``) and load it. Returns {"seconds", "library", "log"}; the log
    holds ptxas' register/spill report when this call compiled."""
    global _lib
    lib, info = build_library("flash_attention", force)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return info


def check_inputs(q, k, v, offset: int = 0):
    """The kernel's checks of its inputs' shapes, dtypes, devices and
    layout, which the op's fake version (``flash_fwd``) repeats without a
    card: ValueError / TypeError where the kernel would refuse them."""
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q must be (B, Sq, KV, G, hd) and k/v (B, Skv, KV, hd)")
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    if tuple(k.shape) != (B, Skv, KV, hd) or tuple(v.shape) != (B, Skv, KV, hd):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if offset < 0:
        raise ValueError(f"flash_attention: offset must be >= 0, got {offset}")
    if min(B, Sq, Skv, KV, G) == 0:
        raise ValueError(f"flash_attention: empty input q {tuple(q.shape)}, k {tuple(k.shape)}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, offset: int = 0):
    """q (B, Sq, KV, G, hd); k/v (B, Skv, KV, hd): contiguous CUDA tensors of
    one dtype (float32 or bfloat16). Launches the kernel on the current
    stream and returns out (B, Sq, KV, G, hd) in q's dtype. With ``causal``,
    query row i sees the keys <= ``offset`` + i (0: top-left)."""
    global launches
    if not q.is_cuda:
        raise ValueError(f"flash_attention: the CUDA kernel needs CUDA tensors, got {q.device}")
    check_inputs(q, k, v, offset)
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    # the kernels copy q/k/v rows in 16-byte pieces (cp.async, TMA); a view
    # that starts mid-piece is copied to fresh (aligned) storage
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    if _lib is None:
        build()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Skv, KV, G, hd,
            float(hd ** -0.5), int(causal), int(offset), DTYPES[q.dtype], stream,
        )
    if status == -1:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled failed on the TMA maps")
    if status != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {status}")
    launches += 1
    return out


# ----------------------------------------------------------------------------
# The kernel as an operator that a trace sees
# ----------------------------------------------------------------------------
@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v, bool causal, int offset) -> Tensor")
def flash_fwd(q, k, v, causal, offset):
    """The kernel as ``torch.ops.repro_torch.flash_fwd``: on real tensors
    ``flash_attention_fwd`` (which launches it, or raises off the card); on
    fake tensors (a dry-run's trace) its fake version gives the output's
    shape and dtype, and nothing runs."""
    return flash_attention_fwd(q, k, v, causal=causal, offset=offset)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal, offset):
    check_inputs(q, k, v, offset)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def flash_fwd_flops(q_shape, k_shape, v_shape, causal, offset, *args, **kwargs) -> int:
    """The products of one call: Q Kᵀ and P V, 2 hd each per score entry, over
    every (query row, key) entry of the Sq x Skv rectangle, causal or not:
    the tiles a causal call skips above its diagonal are counted, as torch's
    FLOP counter counts its own fused attention."""
    B, Sq, KV, G, hd = q_shape
    return 4 * B * Sq * k_shape[1] * KV * G * hd
