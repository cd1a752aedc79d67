"""Host side of the hand-written CUDA SSD chunk kernel (csrc/ssd.cu).

The kernel replaces the Pallas TPU kernel ``repro/kernels/ssd.py::
ssd_chunk_fwd``: per (batch, chunk, head) the Mamba2 SSD intra-chunk dual
form ``y_diag = (C Bᵀ ⊙ tril(exp(segsum(da)))) x`` and the chunk state
``xᵀ (B ⊙ exp(cum_end - cum))``, in float32, with ``cum = cumsum(da)`` in
the reference's order of sums (``ref.cumsum_blocked``), which it also
returns bit for bit. It takes the model's layouts directly: x (B, S, H, P),
B and C (B, S, N), da (B, S, H); P in {16, 32, 64}, N in {16, 32, 64, 128},
a chunk of 1..256 positions that divides S.

The kernel forms each score tile C Bᵀ once for a group of ``head_group()``
heads (B and C are shared by all heads) and runs its three products on the
tensor cores in error-compensated TF32 (three TF32 products per float32
product), so y_diag and the states agree with the plain version
(``ref.ssd_chunk_plain``) within the reference's 2e-5 / 2e-4, not bit for bit.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use by
``kernels/build.py`` (a plain C launcher, loaded with ``ctypes``); nothing is
compiled or loaded at import time. ``launches`` counts the kernel launches
this process made.

``ssd_chunk_op`` is the kernel as the operator
``torch.ops.repro_torch.ssd_chunk_fwd`` (``ops.ssd_chunks`` calls it): a
trace on fake tensors (the dry-run, ``launch/dryrun.py``) sees the operator,
its fake version gives its outputs' shapes without a card, and
``ssd_chunk_flops`` is its count for torch's FLOP counter. Only a real launch
adds to ``launches``.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.build import build_library

PRODUCTS = "3xTF32 mma.sync m16n8k8"  # the route of the kernel's three products
HEAD_DIMS = (16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 256

launches = 0  # kernel launches by this process (chip_smoke.py resets and reads it)
_lib = None


def build(force: bool = False) -> dict:
    """Compile the kernel (if its content-hashed library is missing or
    ``force``) and load it. Returns {"seconds", "library", "log"}; the log
    holds ptxas' register/spill report when this call compiled."""
    global _lib
    lib, info = build_library("ssd", force)
    fn = lib.ssd_chunk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_chunk_head_group.argtypes = []
    lib.ssd_chunk_head_group.restype = ctypes.c_int
    _lib = lib
    return info


def head_group() -> int:
    """Heads that share one score tile in the kernel (a compile-time
    constant of csrc/ssd.cu); builds the kernel if needed."""
    if _lib is None:
        build()
    return _lib.ssd_chunk_head_group()


def check_inputs(x, bmat, cmat, da, chunk: int):
    """The kernel's checks of its inputs' shapes, dtypes, devices, layout and
    chunk, which the op's fake version (``ssd_chunk_op``) repeats without a
    card: ValueError / TypeError where the kernel would refuse them."""
    if x.dim() != 4 or bmat.dim() != 3 or cmat.dim() != 3 or da.dim() != 3:
        raise ValueError("ssd_chunk_fwd: x must be (B, S, H, P), bmat/cmat (B, S, N) and "
                         "da (B, S, H)")
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    if tuple(bmat.shape) != (B, S, N) or tuple(cmat.shape) != (B, S, N) or \
            tuple(da.shape) != (B, S, H):
        raise ValueError(f"ssd_chunk_fwd: bmat {tuple(bmat.shape)}, cmat {tuple(cmat.shape)} "
                         f"or da {tuple(da.shape)} do not match x {tuple(x.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd_chunk_fwd: head_dim {P} not in {HEAD_DIMS} or d_state {N} "
                         f"not in {STATE_DIMS}")
    if min(B, S, H) == 0:
        raise ValueError(f"ssd_chunk_fwd: empty input x {tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_chunk_fwd: chunk {chunk} must be in [1, {MAX_CHUNK}] and "
                         f"divide the sequence length {S}")
    for name, t in (("x", x), ("bmat", bmat), ("cmat", cmat), ("da", da)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk_fwd: {name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ssd_chunk_fwd: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk_fwd: {name} must be contiguous")


def ssd_chunk_fwd(x, bmat, cmat, da, *, chunk: int):
    """x (B, S, H, P); bmat/cmat (B, S, N); da (B, S, H): contiguous float32
    CUDA tensors. Launches the kernel on the current stream and returns
    y_diag (B, S, H, P), states (B, S // chunk, H, P, N) and each chunk's
    cumsum of da (B, S, H), float32."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"ssd_chunk_fwd: the CUDA kernel needs CUDA tensors, got {x.device}")
    check_inputs(x, bmat, cmat, da, chunk)
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    # the kernel copies x, B and C rows in 16-byte pieces; a view that starts
    # mid-piece is copied to fresh (aligned) storage
    x, bmat, cmat = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, bmat, cmat))
    if _lib is None:
        build()
    y = torch.empty_like(x)
    states = torch.empty((B, S // chunk, H, P, N), dtype=torch.float32, device=x.device)
    cum = torch.empty_like(da)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib.ssd_chunk_launch(
            x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), da.data_ptr(), y.data_ptr(),
            states.data_ptr(), cum.data_ptr(), B, S, H, P, N, chunk, stream,
        )
    if status != 0:
        raise RuntimeError(f"ssd_chunk_fwd: kernel launch failed with CUDA error {status}")
    launches += 1
    return y, states, cum


# ----------------------------------------------------------------------------
# The kernel as an operator that a trace sees
# ----------------------------------------------------------------------------
@torch.library.custom_op(
    "repro_torch::ssd_chunk_fwd", mutates_args=(),
    schema="(Tensor x, Tensor bmat, Tensor cmat, Tensor da, int chunk) -> (Tensor, Tensor, Tensor)")
def ssd_chunk_op(x, bmat, cmat, da, chunk):
    """The kernel as ``torch.ops.repro_torch.ssd_chunk_fwd``: on real tensors
    ``ssd_chunk_fwd`` (which launches it, or raises off the card); on fake
    tensors (a dry-run's trace) its fake version gives y_diag, the states and
    the cumsum's shapes, and nothing runs."""
    return ssd_chunk_fwd(x, bmat, cmat, da, chunk=chunk)


@ssd_chunk_op.register_fake
def _ssd_chunk_fake(x, bmat, cmat, da, chunk):
    check_inputs(x, bmat, cmat, da, chunk)
    B, S, H, P = x.shape
    states = x.new_empty((B, S // chunk, H, P, bmat.shape[-1]))
    return torch.empty_like(x), states, torch.empty_like(da)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk_fwd)
def ssd_chunk_flops(x_shape, b_shape, c_shape, da_shape, chunk, *args, **kwargs) -> int:
    """The products of one call, the three chunk einsums of
    ``ref.ssd_chunk_plain``: per chunk of Q positions the scores C Bᵀ (2 Q² N),
    y_diag's (scores ⊙ L) x (2 Q² H P) and the states' xᵀ (B ⊙ decay)
    (2 Q H P N). Every score entry of the Q x Q tile is counted, the ones
    above its diagonal (masked to 0) too, as the plain version's einsum
    computes them."""
    B, S, H, P = x_shape
    N = b_shape[-1]
    return 2 * B * S * (chunk * N + chunk * H * P + H * P * N)
