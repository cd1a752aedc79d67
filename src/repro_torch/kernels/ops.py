"""Public wrappers for the port's kernels with backend dispatch.

backend:
  'auto'      — the hand-written CUDA kernel for CUDA tensors (it launches or
                raises; there is no fallback), its plain-torch version
                (ref.py) for CPU tensors; flash_attention and ssd_chunks
                reach their kernels through its operator
                (``torch.ops.repro_torch.flash_fwd`` / ``ssd_chunk_fwd``),
                which they also call on fake tensors of any device (a
                dry-run's trace), where the operator's fake version gives the
                shapes and nothing runs
  'reference' — crms_grid: the float64 oracle; flash_attention and
                ssd_chunks: the plain version (ref.py), on whatever device
                the tensors are

flash_attention and ssd_chunks are differentiable: their forward is the
kernel (or its plain version) as above, inside a ``torch.autograd.Function``
whose backward is plain torch, as the reference's gradients are jnp (it has
no backward Pallas kernel). Attention's backward is the reference's
blockwise recompute (``ref.flash_attention_bwd``); the SSD chunk step's
recomputes ``ref.ssd_chunk_plain`` under autograd, as the reference
differentiates its einsum oracle.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch import telemetry
# the kernels' host modules register their operators and FLOP formulas (they
# build and load nothing at import)
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd

F32 = torch.float32


def _kernel_route(t, backend: str) -> bool:
    """Whether ``backend`` sends ``t`` to the kernel's operator: "auto" with
    a CUDA tensor, or with a fake tensor whatever its device."""
    return backend == "auto" and (t.is_cuda or isinstance(t, FakeTensor))


# ----------------------------------------------------------------------------
# CRMS candidate grid — see crms_grid.py
# ----------------------------------------------------------------------------
def crms_grid(kappa, lam, xbar, n, c, m, *, caps_cpu, power_span, alpha, beta,
              backend: str = "auto", reduce: str = "sum"):
    if reduce not in ("sum", "per_app"):
        raise ValueError(f"reduce must be 'sum' or 'per_app', got {reduce!r}")
    kappa, lam, xbar, n, c, m = (torch.as_tensor(t) for t in (kappa, lam, xbar, n, c, m))
    if backend == "reference":
        ref_fn = _ref.crms_grid_terms if reduce == "per_app" else _ref.crms_grid_utility
        return ref_fn(kappa, lam, xbar, n, c, m, caps_cpu, power_span, alpha, beta)
    if backend != "auto":
        raise ValueError(f"backend must be 'auto' or 'reference', got {backend!r}")
    kw = dict(caps_cpu=caps_cpu, power_span=power_span, alpha=alpha, beta=beta,
              reduce=reduce)
    if n.is_cuda:
        from repro_torch.kernels.crms_grid import crms_grid_eval

        return crms_grid_eval(kappa, lam, xbar, n, c, m, **kw)
    return _ref.crms_grid_plain(kappa, lam, xbar, n, c, m, **kw)


# ----------------------------------------------------------------------------
# flash attention — q (B,Sq,KV,G,hd), k/v (B,Skv,KV,hd); see flash_attention.py
# ----------------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward is the CUDA kernel's operator
    on CUDA (or fake) tensors with ``backend="auto"``, else the plain
    version; the backward is ``ref.flash_attention_bwd`` at blocks of ``qb``
    query rows and ``kb`` keys (the reference's 512 / 1024 by default), from
    the saved q, k, v and output. ``offset``: the query rows are rows
    offset.. of the keys' sequence (a causal row i sees keys <= offset +
    i)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, backend, qb, kb, offset=0):
        if _kernel_route(q, backend):
            out = _flash.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal, offset)
        else:
            out = _ref.flash_attention_plain(q, k, v, causal, offset=offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.qb, ctx.kb, ctx.offset = causal, qb, kb, offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        with telemetry.span("kernels/flash_attention.bwd"):
            dq, dk, dv = _ref.flash_attention_bwd(q, k, v, out, dout, ctx.causal, ctx.qb, ctx.kb,
                                                  ctx.offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal: bool = True, backend: str = "auto", offset: int = 0):
    """``offset`` >= 0 moves the causal diagonal: query row i is row offset + i
    of the keys' sequence (a block of a sequence-sharded query); 0 is the
    reference's top-left mask."""
    if backend not in ("auto", "reference"):
        raise ValueError(f"backend must be 'auto' or 'reference', got {backend!r}")
    if offset < 0:
        raise ValueError(f"flash_attention: offset must be >= 0, got {offset}")
    return FlashAttention.apply(q, k, v, causal, backend, _ref.DEFAULT_QB, _ref.DEFAULT_KB,
                                int(offset))


# ----------------------------------------------------------------------------
# SSD chunk scan — xh (B,S,H,P), bmat/cmat (B,S,N), da (B,S,H); see ssd.py
# ----------------------------------------------------------------------------
class SSDChunk(torch.autograd.Function):
    """The SSD intra-chunk step with a gradient: the forward is the CUDA
    kernel's operator on CUDA (or fake) tensors with ``backend="auto"``, else
    the plain version, returning y_diag, the chunk states and the chunks'
    cumsum of da; the backward recomputes ``ref.ssd_chunk_plain`` from the
    saved inputs under autograd and returns its gradient (the reference
    differentiates its einsum oracle)."""

    @staticmethod
    def forward(ctx, x, bmat, cmat, da, chunk, backend):
        with telemetry.span("kernels/ssd.chunk_fwd", x=tuple(x.shape), n=bmat.shape[-1],
                            chunk=chunk):
            if _kernel_route(x, backend):
                outs = _ssd.ssd_chunk_op(x, bmat, cmat, da, chunk)
            else:
                outs = _ref.ssd_chunk_plain(x, bmat, cmat, da, chunk)
        ctx.save_for_backward(x, bmat, cmat, da)
        ctx.chunk = chunk
        return outs

    @staticmethod
    def backward(ctx, d_y, d_states, d_cum):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with telemetry.span("kernels/ssd.chunk_bwd"), torch.enable_grad():
            outs = _ref.ssd_chunk_plain(*inputs, ctx.chunk)
            grads = torch.autograd.grad(outs, inputs, (d_y, d_states, d_cum), allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads)]
        return (*grads, None, None)


def ssd_chunks(xh, bmat, cmat, da, chunk: int = 128, backend: str = "auto"):
    """Chunked SSD scan in float32 with chunks of Q = min(chunk, S): the
    intra-chunk step (y_diag, chunk states and the chunks' cumsum of da)
    through the CUDA kernel on CUDA tensors (``auto``) or its plain version,
    then the inter-chunk
    recurrence and the off-diagonal term in plain torch, as the reference's
    ``kernels/ops.py::ssd_chunks``. Returns y (B, S, H, P) and the final
    state (B, H, P, N). Raises ValueError where S is not a multiple of Q
    (the reference's reshape fails there too)."""
    if backend not in ("auto", "reference"):
        raise ValueError(f"backend must be 'auto' or 'reference', got {backend!r}")
    B, S, H, P = xh.shape
    N = bmat.shape[-1]
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_chunks: sequence length {S} is not a multiple of the chunk {Q}")
    nc = S // Q
    xh, bmat, cmat, da = (t.to(F32).contiguous() for t in (xh, bmat, cmat, da))
    y_diag, states, cum = SSDChunk.apply(xh, bmat, cmat, da, Q, backend)
    # inter-chunk recurrence + off-diagonal contribution (tiny, plain torch),
    # on the chunk step's own cumsum of da
    with telemetry.span("kernels/ssd.scan", chunks=nc):
        da_cum = cum.reshape(B, nc, Q, H)
        chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (B, nc, H)
        state = torch.zeros_like(states[:, 0])
        s_in = []
        for n in range(nc):
            s_in.append(state)
            state = states[:, n] + chunk_decay[:, n, :, None, None] * state
        s_in = torch.stack(s_in, dim=1)  # (B, nc, H, P, N): the state entering each chunk
        y_off = torch.einsum("bnts,bnth,bnhps->bnthp", cmat.reshape(B, nc, Q, N),
                             torch.exp(da_cum), s_in)
        y = y_diag.reshape(B, nc, Q, H, P) + y_off
    return y.reshape(B, S, H, P), state
