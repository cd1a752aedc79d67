"""The Mamba2 (state-space duality) mixer of the reference's model substrate
(``repro/models/mamba.py``), in PyTorch.

Prefill runs the chunked SSD scan through ``kernels.ops.ssd_chunks``: the
hand-written CUDA chunk kernel on CUDA tensors, its plain version on CPU
tensors (the reference's model calls its einsum oracle ``_ssd_chunks_ref``
directly, never its Pallas kernel; the two agree to float32 rounding).
Decode is the O(1) recurrent form over a conv ring buffer and an SSM state
in float32, both written into the cache in place.

Parameters keep the reference's leaves and layouts; ``a_log``, ``d_skip``
and ``dt_bias`` stay float32 whatever the model's dtype. On a mesh each rank
runs the whole mixer on its batch rows with the weights gathered (the
reference splits the heads over the model axis, ``repro/models/mamba.py:162``;
mamba2-130m, its one Mamba model that fits a card, is pure data parallel and
has no model axis). The gathered weights' gradients are summed over the
data axes (with pure data parallelism: 'data' and 'model') and come back
in their storage layout (``layers.local_weight``). Where the residual is
split over S (``Runtime.seq_split``) the mixer gathers the sequence whole,
runs as above, and keeps the rank's rows of its output.
"""
from __future__ import annotations

import dataclasses
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MambaSpec, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (Runtime, _param, dot, local_weights, model_all_gather,
                                       residual_constrain)

F32 = torch.float32


class Mamba(nn.Module):
    """``w_in`` (d, 2·d_in + 2N + nh) in the order [z, x, B, C, dt],
    ``conv_w`` (K, Ch) and ``conv_b`` (Ch,) with Ch = d_in + 2N, ``a_log``,
    ``d_skip`` and ``dt_bias`` (nh,) in float32, ``norm_w`` (d_in,), ``w_out``
    (d_in, d). Constants start at their reference init (``d_skip`` and
    ``norm_w`` 1, the rest 0); the matrices at zero until drawn or loaded."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        m = cfg.mamba or MambaSpec()
        d = cfg.d_model
        d_in, nh, N = m.d_inner(d), m.n_heads(d), m.d_state
        ch = d_in + 2 * N
        self.w_in = _param((d, 2 * d_in + 2 * N + nh), device, dtype)
        self.conv_w = _param((m.d_conv, ch), device, dtype)
        self.conv_b = _param((ch,), device, dtype)
        self.a_log = _param((nh,), device, F32)
        self.d_skip = _param((nh,), device, F32, 1.0)
        self.dt_bias = _param((nh,), device, F32)
        self.norm_w = _param((d_in,), device, dtype, 1.0)
        self.w_out = _param((d_in, d), device, dtype)


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, S, Ch); w: (K, Ch); state: (B, K-1, Ch)
    or None (zeros). Returns (out (B, S, Ch), new state (B, K-1, Ch)); the new
    state is a slice of a fresh tensor, never of ``state``."""
    K = w.shape[0]
    S = x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, Ch)
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K)) + b
    return out, xp[:, -(K - 1):, :]


def apply_mamba(p: Mamba, x, cfg: ModelConfig, runtime: Runtime, *, cache=None,
                chunk: int = 256):
    """Returns (y (B, S, d), cache or None). ``cache`` is dict(conv=(B, K-1,
    Ch), ssm=(B, H, P, N) float32); with S > 1 it is filled from the prompt
    (prefill-fill), with S == 1 it advances one recurrent step. Either way the
    new states are written into its tensors in place (the reference returns
    updated copies) and the same dict is returned. Prefill goes through
    ``ops.ssd_chunks`` with chunks of ``chunk`` positions and the backend
    ``runtime.attn_backend`` names."""
    if runtime.seq_split:  # the scan needs the whole sequence: gathered, the rank's rows kept
        y, cache = apply_mamba(p, model_all_gather(x, runtime, 1), cfg,
                               dataclasses.replace(runtime, seq_split=False), cache=cache,
                               chunk=chunk)
        return residual_constrain(y, runtime), cache
    m = cfg.mamba or MambaSpec()
    d_in, nh, N, Pd = m.d_inner(cfg.d_model), m.n_heads(cfg.d_model), m.d_state, m.head_dim
    dt_c = runtime.compute_dtype
    B, S, _ = x.shape
    if runtime.mesh is not None:  # every rank runs the whole mixer on its batch rows
        cast = ("w_in", "conv_w", "conv_b", "w_out")  # cast to the compute dtype before a gather
        named = list(p.named_parameters())
        p = types.SimpleNamespace(**dict(zip((name for name, _ in named), local_weights(
            [(w, None, dt_c if name in cast else None, False) for name, w in named], runtime))))

    zxbcdt = dot(x, p.w_in.to(dt_c))
    z, xin, bmat, cmat, dt_raw = torch.split(zxbcdt, [d_in, d_in, N, N, nh], dim=-1)
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, p.conv_w.to(dt_c), p.conv_b.to(dt_c),
                                       state=None if cache is None else cache["conv"])
    conv_out = F.silu(conv_out)
    xin, bmat, cmat = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = F.softplus(dt_raw.to(F32) + p.dt_bias)  # (B, S, H)
    A = -torch.exp(p.a_log)  # (H,) negative
    da = dt * A
    xh = xin.reshape(B, S, nh, Pd).to(F32) * dt[..., None]

    if cache is None or S > 1:
        y, final_state = kops.ssd_chunks(xh, bmat.to(F32), cmat.to(F32), da, chunk=chunk,
                                         backend=runtime.attn_backend)
    else:
        # O(1) recurrent decode step (S is 1 in practice; loop if larger)
        final_state = cache["ssm"]
        ys = []
        for t in range(S):
            dec = torch.exp(da[:, t])  # (B, H)
            upd = torch.einsum("bhp,bn->bhpn", xh[:, t], bmat[:, t].to(F32))
            final_state = dec[..., None, None] * final_state + upd
            ys.append(torch.einsum("bhpn,bn->bhp", final_state, cmat[:, t].to(F32)))
        y = torch.stack(ys, dim=1)  # (B, S, H, P)
    if cache is not None:
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(final_state)

    y = y + p.d_skip[None, None, :, None] * xin.reshape(B, S, nh, Pd).to(F32)
    y = y.reshape(B, S, d_in)
    # gated RMSNorm (float32) then the output projection
    gated = y * F.silu(z.to(F32))
    ms = torch.mean(gated * gated, dim=-1, keepdim=True)
    gated = gated * torch.rsqrt(ms + 1e-6) * p.norm_w.to(F32)
    return dot(gated.to(dt_c), p.w_out.to(dt_c)), cache
