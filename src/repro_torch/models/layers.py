"""Core layers of the model substrate: norms, RoPE, GQA/MQA self- and
cross-attention (prefill and cross-attention through the flash kernel behind
``kernels.ops``, decode over a KV cache), gated MLPs.

Parameters keep the reference's layouts (``repro/models/layers.py``): q/k/v
projections (d, heads, hd), the output projection (heads, hd, d), MLP
matrices (d, d_ff) and (d_ff, d). Compute runs in ``Runtime.compute_dtype``
with float32 norms, RoPE angles and softmax. Parameters are trainable
``nn.Parameter``s: code that writes into one does so under
``torch.no_grad()``, and the serving entry points run under
``torch.inference_mode()`` so that a forward there builds no graph.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model apply. ``device=None`` is the
    CUDA device (RuntimeError without one). Unlike the reference, there is no
    mesh (one device), and ``attn_backend="auto"`` runs the model's kernels
    (the flash kernel of attention, the SSD chunk kernel of Mamba) on CUDA
    tensors; ``"reference"`` runs their plain versions."""

    device: Any = None
    compute_dtype: torch.dtype = torch.bfloat16
    attn_backend: str = "auto"

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.attn_backend not in ("auto", "reference"):
            raise ValueError(f"attn_backend must be 'auto' or 'reference', "
                             f"got {self.attn_backend!r}")


def _param(shape, device, dtype, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device))


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------
class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        self.w = _param((cfg.d_model,), device, dtype, 0.0 if cfg.norm_plus_one else 1.0)


def apply_norm(p: Norm, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.to(F32)
    w = p.w.to(F32)
    if cfg.norm_plus_one:
        w = 1.0 + w
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps) * w
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * w
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
def rope_embed(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integers, broadcastable."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    ang = positions[..., None].to(F32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        hd, d = cfg.resolved_head_dim, cfg.d_model
        self.wq = _param((d, cfg.n_heads, hd), device, dtype)
        self.wk = _param((d, cfg.kv_heads, hd), device, dtype)
        self.wv = _param((d, cfg.kv_heads, hd), device, dtype)
        self.wo = _param((cfg.n_heads, hd, d), device, dtype)
        if cfg.qkv_bias:
            self.bq = _param((cfg.n_heads, hd), device, dtype)
            self.bk = _param((cfg.kv_heads, hd), device, dtype)
            self.bv = _param((cfg.kv_heads, hd), device, dtype)


def apply_attention(p: Attention, x, cfg: ModelConfig, runtime: Runtime, *, positions,
                    causal: bool = True, memory=None, cache=None, use_rope: bool = True):
    """Returns (out (B,S,d), new_cache or None). ``memory`` (B, S_src, d),
    already normed, is the source of k/v for cross-attention, which is never
    causal and takes no RoPE. ``cache`` is dict(k=(B,KV,T,hd), v=...,
    index=int); this step's k/v are written into its tensors in place (the
    reference returns updated copies)."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    dt = runtime.compute_dtype
    kv_src = memory if memory is not None else x

    q = torch.einsum("bsd,dnh->bsnh", x, p.wq.to(dt))
    k = torch.einsum("bsd,dnh->bsnh", kv_src, p.wk.to(dt))
    v = torch.einsum("bsd,dnh->bsnh", kv_src, p.wv.to(dt))
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if use_rope and memory is None:
        q = rope_embed(q, positions, cfg.rope_theta)
        k = rope_embed(k, positions, cfg.rope_theta)

    KV = cfg.kv_heads
    G = cfg.n_heads // KV
    qg = q.reshape(B, S, KV, G, hd)
    new_cache = None
    if cache is not None and S > 1:
        # prefill-fill: write the fresh k/v into the cache at [0, S), then
        # compute flash attention below as if the cache were absent
        cache["k"][:, :, :S] = k.transpose(1, 2).to(cache["k"].dtype)
        cache["v"][:, :, :S] = v.transpose(1, 2).to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "index": cache["index"]}
        cache = None
    if cache is not None:
        # decode: write this step's k/v at cache["index"] (clamped into the
        # cache, as dynamic_update_slice does), attend over the prefix
        k_cache, v_cache, index = cache["k"], cache["v"], int(cache["index"])
        T = k_cache.shape[2]
        start = min(max(index, 0), T - S)
        k_cache[:, :, start:start + S] = k.transpose(1, 2).to(k_cache.dtype)
        v_cache[:, :, start:start + S] = v.transpose(1, 2).to(v_cache.dtype)
        new_cache = {"k": k_cache, "v": v_cache, "index": cache["index"]}
        kk = k_cache.to(dt).to(F32)  # (B, KV, T, hd); f32 products as preferred_element_type
        vv = v_cache.to(dt).to(F32)
        s = torch.einsum("bskgh,bkth->bkgst", qg.to(F32), kk) * hd**-0.5
        valid = torch.arange(T, device=s.device) <= index  # uniform decode step
        s = torch.where(valid, s, -torch.inf)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgst,bkth->bskgh", w.to(dt).to(F32), vv)
        out = o.reshape(B, S, cfg.n_heads, hd).to(dt)
    else:
        out5 = kops.flash_attention(qg, k, v, causal=causal and memory is None,
                                    backend=runtime.attn_backend)
        out = out5.reshape(B, S, cfg.n_heads, hd).to(dt)

    y = torch.einsum("bsnh,nhd->bsd", out, p.wo.to(dt))
    return y, new_cache


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_ff
        self.w_up = _param((d, d_ff), device, dtype)
        self.w_down = _param((d_ff, d), device, dtype)
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = _param((d, d_ff), device, dtype)


def apply_mlp(p: MLP, x, cfg: ModelConfig, runtime: Runtime):
    dt = runtime.compute_dtype
    up = x @ p.w_up.to(dt)
    if cfg.act == "swiglu":
        h = torch.nn.functional.silu(x @ p.w_gate.to(dt)) * up
    elif cfg.act == "geglu":
        h = torch.nn.functional.gelu(x @ p.w_gate.to(dt), approximate="tanh") * up
    else:
        h = torch.relu(up)
    return h @ p.w_down.to(dt)
