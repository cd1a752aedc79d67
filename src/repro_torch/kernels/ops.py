"""Public wrappers for the port's kernels with backend dispatch.

backend:
  'auto'      — the hand-written CUDA kernel for CUDA tensors (it launches or
                raises; there is no fallback), its plain-torch version
                (ref.py) for CPU tensors
  'reference' — crms_grid: the float64 oracle; flash_attention: the plain
                version (ref.py), on whatever device the tensors are
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref


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
def flash_attention(q, k, v, causal: bool = True, backend: str = "auto"):
    if backend not in ("auto", "reference"):
        raise ValueError(f"backend must be 'auto' or 'reference', got {backend!r}")
    if backend == "auto" and q.is_cuda:
        from repro_torch.kernels.flash_attention import flash_attention_fwd

        return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal)
    return _ref.flash_attention_plain(q, k, v, causal)
