"""Vectorized batched evaluation of Problem-P candidates in float64 torch.

The float64 oracle of the ``crms_grid`` kernel's per-app output
(``utility_terms_batch``) and the batched Eq. (8) scorer of CRMS refinement
candidates (``evaluate_candidates``). A candidate is (N, r_cpu, r_mem) per
app; infeasible / unstable candidates map to +inf (or a soft penalty).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.core.engine import alpha_tensor, as_packed
from repro_torch.core.perf_model import eq1_latency
from repro_torch.core.problem import ServerCaps
from repro_torch.device import f64, resolve_device


def pack_apps(apps, device=None) -> dict:
    """The shared engine packing as float64 tensors on ``device`` (the CUDA
    device by default), the reference's historical entry point."""
    return as_packed(apps).as_dict(resolve_device(device))


def utility_batch(
    packed: dict,
    n: torch.Tensor,  # (B, M) float64
    c: torch.Tensor,  # (B, M)
    m: torch.Tensor,  # (B, M)
    caps_cpu: float,
    caps_mem: float,
    power_span: float,
    alpha,
    beta: float,
    hard: bool = True,
    penalty: float = 1e4,
    tail_q: float = 0.0,
):
    """Returns (U (B,), ws (B,M), feasible (B,)). ``hard`` -> infeasible = inf;
    else a smooth penalty. ``tail_q`` swaps the latency term for the analytic
    quantile surrogate (queueing.erlang_wait_quantile)."""
    kap = packed["kappa"]
    d_ms = eq1_latency((kap[:, 0], kap[:, 1], kap[:, 2]), c, m)
    mu = 1000.0 / (packed["xbar"] * d_ms)
    lam_b = packed["lam"] * torch.ones_like(n)
    if tail_q:
        ws = queueing.erlang_wait_quantile(n, lam_b, mu, q=tail_q)
    else:
        ws = queueing.erlang_ws(n, lam_b, mu)
    rho = packed["lam"] / (n * mu)
    dp = power_span * n * c / caps_cpu
    # smooth surrogate on the unstable branch (50·rho^2 s) keeps the search
    # landscape informative instead of a flat +inf cliff
    ws_soft = torch.where(
        rho < 1.0 - 1e-9, torch.where(torch.isfinite(ws), ws, 50.0), 50.0 * rho**2
    )
    terms = alpha * ws + beta * dp / packed["lam"]
    terms_soft = alpha * ws_soft + beta * dp / packed["lam"]
    u = torch.sum(terms, dim=-1)

    cpu_used = torch.sum(n * c, dim=-1)
    mem_used = torch.sum(n * m, dim=-1)
    bounds_ok = torch.all(
        (m >= packed["r_min"] - 1e-9) & (m <= packed["r_max"] + 1e-9), dim=-1
    )
    feas = (cpu_used <= caps_cpu + 1e-9) & (mem_used <= caps_mem + 1e-9) & bounds_ok
    stable = torch.all(torch.isfinite(ws), dim=-1)

    if hard:
        u = torch.where(feas & stable, u, torch.inf)
    else:
        viol = (
            torch.clamp(cpu_used - caps_cpu, min=0.0) / caps_cpu
            + torch.clamp(mem_used - caps_mem, min=0.0) / caps_mem
        )
        u = torch.sum(terms_soft, dim=-1) + penalty * viol
    return u, ws, feas & stable


def utility_terms_batch(packed, n, c, m, caps_cpu, power_span, alpha, beta):
    """Per-app utility terms (B, M) of Eq. (8): α·Ws_i + β·ΔP_i/λ_i, with
    unstable apps mapped to +inf — the float64 oracle of the ``crms_grid``
    kernel's per-app output."""
    _, ws, _ = utility_batch(
        packed, n, c, m, caps_cpu, torch.inf, power_span, alpha, beta, hard=True
    )
    dp = power_span * n * c / caps_cpu
    return alpha * ws + beta * dp / packed["lam"]


def evaluate_candidates(apps, caps: ServerCaps, n, c, m, alpha, beta, hard=True,
                        tail_q: float = 0.0, device=None):
    """NumPy-in, NumPy-out wrapper. ``apps`` may be a Sequence[App] or an
    already-built engine.PackedApps. ``alpha`` may be a scalar or a per-app
    (M,) priority-weighted latency weight; ``tail_q`` selects the
    quantile-surrogate latency term (0.0 = mean)."""
    dev = resolve_device(device)
    packed = as_packed(apps).as_dict(dev)
    u, ws, feas = utility_batch(
        packed,
        f64(np.asarray(n, dtype=float), dev),
        f64(np.asarray(c, dtype=float), dev),
        f64(np.asarray(m, dtype=float), dev),
        float(caps.r_cpu),
        float(caps.r_mem),
        float(caps.power.span),
        alpha_tensor(alpha, dev),
        float(beta),
        hard=hard,
        tail_q=float(tail_q),
    )
    return u.cpu().numpy(), ws.cpu().numpy(), feas.cpu().numpy()
