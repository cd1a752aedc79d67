"""Solvers for the paper's decomposition (§V).

SP1  — per-container quota selection under sufficient resources (Theorem 2:
       strictly convex; memory monotone ⇒ m* = r_max; CPU by bisection on the
       1-D convex derivative).
SP2  — container count (Theorem 3: convex) — paper-faithful integer ternary
       search plus a vectorized exhaustive argmin oracle.
P1   — constrained joint reallocation over (r_cpu_i, r_mem_i) with N fixed
       (Theorem 4: convex) — log-barrier interior-point Newton, with a scipy
       SLSQP cross-check path (the paper's own solver) fed a torch-autograd
       gradient.

The serial ``p1_solve`` is the B=1 special case of ``engine.p1_solve_batch``,
so the two paths cannot drift apart.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.core.engine import (  # noqa: F401 — re-exported solver surface
    P1BatchResult,
    P1Result,
    PackedApps,
    as_packed,
    find_feasible_start_batch,
    grid_seed_chints,
    p1_objective,
    p1_solve_batch,
)
from repro_torch.core.perf_model import eq1_latency
from repro_torch.core.problem import App, ServerCaps
from repro_torch.device import F64, f64, resolve_device


# ----------------------------------------------------------------------------
# SP1 — per-container (r_cpu, r_mem) under sufficient resources
# ----------------------------------------------------------------------------
def sp1_objective(app: App, caps: ServerCaps, alpha: float, beta: float, c, m,
                  device=None):
    """F_i of Eq. (14): α·x̄·d/1000 + β·Δp/λ  (d ms→s conversion)."""
    dev = resolve_device(device)
    d_ms = eq1_latency(f64(app.kappa, dev), f64(c, dev), f64(m, dev))
    power_term = beta * caps.power.span * f64(c, dev) / (caps.r_cpu * app.lam)
    return alpha * app.xbar * d_ms * 1e-3 + power_term


def sp1_solve(app: App, caps: ServerCaps, alpha: float, beta: float, iters: int = 100,
              device=None):
    """Returns (r_cpu*, r_mem*). m* = r_max by Theorem-2 monotonicity; c* by
    bisection on dF/dc (convex ⇒ derivative crosses zero at most once)."""
    dev = resolve_device(device)
    m_star = app.r_max
    k1, k2, _ = app.kappa

    def dF_dc(c):
        # d/dc [α x̄/1000 · k1/(1-e^{-k2 c})] + β·span/(R̄cpu λ)
        e = torch.exp(-k2 * c)
        d_latency = -k1 * k2 * e / (1.0 - e) ** 2
        return alpha * app.xbar * 1e-3 * d_latency + beta * caps.power.span / (
            caps.r_cpu * app.lam
        )

    lo, hi = f64(app.cpu_min, dev), f64(app.cpu_max, dev)
    # If still decreasing at cpu_max, the optimum is the box edge.
    if float(dF_dc(hi)) < 0:
        return float(hi), float(m_star)
    if float(dF_dc(lo)) > 0:
        return float(lo), float(m_star)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        g = dF_dc(mid)
        lo = torch.where(g < 0, mid, lo)
        hi = torch.where(g < 0, hi, mid)
    return float(0.5 * (lo + hi)), float(m_star)


# ----------------------------------------------------------------------------
# SP2 — container count
# ----------------------------------------------------------------------------
def phi(app: App, caps: ServerCaps, alpha: float, beta: float, n, mu_star, r_cpu_star):
    """Φ(N) of Eq. (23)."""
    ws = queueing.erlang_ws(n, app.lam, mu_star)
    dp = caps.power.span * torch.as_tensor(n, dtype=F64, device=ws.device) * r_cpu_star / caps.r_cpu
    return alpha * ws + beta * dp / app.lam


def sp2_bounds(app: App, caps: ServerCaps, mu_star, r_cpu_star, r_mem_star):
    lo = queueing.stability_lower_bound(app.lam, mu_star)
    hi = int(min(caps.r_cpu / r_cpu_star, caps.r_mem / r_mem_star))
    hi = min(max(hi, lo), queueing.MAX_SERVERS - 1)
    return lo, hi


def sp2_ternary(app, caps, alpha, beta, mu_star, r_cpu_star, r_mem_star) -> int:
    """Paper-faithful Algorithm 1 lines 4-15 (integer ternary search on convex Φ)."""
    l, r = sp2_bounds(app, caps, mu_star, r_cpu_star, r_mem_star)
    f = lambda n: float(phi(app, caps, alpha, beta, float(n), mu_star, r_cpu_star))  # noqa: E731
    while r - l > 2:
        lmid = l + (r - l) // 3
        rmid = r - (r - l) // 3
        if f(lmid) <= f(rmid):
            r = rmid - 1
        else:
            l = lmid + 1
    return min(range(l, r + 1), key=f)


def sp2_exhaustive(app, caps, alpha, beta, mu_star, r_cpu_star, r_mem_star) -> int:
    """Vectorized argmin over the full stable range (oracle for the ternary)."""
    l, r = sp2_bounds(app, caps, mu_star, r_cpu_star, r_mem_star)
    ns = torch.arange(l, r + 1, dtype=F64)
    vals = phi(app, caps, alpha, beta, ns, mu_star, r_cpu_star)
    return int(ns[int(torch.argmin(vals))])


# ----------------------------------------------------------------------------
# P1 — constrained joint reallocation (N fixed) — interior-point Newton
# ----------------------------------------------------------------------------
def _find_feasible_start(apps, caps, n, c_hint=None):
    """Phase-1 heuristic (B=1 view of engine.find_feasible_start_batch).
    Returns (x0, ok)."""
    x0, ok = find_feasible_start_batch(
        as_packed(apps), caps, np.asarray(n, dtype=float)[None, :], c_hint=c_hint
    )
    if not ok[0]:
        return None, False
    return x0[0], True


def p1_solve(
    apps: Sequence[App],
    caps: ServerCaps,
    n,
    alpha: float,
    beta: float,
    c_hint=None,
    solver: str = "structured",
    seed_grid: bool = False,
    device=None,
) -> P1Result:
    """Solve Problem P1 (Eq. 26) with N fixed — the B=1 case of the batched
    engine. ``solver`` picks the Newton direction ("structured" / "dense");
    ``seed_grid`` derives the phase-1 CPU hint from the coarse utility grid
    sweep."""
    batch = p1_solve_batch(
        as_packed(apps), caps, np.asarray(n, dtype=float)[None, :], alpha, beta,
        c_hint=c_hint, solver=solver, seed_grid=seed_grid, device=device,
    )
    return batch.row(0)


def p1_solve_scipy(apps, caps, n, alpha, beta, c_hint=None, device=None) -> P1Result:
    """Cross-check path using scipy SLSQP (the paper's own solver choice),
    with the objective's gradient from torch autograd."""
    from scipy.optimize import minimize

    dev = resolve_device(device)
    packed = as_packed(apps).as_dict(dev)
    n_arr = f64(np.asarray(n, dtype=float), dev)
    M = len(apps)
    x0, ok = _find_feasible_start(apps, caps, n, c_hint=c_hint)
    if not ok:
        return P1Result(np.zeros(M), np.array([a.r_min for a in apps]), float("inf"), False,
                        {"reason": "no_feasible_start"})

    def fun(x):
        return p1_objective(x, packed, n_arr, caps.r_cpu, caps.r_mem, caps.power.span,
                            alpha, beta)

    def f(x):
        return float(fun(f64(x, dev)))

    def g(x):
        xt = f64(x, dev).requires_grad_(True)
        (grad,) = torch.autograd.grad(fun(xt), xt)
        return grad.cpu().numpy()

    cons = [
        {"type": "ineq", "fun": lambda x: caps.r_cpu - float(np.sum(np.asarray(n) * x[:M]))},
        {"type": "ineq", "fun": lambda x: caps.r_mem - float(np.sum(np.asarray(n) * x[M:]))},
    ]
    bounds = [(a.cpu_min, a.cpu_max) for a in apps] + [(a.r_min, a.r_max) for a in apps]
    res = minimize(f, x0, jac=g, method="SLSQP", bounds=bounds, constraints=cons,
                   options={"maxiter": 200, "ftol": 1e-12})
    c, m = res.x[:M], res.x[M:]
    return P1Result(r_cpu=c, r_mem=m, utility=float(res.fun), converged=bool(res.success),
                    info={"scipy": res.message})
