"""M/M/N queueing (Eqs. 4-7 of the paper) in float64 torch, log-space and
differentiable under autograd.

Every function broadcasts over its inputs' leading dimensions (the batch the
reference obtains with ``vmap``) and accepts Python numbers or tensors; the
result lies on the device of the first tensor argument (CPU for plain
numbers). ``N`` may be fractional (the continuous extension via
Gamma(N+1)); the sum over k=0..N-1 is a masked fixed-width logsumexp.

Conventions
-----------
lam : request arrival rate [req/s]
mu  : per-container service rate [req/s]  (mu = 1000/(xbar * d_ms), Eq. 6)
N   : container count
rho : lam / (N mu) — must be < 1 for stability; unstable inputs return +inf.
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64

# Fixed width of the masked k-sum. Edge scenarios use N <= ~64.
MAX_SERVERS = 512


def _f64(*xs):
    """Broadcast float64 tensors on the device of the first tensor input."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return torch.broadcast_tensors(*(torch.as_tensor(x, dtype=F64, device=dev) for x in xs))


def _log_sum_k(N, log_a, width: int | None = None):
    """log Σ_{k=0}^{N-1} a^k / k!  as a masked logsumexp (fixed width).

    ``width`` narrows the masked sum from MAX_SERVERS (the default) to a
    caller-chosen width. EXACT whenever N <= width: masked terms contribute
    exp(-inf) = 0 to the logsumexp."""
    ks = torch.arange(MAX_SERVERS if width is None else width, dtype=log_a.dtype,
                      device=log_a.device)
    logs = ks * log_a[..., None] - torch.lgamma(ks + 1.0)
    logs = torch.where(ks < N[..., None], logs, -math.inf)
    return torch.logsumexp(logs, dim=-1)


def _head_tail(N, lam, mu, width, rho_cap):
    """(log_a, rho, rho_s, log_head, log_tail) shared by the Erlang forms."""
    log_a = torch.log(lam) - torch.log(mu)
    rho = lam / (N * mu)
    rho_s = torch.clamp(rho, max=rho_cap)
    log_head = _log_sum_k(N, log_a, width)
    log_tail = N * log_a - torch.lgamma(N + 1.0) - torch.log1p(-rho_s)
    return log_a, rho, rho_s, log_head, log_tail


def erlang_pi0(N, lam, mu, width: int | None = None):
    """pi0 of Eq. (5): probability of an empty M/M/N system (log-space)."""
    N, lam, mu = _f64(N, lam, mu)
    _, _, _, log_head, log_tail = _head_tail(N, lam, mu, width, 1.0 - 1e-9)
    return torch.exp(-torch.logaddexp(log_head, log_tail))


def _erlang_log_lq(N, lam, mu, width: int | None = None):
    """log Lq where Lq = pi0 * a^N * rho / (N! (1-rho)^2)   (queue part of Eq. 4)."""
    N, lam, mu = _f64(N, lam, mu)
    log_a, rho, rho_s, log_head, log_tail = _head_tail(N, lam, mu, width, 1.0 - 1e-9)
    log_pi0 = -torch.logaddexp(log_head, log_tail)
    log_lq = (
        N * log_a
        - torch.lgamma(N + 1.0)
        + torch.log(rho_s)
        - 2.0 * torch.log1p(-rho_s)
        + log_pi0
    )
    return log_lq, rho, lam, mu


def erlang_ls(N, lam, mu, width: int | None = None):
    """Eq. (4): expected number of requests in the system. +inf when rho >= 1."""
    log_lq, rho, lam, mu = _erlang_log_lq(N, lam, mu, width)
    ls = torch.exp(log_lq) + lam / mu
    return torch.where(rho < 1.0, ls, math.inf)


def erlang_ws(N, lam, mu, width: int | None = None):
    """Eq. (7): expected response time per request (Little's law). +inf if
    unstable. ``width`` narrows the masked k-sum (exact for N <= width)."""
    _, lam, _ = _f64(N, lam, mu)
    return erlang_ls(N, lam, mu, width) / lam


def erlang_ws_derivs(N, lam, mu, width: int | None = None):
    """Closed-form (Ws, dWs/dmu, d²Ws/dmu²) on the stable region, for the
    structured Newton path of the P1 solver.

    Uses the Erlang-C identity Lq = C·rho/(1-rho) with C the probability of
    waiting and the exact a-derivatives

        dC/da  = C·[(1-rho)/rho + (1-C)/(N(1-rho))]
        dLq/da = C'·rho/(1-rho) + C/(N(1-rho)²)

    (valid for integer N), chained through a = lam/mu. Ws = Lq/lam + 1/mu.
    Unstable inputs (rho >= 1) return +inf value with unspecified
    derivatives."""
    N, lam, mu = _f64(N, lam, mu)
    a = lam / mu
    rho = a / N
    rho_s = torch.clamp(rho, max=1.0 - 1e-9)
    one_m = 1.0 - rho_s  # (1 - rho), the only small quantity here
    log_a = torch.log(lam) - torch.log(mu)
    log_head = _log_sum_k(N, log_a, width)
    log_tail = N * log_a - torch.lgamma(N + 1.0) - torch.log(one_m)
    C = torch.exp(log_tail - torch.logaddexp(log_head, log_tail))

    lq = C * rho_s / one_m
    # first derivatives w.r.t. a
    h = one_m / rho_s + (1.0 - C) / (N * one_m)
    dC = C * h
    dlq = dC * rho_s / one_m + C / (N * one_m**2)
    # second derivatives w.r.t. a
    dh = -N / a**2 + (-dC * one_m + (1.0 - C) / N) / (N * one_m**2)
    d2C = dC * h + C * dh
    d2lq = d2C * rho_s / one_m + 2.0 * dC / (N * one_m**2) + 2.0 * C / (N**2 * one_m**3)

    # chain rule through a(mu) = lam/mu:  da/dmu = -a/mu, d²a/dmu² = 2a/mu²
    ws = lq / lam + 1.0 / mu
    dws = -dlq * a / (mu * lam) - 1.0 / mu**2
    d2ws = (d2lq * (a / mu) ** 2 + dlq * 2.0 * a / mu**2) / lam + 2.0 / mu**3
    ws = torch.where(rho < 1.0, ws, math.inf)
    return ws, dws, d2ws


def erlang_wait_prob(N, lam, mu, width: int | None = None):
    """Erlang-C probability of waiting C = P(W_q > 0); 1.0 on the unstable
    branch (every request waits)."""
    N, lam, mu = _f64(N, lam, mu)
    _, rho, _, log_head, log_tail = _head_tail(N, lam, mu, width, 1.0 - 1e-9)
    C = torch.exp(log_tail - torch.logaddexp(log_head, log_tail))
    return torch.where(rho < 1.0, C, 1.0)


def erlang_wait_quantile(N, lam, mu, q: float = 0.95, width: int | None = None):
    """Analytic q-quantile surrogate for the M/M/N response time:

        T_q ≈ Ws + max(ln(C/(1−q)), 0) / (Nμ − λ)

    +inf on the unstable branch. Differentiable in lam/mu on the stable
    region (C's dependence included)."""
    N, lam, mu = _f64(N, lam, mu)
    rho = lam / (N * mu)
    ws = erlang_ws(N, lam, mu, width)
    C = erlang_wait_prob(N, lam, mu, width)
    gap = torch.clamp(N * mu - lam, min=1e-300)
    L = torch.clamp(torch.log(C) - math.log1p(-q), min=0.0)
    return torch.where(rho < 1.0, ws + L / gap, math.inf)


def erlang_wait_quantile_derivs(N, lam, mu, q: float = 0.95,
                                width: int | None = None):
    """(T_q, dT_q/dmu, d²T_q/dmu²) for the structured Newton path, with the
    Erlang-C coefficient FROZEN: d(L/g)/dμ = −L·N/g², d²(L/g)/dμ² = 2·L·N²/g³
    with g = Nμ−λ and L = max(ln(C/(1−q)), 0) held as data."""
    ws, dws, d2ws = erlang_ws_derivs(N, lam, mu, width)
    N, lam, mu = _f64(N, lam, mu)
    C = erlang_wait_prob(N, lam, mu, width)
    g = torch.clamp(N * mu - lam, min=1e-300)
    L = torch.clamp(torch.log(C) - math.log1p(-q), min=0.0)
    T = ws + L / g
    dT = dws - L * N / g**2
    d2T = d2ws + 2.0 * L * N**2 / g**3
    return T, dT, d2T


def erlang_ws_finite(N, lam, mu, cap: float = 1e9):
    """Ws with the unstable branch mapped to a large finite cap."""
    ws = erlang_ws(N, lam, mu)
    return torch.where(torch.isfinite(ws), ws, cap)


def stability_lower_bound(lam, mu) -> int:
    """Smallest integer N with lam < N*mu (paper uses ceil(lam/mu); we bump the
    exact-integer case where rho would be exactly 1)."""
    ratio = float(lam) / float(mu)
    n = math.ceil(ratio)
    if n <= ratio + 1e-12:  # ratio integral -> rho == 1, not stable
        n += 1
    return max(n, 1)


# ----------------------------------------------------------------------------
# Scalar float64 versions (oracles for tests; mirror the formulas verbatim)
# ----------------------------------------------------------------------------
def erlang_ws_np(N: int, lam: float, mu: float) -> float:
    from math import exp, inf, lgamma, log

    a = lam / mu
    rho = lam / (N * mu)
    if rho >= 1.0:
        return inf
    log_a = log(a)
    head = [k * log_a - lgamma(k + 1) for k in range(int(N))]
    tail = N * log_a - lgamma(N + 1) - log(1.0 - rho)
    m = max(max(head), tail)
    log_denom = m + log(sum(exp(h - m) for h in head) + exp(tail - m))
    log_pi0 = -log_denom
    log_lq = N * log_a - lgamma(N + 1) + log(rho) - 2.0 * log(1.0 - rho) + log_pi0
    ls = exp(log_lq) + a
    return ls / lam


def erlang_wait_prob_np(N: int, lam: float, mu: float) -> float:
    """Scalar Erlang-C waiting probability (mirrors Eq. 5)."""
    from math import exp, fsum, lgamma, log

    a = lam / mu
    rho = lam / (N * mu)
    if rho >= 1.0:
        return 1.0
    log_a = log(a)
    head = [k * log_a - lgamma(k + 1) for k in range(int(N))]
    tail = N * log_a - lgamma(N + 1) - log(1.0 - rho)
    m = max(max(head), tail)
    return exp(tail - m) / (fsum(exp(h - m) for h in head) + exp(tail - m))


def erlang_wait_quantile_np(N: int, lam: float, mu: float, q: float = 0.95) -> float:
    """Scalar response-time quantile surrogate."""
    from math import inf, log

    rho = lam / (N * mu)
    if rho >= 1.0:
        return inf
    C = erlang_wait_prob_np(N, lam, mu)
    gap = N * mu - lam
    L = max(log(C / (1.0 - q)), 0.0)
    return erlang_ws_np(N, lam, mu) + L / gap
