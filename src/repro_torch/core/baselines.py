"""Baseline allocators from the paper's evaluation (§VI).

SNFC        — scale-number-fixed-config: per-container quotas fixed, only the
              pod count adapts (paper's sufficient-resource comparison;
              SNFC1: c=1.8, m=0.35GB; SNFC2: c=1.0, m=r_max).
RandomSearch— uniform sampling over (N, c, m) boxes [Bergstra-Bengio].
GPBO        — Gaussian-process Bayesian optimization with EI acquisition.
TPEBO       — tree-structured Parzen estimator BO.
DRF         — dominant-resource-fairness progressive filling.

All return ``problem.Allocation`` so benchmarks compare like-for-like.
Candidates are scored in float64 by ``batch_eval.evaluate_candidates`` on
``device`` (None: the CUDA device); the draws come from
``np.random.default_rng(seed)`` on the host and never depend on the scores,
and the GP posterior, the expected improvement and the TPE densities stay
NumPy/scipy on the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.batch_eval import evaluate_candidates
from repro_torch.core.engine import _eq1_np, as_packed
from repro_torch.core.problem import App, Allocation, ServerCaps, evaluate, service_rate
from repro_torch.core.solvers import phi, sp1_solve, sp2_bounds
from repro_torch.device import f64, resolve_device


# ----------------------------------------------------------------------------
# SNFC
# ----------------------------------------------------------------------------
def snfc(
    apps: Sequence[App],
    caps: ServerCaps,
    alpha: float,
    beta: float,
    r_cpu_fixed: float = 1.8,
    r_mem_fixed: float | str = 0.35,
    device=None,
) -> Allocation:
    """Fixed per-container config; choose each N by the same convex Φ search.
    r_mem_fixed='rmax' reproduces SNFC2. Quotas are clipped into each app's
    feasible memory interval (a container below r_min would OOM). Each app's
    Φ(N) candidates are one evaluation on ``device``."""
    dev = resolve_device(device)
    n, cs, ms, mus = [], [], [], []
    for app in apps:
        m = app.r_max if r_mem_fixed == "rmax" else float(np.clip(r_mem_fixed, app.r_min, app.r_max))
        c = float(r_cpu_fixed)
        mu = float(service_rate(app, c, m, device=dev))
        lo, hi = sp2_bounds(app, caps, mu, c, m)
        cand = np.arange(lo, hi + 1)
        vals = phi(app, caps, alpha, beta, f64(cand, dev), mu, c).cpu().numpy()
        n.append(int(cand[int(np.argmin(vals))]))
        cs.append(c)
        ms.append(m)
        mus.append(mu)
    # trim to fit global caps (drop containers from the least-loss app first)
    n = np.asarray(n, dtype=int)
    cs, ms = np.asarray(cs), np.asarray(ms)
    for _ in range(int(np.sum(n))):
        if np.sum(n * cs) <= caps.r_cpu and np.sum(n * ms) <= caps.r_mem:
            break
        losses = []
        for i, app in enumerate(apps):
            if n[i] <= 1:
                losses.append(np.inf)
                continue
            cur, dec = phi(app, caps, alpha, beta, f64([n[i], n[i] - 1], dev), mus[i],
                           cs[i]).tolist()
            losses.append(dec - cur)
        i = int(np.argmin(losses))
        if not np.isfinite(losses[i]):
            break
        n[i] -= 1
    return evaluate(apps, n, cs, ms, caps, alpha, beta, device=dev)


# ----------------------------------------------------------------------------
# Random search
# ----------------------------------------------------------------------------
def _n_from_delta(apps, delta, c, m):
    """Stability-aware parameterization shared by the search baselines: for
    quotas (c, m) the container count is N = (stability floor) + Δ, Δ ≥ 0.
    Sampling N directly makes the stable region measure-zero under tight
    budgets; every practical tuner encodes the queue constraint this way."""
    packed = as_packed(apps)
    d_ms = _eq1_np(packed.kappa, np.asarray(c, dtype=float), np.asarray(m, dtype=float))
    mu = 1000.0 / (packed.xbar * d_ms)
    n_min = np.floor(packed.lam / mu) + 1.0
    return n_min + np.round(np.asarray(delta))


def _sample_box(apps, caps, rng, size):
    M = len(apps)
    delta = rng.integers(0, 8, size=(size, M)).astype(float)
    c = rng.uniform(0.1, 3.0, size=(size, M))
    m = np.stack(
        [rng.uniform(a.r_min, a.r_max, size=size) for a in apps], axis=1
    )
    n = _n_from_delta(apps, delta, c, m)
    return n, c, m


def random_search(
    apps, caps: ServerCaps, alpha, beta, n_samples: int = 20000, seed: int = 0,
    device=None,
) -> Allocation:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    packed = as_packed(apps)
    n, c, m = _sample_box(apps, caps, rng, n_samples)
    u, _, _ = evaluate_candidates(packed, caps, n, c, m, alpha, beta, hard=True, device=dev)
    best = int(np.argmin(u))
    if not np.isfinite(u[best]):
        # all infeasible — fall back to minimal configs
        n0 = np.ones(len(apps), dtype=int)
        return evaluate(apps, n0, [a.cpu_min for a in apps], [a.r_min for a in apps], caps,
                        alpha, beta, device=dev)
    return evaluate(apps, n[best].astype(int), c[best], m[best], caps, alpha, beta, device=dev)


# ----------------------------------------------------------------------------
# GP Bayesian optimization
# ----------------------------------------------------------------------------
def _normalize(x, lo, hi):
    return (x - lo) / (hi - lo)


def _repair(apps, caps, n, c, m):
    """Project a candidate onto the budget: scale CPU quotas down to fit the
    CPU cap; walk memory toward each app's r_min to fit the memory cap."""
    n = np.asarray(n, dtype=float)
    c = np.asarray(c, dtype=float).copy()
    m = np.asarray(m, dtype=float).copy()
    cpu_used = float(np.sum(n * c))
    if cpu_used > caps.r_cpu:
        c *= caps.r_cpu / cpu_used * 0.999
    r_min = np.array([a.r_min for a in apps])
    mem_used = float(np.sum(n * m))
    if mem_used > caps.r_mem:
        # shrink the (m - r_min) headroom uniformly
        head = np.sum(n * (m - r_min))
        need = mem_used - caps.r_mem * 0.999
        if head > need > 0:
            m = r_min + (m - r_min) * (1.0 - need / head)
        else:
            m = r_min.copy()
    # if the container counts alone blow the memory budget, trim the largest
    # footprint (the result may lose stability — recorded honestly upstream)
    while float(np.sum(n * m)) > caps.r_mem * 0.999 and np.sum(n) > len(apps):
        i = int(np.argmax(n * m * (n > 1)))
        n[i] -= 1
    return n, c, m


def _search_box(packed):
    """The (Δ, c, m) box of the BO baselines, (3M,) lower and upper edges."""
    M = packed.M
    lo = np.concatenate([np.zeros(M), np.full(M, 0.1), packed.r_min])
    hi = np.concatenate([np.full(M, 8.0), np.full(M, 3.0), packed.r_max])
    return lo, hi


def _soft_scorer(packed, caps, alpha, beta, dev):
    """The soft-penalty utility of (B, 3M) points in (Δ, c, m) space (see
    _n_from_delta), so the surrogate models see a smooth landscape."""
    M = packed.M

    def eval_soft(X):
        delta, c, m = X[:, :M], X[:, M : 2 * M], X[:, 2 * M :]
        n = _n_from_delta(packed, delta, c, m)
        u, _, _ = evaluate_candidates(packed, caps, n, c, m, alpha, beta, hard=False,
                                      device=dev)
        return u

    return eval_soft


def _best_hard(apps, caps, alpha, beta, packed, X, y, dev) -> Allocation:
    """The best *hard-feasible* evaluated point; with none, the soft best
    projected onto the budget."""
    M = packed.M
    c_all, m_all = X[:, M : 2 * M], X[:, 2 * M :]
    n_all = _n_from_delta(packed, X[:, :M], c_all, m_all)
    u_hard, _, _ = evaluate_candidates(packed, caps, n_all, c_all, m_all, alpha, beta,
                                       hard=True, device=dev)
    if np.all(~np.isfinite(u_hard)):
        i = int(np.argmin(y))
        n_i, c_i, m_i = _repair(apps, caps, n_all[i], c_all[i], m_all[i])
        return evaluate(apps, n_i.astype(int), c_i, m_i, caps, alpha, beta, device=dev)
    i = int(np.argmin(u_hard))
    return evaluate(apps, n_all[i].astype(int), c_all[i], m_all[i], caps, alpha, beta,
                    device=dev)


def gpbo(
    apps,
    caps: ServerCaps,
    alpha,
    beta,
    n_init: int = 16,
    n_iters: int = 84,
    seed: int = 0,
    device=None,
) -> Allocation:
    """GP + expected-improvement over the 3M-dim (N, c, m) space. The objective
    uses the soft-penalty utility so the GP sees a smooth landscape."""
    from scipy.stats import norm

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    packed = as_packed(apps)
    M = packed.M
    lo, hi = _search_box(packed)
    eval_soft = _soft_scorer(packed, caps, alpha, beta, dev)

    X = rng.uniform(lo, hi, size=(n_init, 3 * M))
    y = eval_soft(X)

    ls = 0.2

    def gp_posterior(Xn, yn, Xq):
        def k(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / ls**2)

        K = k(Xn, Xn) + 1e-6 * np.eye(len(Xn))
        L = np.linalg.cholesky(K)
        alpha_v = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        Ks = k(Xn, Xq)
        mu = Ks.T @ alpha_v
        v = np.linalg.solve(L, Ks)
        var = np.maximum(1.0 - (v**2).sum(0), 1e-12)
        return mu, np.sqrt(var)

    for _ in range(n_iters):
        Xn = _normalize(X, lo, hi)
        mu_y, sd_y = float(np.mean(y)), float(np.std(y) + 1e-9)
        yn = (y - mu_y) / sd_y
        cand = rng.uniform(lo, hi, size=(512, 3 * M))
        best_idx = int(np.argmin(y))
        local = X[best_idx] + rng.normal(0, 0.05, size=(64, 3 * M)) * (hi - lo)
        cand = np.vstack([cand, np.clip(local, lo, hi)])
        mu_c, sd_c = gp_posterior(Xn, yn, _normalize(cand, lo, hi))
        y_best = yn.min()
        z = (y_best - mu_c) / sd_c
        ei = sd_c * (z * norm.cdf(z) + norm.pdf(z))
        x_next = cand[int(np.argmax(ei))]
        X = np.vstack([X, x_next])
        y = np.concatenate([y, eval_soft(x_next[None])])

    return _best_hard(apps, caps, alpha, beta, packed, X, y, dev)


# ----------------------------------------------------------------------------
# TPE Bayesian optimization
# ----------------------------------------------------------------------------
def tpebo(
    apps,
    caps: ServerCaps,
    alpha,
    beta,
    n_init: int = 16,
    n_iters: int = 84,
    gamma: float = 0.25,
    seed: int = 0,
    device=None,
) -> Allocation:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    packed = as_packed(apps)
    M = packed.M
    lo, hi = _search_box(packed)
    eval_soft = _soft_scorer(packed, caps, alpha, beta, dev)

    X = rng.uniform(lo, hi, size=(n_init, 3 * M))
    y = eval_soft(X)

    def kde_logpdf(samples, query):
        # per-dim product of Gaussian KDEs (Scott's bandwidth), normalized space
        s = _normalize(samples, lo, hi)
        q = _normalize(query, lo, hi)
        nS, D = s.shape
        bw = max(nS ** (-1.0 / (D + 4)), 0.08)
        lp = np.zeros(len(q))
        for d in range(D):
            diff = (q[:, None, d] - s[None, :, d]) / bw
            comp = -0.5 * diff**2 - np.log(bw * np.sqrt(2 * np.pi))
            lp += np.logaddexp.reduce(comp, axis=1) - np.log(nS)
        return lp

    for _ in range(n_iters):
        order = np.argsort(y)
        n_good = max(2, int(np.ceil(gamma * len(y))))
        good, bad = X[order[:n_good]], X[order[n_good:]]
        # sample candidates from the good KDE (perturbed good points)
        base = good[rng.integers(0, len(good), size=64)]
        cand = np.clip(base + rng.normal(0, 0.1, size=base.shape) * (hi - lo), lo, hi)
        score = kde_logpdf(good, cand) - kde_logpdf(bad, cand)
        x_next = cand[int(np.argmax(score))]
        X = np.vstack([X, x_next])
        y = np.concatenate([y, eval_soft(x_next[None])])

    return _best_hard(apps, caps, alpha, beta, packed, X, y, dev)


# ----------------------------------------------------------------------------
# DRF — dominant resource fairness (progressive filling)
# ----------------------------------------------------------------------------
def drf(apps, caps: ServerCaps, alpha, beta, device=None) -> Allocation:
    """Progressive filling on dominant shares. Each grant = one container at the
    app's sufficient-resource quota. May leave apps unstable (ρ≥1) — exactly the
    pathology the paper reports for APP2/APP4."""
    dev = resolve_device(device)
    M = len(apps)
    demands = [sp1_solve(app, caps, alpha, beta, device=dev) for app in apps]
    n = np.zeros(M, dtype=int)
    cpu_left, mem_left = caps.r_cpu, caps.r_mem
    while True:
        shares = [
            max(n[i] * demands[i][0] / caps.r_cpu, n[i] * demands[i][1] / caps.r_mem)
            for i in range(M)
        ]
        order = np.argsort(shares)
        granted = False
        for i in order:
            c_i, m_i = demands[i]
            if c_i <= cpu_left and m_i <= mem_left:
                n[i] += 1
                cpu_left -= c_i
                mem_left -= m_i
                granted = True
                break
        if not granted:
            break
    n = np.maximum(n, 1)
    cs = np.array([d[0] for d in demands])
    ms = np.array([d[1] for d in demands])
    return evaluate(apps, n, cs, ms, caps, alpha, beta, device=dev)
