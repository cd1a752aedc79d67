"""Problem P (paper §IV-C): joint latency+energy MINLP over container configs.

    min_{N_i, r_cpu_i, r_mem_i}  Σ_i  α·Ws(N_i, λ_i, μ_i) + β·ΔP_i/λ_i
    s.t.  Σ N_i r_cpu_i ≤ R̄cpu,  Σ N_i r_mem_i ≤ R̄mem,
          r_min_i ≤ r_mem_i ≤ r_max_i.

Latency d is in ms (perf_model), Ws in seconds, power in W. μ = 1000/(x̄·d).
The per-app terms are evaluated for all apps at once on ``device``; sums over
apps are taken in app order, as a sequential loop would.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import queueing
from repro_torch.core.perf_model import eq1_latency
from repro_torch.core.power import EDGE_POWER, PowerModel, delta_power
from repro_torch.device import f64, resolve_device


@dataclasses.dataclass(frozen=True)
class App:
    """One heterogeneous application (paper: a container cluster workload)."""

    name: str
    lam: float  # request arrival rate [req/s]
    xbar: float  # mean images per request
    kappa: tuple  # (k1, k2, k3) of Eq. (1), k1>0 convention
    r_min: float  # memory lower bound [GB] (OOM threshold)
    r_max: float  # memory saturation point [GB]
    cpu_min: float = 0.05  # smallest meaningful CPU quota [cores]
    cpu_max: float = 16.0  # largest per-container quota [cores]

    def with_lam(self, lam: float) -> "App":
        return dataclasses.replace(self, lam=lam)

    def with_xbar(self, xbar: float) -> "App":
        return dataclasses.replace(self, xbar=xbar)


@dataclasses.dataclass(frozen=True)
class ServerCaps:
    """Global resource budget (edge server)."""

    r_cpu: float  # total CPU capacity [cores]
    r_mem: float  # total memory [GB]
    power: PowerModel = EDGE_POWER


@dataclasses.dataclass
class Allocation:
    """A full solution to Problem P."""

    n: np.ndarray  # (M,) int container counts
    r_cpu: np.ndarray  # (M,) per-container CPU quota
    r_mem: np.ndarray  # (M,) per-container memory [GB]
    utility: float = np.nan
    ws: np.ndarray | None = None  # (M,) per-app response time [s]
    power_w: np.ndarray | None = None  # (M,) per-app incremental power [W]
    feasible: bool = True
    stable: bool = True
    meta: dict = dataclasses.field(default_factory=dict)

    def total_cpu(self) -> float:
        return float(np.sum(self.n * self.r_cpu))

    def total_mem(self) -> float:
        return float(np.sum(self.n * self.r_mem))


def _app_field(apps, name, dev):
    return f64([getattr(a, name) for a in apps], dev)


def latency_ms(app: App, r_cpu, r_mem, device=None):
    """Eq. (1) per-image latency for an app at a given allocation."""
    dev = resolve_device(device)
    return eq1_latency(f64(app.kappa, dev), f64(r_cpu, dev), f64(r_mem, dev))


def service_rate(app: App, r_cpu, r_mem, device=None):
    """Eq. (6): μ = 1/(x̄ d) with d converted ms→s."""
    d_s = latency_ms(app, r_cpu, r_mem, device) * 1e-3
    return 1.0 / (app.xbar * d_s)


def _service_rates(apps, r_cpu, r_mem, dev):
    """Eq. (6) for every app at once: (M,) float64 on ``dev``."""
    kap = f64([a.kappa for a in apps], dev)
    d_s = eq1_latency(kap.T, f64(r_cpu, dev), f64(r_mem, dev)) * 1e-3
    return 1.0 / (_app_field(apps, "xbar", dev) * d_s)


def app_terms(app: App, n, r_cpu, r_mem, caps: ServerCaps, alpha: float, beta: float,
              tail_q: float = 0.0, device=None):
    """Returns (ws_seconds, dP_watts, utility_term) for one app. ``tail_q``
    swaps the latency factor for the analytic response-time quantile
    surrogate; 0.0 keeps the paper's mean Ws."""
    mu = service_rate(app, r_cpu, r_mem, device)
    if tail_q:
        ws = queueing.erlang_wait_quantile(n, app.lam, mu, q=tail_q)
    else:
        ws = queueing.erlang_ws(n, app.lam, mu)
    dp = delta_power(n, r_cpu, caps.r_cpu, caps.power)
    term = alpha * ws + beta * dp / app.lam
    return ws, dp, term


def p95_surrogate_s(apps: Sequence[App], n, r_cpu, r_mem, q: float = 0.95,
                    device=None) -> np.ndarray:
    """Per-app analytic response-time quantile surrogate at an allocation.
    +inf for unstable apps."""
    mu = _service_rates(apps, r_cpu, r_mem, resolve_device(device)).tolist()
    n = np.asarray(n)
    return np.asarray(
        [queueing.erlang_wait_quantile_np(int(n[i]), a.lam, mu[i], q=q)
         for i, a in enumerate(apps)],
        dtype=float,
    )


def utility(
    apps: Sequence[App],
    n,
    r_cpu,
    r_mem,
    caps: ServerCaps,
    alpha: float,
    beta: float,
    weights: Sequence[float] | None = None,
    tail_q: float = 0.0,
    device=None,
):
    """Objective U_p of Eq. (8). Returns (U_p, per-app Ws, per-app ΔP).

    ``weights``: optional per-app priority weights w_i scaling the latency
    term to α·w_i·Ws_i; None keeps the paper's unweighted objective.
    ``tail_q``: quantile-surrogate latency term (0.0 = mean)."""
    dev = resolve_device(device)
    n_t, c_t = f64(np.asarray(n, dtype=float), dev), f64(r_cpu, dev)
    lam = _app_field(apps, "lam", dev)
    mu = _service_rates(apps, c_t, r_mem, dev)
    if tail_q:
        ws = queueing.erlang_wait_quantile(n_t, lam, mu, q=tail_q)
    else:
        ws = queueing.erlang_ws(n_t, lam, mu)
    dp = delta_power(n_t, c_t, caps.r_cpu, caps.power)
    a = alpha if weights is None else f64(alpha * np.asarray(weights, dtype=float), dev)
    terms = a * ws + beta * dp / lam
    total = 0.0
    for term in terms.tolist():  # app order, as the per-app reference loop
        total = total + term
    return total, ws, dp


def check_feasible(apps, n, r_cpu, r_mem, caps: ServerCaps, tol: float = 1e-6,
                   device=None):
    """Constraints (9)-(11) + queue stability. Returns dict of booleans."""
    n = np.asarray(n)
    r_cpu = np.asarray(r_cpu)
    r_mem = np.asarray(r_mem)
    cpu_ok = float(np.sum(n * r_cpu)) <= caps.r_cpu * (1 + tol)
    mem_ok = float(np.sum(n * r_mem)) <= caps.r_mem * (1 + tol)
    bounds_ok = all(
        (a.r_min - tol <= m <= a.r_max + tol) and (c > 0) for a, c, m in zip(apps, r_cpu, r_mem)
    )
    mu = _service_rates(apps, r_cpu, r_mem, resolve_device(device)).tolist()
    stable = all(app.lam < nn * mu_i for app, nn, mu_i in zip(apps, n, mu))
    return {
        "cpu": cpu_ok,
        "mem": mem_ok,
        "bounds": bounds_ok,
        "stable": stable,
        "all": cpu_ok and mem_ok and bounds_ok,
    }


def evaluate(apps, n, r_cpu, r_mem, caps, alpha, beta, weights=None,
             tail_q: float = 0.0, device=None) -> Allocation:
    """Package a candidate solution with metrics + feasibility flags.
    ``tail_q`` makes ``utility`` the quantile-surrogate objective while the
    ``ws`` field KEEPS the mean response; the per-app surrogate lands in
    ``meta["p95_surrogate_s"]``."""
    dev = resolve_device(device)
    u, ws, dp = utility(apps, n, r_cpu, r_mem, caps, alpha, beta, weights=weights,
                        tail_q=tail_q, device=dev)
    feas = check_feasible(apps, n, r_cpu, r_mem, caps, device=dev)
    meta = {}
    if tail_q:
        _, ws_mean, _ = utility(apps, n, r_cpu, r_mem, caps, alpha, beta,
                                weights=weights, device=dev)
        meta["p95_surrogate_s"] = ws.cpu().numpy().astype(float).tolist()
        meta["tail_q"] = float(tail_q)
        ws = ws_mean
    return Allocation(
        n=np.asarray(n, dtype=int),
        r_cpu=np.asarray(r_cpu, dtype=float),
        r_mem=np.asarray(r_mem, dtype=float),
        utility=float(u),
        ws=ws.cpu().numpy().astype(float),
        power_w=dp.cpu().numpy().astype(float),
        feasible=feas["all"],
        stable=feas["stable"],
        meta=meta,
    )
