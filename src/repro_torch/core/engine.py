"""Batched allocation engine: one packed-apps representation and batched
solver paths shared by the whole stack, in float64 torch.

The first-class unit of work is a *batch of candidate allocations*: a (B, M)
matrix of per-app container counts, solved jointly as one leading tensor
dimension.

PackedApps
    The single array-of-structs packing of an ``App`` sequence (NumPy), with
    a cached dict of float64 tensors per device.
find_feasible_start_batch
    The P1 phase-1 heuristic (memory waterfill + CPU scaling + stability
    repair) vectorized in NumPy over the batch; infeasible rows are masked
    out rather than short-circuited.
p1_solve_batch
    The log-barrier interior-point Newton of Theorem 4 over the whole batch
    at once. Serial ``solvers.p1_solve`` is the B=1 special case of this
    path, so the batched and serial solvers cannot drift apart.
ideal_configs_batch
    Algorithm 1's inner solves — the SP1 bisection-on-dF/dc and the SP2
    integer argmin over Φ(N) — batched over apps.
ip_solve_rows
    The same interior point over a stack of FULL per-row problems (each row
    its own packing, sentinel mask and budgets): the fleet placement layer's
    inner engine.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.core.perf_model import eq1_latency
from repro_torch.core.problem import App, ServerCaps
from repro_torch.device import F64, f64, resolve_device


# ----------------------------------------------------------------------------
# PackedApps — the shared array-of-structs representation
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PackedApps:
    """Array-of-structs packing of a Sequence[App] (all float64 NumPy)."""

    kappa: np.ndarray  # (M, 3) Eq.(1) parameters
    lam: np.ndarray  # (M,) arrival rates [req/s]
    xbar: np.ndarray  # (M,) work units per request
    r_min: np.ndarray  # (M,) memory floor [GB]
    r_max: np.ndarray  # (M,) memory saturation [GB]
    cpu_min: np.ndarray  # (M,) smallest CPU quota
    cpu_max: np.ndarray  # (M,) largest CPU quota

    @classmethod
    def from_apps(cls, apps: Sequence[App]) -> "PackedApps":
        return cls(
            kappa=np.asarray([a.kappa for a in apps], dtype=np.float64),
            lam=np.asarray([a.lam for a in apps], dtype=np.float64),
            xbar=np.asarray([a.xbar for a in apps], dtype=np.float64),
            r_min=np.asarray([a.r_min for a in apps], dtype=np.float64),
            r_max=np.asarray([a.r_max for a in apps], dtype=np.float64),
            cpu_min=np.asarray([a.cpu_min for a in apps], dtype=np.float64),
            cpu_max=np.asarray([a.cpu_max for a in apps], dtype=np.float64),
        )

    @property
    def M(self) -> int:
        return int(self.lam.shape[0])

    @cached_property
    def _tensors(self) -> dict:
        return {}  # device -> {field: float64 tensor}, filled on first use

    def as_dict(self, device) -> dict:
        """The fields as float64 tensors on ``device`` (cached: pack once,
        solve many). A fresh dict over the cached leaves, so callers may
        rebind keys without poisoning the shared packing."""
        dev = torch.device(device)
        if dev not in self._tensors:
            self._tensors[dev] = {
                f.name: f64(getattr(self, f.name), dev) for f in dataclasses.fields(self)
            }
        return dict(self._tensors[dev])


def as_packed(apps) -> PackedApps:
    """Coerce a Sequence[App] (or an already-packed instance) to PackedApps."""
    return apps if isinstance(apps, PackedApps) else PackedApps.from_apps(apps)


def _eq1_np(kappa: np.ndarray, c, m):
    """Eq. (1) in NumPy, broadcasting kappa (..., M, 3) against (..., M) quotas."""
    k1, k2, k3 = kappa[..., 0], kappa[..., 1], kappa[..., 2]
    return k1 / (1.0 - np.exp(-k2 * c)) + np.exp(k3 / m)


def _mask_counts(packed, n):
    """(n_eff, n_ws) under the optional packed["mask"] sentinel-slot pattern:
    masked slots (mask = 0) carry n = 0 for the budgets and power, and 1
    server for the Erlang-C evaluations so they stay finite."""
    mask = packed.get("mask") if isinstance(packed, dict) else None
    if mask is None:
        return n, n
    return n * mask, torch.where(mask > 0, n, torch.ones_like(n))


def _alpha_arg(alpha):
    """Normalize the latency weight: a scalar becomes a Python float, a
    per-app priority-weighted (M,) vector a float64 array — every objective
    and derivative expression multiplies alpha elementwise against per-app
    terms, so the vector form broadcasts unchanged."""
    a = np.asarray(alpha, dtype=float)
    return float(a) if a.ndim == 0 else a


def alpha_tensor(alpha, device):
    """``_alpha_arg`` with a vector alpha as a float64 tensor on ``device``."""
    a = _alpha_arg(alpha)
    return a if isinstance(a, float) else f64(a, device)


# ----------------------------------------------------------------------------
# P1 objective / barrier (Theorem 4) — batched over leading dimensions of x
# ----------------------------------------------------------------------------
def _split(x, packed):
    M = packed["lam"].shape[-1]  # the last axis: a row stack's fields are (N, M)
    return x[..., :M], x[..., M:]


def _per_app(cap):
    """A budget as a factor of per-app terms: a scalar as it is, a per-row
    (N,) budget of the row-wise solve as (N, 1)."""
    return cap[..., None] if isinstance(cap, torch.Tensor) and cap.ndim else cap


def _mu(packed, c, m):
    kap = packed["kappa"]
    d_ms = eq1_latency((kap[..., 0], kap[..., 1], kap[..., 2]), c, m)
    return 1000.0 / (packed["xbar"] * d_ms)


def p1_objective(x, packed, n, caps_cpu, caps_mem, power_span, alpha, beta,
                 width: int | None = None, tail_q: float = 0.0):
    """Σ_i α Ws_i + β ΔP_i/λ_i as a function of x = [c_1..c_M, m_1..m_M]
    (any leading batch dimensions). Honors the optional ``packed["mask"]``
    sentinel slots and the optional Erlang sum ``width``; ``tail_q`` swaps the
    latency term for the analytic response-time quantile surrogate."""
    c, m = _split(x, packed)
    mask = packed.get("mask")
    n_eff, n_ws = _mask_counts(packed, n)
    mu = _mu(packed, c, m)
    lam = packed["lam"].expand(mu.shape)
    if tail_q:
        ws = queueing.erlang_wait_quantile(n_ws, lam, mu, q=tail_q, width=width)
    else:
        ws = queueing.erlang_ws(n_ws, lam, mu, width=width)
    dp = power_span * n_eff * c / _per_app(caps_cpu)
    terms = alpha * ws + beta * dp / packed["lam"]
    if mask is not None:
        terms = torch.where(mask > 0, terms, 0.0)
    return torch.sum(terms, dim=-1)


def p1_slacks(x, packed, n, caps_cpu, caps_mem):
    """The barrier constraint slacks (budgets, memory box, CPU floor) — one
    definition shared by the barrier value and the line search's cheap
    feasibility check. Shape (..., 2 + 3M)."""
    c, m = _split(x, packed)
    n_eff, _ = _mask_counts(packed, n)
    s_cpu = caps_cpu - torch.sum(n_eff * c, dim=-1)
    s_mem = caps_mem - torch.sum(n_eff * m, dim=-1)
    return torch.cat(
        [s_cpu[..., None], s_mem[..., None], m - packed["r_min"], packed["r_max"] - m,
         c - packed["cpu_min"]],
        dim=-1,
    )


def p1_barrier(x, t, packed, n, caps_cpu, caps_mem, power_span, alpha, beta,
               width: int | None = None, tail_q: float = 0.0):
    f = p1_objective(x, packed, n, caps_cpu, caps_mem, power_span, alpha, beta,
                     width, tail_q)
    slacks = p1_slacks(x, packed, n, caps_cpu, caps_mem)
    barrier = -torch.sum(torch.log(slacks), dim=-1)
    return t * f + barrier, slacks


def p1_rho(x, packed, n):
    c, m = _split(x, packed)
    mask = packed.get("mask")
    _, n_ws = _mask_counts(packed, n)
    rho = packed["lam"] / (n_ws * _mu(packed, c, m))
    # masked slots report rho = 0 so the stability predicate never freezes a
    # whole row on a sentinel lane
    return rho if mask is None else torch.where(mask > 0, rho, 0.0)


_NEWTON_DAMP = 1e-9  # diagonal damping shared by the dense and structured paths


def _newton_direction_structured(x, t, packed, n, caps_cpu, caps_mem, power_span, alpha,
                                 beta, width: int | None = None, tail_q: float = 0.0):
    """Analytic Newton direction H⁻¹g for the P1 barrier in O(M) per row.

    The objective and all box barriers are separable per app — each (c_i,
    m_i) pair contributes one 2×2 block — and only the two budget barriers
    couple apps, each as a rank-1 term (1/s²)·nnᵀ on its own resource block:

        H = B + uuᵀ + vvᵀ,   B block-diagonal (2×2), u = [n/s_cpu; 0],
                             v = [0; n/s_mem]

    so H⁻¹g follows from per-app 2×2 solves plus a 2×2 Woodbury capacitance
    solve. All derivatives are closed-form (Eq. (1), mu = 1000/(x̄ d), Erlang-C
    Ws via queueing.erlang_ws_derivs, the linear power term, the log
    barriers); with the same _NEWTON_DAMP on the block diagonals this is the
    same damped-Hessian solve as the dense path."""
    c, m = _split(x, packed)
    kap = packed["kappa"]
    k1, k2, k3 = kap[..., 0], kap[..., 1], kap[..., 2]
    lam, xbar = packed["lam"], packed["xbar"]
    mask = packed.get("mask")
    n_eff, n_ws = _mask_counts(packed, n)

    # Eq. (1): d = k1/(1-e^{-k2 c}) + e^{k3/m}, separable so d_cm = 0
    e = torch.exp(-k2 * c)
    s = 1.0 - e
    B_m = torch.exp(k3 / m)
    d = k1 / s + B_m
    d_c = -k1 * k2 * e / s**2
    d_cc = k1 * k2**2 * e * (s + 2.0 * e) / s**3
    d_m = -(k3 / m**2) * B_m
    d_mm = B_m * (k3**2 / m**4 + 2.0 * k3 / m**3)

    # mu = K/d with K = 1000/x̄ (Eq. 6)
    K = 1000.0 / xbar
    mu = K / d
    mu_c = -K * d_c / d**2
    mu_m = -K * d_m / d**2
    mu_cc = K * (2.0 * d_c**2 / d**3 - d_cc / d**2)
    mu_mm = K * (2.0 * d_m**2 / d**3 - d_mm / d**2)
    mu_cm = 2.0 * K * d_c * d_m / d**3

    lam_b = lam.expand(mu.shape)
    if tail_q:
        # tail objective: frozen-Erlang-C quantile derivatives
        _, ws1, ws2 = queueing.erlang_wait_quantile_derivs(n_ws, lam_b, mu, q=tail_q,
                                                           width=width)
    else:
        _, ws1, ws2 = queueing.erlang_ws_derivs(n_ws, lam_b, mu, width=width)
    P = beta * power_span * n_eff / (_per_app(caps_cpu) * lam)  # linear power slope in c

    f_c = alpha * ws1 * mu_c + P
    f_m = alpha * ws1 * mu_m
    f_cc = alpha * (ws2 * mu_c**2 + ws1 * mu_cc)
    f_cm = alpha * (ws2 * mu_c * mu_m + ws1 * mu_cm)
    f_mm = alpha * (ws2 * mu_m**2 + ws1 * mu_mm)
    if mask is not None:
        # masked-slot objective terms are constants (0): drop their
        # derivatives so the frozen coordinates carry no pull
        f_c, f_m, f_cc, f_cm, f_mm = (v * mask for v in (f_c, f_m, f_cc, f_cm, f_mm))

    s_cpu = (caps_cpu - torch.sum(n_eff * c, dim=-1))[..., None]
    s_mem = (caps_mem - torch.sum(n_eff * m, dim=-1))[..., None]
    sc_lo = c - packed["cpu_min"]
    sm_lo = m - packed["r_min"]
    sm_hi = packed["r_max"] - m

    g_c = t * f_c + n_eff / s_cpu - 1.0 / sc_lo
    g_m = t * f_m + n_eff / s_mem - 1.0 / sm_lo + 1.0 / sm_hi

    bcc = t * f_cc + 1.0 / sc_lo**2 + _NEWTON_DAMP
    bmm = t * f_mm + 1.0 / sm_lo**2 + 1.0 / sm_hi**2 + _NEWTON_DAMP
    bcm = t * f_cm
    det = bcc * bmm - bcm**2

    def bsolve(rc, rm):  # per-app 2×2 solve B_i y_i = r_i, vectorized over apps
        return (bmm * rc - bcm * rm) / det, (bcc * rm - bcm * rc) / det

    u = n_eff / s_cpu  # rank-1 factors of the two budget-barrier Hessians
    v = n_eff / s_mem
    yg_c, yg_m = bsolve(g_c, g_m)
    yu_c, yu_m = bsolve(u, torch.zeros_like(u))
    yv_c, yv_m = bsolve(torch.zeros_like(v), v)

    def dot(p, q):
        return torch.sum(p * q, dim=-1, keepdim=True)

    # 2×2 capacitance solve: (I + Uᵀ B⁻¹ U) w = Uᵀ B⁻¹ g, U = [u | v]
    S11 = 1.0 + dot(u, yu_c)
    S12 = dot(u, yv_c)
    S21 = dot(v, yu_m)
    S22 = 1.0 + dot(v, yv_m)
    bu = dot(u, yg_c)
    bv = dot(v, yg_m)
    detS = S11 * S22 - S12 * S21
    w1 = (S22 * bu - S12 * bv) / detS
    w2 = (S11 * bv - S21 * bu) / detS
    dx_c = yg_c - (yu_c * w1 + yv_c * w2)
    dx_m = yg_m - (yu_m * w1 + yv_m * w2)
    if mask is not None:
        # freeze masked coordinates at their box-center start
        dx_c = dx_c * mask
        dx_m = dx_m * mask
    return torch.cat([dx_c, dx_m], dim=-1)


def _newton_direction_dense(x, t, packed, n, caps_cpu, caps_mem, power_span, alpha, beta,
                            width: int | None = None, tail_q: float = 0.0):
    """Autodiff escape hatch: per-row gradient and Hessian of the barrier by
    torch.func, damped, then a dense O((2M)³) solve. Kept for parity testing
    against the structured direction."""

    def val(xx, nn, pk, cc, cm):
        return p1_barrier(xx, t, pk, nn, cc, cm, power_span, alpha, beta, width, tail_q)[0]

    # a row stack maps every row's packing and budgets along with it
    rowwise = packed["lam"].ndim > 1
    in_dims = (0, 0) + ((0, 0, 0) if rowwise else (None, None, None))
    args = (x, n, packed, caps_cpu, caps_mem)
    g = torch.func.vmap(torch.func.grad(val), in_dims=in_dims)(*args)
    H = torch.func.vmap(torch.func.hessian(val), in_dims=in_dims)(*args)
    H = H + _NEWTON_DAMP * torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.linalg.solve(H, g[..., None])[..., 0]


_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 3e-3, 1e-3)


def _ip_core(x0, packed, n, caps_cpu, caps_mem, power_span, alpha, beta, n_outer, n_inner,
             solver: str = "structured", t0: float = 1.0, width: int | None = None,
             tail_q: float = 0.0):
    """Log-barrier interior point over a (B, 2M) batch of starts: t <- 6t,
    damped Newton inner loop with a feasibility-preserving backtracking line
    search (rejects steps that leave the barrier domain or the
    queue-stability region).

    ``solver`` picks the Newton direction: "structured" (default) is the
    analytic block-diagonal + Woodbury O(M) solve; "dense" the autodiff
    Hessian + dense solve escape hatch. Both share the line search: a row
    takes the largest trial step that is strictly feasible and decreases
    its barrier value. All trial steps of all rows are checked in one
    batched evaluation, so the loop never waits on the device."""
    direction = (_newton_direction_structured if solver == "structured"
                 else _newton_direction_dense)
    B, D = x0.shape
    alphas = torch.tensor(_ALPHAS, dtype=x0.dtype, device=x0.device)
    K = alphas.shape[0]
    n_trial = n.repeat_interleave(K, dim=0)  # (B*K, M), row-major over (b, k)
    rows = torch.arange(B, device=x0.device)
    if packed["lam"].ndim > 1:
        # a row stack (``ip_solve_rows``): each row's packing, sentinel mask
        # and budgets go along with its K trial steps
        trial = {k: v.repeat_interleave(K, dim=0) for k, v in packed.items()}
        cpu_trial = caps_cpu.repeat_interleave(K, dim=0)
        mem_trial = caps_mem.repeat_interleave(K, dim=0)
    else:
        trial, cpu_trial, mem_trial = packed, caps_cpu, caps_mem

    def val_fn(xx, nn, t, pk, cc, cm):
        return p1_barrier(xx, t, pk, nn, cc, cm, power_span, alpha, beta, width, tail_q)[0]

    def feasible_cheap(xx, nn, pk, cc, cm):
        # slacks are linear/box terms, rho needs only the Eq. (1) latency
        slacks = p1_slacks(xx, pk, nn, cc, cm)
        rho = p1_rho(xx, pk, nn)
        return torch.all(slacks > 0, dim=-1) & torch.all(rho < 1.0 - 1e-7, dim=-1)

    x = x0
    t = float(t0)
    for _ in range(n_outer):
        # the barrier value at x rides along the steps
        cur = val_fn(x, n, t, packed, caps_cpu, caps_mem)
        for _ in range(n_inner):
            dx = direction(x, t, packed, n, caps_cpu, caps_mem, power_span, alpha, beta,
                           width, tail_q)
            cands = (x[:, None, :] - alphas[:, None] * dx[:, None, :]).reshape(B * K, D)
            feas = feasible_cheap(cands, n_trial, trial, cpu_trial, mem_trial)
            v = torch.where(feas, val_fn(cands, n_trial, t, trial, cpu_trial, mem_trial),
                            torch.inf).reshape(B, K)
            better = v < cur[:, None]
            found = better.any(dim=1)
            first = torch.argmax(better.to(torch.int8), dim=1)  # largest improving step
            x = torch.where(found[:, None], cands.reshape(B, K, D)[rows, first], x)
            cur = torch.where(found, v[rows, first], cur)
        t = t * 6.0
    return x


def _ip_solve_batched(x0, packed, n, caps_cpu, caps_mem, power_span, alpha, beta,
                      n_outer=14, n_inner=24, solver="structured", t0=1.0, width=None,
                      tail_q=0.0):
    """Interior point over a (B, 2M) batch of starts + (B, M) counts. Returns
    (x* (B, 2M), utility (B,)) — the utility is the tail objective when
    ``tail_q`` is set, so candidate ranking and the reported optimum agree."""
    x = _ip_core(x0, packed, n, caps_cpu, caps_mem, power_span, alpha, beta, n_outer,
                 n_inner, solver=solver, t0=t0, width=width, tail_q=tail_q)
    u = p1_objective(x, packed, n, caps_cpu, caps_mem, power_span, alpha, beta, width,
                     tail_q)
    return x, u


# ----------------------------------------------------------------------------
# Row-wise P1 solve — the fleet placement layer's inner engine
# ----------------------------------------------------------------------------
def p1_app_ws(x, packed, n, width: int | None = None):
    """Per-app response times at a solution x (masked sentinel slots -> 0)."""
    c, m = _split(x, packed)
    mask = packed.get("mask")
    _, n_ws = _mask_counts(packed, n)
    mu = _mu(packed, c, m)
    ws = queueing.erlang_ws(n_ws, packed["lam"].expand(mu.shape), mu, width=width)
    return ws if mask is None else torch.where(mask > 0, ws, 0.0)


def _rows_core(x0, packed_rows, n, caps_cpu, caps_mem, power_span, alpha, beta,
               n_outer, n_inner, solver, t0, width):
    """FULL per-row problems: unlike ``_ip_solve_batched`` (one shared
    packing, many count vectors), every row here carries its own packed-field
    stack AND its own (caps_cpu, caps_mem) budget — one row per fleet node.
    Returns (x* (N, 2M), utility (N,), ws (N, M))."""
    x = _ip_core(x0, packed_rows, n, caps_cpu, caps_mem, power_span, alpha, beta,
                 n_outer, n_inner, solver=solver, t0=t0, width=width)
    u = p1_objective(x, packed_rows, n, caps_cpu, caps_mem, power_span, alpha, beta, width)
    ws = p1_app_ws(x, packed_rows, n, width)
    return x, u, ws


def ip_solve_rows(
    x0, packed_rows, n, caps_cpu, caps_mem, power_span, alpha, beta,
    n_outer=8, n_inner=3, solver="structured", t0=1.0, width=None,
    mesh=None, mesh_axis: str = "nodes",
):
    """Public row-wise solver on the operands' device. All operands are
    float64 tensors row-stacked along the leading node axis: x0 (N, 2M),
    packed_rows a dict of (N, M)/(N, M, 3) tensors (plus the (N, M) "mask"
    sentinel field), n (N, M), caps_cpu/caps_mem (N,); power_span/alpha/beta
    are fleet-wide scalars. Returns (x* (N, 2M), utility (N,), ws (N, M)).
    One card only: a ``mesh`` (the rows sharded over several devices) raises
    NotImplementedError."""
    if mesh is not None:
        raise NotImplementedError(
            f"ip_solve_rows runs on one device; sharding the rows over a mesh "
            f"(axis {mesh_axis!r}) is not available"
        )
    return _rows_core(x0, packed_rows, n, caps_cpu, caps_mem, power_span, alpha, beta,
                      n_outer, n_inner, solver, t0, width)


# ----------------------------------------------------------------------------
# Phase-1 feasible start, vectorized over the batch (NumPy)
# ----------------------------------------------------------------------------
def find_feasible_start_batch(packed, caps: ServerCaps, n_batch, c_hint=None, mask=None):
    """Phase-1 heuristic over a (B, M) batch of container-count vectors:
    memory waterfill + CPU proportional scaling + a stability repair pass.
    Rows with no strictly feasible interior point are masked (ok=False) and
    their x0 contents are unspecified. Returns (x0 (B, 2M), ok (B,)).

    Packed fields may be per-row (B, M[, 3]) stacks, ``caps`` fields may be
    (B,) arrays, and ``mask`` (B, M) marks sentinel slots — masked lanes are
    exempted from every feasibility predicate and land on their box center."""
    packed = as_packed(packed)
    n = np.asarray(n_batch, dtype=float)
    B, M = n.shape
    r_min, r_max = packed.r_min, packed.r_max
    cpu_min = packed.cpu_min
    k1, k3 = packed.kappa[..., 0], packed.kappa[..., 2]
    lam, xbar = packed.lam, packed.xbar
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        n = n * mask  # sentinel slots budget nothing regardless of caller's n
    ok = np.ones(B, dtype=bool)

    with np.errstate(all="ignore"):
        # memory: m = r_min + phi (r_max - r_min), largest phi in [0, .95]
        # fitting the budget
        base = np.sum(n * r_min, axis=1)
        spread = np.sum(n * (r_max - r_min), axis=1)
        ok &= ~(base > 0.98 * caps.r_mem)
        phi_frac = np.minimum(
            0.95, np.maximum(0.0, (0.95 * caps.r_mem - base) / np.maximum(spread, 1e-9))
        )
        m0 = r_min + phi_frac[:, None] * (r_max - r_min)

        # cpu: scale the hint (sufficient-resource optimum) into the budget
        if c_hint is None:
            c_hint = np.ones(M)
        c_hint = np.asarray(c_hint, dtype=float)
        c_hint = np.broadcast_to(c_hint, (B, M)) if c_hint.ndim == 1 else c_hint
        scale = np.minimum(
            1.0, 0.95 * caps.r_cpu / np.maximum(np.sum(n * c_hint, axis=1), 1e-9)
        )
        c0 = np.maximum(c_hint * scale[:, None], cpu_min * 1.5 + 1e-5)

        # memory repair: two-tier waterfill — a hard floor (mem term <= 90% of
        # the latency cap, bare stabilizability) plus proportional headroom
        # toward a comfortable 60%-of-cap target, within the global budget
        d_cap_ms = 0.92 * n * 1000.0 / (lam * xbar)  # (B, M)
        if mask is not None:
            # sentinel lanes have no queue: no latency cap, never "bad"
            d_cap_ms = np.where(mask, d_cap_ms, np.inf)
        d_cap_ms = np.broadcast_to(d_cap_ms, (B, M))
        hard, soft = 0.9 * d_cap_ms, 0.6 * d_cap_ms
        ok &= ~np.any(hard <= 1.05, axis=1)  # latency cap below the e^0 floor
        floor = k3 / np.log(np.maximum(hard, 1.0 + 1e-12))
        ok &= ~np.any(floor > r_max + 1e-9, axis=1)  # no memory can stabilize
        m_bare = np.clip(np.maximum(floor * 1.01, r_min), r_min, r_max)
        pref = k3 / np.log(np.maximum(soft, 1.06))
        m_pref = np.clip(np.maximum(pref * 1.01, m0), m_bare, r_max)
        bare_need = np.sum(n * m_bare, axis=1)
        ok &= ~(bare_need > 0.98 * caps.r_mem)
        spread2 = np.sum(n * (m_pref - m_bare), axis=1)
        phi2 = np.where(
            spread2 <= 1e-12,
            1.0,
            np.minimum(1.0, (0.98 * caps.r_mem - bare_need) / np.where(spread2 <= 1e-12, 1.0, spread2)),
        )
        m0 = m_bare + phi2[:, None] * (m_pref - m_bare)

        # stability repair: each app needs d(c, m0) < N/(λ x̄) * 1000 ms.
        # Typical rows settle in 1-3 rounds; survivors are masked by the
        # hard-cap check below
        for _ in range(12):
            d_now = _eq1_np(packed.kappa, c0, m0)
            bad = d_now >= d_cap_ms  # (B, M)
            active = np.any(bad, axis=1)  # rows still being repaired
            if not np.any(active & ok):
                break
            mem_term = np.exp(k3 / m0)
            ok &= ~np.any(bad & (k1 + mem_term >= d_cap_ms), axis=1)  # infinite cpu won't do
            # bisect the cpu needed for d = d_cap (d decreasing in c), all
            # (B, M) lanes at once — non-bad lanes are discarded by the mask
            lo = np.broadcast_to(cpu_min, (B, M)).copy()
            hi = np.broadcast_to(packed.cpu_max, (B, M)).copy()
            for _ in range(44):  # 8 cores / 2^44 ≈ 5e-13 — still fp-exact
                mid = 0.5 * (lo + hi)
                too_slow = _eq1_np(packed.kappa, mid, m0) >= d_cap_ms
                lo = np.where(too_slow, mid, lo)
                hi = np.where(too_slow, hi, mid)
            c0 = np.where(bad, np.maximum(c0, hi), c0)
            # over-budget rows shrink the non-binding apps proportionally
            total = np.sum(n * c0, axis=1)
            over = active & (total > 0.98 * caps.r_cpu)
            fixed = np.sum(np.where(bad, n * c0, 0.0), axis=1)
            ok &= ~(over & (fixed > 0.98 * caps.r_cpu))
            room = 0.98 * caps.r_cpu - fixed
            cur = np.sum(np.where(bad, 0.0, n * c0), axis=1)
            shrink_row = over & (cur > room)
            shrink = np.where(cur > 0, room / np.maximum(cur, 1e-300), 1.0)
            c0 = np.where(
                shrink_row[:, None] & ~bad,
                np.maximum(c0 * shrink[:, None], cpu_min * 1.5),
                c0,
            )

        # rows whose repair budget ran out with still-unstable lanes never
        # reached a strictly feasible interior point — mask them instead of
        # handing the solver a start outside the barrier domain
        d_hard_ms = d_cap_ms / 0.92
        ok &= ~np.any(
            _eq1_np(packed.kappa, c0, m0) >= d_hard_ms * (1.0 - 1e-7), axis=1
        )

    if mask is not None:
        c_mid = np.broadcast_to(0.5 * (cpu_min + packed.cpu_max), (B, M))
        m_mid = np.broadcast_to(0.5 * (r_min + r_max), (B, M))
        c0 = np.where(mask, c0, c_mid)
        m0 = np.where(mask, m0, m_mid)
    x0 = np.concatenate([c0, m0], axis=1)
    return x0, ok


# ----------------------------------------------------------------------------
# Grid-seeded phase-1 CPU hints
# ----------------------------------------------------------------------------
def grid_seed_chints(
    packed,
    caps: ServerCaps,
    n_batch,
    alpha: float,
    beta: float,
    n_c: int = 6,
    n_m: int = 3,
    backend: str | None = None,
    device=None,
) -> np.ndarray:
    """Coarse per-app (c, m) utility sweep per candidate count vector; returns
    the argmin-cell CPU quotas as (B, M) phase-1 ``c_hint``s.

    Each app gets a log-spaced CPU grid × linear memory grid over its own box;
    grid cell g assigns every app its g-th quota simultaneously, so the
    per-app utility terms of one batched evaluation decouple and a single
    argmin over G recovers each app's grid-optimal cell at its actual
    container count. The budget coupling is left to
    ``find_feasible_start_batch``, which scales the hint into the budget.

    ``backend``: None/'auto' evaluates the grid with the ``crms_grid`` CUDA
    kernel (per-app mode) on a CUDA device and with the float64 oracle
    (batch_eval.utility_terms_batch) on the CPU; 'kernel' forces
    ``ops.crms_grid`` (the kernel, or its plain float32 version for CPU
    tensors), 'oracle' forces the float64 oracle. Apps with no stable grid
    cell fall back to cpu_max (the most stabilizing quota the box allows).
    """
    dev = resolve_device(device)
    packed = as_packed(packed)
    n = np.asarray(n_batch, dtype=float)
    B, M = n.shape

    # Per-app terms depend on the app's own count only, so the sweep needs the
    # per-COLUMN unique counts, not all B rows: a CRMS refinement batch has at
    # most 3 distinct counts per app (n0, n0±1), collapsing the (B·G, M)
    # candidate matrix to (K·G, M) with K = max distinct counts per app.
    uniq = [np.unique(n[:, i]) for i in range(M)]
    K = max(u.shape[0] for u in uniq)
    Kp = _pad_pow2(K)  # stable shapes as the CRMS move set shrinks
    V = np.stack(  # (Kp, M) pseudo-rows; short columns repeat their last count
        [np.concatenate([u, np.full(Kp - u.shape[0], u[-1])]) for u in uniq], axis=1
    )
    # row index of each (b, i)'s count among its column's unique values
    kidx = np.stack([np.searchsorted(u, n[:, i]) for i, u in enumerate(uniq)], axis=1)

    cgrid = np.geomspace(packed.cpu_min * 1.25 + 1e-3, packed.cpu_max, n_c)  # (n_c, M)
    span = packed.r_max - packed.r_min
    mgrid = np.linspace(packed.r_min + 0.02 * span, packed.r_max, n_m)  # (n_m, M)
    cg = np.repeat(cgrid, n_m, axis=0)  # (G, M) cell -> cpu quota
    mg = np.tile(mgrid, (n_c, 1))  # (G, M) cell -> mem quota
    G = n_c * n_m

    n_rep = f64(np.repeat(V, G, axis=0), dev)  # (Kp*G, M)
    c_rep = f64(np.tile(cg, (Kp, 1)), dev)
    m_rep = f64(np.tile(mg, (Kp, 1)), dev)

    alpha = _alpha_arg(alpha)
    # Routing follows the reference's semantics, not a fallback: the kernel
    # takes a scalar alpha, so priority-weighted (vector-alpha) sweeps go
    # through the float64 oracle, which broadcasts per app; on the CPU the
    # default is the oracle, as the reference's is off its accelerator.
    use_oracle = backend == "oracle" or np.ndim(alpha) > 0 or (
        backend in (None, "auto") and dev.type != "cuda"
    )
    if use_oracle:
        from repro_torch.core.batch_eval import utility_terms_batch

        terms = utility_terms_batch(
            packed.as_dict(dev), n_rep, c_rep, m_rep, float(caps.r_cpu),
            float(caps.power.span), alpha_tensor(alpha, dev), float(beta),
        )
    elif backend in (None, "auto", "kernel"):
        from repro_torch.kernels import ops

        pk = packed.as_dict(dev)
        terms = ops.crms_grid(
            pk["kappa"], pk["lam"], pk["xbar"], n_rep, c_rep, m_rep,
            caps_cpu=float(caps.r_cpu), power_span=float(caps.power.span),
            alpha=float(alpha), beta=float(beta), reduce="per_app",
        )
    else:
        raise ValueError(f"backend must be None, 'auto', 'kernel' or 'oracle', got {backend!r}")
    terms = terms.cpu().numpy().astype(float).reshape(Kp, G, M)
    # unstable cells: +inf from the float64 oracle, the ws=1e9 sentinel from
    # the float32 kernel (emitted as alpha·1e9 + power term) — map both to inf
    # so argmin/fallback agree across backends; the threshold scales with
    # alpha so small latency weights don't slip the sentinel past the filter
    thresh = max(float(np.max(alpha)), 1e-3) * 1e8
    terms = np.where(np.isfinite(terms) & (terms < thresh), terms, np.inf)
    gstar = np.argmin(terms, axis=1)  # (Kp, M) argmin cell per (count, app)
    cols = np.arange(M)
    c_hint_k = cg[gstar, cols[None, :]]  # (Kp, M)
    no_stable_cell = ~np.isfinite(np.min(terms, axis=1))
    c_hint_k = np.where(no_stable_cell, packed.cpu_max[None, :], c_hint_k)
    return c_hint_k[kidx, cols[None, :]]  # scatter back to the (B, M) batch


# ----------------------------------------------------------------------------
# Batched P1 solve
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class P1Result:
    r_cpu: np.ndarray
    r_mem: np.ndarray
    utility: float
    converged: bool
    info: dict


@dataclasses.dataclass
class P1BatchResult:
    """A (B,)-batch of P1 solutions; ``row(i)`` views one as a P1Result."""

    r_cpu: np.ndarray  # (B, M)
    r_mem: np.ndarray  # (B, M)
    utility: np.ndarray  # (B,)
    converged: np.ndarray  # (B,) bool
    started: np.ndarray  # (B,) bool — phase-1 found a feasible interior point
    info: dict

    def row(self, i: int) -> P1Result:
        info = dict(self.info)
        if not self.started[i]:
            info.setdefault("reason", "no_feasible_start")
        elif not self.converged[i]:
            info.setdefault("reason", "diverged")
        return P1Result(
            r_cpu=self.r_cpu[i].copy(),
            r_mem=self.r_mem[i].copy(),
            utility=float(self.utility[i]),
            converged=bool(self.converged[i]),
            info=info,
        )


def _pad_pow2(B: int) -> int:
    return 1 << max(B - 1, 0).bit_length()


class InfeasibleAllocation(RuntimeError):
    """Every row of a ``p1_solve_batch`` batch lacks a feasible interior
    point (opt-in via ``on_infeasible="raise"``). Carries the binding
    constraint — ``.binding`` ∈ {"stability", "memory", "cpu"}."""

    def __init__(self, binding: str, detail: dict):
        self.binding = binding
        self.detail = dict(detail)
        super().__init__(
            f"no feasible allocation for any of the "
            f"{detail.get('batch', '?')} candidate count vectors; "
            f"binding constraint: {binding}"
        )


def _diagnose_infeasible(packed, caps: ServerCaps, n_np: np.ndarray) -> tuple:
    """Name the constraint that kills an all-masked batch, by re-running the
    cheap phase-1 impossibility predicates per row and taking the modal
    label: "stability", "memory", else "cpu". Returns (binding,
    {label: n_rows})."""
    with np.errstate(all="ignore"):
        k3 = packed.kappa[..., 2]
        mem_floor = np.sum(n_np * packed.r_min, axis=1)
        memory = mem_floor > 0.98 * np.asarray(caps.r_mem)
        d_cap_ms = 0.92 * n_np * 1000.0 / (packed.lam * packed.xbar)
        hard = 0.9 * d_cap_ms
        floor = k3 / np.log(np.maximum(hard, 1.0 + 1e-12))
        stability = np.any(hard <= 1.05, axis=1) | np.any(
            floor > packed.r_max + 1e-9, axis=1
        )
    counts = {
        "stability": int(np.sum(stability)),
        "memory": int(np.sum(memory & ~stability)),
        "cpu": int(np.sum(~memory & ~stability)),
    }
    binding = max(counts, key=counts.get)
    return binding, counts


# Barrier-schedule profiles (n_outer, n_inner). "reference" is heavily
# over-converged; "refine" is the schedule of the CRMS greedy refinement;
# "fleet" the placement layer's.
P1_PROFILES = {"reference": (14, 24), "refine": (12, 4), "fleet": (8, 3)}


def p1_solve_batch(
    apps,
    caps: ServerCaps,
    n_batch,
    alpha: float,
    beta: float,
    c_hint=None,
    n_outer: int | None = None,
    n_inner: int | None = None,
    pad: bool = True,
    profile: str = "reference",
    solver: str = "structured",
    seed_grid: bool = False,
    max_servers: int | None = None,
    tail_q: float = 0.0,
    on_infeasible: str = "mask",
    device=None,
) -> P1BatchResult:
    """Solve Problem P1 (Eq. 26) for every row of a (B, M) batch of container
    counts in ONE batched interior-point call on ``device``.

    ``apps`` may be a Sequence[App] or an already-built PackedApps. Rows with
    no phase-1 feasible start come back with utility=inf / converged=False;
    the remaining lanes are solved jointly (infeasible lanes are filled with a
    feasible row's data so the batch stays dense, then masked out). ``pad``
    rounds B up to a power of two so shapes stay stable as the CRMS move set
    shrinks. ``profile`` picks the barrier schedule (see P1_PROFILES);
    explicit n_outer/n_inner override it. ``solver`` picks the Newton
    direction ("structured" O(M) analytic default, "dense" autodiff escape
    hatch). ``seed_grid`` puts phase-1 CPU hints from the coarse per-app
    (c, m) utility grid sweep (grid_seed_chints) at the head of the hint
    chain; rows where a hinted phase-1 fails fall back to the caller's
    ``c_hint`` and finally the plain waterfill, so hint sources only ever add
    feasible rows. ``max_servers`` narrows every Erlang-C logsumexp to the
    given width (exact: every count must stay ≤ it, validated eagerly).
    ``tail_q`` swaps the per-app latency term for the analytic quantile
    surrogate. ``on_infeasible``: ``"mask"`` returns ok=False rows with
    ``info["binding"]`` naming the constraint; ``"raise"`` raises
    ``InfeasibleAllocation``."""
    if on_infeasible not in ("mask", "raise"):
        raise ValueError(
            f"on_infeasible must be 'mask' or 'raise', got {on_infeasible!r}"
        )
    dev = resolve_device(device)
    prof_outer, prof_inner = P1_PROFILES[profile]
    n_outer = prof_outer if n_outer is None else n_outer
    n_inner = prof_inner if n_inner is None else n_inner
    packed = as_packed(apps)
    n_np = np.asarray(n_batch, dtype=float)
    if n_np.ndim != 2:
        raise ValueError(f"n_batch must be (B, M), got shape {n_np.shape}")
    if max_servers is not None and n_np.size and float(n_np.max()) > max_servers:
        raise ValueError(
            f"max_servers={max_servers} is below the largest container count "
            f"{int(n_np.max())} in the batch — the narrowed Erlang sum would "
            "no longer be exact"
        )
    B, M = n_np.shape
    # Phase-1 hint chain: grid-seeded cells first (when enabled), then the
    # caller's hint (SP1 ideal / warm quotas), then the plain waterfill.
    hint_chain: list = [c_hint] if c_hint is not None else []
    if seed_grid:
        hint_chain.insert(0, grid_seed_chints(packed, caps, n_np, alpha, beta, device=dev))
    if not hint_chain or hint_chain[-1] is not None:
        hint_chain.append(None)
    x0, ok = find_feasible_start_batch(packed, caps, n_np, c_hint=hint_chain[0])
    n_rescued = 0  # rows the hint fallback chain recovered after a failed start
    for fb in hint_chain[1:]:
        if np.all(ok):
            break
        idx = np.where(~ok)[0]
        fb_np = np.asarray(fb, dtype=float) if fb is not None else None
        sub = fb_np[idx] if fb_np is not None and fb_np.ndim == 2 else fb_np
        x0_fb, ok_fb = find_feasible_start_batch(packed, caps, n_np[idx], c_hint=sub)
        x0[idx[ok_fb]] = x0_fb[ok_fb]
        ok[idx[ok_fb]] = True
        n_rescued += int(np.sum(ok_fb))

    r_cpu = np.zeros((B, M))
    r_mem = np.broadcast_to(packed.r_min, (B, M)).copy()
    utility = np.full(B, np.inf)
    converged = np.zeros(B, dtype=bool)
    if not np.any(ok):
        binding, bind_counts = _diagnose_infeasible(packed, caps, n_np)
        if on_infeasible == "raise":
            raise InfeasibleAllocation(
                binding, {"batch": B, "rows_by_binding": bind_counts}
            )
        return P1BatchResult(
            r_cpu, r_mem, utility, converged, started=ok,
            info={"n_feasible_start": 0, "n_rescued": n_rescued, "n_masked": B,
                  "binding": binding, "rows_by_binding": bind_counts},
        )

    sub = int(np.argmax(ok))  # donor row for masked-out lanes
    x0 = np.where(ok[:, None], x0, x0[sub])
    n_solve = np.where(ok[:, None], n_np, n_np[sub])
    Bp = _pad_pow2(B) if pad else B
    if Bp > B:
        x0 = np.concatenate([x0, np.broadcast_to(x0[sub], (Bp - B, 2 * M))], axis=0)
        n_solve = np.concatenate([n_solve, np.broadcast_to(n_solve[sub], (Bp - B, M))], axis=0)

    x, u = _ip_solve_batched(
        f64(x0, dev),
        packed.as_dict(dev),
        f64(n_solve, dev),
        float(caps.r_cpu),
        float(caps.r_mem),
        float(caps.power.span),
        alpha_tensor(alpha, dev),
        float(beta),
        n_outer=n_outer,
        n_inner=n_inner,
        solver=solver,
        width=max_servers,
        tail_q=float(tail_q),
    )
    x = x.cpu().numpy()[:B]
    u = u.cpu().numpy()[:B]
    r_cpu = np.where(ok[:, None], x[:, :M], r_cpu)
    r_mem = np.where(ok[:, None], x[:, M:], r_mem)
    utility = np.where(ok, u, np.inf)
    converged = ok & np.isfinite(utility)
    return P1BatchResult(
        r_cpu, r_mem, utility, converged, started=ok,
        info={
            "n_feasible_start": int(ok.sum()),
            "n_rescued": n_rescued,
            "n_masked": int(B - ok.sum()),
            "batch": B,
            "padded_to": Bp,
        },
    )


# ----------------------------------------------------------------------------
# Algorithm 1 inner solves, batched over apps
# ----------------------------------------------------------------------------
def _sp1_batch(packed, caps_cpu, power_span, alpha, beta, iters=100):
    """SP1 for every app at once: m* = r_max (Theorem-2 monotonicity), c* by
    bisection on dF/dc with the box edges handled by masks."""
    k1, k2 = packed["kappa"][:, 0], packed["kappa"][:, 1]
    lam, xbar = packed["lam"], packed["xbar"]

    def dF_dc(c):
        e = torch.exp(-k2 * c)
        d_latency = -k1 * k2 * e / (1.0 - e) ** 2
        return alpha * xbar * 1e-3 * d_latency + beta * power_span / (caps_cpu * lam)

    lo0, hi0 = packed["cpu_min"], packed["cpu_max"]
    g_lo, g_hi = dF_dc(lo0), dF_dc(hi0)
    lo, hi = lo0, hi0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        g = dF_dc(mid)
        lo = torch.where(g < 0, mid, lo)
        hi = torch.where(g < 0, hi, mid)
    c = 0.5 * (lo + hi)
    # still decreasing at cpu_max -> box edge; increasing at cpu_min -> floor
    c = torch.where(g_hi < 0, hi0, torch.where(g_lo > 0, lo0, c))
    return c, packed["r_max"]


def sp1_solve_batch(apps, caps: ServerCaps, alpha: float, beta: float, iters: int = 100,
                    device=None):
    """Vectorized SP1: returns (r_cpu* (M,), r_mem* (M,)) as NumPy arrays."""
    dev = resolve_device(device)
    packed = as_packed(apps)
    c, m = _sp1_batch(
        packed.as_dict(dev), float(caps.r_cpu), float(caps.power.span),
        alpha_tensor(alpha, dev), float(beta), iters=iters,
    )
    return c.cpu().numpy(), m.cpu().numpy()


def _phi_grid(lam, mu, c, power_span, caps_cpu, alpha, beta, ns, width=None):
    """Φ(N) of Eq. (23) on an (M, K) grid of container counts. ``alpha`` is a
    per-app (M,) latency weight. ``width``: Erlang-sum width — K itself is
    exact, since no grid count exceeds K."""
    n = ns[None, :]
    ws = queueing.erlang_ws(n, lam[:, None], mu[:, None], width)
    dp = power_span * n * c[:, None] / caps_cpu
    return alpha[:, None] * ws + beta * dp / lam[:, None]


def sp2_argmin_batch(apps, caps: ServerCaps, alpha, beta, mu_star, c_star, m_star,
                     n_cap: int | None = None, device=None):
    """Vectorized SP2: per-app argmin of convex Φ over the stable feasible
    range [stability floor, cap-implied ceiling], evaluated as one (M, K)
    grid. ``n_cap`` clamps the ceiling (and with it the grid width K)."""
    dev = resolve_device(device)
    packed = as_packed(apps)
    mu_star = np.asarray(mu_star, dtype=float)
    c_star = np.asarray(c_star, dtype=float)
    m_star = np.asarray(m_star, dtype=float)
    lo = np.array(
        [queueing.stability_lower_bound(l, mu) for l, mu in zip(packed.lam, mu_star)],
        dtype=int,
    )
    hi = np.minimum(caps.r_cpu / c_star, caps.r_mem / m_star).astype(int)
    cap = queueing.MAX_SERVERS - 1 if n_cap is None else min(n_cap, queueing.MAX_SERVERS - 1)
    hi = np.minimum(np.maximum(hi, lo), cap)
    K = _pad_pow2(int(hi.max()))
    ns = torch.arange(1, K + 1, dtype=F64, device=dev)
    alpha_vec = np.broadcast_to(_alpha_arg(alpha), packed.lam.shape)
    vals = _phi_grid(
        f64(packed.lam, dev), f64(mu_star, dev), f64(c_star, dev),
        float(caps.power.span), float(caps.r_cpu), f64(alpha_vec, dev), float(beta),
        ns, width=K,
    ).cpu().numpy()
    grid = np.arange(1, K + 1)
    mask = (grid[None, :] >= lo[:, None]) & (grid[None, :] <= hi[:, None])
    vals = np.where(mask & np.isfinite(vals), vals, np.inf)
    return grid[np.argmin(vals, axis=1)].astype(int)


def ideal_configs_batch(apps, caps: ServerCaps, alpha: float, beta: float,
                        n_cap: int | None = None, device=None):
    """Algorithm 1's per-app ideal configs, batched over apps. Returns
    (r_cpu* (M,), r_mem* (M,), n* (M,) int, mu* (M,))."""
    dev = resolve_device(device)
    packed = as_packed(apps)
    c_star, m_star = sp1_solve_batch(packed, caps, alpha, beta, device=dev)
    d_ms = _eq1_np(packed.kappa, c_star, m_star)
    mu_star = 1000.0 / (packed.xbar * d_ms)
    n_star = sp2_argmin_batch(packed, caps, alpha, beta, mu_star, c_star, m_star,
                              n_cap=n_cap, device=dev)
    return c_star, m_star, n_star, mu_star
