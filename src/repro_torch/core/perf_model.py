"""Container-level latency-resource performance model (paper §III).

The five candidate fitting families of Table I and a batched
Levenberg-Marquardt nonlinear-least-squares fitter in float64 torch. Eq. (1)
— the winner — is:

    d(c, m) = k1 / (1 - exp(-k2 * c)) + exp(k3 / m)          [d in ms]

with c = CPU quota [cores] and m = memory [GB]. We fit/hold k1 > 0 (the
literal Eq. (1) form needs it for positivity, monotone-decreasing latency and
convexity).

Multi-start fits draw their starting points from
``np.random.default_rng(seed)``. The starts differ from a JAX-keyed draw, but
the fitted optimum does not depend on them to within ~1e-10 relative on the
paper's profiles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.device import F64, f64, resolve_device


# ----------------------------------------------------------------------------
# Candidate families (Table I). Each maps (params, cpu, mem) -> latency [ms].
# ----------------------------------------------------------------------------
def eq1_latency(params, cpu, mem):
    """Eq. (1): k1/(1-e^{-k2 c}) + e^{k3/m}.  params = (k1, k2, k3), all > 0."""
    k1, k2, k3 = params[0], params[1], params[2]
    return k1 / (1.0 - torch.exp(-k2 * cpu)) + torch.exp(k3 / mem)


def family2(params, cpu, mem):
    """k1/c + k2 m^2 + k3 m."""
    k1, k2, k3 = params[0], params[1], params[2]
    return k1 / cpu + k2 * mem**2 + k3 * mem


def family3(params, cpu, mem):
    """1 / (k1 log(1+c) + k2 log(1+m))."""
    k1, k2 = params[0], params[1]
    return 1.0 / (k1 * torch.log1p(cpu) + k2 * torch.log1p(mem))


def family4(params, cpu, mem):
    """k1 / (k2 + k3 c^2 + k4 m^2)."""
    k1, k2, k3, k4 = params[0], params[1], params[2], params[3]
    return k1 / (k2 + k3 * cpu**2 + k4 * mem**2)


def family5(params, cpu, mem):
    """k1 c^3 + k2 m^3 + k3 c m."""
    k1, k2, k3 = params[0], params[1], params[2]
    return k1 * cpu**3 + k2 * mem**3 + k3 * cpu * mem


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    fn: Callable
    n_params: int
    positive: bool  # constrain params > 0 via softplus reparametrization


FAMILIES: Dict[str, Family] = {
    "eq1": Family("eq1", eq1_latency, 3, True),
    "inv_quad": Family("inv_quad", family2, 3, False),
    "log_inv": Family("log_inv", family3, 2, True),
    "rational": Family("rational", family4, 4, True),
    "cubic": Family("cubic", family5, 3, False),
}


# ----------------------------------------------------------------------------
# Levenberg-Marquardt NLLS, batched over starting points
# ----------------------------------------------------------------------------
def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    y = np.maximum(y, 1e-8)
    return y + np.log(-np.expm1(-y))


@dataclasses.dataclass
class FitResult:
    family: str
    params: np.ndarray
    rmse: float
    mse: float
    r2: float
    adj_r2: float
    residuals: np.ndarray
    converged: bool

    def predict(self, cpu, mem, device=None):
        """The fitted family at (cpu, mem), computed on ``device`` (the CUDA
        device unless named); returns a NumPy array."""
        dev = resolve_device(device)
        fn = FAMILIES[self.family].fn
        return fn(f64(self.params, dev), f64(cpu, dev), f64(mem, dev)).cpu().numpy()


def _lm_fit(theta0, cpu, mem, y, fn, positive: bool = True, iters: int = 200):
    """Levenberg-Marquardt on residuals r(theta) = fn(map(theta)) - y for a
    (S, P) batch of starting points; returns (params (S, P), best loss (S,)).
    Each start runs its own damping schedule: two damping trials per step
    (λ and 10λ), the best improving one accepted."""

    def unmap(theta):
        return _softplus(theta) if positive else theta

    def resid_one(theta):  # (P,) -> (D,)
        return fn(unmap(theta), cpu, mem) - y

    def loss(theta):  # (S, P) -> (S,)
        r = fn(unmap(theta).T[..., None], cpu, mem) - y
        return 0.5 * torch.sum(r * r, dim=-1)

    resid = torch.func.vmap(resid_one)
    jac = torch.func.vmap(torch.func.jacfwd(resid_one))
    S, P = theta0.shape
    eye = torch.eye(P, dtype=theta0.dtype, device=theta0.device)

    def try_lambda(theta, JTJ, g, lam):
        delta = torch.linalg.solve_ex(JTJ + lam[:, None, None] * eye, g[..., None])[0][..., 0]
        cand = theta - delta
        return cand, loss(cand)

    theta = theta0
    lam_damp = torch.full((S,), 1e-2, dtype=theta0.dtype, device=theta0.device)
    best_theta, best_loss = theta0, loss(theta0)
    for _ in range(iters):
        r = resid(theta)
        J = jac(theta)
        JTJ = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        cand1, l1 = try_lambda(theta, JTJ, g, lam_damp)
        cand2, l2 = try_lambda(theta, JTJ, g, lam_damp * 10.0)
        cur = loss(theta)
        # accept best improving candidate; adapt damping
        use1 = l1 < cur
        use2 = ~use1 & (l2 < cur)
        theta = torch.where(use1[:, None], cand1, torch.where(use2[:, None], cand2, theta))
        lam_damp = torch.where(use1, lam_damp * 0.5, lam_damp * 10.0)
        lam_damp = torch.clamp(lam_damp, 1e-12, 1e12)
        new_loss = loss(theta)
        better = new_loss < best_loss
        best_theta = torch.where(better[:, None], theta, best_theta)
        best_loss = torch.where(better, new_loss, best_loss)
    return unmap(best_theta), best_loss


def fit_family(
    family: str,
    cpu: np.ndarray,
    mem: np.ndarray,
    y: np.ndarray,
    n_starts: int = 16,
    seed: int = 0,
    iters: int = 200,
    device=None,
) -> FitResult:
    """Multi-start LM fit of one candidate family; returns metrics per Table I.
    All ``n_starts`` starts run as one batch on ``device``."""
    dev = resolve_device(device)
    fam = FAMILIES[family]
    y_np = np.asarray(y, dtype=np.float64)
    cpu_t, mem_t, y_t = f64(cpu, dev), f64(mem, dev), f64(y_np, dev)

    # data-informed starting scales
    y_scale = float(max(np.mean(y_np), 1e-3))
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0.05, 3.0, (n_starts, fam.n_params))
    raw = raw * np.asarray([y_scale, 1.0, 1.0, 1.0][: fam.n_params])
    starts = _inv_softplus(raw) if fam.positive else raw

    params_all, losses = _lm_fit(
        f64(starts, dev), cpu_t, mem_t, y_t, fam.fn, positive=fam.positive, iters=iters
    )
    best = int(torch.argmin(losses))
    params = params_all[best]

    resid = (fam.fn(params, cpu_t, mem_t) - y_t).cpu().numpy()
    n = y_np.shape[0]
    mse = float(np.mean(resid**2))
    rmse = float(np.sqrt(mse))
    ss_res = float(np.sum(resid**2))
    ss_tot = float(np.sum((y_np - np.mean(y_np)) ** 2))
    r2 = 1.0 - ss_res / max(ss_tot, 1e-12)
    p = fam.n_params
    adj_r2 = 1.0 - (1.0 - r2) * (n - 1) / max(n - p - 1, 1)
    return FitResult(
        family=family,
        params=params.cpu().numpy(),
        rmse=rmse,
        mse=mse,
        r2=r2,
        adj_r2=adj_r2,
        residuals=resid,
        converged=bool(np.isfinite(rmse)),
    )


def fit_best_family(cpu, mem, y, **kw) -> Dict[str, FitResult]:
    """Fit all Table-I families; caller compares RMSE (Table I reproduction)."""
    return {name: fit_family(name, cpu, mem, y, **kw) for name in FAMILIES}


# ----------------------------------------------------------------------------
# Sensitivity (the quantity the paper's allocator exploits)
# ----------------------------------------------------------------------------
def _eq1_grad(params, cpu, mem, wrt: int, order: int = 1):
    """Elementwise ∂ⁿd/∂cⁿ (wrt=0) or ∂ⁿd/∂mⁿ (wrt=1) of Eq. (1) by autograd."""
    cm = [cpu.detach().clone().requires_grad_(wrt == 0),
          mem.detach().clone().requires_grad_(wrt == 1)]
    out = eq1_latency(params, cm[0], cm[1])
    for k in range(order):
        (out,) = torch.autograd.grad(out.sum(), cm[wrt], create_graph=k + 1 < order)
    return out.detach()


def cpu_sensitivity(params, cpu, mem, device=None):
    """-∂d/∂c at the operating point (>0: latency improves with more CPU)."""
    dev = resolve_device(device)
    return -_eq1_grad(f64(params, dev), f64(cpu, dev), f64(mem, dev), wrt=0)


def mem_sensitivity(params, cpu, mem, device=None):
    """-∂d/∂m at the operating point."""
    dev = resolve_device(device)
    return -_eq1_grad(f64(params, dev), f64(cpu, dev), f64(mem, dev), wrt=1)


def validate_eq1_shape(params, device=None) -> dict:
    """Checks the fitted Eq.1 surface has the Theorem-2 shape: positive,
    decreasing, convex in both resources over a probe grid."""
    dev = resolve_device(device)
    p = f64(params, dev)
    c = torch.linspace(0.25, 8.0, 64, dtype=F64, device=dev)
    m = torch.linspace(0.15, 1.0, 64, dtype=F64, device=dev)
    C, M = torch.meshgrid(c, m, indexing="xy")
    d = eq1_latency(p, C, M)
    return {
        "positive": bool(torch.all(d > 0)),
        "decreasing_cpu": bool(torch.all(_eq1_grad(p, C, M, 0) < 0)),
        "decreasing_mem": bool(torch.all(_eq1_grad(p, C, M, 1) < 0)),
        "convex_cpu": bool(torch.all(_eq1_grad(p, C, M, 0, order=2) > 0)),
        "convex_mem": bool(torch.all(_eq1_grad(p, C, M, 1, order=2) > 0)),
    }
