"""Numerical checks of the paper's Theorems 2-4 on the port (repro_torch,
device="cpu"), as ``tests/test_theorems.py`` makes them on the reference:

* Theorem 2: F_i of SP1 strictly convex in (c, m) and decreasing in m —
  its float64 Hessian by ``torch.autograd``: h_cc > 0, h_mm > 0,
  |h_cm| <= 1e-10 (Eq. 22), dF/dm < 0; the derivatives also against the
  reference's ``jax.grad`` ones;
* Theorem 3: Φ(N) convex in N;
* Theorem 4: the P1 objective midpoint-convex along random feasible segments.

Theorem 1 is a brute-force knapsack check that touches neither package, so
it is not repeated here.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro.core import problem as ref_problem
from repro.core import profiler as ref_profiler
from repro.core import solvers as ref_solvers
from repro_torch.core import engine
from repro_torch.core.problem import ServerCaps, service_rate
from repro_torch.core.profiler import make_paper_apps
from repro_torch.core.solvers import phi, sp1_objective, sp1_solve

CPU = "cpu"
CAPS = ServerCaps(r_cpu=30.0, r_mem=10.0)
APPS = make_paper_apps(fitted=False)
GRID_C = np.linspace(0.3, 5.0, 7)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _derivs(app, c, m):
    """(dF/dm, h_cc, h_mm, h_cm) of SP1's F_i at (c, m), by torch.autograd."""
    def f(cc, mm):
        return sp1_objective(app, CAPS, 1.4, 0.2, cc, mm, device=CPU)

    point = (torch.tensor(c, dtype=torch.float64), torch.tensor(m, dtype=torch.float64))
    (h_cc, h_cm), (_, h_mm) = torch.autograd.functional.hessian(f, point)
    g_m = torch.autograd.functional.jacobian(f, point)[1]
    return float(g_m), float(h_cc), float(h_mm), float(h_cm)


@pytest.mark.parametrize("i", range(4), ids=[a.name for a in APPS])
def test_theorem2_convexity_and_monotonicity(i):
    """F_i strictly convex in (c, m); monotone decreasing in m."""
    app = APPS[i]
    for c in GRID_C:
        for m in np.linspace(app.r_min, app.r_max, 5):
            g_m, h_cc, h_mm, h_cm = _derivs(app, c, m)
            assert h_cc > 0, (app.name, c, m)
            assert h_mm > 0
            assert abs(h_cm) <= 1e-10  # Eq. (22)
            assert g_m < 0  # optimal memory = r_max


@pytest.mark.parametrize("i", range(4), ids=[a.name for a in APPS])
def test_theorem2_derivatives_match_reference(i):
    app, ref_app = APPS[i], ref_profiler.make_paper_apps(fitted=False)[i]
    ref_caps = ref_problem.ServerCaps(30.0, 10.0)

    def f(c, m):
        return ref_solvers.sp1_objective(ref_app, ref_caps, 1.4, 0.2, c, m)

    for c in GRID_C:
        m = 0.5 * (app.r_min + app.r_max)
        g_m, h_cc, h_mm, _ = _derivs(app, c, m)
        np.testing.assert_allclose(
            [g_m, h_cc, h_mm],
            [float(jax.grad(f, 1)(c, m)), float(jax.grad(jax.grad(f, 0), 0)(c, m)),
             float(jax.grad(jax.grad(f, 1), 1)(c, m))],
            rtol=1e-9)


@pytest.mark.parametrize("i", range(4), ids=[a.name for a in APPS])
def test_theorem3_phi_convex_in_n(i):
    app = APPS[i]
    c_star, m_star = sp1_solve(app, CAPS, 1.4, 0.2, device=CPU)
    mu = float(service_rate(app, c_star, m_star, device=CPU))
    lo = int(np.ceil(app.lam / mu)) + 1
    vals = phi(app, CAPS, 1.4, 0.2, torch.arange(lo, lo + 12, dtype=torch.float64), mu,
               c_star).tolist()
    for a, b, c in zip(vals, vals[1:], vals[2:]):
        assert a + c - 2 * b >= -1e-9


def test_theorem4_p1_convex_along_segments():
    """P1 objective convex over (c, m) with N fixed: midpoint convexity along
    random feasible segments."""
    packed = engine.PackedApps.from_apps(APPS).as_dict(CPU)
    # generous container counts keep a usable slice of the stable region
    n = torch.tensor([8.0, 9.0, 4.0, 9.0], dtype=torch.float64)
    rng = np.random.default_rng(0)

    def f(x):
        return float(engine.p1_objective(torch.as_tensor(x), packed, n, CAPS.r_cpu, CAPS.r_mem,
                                         CAPS.power.span, 1.4, 0.2))

    M = len(APPS)
    checked = 0
    for _ in range(200):
        c1 = rng.uniform(1.2, 4.0, M)
        c2 = rng.uniform(1.2, 4.0, M)
        m1 = np.array([rng.uniform(0.6 * a.r_min + 0.4 * a.r_max, a.r_max) for a in APPS])
        m2 = np.array([rng.uniform(0.6 * a.r_min + 0.4 * a.r_max, a.r_max) for a in APPS])
        x1, x2 = np.concatenate([c1, m1]), np.concatenate([c2, m2])
        fx1, fx2, fmid = f(x1), f(x2), f(0.5 * (x1 + x2))
        if not (np.isfinite(fx1) and np.isfinite(fx2) and np.isfinite(fmid)):
            continue  # segment crosses the instability boundary
        assert fmid <= 0.5 * (fx1 + fx2) + 1e-6
        checked += 1
    assert checked > 20
