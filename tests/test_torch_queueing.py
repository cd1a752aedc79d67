"""Port parity: repro_torch.core.queueing against repro.core.queueing.

Every Erlang function is evaluated on the same inputs by the JAX reference and
by the torch port (float64, CPU) and must agree at rtol 1e-12, including the
``width``-narrowed sums and the unstable branch (+inf). The closed-form
derivatives of ``erlang_ws_derivs`` are held against torch autograd at rtol
1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queueing as rq
from repro_torch.core import queueing as tq

CASES = [
    (7.0, 8.0, 1.4),
    (3.0, 10.0, 3.5),
    (2.0, 0.3, 0.2),
    (40.0, 30.0, 0.8),
    (128.0, 64.0, 0.6),
    (1.0, 0.5, 0.7),
    (2.0, 10.0, 1.0),  # rho = 5: unstable
    (4.0, 8.0, 2.0),  # rho = 1 exactly: unstable
]
FUNCS = ["erlang_pi0", "erlang_ls", "erlang_ws", "erlang_wait_prob",
         "erlang_wait_quantile", "erlang_ws_finite"]


def _close(port, ref, rtol=1e-12):
    port = np.asarray(port.detach().numpy() if torch.is_tensor(port) else port)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol, atol=0)
    np.testing.assert_array_equal(port[~fin], ref[~fin])


@pytest.mark.parametrize("N,lam,mu", CASES)
@pytest.mark.parametrize("fn", FUNCS)
def test_scalar_functions_match_reference(fn, N, lam, mu):
    _close(getattr(tq, fn)(N, lam, mu), getattr(rq, fn)(N, lam, mu))


@pytest.mark.parametrize("N,lam,mu", CASES)
def test_closed_form_derivatives_match_reference(N, lam, mu):
    for port, ref in zip(tq.erlang_ws_derivs(N, lam, mu), rq.erlang_ws_derivs(N, lam, mu)):
        if np.isfinite(float(rq.erlang_ws(N, lam, mu))):
            _close(port, ref)
    for port, ref in zip(tq.erlang_wait_quantile_derivs(N, lam, mu, q=0.9),
                         rq.erlang_wait_quantile_derivs(N, lam, mu, q=0.9)):
        if np.isfinite(float(rq.erlang_ws(N, lam, mu))):
            _close(port, ref)


def _grid():
    rng = np.random.default_rng(0)
    N = rng.integers(1, 16, (5, 9)).astype(float)
    lam = rng.uniform(0.5, 20.0, (5, 9))
    mu = rng.uniform(0.5, 6.0, (5, 9))
    return N, lam, mu


@pytest.mark.parametrize("width", [None, 16, 32])
@pytest.mark.parametrize("fn", ["erlang_ws", "erlang_pi0", "erlang_wait_prob"])
def test_batched_and_narrowed_match_reference(fn, width):
    """Broadcast (batched) evaluation against the reference's vmap, with the
    exact ``width`` narrowing (every N here is <= 16); about half the grid
    is unstable."""
    N, lam, mu = _grid()
    ref_fn = jax.vmap(jax.vmap(lambda n, la, m: getattr(rq, fn)(n, la, m, width=width)))
    ref = ref_fn(jnp.asarray(N), jnp.asarray(lam), jnp.asarray(mu))
    port = getattr(tq, fn)(torch.as_tensor(N), torch.as_tensor(lam), torch.as_tensor(mu),
                           width=width)
    assert port.dtype == torch.float64 and port.shape == N.shape
    _close(port, ref)
    if fn == "erlang_ws":
        assert (~np.isfinite(np.asarray(ref))).sum() > 0  # the unstable branch is hit


def test_width_narrowing_is_exact_in_the_port():
    N, lam, mu = _grid()
    wide = tq.erlang_ws(torch.as_tensor(N), torch.as_tensor(lam), torch.as_tensor(mu))
    narrow = tq.erlang_ws(torch.as_tensor(N), torch.as_tensor(lam), torch.as_tensor(mu),
                          width=16)
    _close(narrow, wide, rtol=1e-14)


@pytest.mark.parametrize("N,lam,mu", CASES[:6])
def test_ws_derivs_match_autograd(N, lam, mu):
    ws, d1, d2 = tq.erlang_ws_derivs(N, lam, mu)
    m = torch.tensor(mu, dtype=torch.float64, requires_grad=True)
    f = tq.erlang_ws(N, lam, m)
    (g,) = torch.autograd.grad(f, m, create_graph=True)
    (h,) = torch.autograd.grad(g, m)
    assert float(ws) == pytest.approx(float(f.detach()), rel=1e-12)
    assert float(d1) == pytest.approx(float(g.detach()), rel=1e-8)
    assert float(d2) == pytest.approx(float(h), rel=1e-8)


def test_quantile_is_differentiable_on_the_stable_region():
    m = torch.tensor(1.4, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tq.erlang_wait_quantile(7.0, 8.0, m), m)
    ref = jax.grad(lambda mm: rq.erlang_wait_quantile(7.0, 8.0, mm))(jnp.asarray(1.4))
    assert float(g) == pytest.approx(float(ref), rel=1e-9)


@pytest.mark.parametrize("N,lam,mu", CASES)
def test_scalar_oracles_and_stability_bound_match(N, lam, mu):
    assert tq.erlang_ws_np(N, lam, mu) == rq.erlang_ws_np(N, lam, mu)
    assert tq.erlang_wait_prob_np(N, lam, mu) == rq.erlang_wait_prob_np(N, lam, mu)
    assert tq.erlang_wait_quantile_np(N, lam, mu) == rq.erlang_wait_quantile_np(N, lam, mu)
    assert tq.stability_lower_bound(lam, mu) == rq.stability_lower_bound(lam, mu)
    if np.isfinite(rq.erlang_ws_np(N, lam, mu)):
        assert float(tq.erlang_ws(N, lam, mu)) == pytest.approx(tq.erlang_ws_np(N, lam, mu),
                                                                rel=1e-10)
