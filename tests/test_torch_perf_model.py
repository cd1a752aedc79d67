"""Port parity: repro_torch.core.perf_model / profiler against repro.

Eq. (1) and the other Table-I families agree at rtol 1e-12 on the same inputs.
The port's multi-start Levenberg-Marquardt fit draws its starts from
``np.random.default_rng`` instead of ``jax.random``; the fitted optimum does
not depend on the starts, so the fitted κ of the four paper apps agree with
the reference's within rtol 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import perf_model as rpm
from repro.core import profiler as rp
from repro_torch.core import perf_model as tpm
from repro_torch.core import profiler as tp


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs():
    rng = np.random.default_rng(0)
    params = rng.uniform(0.2, 3.0, 4)
    params[0] *= 40.0
    return params, rng.uniform(0.1, 8.0, 64), rng.uniform(0.1, 1.0, 64)


@pytest.mark.parametrize("family", sorted(tpm.FAMILIES))
def test_families_match_reference(family):
    params, cpu, mem = _inputs()
    ref = np.asarray(rpm.FAMILIES[family].fn(jnp.asarray(params), jnp.asarray(cpu),
                                             jnp.asarray(mem)))
    port = tpm.FAMILIES[family].fn(torch.as_tensor(params), torch.as_tensor(cpu),
                                   torch.as_tensor(mem))
    assert port.dtype == torch.float64
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-12)


def test_profiles_match_reference():
    ref, port = rp.profile_all(seed=3), tp.profile_all(seed=3)
    for name in rp.PAPER_APPS_TRUE:
        np.testing.assert_array_equal(port[name].cpu, ref[name].cpu)
        np.testing.assert_array_equal(port[name].mem, ref[name].mem)
        np.testing.assert_allclose(port[name].latency_ms, ref[name].latency_ms, rtol=1e-14)


def test_fitted_paper_apps_match_reference():
    """make_paper_apps(fitted=True): 12 starts x 200 LM steps per app."""
    ref = rp.make_paper_apps(lam=(8, 7, 10, 15), fitted=True)
    port = tp.make_paper_apps(lam=(8, 7, 10, 15), fitted=True, device="cpu")
    for r, p in zip(ref, port):
        assert p.name == r.name
        np.testing.assert_allclose(p.kappa, r.kappa, rtol=1e-8)
        assert (p.lam, p.xbar, p.r_min, p.r_max, p.cpu_min, p.cpu_max) == (
            r.lam, r.xbar, r.r_min, r.r_max, r.cpu_min, r.cpu_max)


@pytest.mark.parametrize("family", sorted(tpm.FAMILIES))
def test_fit_quality_matches_reference(family):
    """Every family's best fit reaches the reference's RMSE (the parameters
    of the scale-invariant 'rational' family are not identifiable, so the
    loss is what is compared)."""
    p = rp.profile_app("MobileNet_v2", seed=1)
    ref = rpm.fit_family(family, p.cpu, p.mem, p.latency_ms, n_starts=4, iters=60)
    port = tpm.fit_family(family, p.cpu, p.mem, p.latency_ms, n_starts=4, iters=60,
                          device="cpu")
    assert port.rmse == pytest.approx(ref.rmse, rel=1e-8)
    assert port.r2 == pytest.approx(ref.r2, rel=1e-8)
    assert port.converged == ref.converged
    np.testing.assert_allclose(port.predict(p.cpu, p.mem, device="cpu"),
                               ref.predict(p.cpu, p.mem),
                               rtol=1e-6)
    if family != "rational":
        np.testing.assert_allclose(port.params, ref.params, rtol=1e-6)


@pytest.mark.parametrize(
    "kappa", [(96.0, 1.1, 0.9), (24.0, 1.6, 0.45), (-5.0, 1.0, 0.5), (30.0, 1.0, -0.4)]
)
def test_shape_flags_match_reference(kappa):
    assert tpm.validate_eq1_shape(np.asarray(kappa), device="cpu") == rpm.validate_eq1_shape(
        np.asarray(kappa))


@pytest.mark.parametrize("name", sorted(rp.PAPER_APPS_TRUE))
def test_sensitivities_match_reference(name):
    kappa = np.asarray(rp.PAPER_APPS_TRUE[name]["kappa"])
    for c, m in [(1.0, 0.4), (4.0, 0.2), (0.3, 0.7)]:
        assert float(tpm.cpu_sensitivity(kappa, c, m, device="cpu")) == pytest.approx(
            float(rpm.cpu_sensitivity(kappa, c, m)), rel=1e-12)
        assert float(tpm.mem_sensitivity(kappa, c, m, device="cpu")) == pytest.approx(
            float(rpm.mem_sensitivity(kappa, c, m)), rel=1e-12)


def test_fit_best_family_reproduces_table1():
    """Table I through the port alone: Eq. (1) has the lowest RMSE of the
    five families on the MobileNet profile, as in tests/test_perf_model.py."""
    p = rp.profile_app("MobileNet_v2", seed=1)
    fits = tpm.fit_best_family(p.cpu, p.mem, p.latency_ms, n_starts=4, device="cpu")
    assert sorted(fits) == sorted(tpm.FAMILIES)
    rmses = {k: v.rmse for k, v in fits.items()}
    assert min(rmses, key=rmses.get) == "eq1", rmses
    assert fits["eq1"].r2 > 0.99
