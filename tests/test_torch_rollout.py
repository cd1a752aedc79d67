"""The port's candidate-batched CRN rollouts (``des_vector.rollout_candidates``
on the CPU) against the reference's, on the cases of tests/test_rollout.py
and at ``make_tenant_mix(8)`` with B = 1 and B = 2M + 1 (the incumbent and
its 2M ±1 moves, the refinement's batch): per-app and pooled mean and p95
within rtol 1e-12 of the reference's ``numpy`` and ``jax`` backends, the
warmup slice, zero-server candidates at inf, apps without arrivals at NaN,
the lazy statistics, the bounded CRN cache and the validation errors."""
import numpy as np
import pytest
import torch

from repro.core import des_vector as ref_vec
from repro.core.profiler import make_tenant_mix as ref_tenant_mix
from repro_torch.core import des, des_vector
from repro_torch.core.des_vector import _CRN_CACHE, _CRN_CACHE_MAX, rollout_candidates

MIX = [("a", 8.0, 1.8, 6), ("b", 15.0, 3.3, 7), ("c", 2.0, 5.0, 1)]
NAMES = [m[0] for m in MIX]
LAM = np.array([m[1] for m in MIX])
MU = np.array([[m[2] for m in MIX]])  # (1, M)
NS = np.array([[m[3] for m in MIX]])  # (1, M)
STATS = ("mean_s", "p95_s", "pooled_mean_s", "pooled_p95_s")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_stats(port, ref, rtol=1e-12):
    np.testing.assert_array_equal(port.n_arrivals, ref.n_arrivals)
    np.testing.assert_array_equal(port.n_scored, ref.n_scored)
    assert port.n_events == ref.n_events
    for k in STATS:
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k), rtol=rtol, atol=0.0,
                                   err_msg=k)


def _mix8_candidates():
    """make_tenant_mix(8)'s apps at mid-range quotas, the incumbent n0 and
    its 2M ±1 moves (B = 17), as the refinement builds them."""
    apps, _, n0 = ref_tenant_mix(8)
    M = len(apps)
    rng = np.random.default_rng(8)
    kap = np.array([a.kappa for a in apps])
    c = rng.uniform(1.0, 2.5, (2 * M + 1, M))
    m = np.array([0.5 * (a.r_min + a.r_max) for a in apps])[None, :].repeat(2 * M + 1, 0)
    d_ms = kap[:, 0] / (1.0 - np.exp(-kap[:, 1] * c)) + np.exp(kap[:, 2] / m)
    mu = 1000.0 / (np.array([a.xbar for a in apps])[None, :] * d_ms)
    n = np.vstack([n0] + [n0 + s * np.eye(M, dtype=int)[i] for i in range(M) for s in (-1, 1)])
    return [a.name for a in apps], np.array([a.lam for a in apps]), mu, n


@pytest.mark.parametrize("B", [1, 17])
def test_mix8_rollout_matches_the_reference(B):
    names, lam, mu, n = _mix8_candidates()
    kw = dict(horizon_s=20.0, seed=0, warmup_s=4.0)
    port = rollout_candidates(names, lam, mu[:B], n[:B], device="cpu", **kw)
    for backend in ("numpy", "jax"):
        _assert_stats(port, ref_vec.rollout_candidates(names, lam, mu[:B], n[:B],
                                                       backend=backend, **kw))
    assert np.all(np.isfinite(port.p95_s))


def test_b1_parity_with_the_port_vector_engine():
    horizon = 200.0
    ro = rollout_candidates(NAMES, LAM, MU, NS, horizon, seed=7, device="cpu")
    _assert_stats(ro, ref_vec.rollout_candidates(NAMES, LAM, MU, NS, horizon, seed=7))
    sim = des.FleetSimulator(seed=7, engine="vector", device="cpu")
    for i, name in enumerate(NAMES):
        sim.add_app(name, float(LAM[i]), float(MU[0, i]), int(NS[0, i]))
    sim.run_until(horizon)
    sim.drain()
    resp = [sim.responses(name, 0.0, horizon) for name in NAMES]
    for i, r in enumerate(resp):
        assert ro.n_arrivals[i] == r.shape[0]
        assert ro.mean_s[0, i] == pytest.approx(float(np.mean(r)), rel=1e-12)
        assert ro.p95_s[0, i] == pytest.approx(float(np.percentile(r, 95)), rel=1e-12)
    pooled = np.concatenate(resp)
    assert ro.pooled_p95_s[0] == pytest.approx(float(np.percentile(pooled, 95)), rel=1e-12)


def test_warmup_scores_only_post_warmup_arrivals():
    port = rollout_candidates(NAMES, LAM, MU, NS, 200.0, seed=7, warmup_s=50.0, device="cpu")
    full = rollout_candidates(NAMES, LAM, MU, NS, 200.0, seed=7, device="cpu")
    _assert_stats(port, ref_vec.rollout_candidates(NAMES, LAM, MU, NS, 200.0, seed=7,
                                                   warmup_s=50.0))
    assert np.all(port.n_scored < full.n_scored)
    np.testing.assert_array_equal(port.n_arrivals, full.n_arrivals)


def test_paired_mh_candidates_match():
    """Several μ and n per app, an H2 law and an MMPP arrival list."""
    mu_all = np.vstack([MU[0], MU[0] * 1.1, MU[0] * 0.95])
    n_all = np.vstack([NS[0], NS[0] + 1, np.maximum(NS[0] - 1, 1)])
    arrival = [None, {"kind": "mmpp", "rates": [0.5, 2.5], "sojourn": [30.0, 10.0]}, None]
    for kw in ({}, {"service": "h2", "h2_scv": 4.0}, {"arrival": arrival}):
        port = rollout_candidates(NAMES, LAM, mu_all, n_all, 120.0, seed=3, device="cpu", **kw)
        _assert_stats(port, ref_vec.rollout_candidates(NAMES, LAM, mu_all, n_all, 120.0,
                                                       seed=3, backend="numpy", **kw))


def test_zero_server_candidate_scores_inf_not_garbage():
    mu_all = np.vstack([MU[0], MU[0]])
    n_all = np.vstack([NS[0], NS[0]])
    n_all[1, 0] = 0  # candidate 1 starves app "a"
    ro = rollout_candidates(NAMES, LAM, mu_all, n_all, 80.0, seed=1, device="cpu")
    _assert_stats(ro, ref_vec.rollout_candidates(NAMES, LAM, mu_all, n_all, 80.0, seed=1))
    assert ro.mean_s[1, 0] == np.inf and ro.p95_s[1, 0] == np.inf
    assert np.isfinite(ro.mean_s[1, 1:]).all() and np.isfinite(ro.mean_s[0]).all()
    assert ro.pooled_mean_s[1] == np.inf and np.isfinite(ro.pooled_mean_s[0])


def test_no_arrivals_is_nan_not_inf():
    ro = rollout_candidates(["idle"], [1e-9], np.array([[2.0]]), np.array([[1]]), 1.0,
                            seed=0, device="cpu")
    assert ro.n_events == 0
    assert np.isnan(ro.mean_s).all() and np.isnan(ro.p95_s).all()
    assert np.isnan(ro.pooled_mean_s).all()


def test_stats_are_lazy_and_cached():
    ro = rollout_candidates(NAMES, LAM, MU, NS, 60.0, seed=2, device="cpu")
    assert isinstance(ro._raw[0], torch.Tensor)  # the waits stay where the scan ran
    m1 = ro.mean_s
    assert ro._raw is None  # the first access consumed (and released) the raws
    assert ro.mean_s is m1
    assert np.isfinite(ro.p95_s).all() and np.isfinite(ro.pooled_p95_s).all()


def test_crn_cache_reuses_draws_and_stays_bounded():
    _CRN_CACHE.clear()
    a = rollout_candidates(NAMES, LAM, MU, NS, 60.0, seed=5, device="cpu")
    key = next(iter(_CRN_CACHE))
    assert key[-1] == torch.device("cpu")  # keyed by the device ...
    assert isinstance(_CRN_CACHE[key][4], torch.Tensor)  # ... and committed to it once
    b = rollout_candidates(NAMES, LAM, MU, NS, 60.0, seed=5, device="cpu")
    assert len(_CRN_CACHE) == 1
    np.testing.assert_array_equal(a.mean_s, b.mean_s)
    rollout_candidates(NAMES, LAM, MU, NS, 60.0, seed=5, backend="numpy")
    assert len(_CRN_CACHE) == 2  # the host loop's draws stay NumPy, keyed apart
    for s in range(2 * _CRN_CACHE_MAX):  # distinct keys evict oldest-first
        rollout_candidates(NAMES, LAM, MU, NS, 60.0, seed=100 + s, device="cpu")
    assert len(_CRN_CACHE) <= _CRN_CACHE_MAX


@pytest.mark.parametrize("call,match", [
    (lambda f: f(NAMES, LAM, MU[0], NS[0], 10.0), r"\(B, M\)"),
    (lambda f: f(NAMES, LAM, MU, NS[:, :2], 10.0), r"\(B, M\)"),
    (lambda f: f(NAMES[:2], LAM, MU, NS, 10.0), "names"),
    (lambda f: f(NAMES, LAM, 0.0 * MU, NS, 10.0), "mu"),
    (lambda f: f(NAMES, LAM, MU, NS, 10.0, warmup_s=10.0), "warmup"),
    (lambda f: f(NAMES, LAM, MU, NS, 10.0, backend="fortran"), "backend"),
])
def test_validation_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call(lambda *a, **k: rollout_candidates(*a, device="cpu", **k))
    with pytest.raises(ValueError, match=match):
        call(ref_vec.rollout_candidates)
    assert des_vector._BACKENDS == ("auto", "torch", "numpy")
