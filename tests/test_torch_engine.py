"""Port parity of the batched engine and the modules around it: PackedApps,
the phase-1 start, grid seeding, the structured and dense Newton directions,
the batched P1 interior point at the "reference" and "refine" profiles,
infeasibility naming, Algorithm 1's batched inner solves, batch_eval, the
problem module and the serial solvers — repro (JAX, CPU) against repro_torch
(device="cpu") on the same inputs.

Bars (the reference's own): utility rtol 1e-6, quotas rtol 1e-5, Newton
direction rtol 1e-9 against the reference (1e-6 structured vs dense),
phase-1 starts and grid-seeded hints exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_eval as rbe
from repro.core import engine as reng
from repro.core import problem as rprob
from repro.core import profiler as rprof
from repro.core import solvers as rsol
from repro_torch import interop
from repro_torch.core import batch_eval as tbe
from repro_torch.core import engine as teng
from repro_torch.core import problem as tprob
from repro_torch.core import solvers as tsol

ALPHA, BETA = 1.4, 0.2
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _port(apps, caps):
    port_apps = interop.apps_from_arrays(
        [a.name for a in apps], [a.kappa for a in apps],
        *([getattr(a, f) for a in apps]
          for f in ("lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max")),
    )
    return port_apps, interop.caps_from_values(caps.r_cpu, caps.r_mem, caps.power.p_idle,
                                               caps.power.p_full)


def _neighbors(n0):
    M = len(n0)
    return np.stack(
        [n0 + d * np.eye(M, dtype=int)[i] for i in range(M) for d in (-1, +1)]
    ).astype(float)


@pytest.fixture(scope="module")
def mix8():
    apps, caps, n0 = rprof.make_tenant_mix(8)
    port_apps, port_caps = _port(apps, caps)
    return {
        "ref": (apps, caps, reng.PackedApps.from_apps(apps)),
        "port": (port_apps, port_caps, teng.PackedApps.from_apps(port_apps)),
        "n0": n0,
    }


PAPER = rprof.make_paper_apps(lam=(8, 7, 10, 15), fitted=False)
CAPS4 = rprob.ServerCaps(30.0, 10.0)
# (caps, rows) from the reference's engine tests: feasible rows plus one whose
# memory demand alone busts the budget
SCENARIOS = [
    ((30.0, 10.0), [[6, 7, 3, 7], [5, 7, 3, 7], [6, 6, 3, 7], [40, 40, 40, 40]]),
    ((28.0, 9.0), [[5, 6, 3, 6], [5, 6, 4, 6], [30, 30, 30, 30]]),
    ((120.0, 40.0), [[8, 10, 4, 9], [7, 10, 4, 9], [8, 9, 4, 9], [80, 80, 80, 80]]),
]


def test_packed_apps_match(mix8):
    ref, port = mix8["ref"][2], mix8["port"][2]
    for f in ("kappa", "lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    d = port.as_dict(CPU)
    assert all(v.dtype == torch.float64 and v.device == CPU for v in d.values())
    assert d["lam"] is port.as_dict("cpu")["lam"]  # cached leaves, fresh shell
    assert teng.as_packed(port) is port


@pytest.mark.parametrize("caps,rows", SCENARIOS)
@pytest.mark.parametrize("hint", [None, "ones2"])
def test_feasible_start_exact(caps, rows, hint):
    ref_apps, ref_caps = PAPER, rprob.ServerCaps(*caps)
    port_apps, port_caps = _port(ref_apps, ref_caps)
    c_hint = None if hint is None else np.full(4, 2.0)
    x_r, ok_r = reng.find_feasible_start_batch(reng.PackedApps.from_apps(ref_apps), ref_caps,
                                               np.asarray(rows, float), c_hint=c_hint)
    x_p, ok_p = teng.find_feasible_start_batch(teng.PackedApps.from_apps(port_apps), port_caps,
                                               np.asarray(rows, float), c_hint=c_hint)
    np.testing.assert_array_equal(ok_p, ok_r)
    np.testing.assert_array_equal(x_p[ok_r], x_r[ok_r])


def test_feasible_start_masked_rows_exact(mix8):
    n = _neighbors(mix8["n0"])
    mask = np.ones_like(n, dtype=bool)
    mask[::3, 5] = False
    x_r, ok_r = reng.find_feasible_start_batch(mix8["ref"][2], mix8["ref"][1], n, mask=mask)
    x_p, ok_p = teng.find_feasible_start_batch(mix8["port"][2], mix8["port"][1], n, mask=mask)
    np.testing.assert_array_equal(ok_p, ok_r)
    np.testing.assert_array_equal(x_p[ok_r], x_r[ok_r])


@pytest.mark.parametrize("alpha", [ALPHA, "vector"])
def test_grid_seed_oracle_exact(mix8, alpha):
    n = _neighbors(mix8["n0"])
    a = np.linspace(0.5, 2.0, 8) if alpha == "vector" else alpha
    ref = reng.grid_seed_chints(mix8["ref"][2], mix8["ref"][1], n, a, BETA, backend="oracle")
    port = teng.grid_seed_chints(mix8["port"][2], mix8["port"][1], n, a, BETA, device="cpu")
    np.testing.assert_array_equal(port, ref)


def test_grid_seed_kernel_path_matches_pallas(mix8):
    """backend="kernel" on CPU tensors runs the plain float32 version; the
    reference's interpreted Pallas kernel picks the same argmin cells (the
    float32 terms may flip near-tied cells, as the reference accepts for its
    kernel vs oracle)."""
    n = _neighbors(mix8["n0"])
    ref = reng.grid_seed_chints(mix8["ref"][2], mix8["ref"][1], n, ALPHA, BETA,
                                backend="interpret")
    port = teng.grid_seed_chints(mix8["port"][2], mix8["port"][1], n, ALPHA, BETA,
                                 backend="kernel", device="cpu")
    assert port.shape == ref.shape
    assert np.mean(port == ref) >= 0.9


def _direction_args(mix8, t):
    ref_apps, ref_caps, ref_packed = mix8["ref"]
    n_b = np.asarray(mix8["n0"], dtype=float)[None, :]
    x0, ok = reng.find_feasible_start_batch(ref_packed, ref_caps, n_b)
    assert ok[0]
    ref_args = (ref_packed.jax_dict, jnp.asarray(n_b[0]), jnp.asarray(float(ref_caps.r_cpu)),
                jnp.asarray(float(ref_caps.r_mem)), jnp.asarray(float(ref_caps.power.span)),
                ALPHA, BETA)
    port_args = (mix8["port"][2].as_dict(CPU), torch.as_tensor(n_b[0]),
                 float(ref_caps.r_cpu), float(ref_caps.r_mem), float(ref_caps.power.span),
                 ALPHA, BETA)
    return x0[0], ref_args, port_args


@pytest.mark.parametrize("t", [1.0, 36.0, 6.0**6])
def test_structured_direction_matches_reference(mix8, t):
    x0, ref_args, port_args = _direction_args(mix8, t)
    ref = reng._newton_direction_structured(jnp.asarray(x0), jnp.asarray(t), *ref_args)
    port = teng._newton_direction_structured(torch.as_tensor(x0), t, *port_args)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-9)
    # batched rows give the same direction as the single row
    both = teng._newton_direction_structured(
        torch.as_tensor(np.stack([x0, x0])), t, port_args[0], port_args[1].expand(2, -1),
        *port_args[2:])
    np.testing.assert_allclose(both.numpy()[1], port.numpy(), rtol=1e-14)


@pytest.mark.parametrize("t", [1.0, 36.0, 6.0**6])
def test_dense_direction_matches_structured(mix8, t):
    x0, _, port_args = _direction_args(mix8, t)
    x = torch.as_tensor(x0)[None, :]
    args = (port_args[0], port_args[1][None, :], *port_args[2:])
    dense = teng._newton_direction_dense(x, t, *args)
    struct = teng._newton_direction_structured(x, t, *args)
    np.testing.assert_allclose(struct.numpy(), dense.numpy(), rtol=1e-6)


@pytest.mark.parametrize("profile", ["refine", "reference"])
def test_p1_batch_matches_reference(mix8, profile):
    n = _neighbors(mix8["n0"])
    ref = reng.p1_solve_batch(mix8["ref"][2], mix8["ref"][1], n, ALPHA, BETA, profile=profile)
    port = teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n, ALPHA, BETA,
                               profile=profile, device="cpu")
    assert port.info == ref.info
    np.testing.assert_array_equal(port.converged, ref.converged)
    np.testing.assert_array_equal(port.started, ref.started)
    conv = ref.converged
    assert conv.any()
    np.testing.assert_allclose(port.utility[conv], ref.utility[conv], rtol=1e-6)
    np.testing.assert_allclose(port.r_cpu[conv], ref.r_cpu[conv], rtol=1e-5)
    np.testing.assert_allclose(port.r_mem[conv], ref.r_mem[conv], rtol=1e-5)


@pytest.mark.parametrize("options", [{"seed_grid": True}, {"tail_q": 0.95},
                                     {"max_servers": 16}, {"alpha": "vector"}])
def test_p1_batch_options_match_reference(mix8, options):
    n = _neighbors(mix8["n0"])[:5]
    kw = dict(options)
    a = np.linspace(0.5, 2.0, 8) if kw.pop("alpha", None) == "vector" else ALPHA
    ref = reng.p1_solve_batch(mix8["ref"][2], mix8["ref"][1], n, a, BETA, profile="refine", **kw)
    port = teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n, a, BETA, profile="refine",
                               device="cpu", **kw)
    assert port.info == ref.info
    conv = ref.converged
    np.testing.assert_array_equal(port.converged, conv)
    np.testing.assert_allclose(port.utility[conv], ref.utility[conv], rtol=1e-6)
    np.testing.assert_allclose(port.r_cpu[conv], ref.r_cpu[conv], rtol=1e-5)


def test_dense_solver_matches_structured(mix8):
    n = _neighbors(mix8["n0"])[[0, 5, 11]]
    kw = dict(profile="refine", device="cpu")
    dense = teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n, ALPHA, BETA,
                                solver="dense", **kw)
    struct = teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n, ALPHA, BETA, **kw)
    np.testing.assert_array_equal(dense.converged, struct.converged)
    conv = dense.converged
    assert conv.any()
    np.testing.assert_allclose(struct.utility[conv], dense.utility[conv], rtol=1e-6)
    np.testing.assert_allclose(struct.r_cpu[conv], dense.r_cpu[conv], rtol=1e-4)


@pytest.mark.parametrize("caps,counts", [((0.05, 0.01), 1.0), ((30.0, 10.0), 40.0),
                                         ((2.0, 10.0), 2.0), ((30.0, 10.0), 1.0)])
def test_infeasible_binding_matches_reference(caps, counts):
    ref_caps = rprob.ServerCaps(*caps)
    port_apps, port_caps = _port(PAPER, ref_caps)
    n = np.full((2, 4), counts)
    ref = reng.p1_solve_batch(PAPER, ref_caps, n, ALPHA, BETA)
    port = teng.p1_solve_batch(port_apps, port_caps, n, ALPHA, BETA, device="cpu")
    assert port.info == ref.info
    if ref.info.get("binding"):
        with pytest.raises(reng.InfeasibleAllocation) as r_exc:
            reng.p1_solve_batch(PAPER, ref_caps, n, ALPHA, BETA, on_infeasible="raise")
        with pytest.raises(teng.InfeasibleAllocation) as p_exc:
            teng.p1_solve_batch(port_apps, port_caps, n, ALPHA, BETA, on_infeasible="raise",
                                device="cpu")
        assert p_exc.value.binding == r_exc.value.binding
        assert p_exc.value.detail == r_exc.value.detail


def test_p1_batch_argument_checks(mix8):
    n = _neighbors(mix8["n0"])
    with pytest.raises(ValueError, match="on_infeasible"):
        teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n, ALPHA, BETA,
                            on_infeasible="explode", device="cpu")
    with pytest.raises(ValueError, match="max_servers"):
        teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n, ALPHA, BETA, max_servers=4,
                            device="cpu")
    with pytest.raises(ValueError, match="n_batch"):
        teng.p1_solve_batch(mix8["port"][2], mix8["port"][1], n[0], ALPHA, BETA, device="cpu")


@pytest.mark.parametrize("alpha", [ALPHA, "vector"])
def test_ideal_configs_match_reference(mix8, alpha):
    a = np.linspace(0.5, 2.0, 8) if alpha == "vector" else alpha
    ref = reng.ideal_configs_batch(mix8["ref"][2], mix8["ref"][1], a, BETA)
    port = teng.ideal_configs_batch(mix8["port"][2], mix8["port"][1], a, BETA, device="cpu")
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=1e-12)
    np.testing.assert_array_equal(port[2], ref[2])
    capped = teng.ideal_configs_batch(mix8["port"][2], mix8["port"][1], a, BETA, n_cap=6,
                                      device="cpu")
    np.testing.assert_array_equal(
        capped[2], reng.ideal_configs_batch(mix8["ref"][2], mix8["ref"][1], a, BETA, n_cap=6)[2])


# ----------------------------------------------------------------------------
# batch_eval
# ----------------------------------------------------------------------------
def _candidates(seed=0, B=48):
    rng = np.random.default_rng(seed)
    n = rng.integers(2, 12, (B, 4)).astype(float)
    c = rng.uniform(0.3, 3.0, (B, 4))
    m = np.stack([rng.uniform(a.r_min, a.r_max, B) for a in PAPER], axis=1)
    m[::7, 2] = 0.05  # below r_min: bounds-infeasible rows
    return n, c, m


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("tail_q", [0.0, 0.95])
@pytest.mark.parametrize("alpha", [ALPHA, "vector"])
def test_evaluate_candidates_matches_reference(hard, tail_q, alpha):
    n, c, m = _candidates()
    a = np.array([1.0, 2.0, 0.5, 1.5]) if alpha == "vector" else alpha
    port_apps, port_caps = _port(PAPER, CAPS4)
    ref = rbe.evaluate_candidates(PAPER, CAPS4, n, c, m, a, BETA, hard=hard, tail_q=tail_q)
    port = tbe.evaluate_candidates(port_apps, port_caps, n, c, m, a, BETA, hard=hard,
                                   tail_q=tail_q, device="cpu")
    np.testing.assert_array_equal(port[2], ref[2])
    for p, r in zip(port[:2], ref[:2]):
        np.testing.assert_array_equal(np.isfinite(p), np.isfinite(r))
        fin = np.isfinite(r)
        np.testing.assert_allclose(p[fin], r[fin], rtol=1e-12)
    assert (~np.isfinite(ref[0])).any() == hard


def test_pack_apps_matches_reference(mix8):
    """batch_eval.pack_apps: the reference's dict of float64 leaves, key for
    key and bit for bit, as tensors on the device asked for (a fresh dict
    over the shared packing's leaves)."""
    for apps in (PAPER, mix8["ref"][0]):
        port_apps = _port(apps, CAPS4)[0]
        ref = rbe.pack_apps(apps)
        got = tbe.pack_apps(port_apps, device="cpu")
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == torch.float64 and got[k].device == CPU, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    packed = teng.as_packed(port_apps)
    a, b = tbe.pack_apps(packed, device="cpu"), tbe.pack_apps(packed, device="cpu")
    assert a is not b and a["lam"] is b["lam"]


def test_utility_terms_batch_matches_reference():
    n, c, m = _candidates(1)
    ref_d = rbe.pack_apps(PAPER)
    ref = rbe.utility_terms_batch(ref_d, jnp.asarray(n), jnp.asarray(c), jnp.asarray(m),
                                  30.0, 150.0, ALPHA, BETA)
    port = tbe.utility_terms_batch(teng.as_packed(_port(PAPER, CAPS4)[0]).as_dict(CPU),
                                   torch.as_tensor(n), torch.as_tensor(c), torch.as_tensor(m),
                                   30.0, 150.0, ALPHA, BETA)
    ref = np.asarray(ref)
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(port.numpy()), fin)
    np.testing.assert_allclose(port.numpy()[fin], ref[fin], rtol=1e-12)


# ----------------------------------------------------------------------------
# problem + serial solvers
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("tail_q", [0.0, 0.95])
@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 0.5, 1.0)])
def test_evaluate_matches_reference(tail_q, weights):
    n, c, m = np.array([6, 7, 3, 7]), np.array([1.2, 1.0, 0.8, 1.1]), np.array([0.3, 0.35, 0.3, 0.5])
    port_apps, port_caps = _port(PAPER, CAPS4)
    ref = rprob.evaluate(PAPER, n, c, m, CAPS4, ALPHA, BETA, weights=weights, tail_q=tail_q)
    port = tprob.evaluate(port_apps, n, c, m, port_caps, ALPHA, BETA, weights=weights,
                          tail_q=tail_q, device="cpu")
    assert port.utility == pytest.approx(ref.utility, rel=1e-13)
    np.testing.assert_allclose(port.ws, ref.ws, rtol=1e-12)
    np.testing.assert_allclose(port.power_w, ref.power_w, rtol=1e-14)
    assert (port.feasible, port.stable) == (ref.feasible, ref.stable)
    assert port.meta.keys() == ref.meta.keys()
    np.testing.assert_allclose(
        tprob.p95_surrogate_s(port_apps, n, c, m, device="cpu"),
        rprob.p95_surrogate_s(PAPER, n, c, m), rtol=1e-12)


def test_check_feasible_matches_reference():
    port_apps, port_caps = _port(PAPER, CAPS4)
    for n, c, m in [([6, 7, 3, 7], [1.2, 1.0, 0.8, 1.1], [0.3, 0.35, 0.3, 0.5]),
                    ([1, 1, 1, 1], [0.2, 0.2, 0.2, 0.2], [0.2, 0.2, 0.15, 0.33]),
                    ([20, 20, 20, 20], [2.0, 2.0, 2.0, 2.0], [0.4, 0.4, 0.35, 0.7])]:
        assert tprob.check_feasible(port_apps, n, c, m, port_caps, device="cpu") == \
            rprob.check_feasible(PAPER, n, c, m, CAPS4)


def test_serial_solvers_match_reference():
    port_apps, port_caps = _port(PAPER, CAPS4)
    for ra, pa in zip(PAPER, port_apps):
        c_r, m_r = rsol.sp1_solve(ra, CAPS4, ALPHA, BETA)
        c_p, m_p = tsol.sp1_solve(pa, port_caps, ALPHA, BETA, device="cpu")
        assert (c_p, m_p) == pytest.approx((c_r, m_r), rel=1e-12)
        mu = float(rprob.service_rate(ra, c_r, m_r))
        assert float(tprob.service_rate(pa, c_p, m_p, device="cpu")) == pytest.approx(mu, rel=1e-12)
        args = (ALPHA, BETA, mu, c_r, m_r)
        assert tsol.sp2_ternary(pa, port_caps, *args) == rsol.sp2_ternary(ra, CAPS4, *args)
        assert tsol.sp2_exhaustive(pa, port_caps, *args) == rsol.sp2_exhaustive(ra, CAPS4, *args)
    np.testing.assert_allclose(
        tsol.sp1_objective(port_apps[0], port_caps, ALPHA, BETA, 1.5, 0.3, device="cpu").numpy(),
        np.asarray(rsol.sp1_objective(PAPER[0], CAPS4, ALPHA, BETA, 1.5, 0.3)), rtol=1e-13)


def test_p1_serial_and_scipy_match_reference():
    port_apps, port_caps = _port(PAPER, CAPS4)
    n = [6, 7, 3, 7]
    r = rsol.p1_solve(PAPER, CAPS4, n, ALPHA, BETA)
    p = tsol.p1_solve(port_apps, port_caps, n, ALPHA, BETA, device="cpu")
    assert p.converged == r.converged and p.info == r.info
    assert p.utility == pytest.approx(r.utility, rel=1e-6)
    np.testing.assert_allclose(p.r_cpu, r.r_cpu, rtol=1e-5)
    r_s = rsol.p1_solve_scipy(PAPER, CAPS4, n, ALPHA, BETA)
    p_s = tsol.p1_solve_scipy(port_apps, port_caps, n, ALPHA, BETA, device="cpu")
    assert p_s.converged == r_s.converged
    assert p_s.utility == pytest.approx(r_s.utility, rel=1e-6)
    assert p_s.utility == pytest.approx(p.utility, rel=1e-4)
