"""The port's Kiefer–Wolfowitz engine (``repro_torch.core.des_vector``)
against the reference's.

1. The scans: the torch segment scan and rollout scan (run here on the CPU)
   against the reference's ``numpy`` backend, bit for bit on every valid
   customer slot, and its ``jax`` backend within rtol 1e-12 (XLA contracts
   ``wait + su * inv_mu`` into one fused multiply-add; the torch step keeps
   the multiply and the add apart, as NumPy does).
2. ``VectorFleetSimulator(device="cpu")`` against the reference's vector
   engine per customer within 1e-12 through grow, shrink, λ, μ,
   retire/rejoin, a zero-server cluster, H2 service, MMPP arrivals,
   lifecycle ramps and crashes — and against the port's own event engine
   at the reference's cross-engine bar (arrivals rtol/atol 1e-9, responses
   rtol 1e-7 / atol 1e-9, tests/test_des_vector.py) wherever the parity is
   structural (every trace without a μ change)."""
import numpy as np
import pytest
import torch

from repro.core import des as ref_des
from repro.core import des_vector as ref_vec
from repro.core.arrivals import mmpp2 as ref_mmpp2
from repro.core.lifecycle import LifecycleSpec as RefLifecycle
from repro_torch.core import des, des_vector
from repro_torch.core.arrivals import mmpp2
from repro_torch.core.lifecycle import LifecycleSpec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------------
# 1. The scans
# ----------------------------------------------------------------------------
def _segment_inputs(seed, M=6, n_pad=8, K=700):
    """One segment's (W0, smask, gaps, svcs, valid) as _simulate_segment
    builds them: ragged per-lane customer counts, in-flight remainders, a
    one-server lane and a zero-server lane."""
    rng = np.random.default_rng(seed)
    Mp, Kp = des_vector._pad_pow2(M), des_vector._pad_pow2(K)
    n_up = rng.integers(1, n_pad + 1, M)
    n_up[1], n_up[2] = 1, 0
    W0 = np.full((Mp, n_pad), des_vector._BIG)
    smask = np.zeros((Mp, n_pad), dtype=bool)
    gaps, svcs = np.zeros((Kp, Mp)), np.zeros((Kp, Mp))
    valid = np.zeros((Kp, Mp), dtype=bool)
    for i in range(M):
        n = n_up[i]
        smask[i, :n] = True
        W0[i, :n] = np.sort(rng.exponential(0.5, n) * (rng.random(n) < 0.6))
        k = K if i == 0 else int(rng.integers(K // 3, K))
        gaps[:k, i] = rng.exponential(1.0 / rng.uniform(3.0, 12.0), k)
        svcs[:k, i] = rng.exponential(1.0 / rng.uniform(0.8, 3.0), k)
        valid[:k, i] = True
    return W0, smask, gaps, svcs, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_scan_matches_the_reference_backends(seed):
    W0, smask, gaps, svcs, valid = _segment_inputs(seed)
    K = int(valid.sum(axis=0).max())
    Wf, waits = des_vector.segment_scan(W0, smask, gaps, svcs, valid, backend="torch",
                                        device=CPU)
    Wn, wn = ref_vec.segment_scan(W0, smask, gaps, svcs, valid, backend="numpy")
    Wj, wj = ref_vec.segment_scan(W0, smask, gaps, svcs, valid, backend="jax")
    assert waits.shape == (K, W0.shape[0])
    v = valid[:K]
    np.testing.assert_array_equal(waits[v], wn[:K][v])  # bit for bit
    np.testing.assert_array_equal(waits[~v], 0.0)
    np.testing.assert_array_equal(Wf, Wn)
    np.testing.assert_allclose(waits[v], wj[:K][v], rtol=1e-12, atol=0.0)
    np.testing.assert_allclose(Wf, Wj, rtol=1e-12)
    # the zero-server lane never starts: its waits stay at the sentinel
    assert np.all(waits[v[:, 2], 2] >= 0.5 * des_vector._BIG)
    # the port's host loop is the reference's, bit for bit
    Wh, wh = des_vector.segment_scan(W0, smask, gaps, svcs, valid, backend="numpy")
    np.testing.assert_array_equal(wh, wn[:K])


def _rollout_inputs(seed, M=5, B=7, K=600):
    rng = np.random.default_rng(seed)
    Mp, Kp = des_vector._pad_pow2(M), des_vector._pad_pow2(K)
    n_srv = rng.integers(1, 9, (B, M))
    n_srv[3, 1] = 0  # a candidate that starves an app
    n_pad = des_vector._pad_pow2(int(n_srv.max()))
    smask = np.zeros((Mp, n_pad, B), dtype=bool)
    smask[:M] = np.arange(n_pad)[None, :, None] < n_srv.T[:, None, :]
    inv_mu = np.zeros((Mp, B))
    inv_mu[:M] = 1.0 / rng.uniform(0.8, 3.0, (M, B))
    gaps, su = np.zeros((Kp, Mp)), np.zeros((Kp, Mp))
    valid = np.zeros((Kp, Mp), dtype=bool)
    ks = [K] + [int(rng.integers(K // 4, K)) for _ in range(M - 1)]
    for i, k in enumerate(ks):
        gaps[:k, i] = rng.exponential(0.15, k)
        su[:k, i] = rng.exponential(1.0, k)
        valid[:k, i] = True
    return np.where(smask, 0.0, des_vector._BIG), smask, gaps, su, valid, inv_mu, n_srv, ks


def test_rollout_scan_matches_the_reference_backends():
    W0, smask, gaps, su, valid, inv_mu, n_srv, ks = _rollout_inputs(3)
    K = max(ks)
    _, waits = des_vector._rollout_scan_torch(
        torch.as_tensor(W0), torch.as_tensor(gaps), torch.as_tensor(su),
        torch.as_tensor(inv_mu), K)
    waits = waits.numpy()
    _, wn = ref_vec._rollout_scan_numpy(W0, smask, gaps, su, valid, inv_mu)
    _, wj = ref_vec._rollout_scan_jax(W0, gaps, su, inv_mu)
    wj = np.asarray(wj)
    assert waits.shape == (K, *inv_mu.shape)
    served = n_srv.T > 0  # (M, B)
    for i, k in enumerate(ks):  # valid slots only: padded rows are garbage
        np.testing.assert_array_equal(waits[:k, i], wn[:k, i])
        ok = served[i]
        np.testing.assert_allclose(waits[:k, i, ok], wj[:k, i, ok], rtol=1e-12, atol=1e-15)
    assert np.all(waits[: ks[1], 1, 3] > 0.5 * des_vector._BIG)  # never served


# ----------------------------------------------------------------------------
# 2. The segment engine
# ----------------------------------------------------------------------------
MMPP = {"kind": "mmpp", "rates": [0.6, 3.4], "sojourn": [34.0, 6.0]}


def _grow_shrink(sim, m):
    sim.add_app("s", lam=6.0, mu=1.2, n_servers=8)
    sim.add_app("hot", lam=6.0, mu=1.0, n_servers=4)
    sim.run_until(60.0)
    sim.configure("s", n_servers=3)  # shrink below the busy count
    sim.configure("hot", n_servers=12)  # grow: the backlog drains
    sim.run_until(120.0)
    sim.configure("s", n_servers=9)
    sim.run_until(180.0)


def _lam_change(sim, m):
    sim.add_app("a", lam=4.0, mu=2.0, n_servers=6)
    sim.run_until(50.0)
    sim.configure("a", lam=10.0)
    sim.run_until(120.0)
    sim.configure("a", lam=2.5)
    sim.run_until(180.0)


def _mu_change(sim, m):
    sim.add_app("c", lam=9.0, mu=1.0, n_servers=5)  # rho=1.8: backlog
    sim.run_until(60.0)
    sim.configure("c", mu=3.0)
    sim.run_until(150.0)


def _retire_rejoin(sim, m):
    sim.add_app("t", lam=5.0, mu=2.0, n_servers=5, arrival=MMPP if m == "mmpp" else None)
    sim.add_app("u", lam=3.0, mu=2.0, n_servers=3)
    sim.run_until(60.0)
    sim.retire("t")
    sim.run_until(120.0)
    sim.activate("t")
    sim.run_until(180.0)


def _zero_server(sim, m):
    sim.add_app("z", lam=3.0, mu=1.0, n_servers=0)
    sim.add_app("bg", lam=3.0, mu=1.5, n_servers=3)
    sim.run_until(30.0)


def _stationary(sim, m):
    sim.add_app("x", lam=8.0, mu=1.8, n_servers=6, arrival=MMPP if m == "mmpp" else None)
    sim.add_app("y", lam=15.0, mu=3.3, n_servers=7)
    sim.add_app("z", lam=2.0, mu=5.0, n_servers=1)
    sim.run_until(150.0)


def _mid_burst(sim, m):
    sim.add_app("a", lam=6.0, mu=1.5, n_servers=7)
    sim.run_until(50.0)
    sim.configure("a", lam=12.0, n_servers=12)
    sim.run_until(120.0)
    sim.configure("a", lam=4.0)
    sim.run_until(180.0)


def _midramp(sim, m):  # tests/test_lifecycle.py::_midramp_sim
    sim.add_app("a", lam=8.0, mu=2.5, n_servers=4)
    sim.add_app("b", lam=5.0, mu=2.0, n_servers=3)
    sim.run_until(30.0)
    sim.configure("a", lam=16.0, n_servers=10)  # starts a cold ramp
    sim.run_until(30.0 + 0.4 * 2.0 + 0.2)  # mid-ramp
    sim.configure("a", n_servers=8, warm_pool=2)  # supersedes the ramp
    sim.run_until(45.0)
    sim.configure("a", lam=8.0, n_servers=5)
    sim.run_until(60.0)


def _scale_to_zero(sim, m):  # tests/test_lifecycle.py::_zero_cap_sim
    sim.add_app("z", lam=4.0, mu=2.0, n_servers=3)
    sim.add_app("bg", lam=3.0, mu=1.5, n_servers=3)
    sim.run_until(20.0)
    sim.configure("z", n_servers=0)
    sim.run_until(30.0)
    sim.configure("z", n_servers=4)
    sim.run_until(50.0)


def _crashes(sim, m):  # tests/test_failures.py::_run_trace
    sim.add_app("a", 8.0, 2.5, 5)
    sim.add_app("b", 5.0, 2.0, 4)
    sim.run_until(12.0)
    sim.crash("b", 2)
    sim.run_until(18.0)
    sim.configure("a", lam=11.0, n_servers=7)
    sim.run_until(25.0)
    sim.repair("b", 2)
    sim.run_until(40.0)


# name: (drive, fleet kwargs (lifecycle/failures built per package), structural)
TRACES = {
    "grow_shrink": (_grow_shrink, {}, True),
    "lam_change": (_lam_change, {}, True),
    "mu_change": (_mu_change, {}, False),
    "retire_rejoin": (_retire_rejoin, {}, True),
    "zero_server": (_zero_server, {}, True),
    "h2": (_stationary, {"service": "h2", "h2_scv": 4.0}, True),
    "mmpp_stationary": (_stationary, {"mode": "mmpp"}, True),
    "mmpp_mid_burst": (_mid_burst, {"mmpp_fleet": True}, True),
    "mmpp_retire_rejoin": (_retire_rejoin, {"mode": "mmpp"}, True),
    "lifecycle_midramp": (_midramp, {"lifecycle": (2.0, 1)}, True),
    "lifecycle_scale_to_zero": (_scale_to_zero, {"lifecycle": (1.5, 0)}, True),
    "scripted_crashes": (_crashes, {"lifecycle": (1.0, 0)}, True),
    "crash_repair": (_crashes, {"lifecycle": (1.0, 0),
                                "failures": {"mtbf": 20.0, "mttr": 4.0}}, True),
}


def _sim(module, trace, engine, **kw):
    drive, opts, _ = TRACES[trace]
    opts = dict(opts)
    mode = opts.pop("mode", None)
    if opts.pop("mmpp_fleet", False):
        opts["arrival"] = (ref_mmpp2 if module is ref_des else mmpp2)(
            burst=4.0, frac=0.15, cycle=40.0)
    if "lifecycle" in opts:
        spec = RefLifecycle if module is ref_des else LifecycleSpec
        opts["lifecycle"] = spec(*opts["lifecycle"])
    sim = module.FleetSimulator(seed=5, engine=engine, **opts, **kw)
    drive(sim, mode)
    sim.drain()
    return sim


def _vector_logs(sim):
    return {nm: (*cl.logs(), cl.queue_t, cl.n_arrived) for nm, cl in sim._clusters.items()}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_vector_engine_matches_the_reference_per_customer(trace):
    port = _sim(des, trace, "vector", device="cpu")
    assert isinstance(port, des_vector.VectorFleetSimulator) and port.backend == "torch"
    ref = _sim(ref_des, trace, "vector", backend="numpy")
    got, want = _vector_logs(port), _vector_logs(ref)
    assert list(got) == list(want)
    for nm, w in want.items():
        g = got[nm]
        assert g[4] == w[4] and g[0].shape == w[0].shape, nm
        for a, b in zip(g[:4], w[:4]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0, err_msg=nm)
        np.testing.assert_allclose(port.snapshot(nm), ref.snapshot(nm), rtol=1e-12)
    assert port.failure_stats() == ref.failure_stats()
    assert port.downs() == ref.downs()
    if trace == "crash_repair":  # the stochastic process really fired
        assert sum(st["crashes"] for st in port.failure_stats().values()) >= 1
    if trace == "zero_server":
        zc = port._clusters["z"]
        assert zc.logs()[0].shape[0] == 0 and zc.queue_t.shape[0] == zc.n_arrived > 0


@pytest.mark.parametrize("trace", sorted(t for t, v in TRACES.items() if v[2]))
def test_vector_engine_matches_the_event_engine(trace):
    """The port's two engines on one trace: sample-path identical up to
    round-off (tests/test_des_vector.py's bars)."""
    ev, vec = _sim(des, trace, "event"), _sim(des, trace, "vector", device="cpu")
    for nm in ev.apps():
        ce = ev._clusters[nm]
        te, re = np.asarray(ce.arr_log), np.asarray(ce.resp_log)
        tv, wv, sv = vec._clusters[nm].logs()
        oe, ov = np.argsort(te), np.argsort(tv)
        assert te.shape == tv.shape and ce.n_arrived == vec._clusters[nm].n_arrived
        np.testing.assert_allclose(te[oe], tv[ov], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(re[oe], (wv + sv)[ov], rtol=1e-7, atol=1e-9)
    assert ev.failure_stats() == vec.failure_stats()


def test_backend_choice_and_device():
    assert des.FleetSimulator(engine="vector", backend="numpy").device is None
    sim = des.FleetSimulator(engine="vector", device="cpu")
    assert (sim.backend, sim.device) == ("torch", CPU)
    with pytest.raises(ValueError, match="auto.torch.numpy"):
        des.FleetSimulator(engine="vector", backend="jax", device="cpu")
    with pytest.raises(ValueError):
        des.FleetSimulator(engine="simpy")
    with pytest.raises(ValueError):
        sim.run_until(np.inf)


def test_simulate_allocation_vector_matches_event():
    from repro_torch.core.problem import Allocation
    from repro_torch.core.profiler import make_tenant_mix

    apps, _, n0 = make_tenant_mix(8)
    alloc = Allocation(n=n0, r_cpu=np.linspace(1.0, 2.5, 8),
                       r_mem=np.array([0.5 * (a.r_min + a.r_max) for a in apps]))
    ev = des.simulate_allocation(apps, alloc, horizon_s=200.0, warmup_s=20.0, seed=1)
    vec = des.simulate_allocation(apps, alloc, horizon_s=200.0, warmup_s=20.0, seed=1,
                                  engine="vector", device="cpu")
    for e, v in zip(ev, vec):
        assert e.n_completed == v.n_completed > 0
        assert v.mean_response_s == pytest.approx(e.mean_response_s, rel=1e-9)
        assert v.p95_response_s == pytest.approx(e.p95_response_s, rel=1e-9)
        assert v.mean_queue_len == pytest.approx(e.mean_queue_len, rel=1e-6, abs=1e-12)
        assert v.utilization == pytest.approx(e.utilization, rel=1e-6)
