"""The port's heapq event engine (``repro_torch.core.des``, a copy of the
reference's NumPy oracle) against the reference on the traces of
tests/test_des.py: reconfiguration carrying in-flight work, a μ change,
retire/rejoin, common-random-number arrivals, H2 service,
``simulate_allocation`` and ``run_quasi_dynamic``. The same code on the same
streams: per-customer arrival and response logs, snapshots and SimStats
equal bit for bit. Where a service rate comes from Eq. (1) (the allocation
entry points), the port's torch ``exp`` and the reference's XLA ``exp`` may
differ in the last place, and the bar is rtol 1e-12."""
import dataclasses

import numpy as np
import pytest

from repro.core import des as ref_des
from repro.core import profiler as ref_profiler
from repro.core.problem import Allocation as RefAllocation
from repro_torch.core import des, profiler
from repro_torch.core.problem import Allocation

HORIZON = 300.0


def _reconfigure(sim):
    sim.add_app("hot", lam=6.0, mu=1.0, n_servers=4)  # rho=1.5: a backlog builds
    sim.run_until(60.0)
    sim.configure("hot", n_servers=12)
    sim.run_until(150.0)
    sim.configure("hot", n_servers=3)  # shrink below the busy count
    sim.run_until(HORIZON)


def _mu_change(sim):
    sim.add_app("a", lam=4.0, mu=2.0, n_servers=8)
    sim.add_app("c", lam=9.0, mu=1.0, n_servers=5)
    sim.run_until(100.0)
    sim.configure("a", mu=4.0)
    sim.configure("c", mu=3.0, lam=7.0)
    sim.run_until(HORIZON)


def _retire_rejoin(sim):
    sim.add_app("t", lam=5.0, mu=2.0, n_servers=5)
    sim.add_app("u", lam=3.0, mu=2.0, n_servers=3)
    sim.run_until(80.0)
    sim.retire("t")
    sim.run_until(160.0)
    sim.activate("t")
    sim.run_until(HORIZON)


def _crn(sim):
    sim.add_app("x", lam=8.0, mu=2.0, n_servers=6)
    sim.add_app("y", lam=8.0, mu=3.5, n_servers=3)
    sim.run_until(HORIZON)


TRACES = {
    "reconfigure": (_reconfigure, {}),
    "mu_change": (_mu_change, {}),
    "retire_rejoin": (_retire_rejoin, {}),
    "crn": (_crn, {}),
    "h2": (_crn, {"service": "h2", "h2_scv": 4.0}),
}


def _run(module, trace, kw):
    drive, fleet_kw = TRACES[trace]
    sim = module.FleetSimulator(seed=3, **fleet_kw, **kw)
    drive(sim)
    mid = {nm: sim.snapshot(nm) for nm in sim.apps()}
    stats = {nm: sim.window_stats(nm, 20.0, HORIZON, snap_start=(0.0, 0.0))
             for nm in sim.apps()}
    sim.drain()
    logs = {nm: (np.asarray(cl.arr_log), np.asarray(cl.resp_log), cl.n_arrived)
            for nm, cl in sim._clusters.items()}
    return sim, logs, mid, stats


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_event_engine_is_the_reference(trace):
    ref, ref_logs, ref_mid, ref_stats = _run(ref_des, trace, {})
    port, logs, mid, stats = _run(des, trace, {"device": "cuda"})  # ignored: host engine
    assert type(port) is des.FleetSimulator and port.engine == "event"
    assert list(logs) == list(ref_logs)
    for nm, (t_arr, resp, n) in ref_logs.items():
        assert logs[nm][2] == n and n > 0
        np.testing.assert_array_equal(logs[nm][0], t_arr)
        np.testing.assert_array_equal(logs[nm][1], resp)
        assert mid[nm] == ref_mid[nm]
        assert dataclasses.astuple(stats[nm]) == dataclasses.astuple(ref_stats[nm])
        np.testing.assert_array_equal(port.responses(nm, 50.0, 200.0),
                                      ref.responses(nm, 50.0, 200.0))
    names = list(ref_logs)
    assert port.mean_response(names, 0.0, HORIZON) == ref.mean_response(names, 0.0, HORIZON)


def test_simulate_mmn_is_the_reference():
    for kw in ({}, {"service": "h2"}, {"arrival": {"kind": "mmpp", "rates": [0.5, 2.5],
                                                   "sojourn": [30.0, 10.0]}}):
        ref = ref_des.simulate_mmn(8.0, 1.8, 6, horizon_s=400.0, warmup_s=40.0, seed=7, **kw)
        port = des.simulate_mmn(8.0, 1.8, 6, horizon_s=400.0, warmup_s=40.0, seed=7, **kw)
        assert dataclasses.astuple(port) == dataclasses.astuple(ref)


def _allocations(M=8):
    """The reference's and the port's tenant mix with one allocation (the
    mix's refinement state n0 at mid-range quotas)."""
    ref_apps, _, n0 = ref_profiler.make_tenant_mix(M)
    apps, _, _ = profiler.make_tenant_mix(M)
    c = np.linspace(1.0, 2.5, M)
    m = np.array([0.5 * (a.r_min + a.r_max) for a in apps])
    return (ref_apps, RefAllocation(n=n0.copy(), r_cpu=c, r_mem=m),
            apps, Allocation(n=n0.copy(), r_cpu=c.copy(), r_mem=m.copy()))


def _assert_stats_close(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p.n_completed == r.n_completed > 0
        for f in ("mean_response_s", "p95_response_s", "mean_queue_len", "utilization"):
            assert getattr(p, f) == pytest.approx(getattr(r, f), rel=1e-12, abs=0.0), f


@pytest.mark.parametrize("service", ["exp", "h2"])
def test_simulate_allocation_matches_the_reference(service):
    ref_apps, ref_alloc, apps, alloc = _allocations()
    ref = ref_des.simulate_allocation(ref_apps, ref_alloc, horizon_s=300.0, warmup_s=30.0,
                                      seed=3, service=service)
    port = des.simulate_allocation(apps, alloc, horizon_s=300.0, warmup_s=30.0, seed=3,
                                   service=service)
    _assert_stats_close(port, ref)


def test_run_quasi_dynamic_matches_the_reference():
    ref_apps, ref_alloc, apps, alloc = _allocations(4)
    phases = [(0.0, (6, 6, 6, 6)), (100.0, (6.2, 6.1, 5.9, 6.0)), (200.0, (9, 8, 11, 13))]

    def scaled(allocation):
        # a stand-in allocator: more containers as the load grows
        def allocate(phase_apps):
            load = sum(a.lam for a in phase_apps) / 24.0
            return dataclasses.replace(allocation, n=np.ceil(allocation.n * load).astype(int))
        return allocate

    ref = ref_des.run_quasi_dynamic(ref_apps, [ref_des.WorkloadPhase(*p) for p in phases],
                                    scaled(ref_alloc), phase_len=100.0, seed=2)
    port = des.run_quasi_dynamic(apps, [des.WorkloadPhase(*p) for p in phases],
                                 scaled(alloc), phase_len=100.0, seed=2)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert p["alloc_n"] == r["alloc_n"] and p["lam"] == r["lam"]
        np.testing.assert_allclose(p["mean_response"], r["mean_response"], rtol=1e-12)
        assert np.all(np.isfinite(p["mean_response"]))
