"""The port's copies of the simulation's NumPy layer — ``core/arrivals.py``,
``core/failures.py``, ``core/lifecycle.py`` and the warm-pool power terms —
against the reference on the same seeds: the same NumPy code on the same
``(seed, name, salt)`` streams, so every draw, estimate and transition is
equal bit for bit."""
import numpy as np
import pytest

from repro.core import arrivals as ref_arrivals
from repro.core import failures as ref_failures
from repro.core import lifecycle as ref_lifecycle
from repro.core import power as ref_power
from repro_torch.core import arrivals, failures, lifecycle, power

SPECS = {
    "poisson": lambda m: None,
    "mmpp2": lambda m: m.mmpp2(burst=4.0, frac=0.15, cycle=40.0),
    "mmpp3_off": lambda m: m.ArrivalSpec(kind="mmpp", rates=(1.0, 3.0, 0.0),
                                         sojourn=(30.0, 8.0, 10.0)),
}


def _spec(module, kind):
    return module.parse_arrival(SPECS[kind](module))


def _drive(module, kind):
    """Arrival times of one stream through the engines' whole API: batched
    pulls, a λ change, a pending draw cancelled, retire and rejoin."""
    s = module.ArrivalStream(_spec(module, kind), 8.0, 3, "app", 0.0)
    out = [s.times_until(50.0), np.array([s.peek(), s.pop(), s.peek()])]
    s.set_lam(12.0, 60.0)
    out.append(s.times_until(120.0))
    s.deactivate()
    s.reactivate(200.0)
    out.append(s.times_until(260.0))
    s.cancel_pending()
    out.append(np.array([s.peek() is None]))
    return out


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_arrival_stream_times_are_the_reference_draws(kind):
    ref, port = _drive(ref_arrivals, kind), _drive(arrivals, kind)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)
    assert ref[0].shape[0] > 100


@pytest.mark.parametrize("spec", [
    None, "poisson", {"kind": "mmpp", "rates": [0.6, 2.6], "sojourn": [480.0, 120.0]},
    {"kind": "mmpp", "rates": [1.0, 3.0, 0.0], "sojourn": [30.0, 8.0, 10.0]},
])
def test_parse_arrival_and_dispersion_match(spec):
    ref, port = ref_arrivals.parse_arrival(spec), arrivals.parse_arrival(spec)
    assert port.to_dict() == ref.to_dict()
    assert port.lam_hi_ratio() == ref.lam_hi_ratio()
    assert arrivals.idc_asymptotic(port, 7.0) == ref_arrivals.idc_asymptotic(ref, 7.0)
    for t in (1.0, 60.0, 3600.0):
        if ref.n_phases <= 2:  # the closed form covers two phases
            assert arrivals.idc_at(port, 7.0, t) == ref_arrivals.idc_at(ref, 7.0, t)
        else:
            with pytest.raises(NotImplementedError):
                arrivals.idc_at(port, 7.0, t)


@pytest.mark.parametrize("bad", [
    {"kind": "weibull"}, {"kind": "mmpp", "burst": 0.5, "frac": 0.2, "cycle": 10.0},
    {"kind": "mmpp", "rates": [1.0], "sojourn": [1.0, 2.0]}, 3.5,
])
def test_parse_arrival_rejects_as_the_reference(bad):
    with pytest.raises(Exception) as ref_err:
        ref_arrivals.parse_arrival(bad)
    with pytest.raises(type(ref_err.value)) as port_err:
        arrivals.parse_arrival(bad)
    assert str(port_err.value) == str(ref_err.value)


def test_estimate_arrival_matches_on_a_simulated_log():
    times = arrivals.ArrivalStream(arrivals.mmpp2(burst=3.0, frac=0.2, cycle=600.0), 20.0,
                                   1, "rt", 0.0).times_until(6 * 3600.0)
    counts, _ = np.histogram(times, bins=360, range=(0.0, 6 * 3600.0))
    for c in (counts, np.full(30, 5.0), np.zeros(10)):
        ref, port = ref_arrivals.estimate_arrival(c, 60.0), arrivals.estimate_arrival(c, 60.0)
        assert port.keys() == ref.keys()
        for k, v in ref.items():
            if k == "spec":
                assert port[k].to_dict() == v.to_dict()
            else:
                np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_read_invocation_csv_matches(tmp_path):
    p = tmp_path / "invocations.csv"
    p.write_text("HashOwner,HashFunction,d01,d02\n# comment\nown1,funcA,5,6,7\n"
                 "own2,funcB,1,0,2\n3,4,5\n")
    ref, port = ref_arrivals.read_invocation_csv(p), arrivals.read_invocation_csv(p)
    assert list(port) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])


@pytest.mark.parametrize("mu,scv", [(2.0, 4.0), (0.7, 1.0), (3.3, 9.5)])
def test_h2_params_and_service_draws_match(mu, scv):
    assert arrivals.h2_params(mu, scv) == ref_arrivals.h2_params(mu, scv)
    from repro.core.des import _service_chunk as ref_chunk
    from repro_torch.core.des import _service_chunk

    for service in ("exp", "h2"):
        a = ref_chunk(ref_arrivals._stream(4, "x", 29), mu, service, scv)
        b = _service_chunk(arrivals._stream(4, "x", 29), mu, service, scv)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [
    {"mtbf": 20.0, "mttr": 4.0}, {"mtbf": 15.0, "mttr": 4.0, "straggler_frac": 0.4},
])
def test_failure_process_draws_match(spec):
    assert failures.FAIL_SALT == ref_failures.FAIL_SALT
    assert failures.OFF.to_dict() == ref_failures.OFF.to_dict()
    ref_spec, port_spec = ref_failures.parse_failures(spec), failures.parse_failures(spec)
    assert port_spec.to_dict() == ref_spec.to_dict()
    assert port_spec.availability(1.5) == ref_spec.availability(1.5)
    procs = [m.FailureProcess(s, 5, "a", 0.0, t_cold=1.5)
             for m, s in ((ref_failures, ref_spec), (failures, port_spec))]
    healthy = [4, 4]
    for step in range(40):
        t = [p.next_change() for p in procs]
        assert t[0] == t[1]
        if not np.isfinite(t[0]):
            break
        outs = [p.apply_at(t[0], h) for p, h in zip(procs, healthy)]
        assert outs[0] == outs[1]
        healthy = [max(h - o["d_down"], 0) for h, o in zip(healthy, outs)]
        if step == 30:
            for p in procs:
                p.halt()
    assert procs[0].stats() == procs[1].stats()
    assert procs[0].stats()["crashes"] >= 1


def test_plan_capacity_transitions_match():
    """A configure sequence through grow, shrink, pool retargets and a ramp
    superseded mid-flight, with the pending ramp settled in between."""
    class Cl:
        def __init__(self):
            self.n_servers, self.warm_avail, self.warm_target, self.pending = 3, 1, 1, None

    script = [(0.0, 8, None), (0.5, None, 3), (1.0, 2, None), (4.0, 6, 0), (9.0, 0, 2),
              (9.2, 5, None), (20.0, None, None)]
    for t_cold in (0.0, 2.0):
        state = []
        for mod in (ref_lifecycle, lifecycle):
            cl, trace = Cl(), []
            for now, n_t, w_t in script:
                trace.append(mod.settle_pending(cl, now))
                cl.n_servers, cl.warm_avail, cl.warm_target, cl.pending = mod.plan_capacity(
                    now, cl.n_servers, cl.warm_avail, cl.warm_target, t_cold, n_t, w_t)
                trace.append((cl.n_servers, cl.warm_avail, cl.warm_target, cl.pending))
            state.append(trace)
        assert state[0] == state[1]
    for bad in ({"t_cold": -1.0}, {"warm_pool": -2}):
        with pytest.raises(ValueError):
            ref_lifecycle.parse_lifecycle(bad)
        with pytest.raises(ValueError):
            lifecycle.parse_lifecycle(bad)
    spec = {"t_cold": 0.5, "t_cold_app": {"a": 2.0}, "warm_pool": 1}
    assert (lifecycle.parse_lifecycle(spec).to_dict()
            == ref_lifecycle.parse_lifecycle(spec).to_dict())


def test_warm_power_matches():
    assert power.WARM_IDLE_FRAC == ref_power.WARM_IDLE_FRAC
    for args in ((3, 1.5, 30.0), (0, 2.0, 120.0), (7, 0.25, 8.0)):
        assert power.warm_power(*args) == ref_power.warm_power(*args)
