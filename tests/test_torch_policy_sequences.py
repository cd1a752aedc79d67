"""The port's stateful policies step by step against the reference's own
instance (``repro``, JAX on the CPU; the port on ``device="cpu"``), each step
held to the per-request bar of ``tests/test_torch_policies.py`` (counts
exactly, quotas and utility within rtol 1e-6, counters and decision records
equal), and the identities of the reference's tests:

* the lifecycle hold / deploy sequence
  (``tests/test_lifecycle.py::test_policy_holds_small_drift_deploys_jump``);
* the failover crash-backoff sequence
  (``tests/test_failures.py::TestFailoverPolicy::test_crash_backoff_sequence``);
* the predictive re-plan ahead of the threshold
  (``tests/test_scenario_des.py::test_predictive_replans_ahead_of_threshold``);
* ``crms_lifecycle`` at t_cold 0 equal to ``crms``
  (``tests/test_lifecycle.py::test_policy_identity_at_tcold_zero``),
  ``crms_failover`` with failures off equal to ``crms``
  (``test_failures.py::TestFailoverPolicy::test_off_identity``), ``crms_shed``
  equal to ``crms`` while feasible (``test_crms_shed_identity_when_feasible``)
  and ``robust_crms_lifecycle`` at t_cold 0 equal to ``robust_crms``
  (``test_robust_lifecycle_variant_matches_robust_at_tcold0``).
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro.api import AllocRequest as RefRequest
from repro.api import PredictivePolicy as RefPredictive
from repro.api import get_policy as ref_get_policy
from repro.core.problem import ServerCaps as RefCaps
from repro.core.profiler import make_paper_apps as ref_paper_apps
from repro_torch.api import AllocRequest, PredictivePolicy, get_policy
from repro_torch.core.problem import ServerCaps
from repro_torch.core.profiler import make_paper_apps

from test_torch_policies import assert_result_parity

LAM4 = (8.0, 7.0, 10.0, 15.0)
CAPS = (30.0, 10.0)
ROOMY = (80.0, 32.0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Pair:
    """The same policy in both packages, fed the same requests."""

    def __init__(self, ref_policy, port_policy):
        self.ref, self.port = ref_policy, port_policy
        for p in (self.ref, self.port):
            if hasattr(p, "reset"):
                p.reset()

    @classmethod
    def named(cls, name):
        return cls(ref_get_policy(name), get_policy(name))

    def step(self, factors=None, caps=CAPS, extra=None, n_apps=4, seed=0):
        """Both instances on the paper's apps scaled per app by ``factors``."""
        factors = factors if factors is not None else [1.0] * 4
        lam = [la * f for la, f in zip(LAM4, factors)]
        ref = self.ref.allocate(RefRequest(
            ref_paper_apps(lam=lam, fitted=False)[:n_apps], RefCaps(*caps), alpha=1.4,
            beta=0.2, seed=seed, extra=dict(extra or {})))
        port = self.port.allocate(AllocRequest(
            make_paper_apps(lam=lam, fitted=False)[:n_apps], ServerCaps(*caps), alpha=1.4,
            beta=0.2, seed=seed, extra=dict(extra or {}), device="cpu"))
        assert_result_parity(ref, port)
        return port


def test_lifecycle_holds_small_drift_deploys_jump():
    pair = Pair.named("crms_lifecycle")
    ex = {"lifecycle": {"t_cold": 8.0}, "replan_horizon_s": 20.0, "keep_warm": 0}
    r0 = pair.step(extra=ex)
    assert r0.diagnostics.extra["lifecycle"]["forced"] and not r0.diagnostics.cache_hit
    r1 = pair.step([1.02] * 4, extra=ex)  # the gain cannot pay the boot energy: HOLD
    d1 = r1.diagnostics.extra["lifecycle"]
    assert r1.diagnostics.cache_hit and not d1["deployed"]
    assert d1["gain_rate_w"] <= d1["gain_rate_bar_w"]
    np.testing.assert_array_equal(r1.allocation.n, r0.allocation.n)
    # the held view's record is a new dict: the incumbent's stays as deployed
    assert pair.port._last.diagnostics.extra["lifecycle"]["deployed"]
    r2 = pair.step([2.2, 1.0, 1.0, 1.0], extra=ex)  # a flash crowd: DEPLOY
    assert r2.diagnostics.extra["lifecycle"]["deployed"] and not r2.diagnostics.cache_hit
    r3 = pair.step([2.2, 1.0, 1.0, 1.0], extra=ex, n_apps=3)  # mix change: forced
    assert r3.diagnostics.extra["lifecycle"]["forced"]


def test_lifecycle_auto_pool_sequence():
    """The default "auto" keep-warm pools over a rise and fall at the roomy
    point: the pools, their power and utility accounting, and each decision."""
    pair = Pair.named("crms_lifecycle")
    ex = {"lifecycle": {"t_cold": 2.0}, "replan_horizon_s": 30.0}
    for f in (1.0, 2.0, 1.0, 1.05):
        res = pair.step([f, 1.0, 1.0, 1.0], caps=ROOMY, extra=ex)
    assert "lifecycle" in res.diagnostics.extra


def _fail_extra(down):
    return {"failures": {"spec": {"mtbf": 120.0, "mttr": 10.0}, "down": down,
                         "t_cold": 1.0}}


def test_failover_crash_backoff_sequence():
    pair = Pair.named("crms_failover")
    name = "ResNet_v2"
    reasons = []
    for down in ({}, {name: 1}, {name: 2}, {name: 2}, {name: 2}, {name: 2}, {name: 2},
                 {name: 3}):
        res = pair.step(extra=_fail_extra(down))
        reasons.append(res.diagnostics.extra["failover"]["reason"])
    assert reasons == ["cold", "crash", "cached", "crash", "cached", "cached", "cached",
                       "crash"]
    # a cached view's record is a new dict: the incumbent keeps its own
    assert pair.port._last.diagnostics.extra["failover"]["reason"] == "crash"


def test_failover_drift_and_hedge_at_roomy_caps():
    """Drift re-plans and the hedge ladder at the deployed quotas: spares on
    top of the plain plan, one replacement per observed crash."""
    pair = Pair.named("crms_failover")
    r0 = pair.step(caps=ROOMY, extra=_fail_extra({}))
    d0 = r0.diagnostics.extra["failover"]
    assert d0["hedge"] > 0.0 and d0["k_extra"] >= 1
    r1 = pair.step([1.3, 1.0, 1.0, 1.0], caps=ROOMY, extra=_fail_extra({"ResNet_v2": 2}))
    assert r1.diagnostics.extra["failover"]["reason"] == "drift"
    scripted = Pair.named("crms_failover")  # a scripted crash with no stochastic spec
    scripted.step(caps=ROOMY, extra={"failures": {"spec": None, "down": {"ResNet_v2": 2},
                                                  "t_cold": 0.0}})


def test_predictive_replans_ahead_of_threshold():
    pair = Pair(RefPredictive("crms", threshold=0.15), PredictivePolicy("crms", threshold=0.15))
    results = [pair.step([f] * 4, caps=(39.0, 13.0)) for f in (1.0, 1.11, 1.23)]
    assert not results[0].diagnostics.cache_hit
    assert not results[1].diagnostics.cache_hit  # ahead of the threshold
    assert pair.port.reoptimizations == pair.ref.reoptimizations >= 2
    for r in results:
        assert r.feasible and r.stable and r.policy == "predictive:crms"
    pair.port.reset()
    assert pair.port.reoptimizations == 0 and pair.port._result is None


def test_predictive_crms_registered_sequence():
    """The registered ``predictive_crms`` over a drifting and then
    re-sized trace, with its cached epochs."""
    pair = Pair.named("predictive_crms")
    for f, caps in ((1.0, CAPS), (1.05, CAPS), (1.1, CAPS), (1.1, (32.0, 11.0))):
        res = pair.step([f] * 4, caps=caps)
    assert res.policy == "predictive_crms" and not res.diagnostics.cache_hit


def test_lifecycle_identity_at_tcold_zero():
    lifec, plain = Pair.named("crms_lifecycle"), Pair.named("crms")
    ex = {"lifecycle": {"t_cold": 0.0}, "replan_horizon_s": 30.0}
    for f in (1.0, 1.2, 0.8):
        r = lifec.step([f] * 4, extra=ex)
        p = plain.step([f] * 4)
        np.testing.assert_array_equal(r.allocation.n, p.allocation.n)
        np.testing.assert_array_equal(r.allocation.r_cpu, p.allocation.r_cpu)
        np.testing.assert_array_equal(r.allocation.r_mem, p.allocation.r_mem)
        assert r.allocation.utility == p.allocation.utility
        assert r.allocation.meta["keep_warm"] == [0] * 4 and not r.diagnostics.cache_hit


def test_failover_off_and_shed_feasible_identities():
    fo = Pair.named("crms_failover").step()
    shed = Pair.named("crms_shed").step()
    plain = Pair.named("crms").step()
    for r in (fo, shed):
        np.testing.assert_array_equal(r.allocation.n, plain.allocation.n)
        np.testing.assert_array_equal(r.allocation.r_cpu, plain.allocation.r_cpu)
        assert r.allocation.utility == plain.allocation.utility
    assert fo.diagnostics.extra["failover"] == {"active": False}
    assert fo.policy == "crms_failover" and not shed.diagnostics.shed


def test_robust_lifecycle_at_tcold_zero_is_robust_crms():
    a = Pair.named("robust_crms_lifecycle").step(extra={"lifecycle": {"t_cold": 0.0},
                                                        "robust": 1.5})
    b = Pair.named("robust_crms").step(extra={"robust": 1.5})
    np.testing.assert_array_equal(a.allocation.n, b.allocation.n)
    np.testing.assert_array_equal(a.allocation.r_cpu, b.allocation.r_cpu)
    assert a.allocation.utility == b.allocation.utility
