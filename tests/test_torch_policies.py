"""Slice gate of the PyTorch port's policies on the simulation: each new
policy through ``repro`` (JAX, CPU) and ``repro_torch`` (``device="cpu"``)
on the same request, at the paper's constrained caps
(30, 10), the roomy (80, 32) and the capacity crunch (4, 1.2) of
``tests/test_failures.py``: identical container counts, quotas and utility
within rtol 1e-6, equal Diagnostics counters, and equal decision records
(``robust_t`` / ``robust_ratio_max``, the ``lifecycle`` dict and
``keep_warm``, the ``failover`` record, ``admission`` / ``shed``): keys,
integers, booleans and strings exactly, their float entries within rtol 1e-6.

This file holds the helpers, the burstiness-robust ladders (``robust_crms``,
``robust_crms_p95``) and the registry; ``crms_lifecycle``,
``robust_crms_lifecycle``, ``crms_shed``, ``crms_failover`` and
``predictive_crms`` are in ``tests/test_torch_policies_adaptive.py``, the
stateful policies' sequences and identities in
``tests/test_torch_policy_sequences.py``.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro import api as ref_api
from repro.api import AllocRequest as RefRequest
from repro.api import get_policy as ref_get_policy
from repro.api import list_policies as ref_list_policies
from repro.core.problem import ServerCaps as RefCaps
from repro.core.profiler import make_paper_apps as ref_paper_apps
from repro_torch import api as port_api
from repro_torch.api import AllocRequest, get_policy, list_policies
from repro_torch.core.problem import ServerCaps
from repro_torch.core.profiler import make_paper_apps

from test_torch_scenario import alloc_record, assert_same, chip_smoke, plain

LAM4 = (8.0, 7.0, 10.0, 15.0)
CAPS = {"constrained": (30.0, 10.0), "roomy": (80.0, 32.0), "crunch": (4.0, 1.2)}
RATIOS = {"arrival_ratios": {"ResNet_v2": 2.0, "MobileNet_v2": 1.5}}
LIFECYCLE = {"lifecycle": {"t_cold": 2.0}, "replan_horizon_s": 30.0}
FAIL = {"failures": {"spec": {"mtbf": 120.0, "mttr": 10.0}, "down": {}, "t_cold": 1.0}}
# the seven policies on the simulation; every policy of the reference is ported
# (the search baselines and placement too), so none is left out
NEW = ("robust_crms", "robust_crms_p95", "crms_lifecycle", "robust_crms_lifecycle",
       "crms_shed", "crms_failover", "predictive_crms")
NOT_PORTED = set()
# (policy, request extra), each at every caps point
ROBUST_CASES = {
    "robust_crms": RATIOS,
    "robust_crms-explicit": {"robust": 1.8},
    "robust_crms_p95": {"robust": 1.5},
    "robust_crms_p95-rollouts": {"robust": 1.5, "rollout_budget": 2,
                                 "rollout_horizon_s": 20.0},
}
ADAPTIVE_CASES = {
    "crms_lifecycle": LIFECYCLE,
    "robust_crms_lifecycle": {**LIFECYCLE, **RATIOS},
    "crms_shed": {},
    "crms_failover": FAIL,
    "crms_failover-off": {},
    "predictive_crms": {},
}
# the roomy point's p95 solves take ~8 s each on the port's CPU path: the
# rollout variant runs at the other two points only
SKIP_CASES = {("robust_crms_p95-rollouts", "roomy")}
# what the policies leave in Allocation.meta for the DES replay and the record
META = ("keep_warm", "lifecycle", "lam_forecast", "p95_surrogate_s", "tail_q", "shed")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def run_both(name, caps, extra, seed=0):
    """One request through both packages' fresh policy instances."""
    ref = chip_smoke._fresh(ref_api, name).allocate(RefRequest(
        ref_paper_apps(lam=LAM4, fitted=False), RefCaps(*caps), seed=seed, extra=dict(extra)))
    port = chip_smoke._fresh(port_api, name).allocate(AllocRequest(
        make_paper_apps(lam=LAM4, fitted=False), ServerCaps(*caps), seed=seed,
        extra=dict(extra), device="cpu"))
    return ref, port


def assert_result_parity(ref, port):
    """Counts exactly, quotas and utility within 1e-6, counters, the
    decision records (Diagnostics.extra, shed) and what the policies leave in
    Allocation.meta equal (floats within 1e-6)."""
    assert port.policy == ref.policy
    assert port.diagnostics.cache_hit == ref.diagnostics.cache_hit
    assert_same(alloc_record(ref), alloc_record(port))
    assert_same(*({k: plain(r.allocation.meta.get(k)) for k in META} for r in (ref, port)))


def cases_at_every_point(cases):
    return [(c, p) for c in cases for p in CAPS if (c, p) not in SKIP_CASES]


def check_case(cases, case, point):
    """One parametrised case: both packages on the same request."""
    name = case.split("-")[0]
    ref, port = run_both(name, CAPS[point], cases[case])
    assert_result_parity(ref, port)
    return name, port


@pytest.mark.parametrize("case,point", cases_at_every_point(ROBUST_CASES))
def test_robust_policy_matches_reference(case, point):
    _, port = check_case(ROBUST_CASES, case, point)
    # capacity allows some inflation, except at the crunch
    assert (port.diagnostics.extra["robust_t"] > 0.0) == (point != "crunch")
    assert port.diagnostics.extra["robust_ratio_max"] > 1.0


def test_robust_without_ratios_is_crms():
    """No ratios (pure Poisson): robust_crms's interval collapses and it is
    exactly crms, with robust_t 0."""
    ref, port = run_both("robust_crms", CAPS["constrained"], {})
    assert_result_parity(ref, port)
    _, crms_res = run_both("crms", CAPS["constrained"], {})
    np.testing.assert_array_equal(port.allocation.n, crms_res.allocation.n)
    assert port.utility == crms_res.utility
    assert port.diagnostics.extra["robust_t"] == 0.0


def test_robust_rejects_ratios_below_one():
    msgs = []
    for get, req, caps, apps in ((ref_get_policy, RefRequest, RefCaps, ref_paper_apps),
                                 (get_policy, AllocRequest, ServerCaps, make_paper_apps)):
        kw = {"device": "cpu"} if req is AllocRequest else {}
        with pytest.raises(ValueError) as info:
            get("robust_crms").allocate(req(apps(lam=LAM4, fitted=False), caps(30.0, 10.0),
                                            extra={"robust": 0.5}, **kw))
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]


def test_list_policies_is_the_reference_minus_the_unported():
    assert set(NEW) <= set(list_policies())
    assert set(list_policies()) == set(ref_list_policies()) - NOT_PORTED
    for name in ("crms_lifecycle", "robust_crms_lifecycle", "crms_failover",
                 "predictive_crms", "crms_fleet"):
        assert getattr(get_policy(name), "self_caching", False), name
        assert get_policy(name).name == name
