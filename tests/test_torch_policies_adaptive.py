"""The port's adaptive policies on one request each against the reference's
(``repro``, JAX on the CPU; the port on ``device="cpu"``), at the paper's
constrained caps (30, 10), the roomy (80, 32) and the capacity crunch
(4, 1.2) of ``tests/test_failures.py``, held to the bar of
``tests/test_torch_policies.py``: ``crms_lifecycle``,
``robust_crms_lifecycle``, ``crms_shed``, ``crms_failover`` (failures on and
off) and ``predictive_crms``. At the crunch the shedding ladder returns a
feasible, stable admitted subset with the shed set reported (mirrors
``tests/test_failures.py::TestFailoverPolicy::test_shed_ladder_at_crunch``).
"""
import pytest
import torch

from test_torch_policies import ADAPTIVE_CASES, cases_at_every_point, check_case


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case,point", cases_at_every_point(ADAPTIVE_CASES))
def test_adaptive_policy_matches_reference(case, point):
    name, port = check_case(ADAPTIVE_CASES, case, point)
    sheds = name in ("crms_shed", "crms_failover") and case != "crms_failover-off"
    if point == "crunch" and sheds:
        assert port.feasible and port.stable and port.diagnostics.shed
        admission = port.allocation.meta["admission"]
        assert port.diagnostics.extra["admission"] == admission
        assert any(f < 1.0 for f in admission.values())
    elif point != "crunch":
        assert port.feasible and port.stable and not port.diagnostics.shed
