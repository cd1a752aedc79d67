"""``tests/test_system.py``'s end-to-end test on the port (device="cpu"):
profile -> fit -> CRMS -> deploy -> simulate on the paper's §VI scenario,
with the port's container counts equal to the reference's ``crms`` on the
same fitted apps (and on the ground-truth apps), utilities within rtol 1e-6.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro.core.problem import App as RefApp
from repro.core.problem import ServerCaps as RefServerCaps
from repro_torch.core.crms import crms
from repro_torch.core.des import simulate_allocation
from repro_torch.core.problem import ServerCaps
from repro_torch.core.profiler import make_paper_apps

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_crms(apps, caps, alpha, beta):
    # the module by name: ``repro.core`` re-exports the function as ``crms``
    ref_crms = importlib.import_module("repro.core.crms").crms
    return ref_crms([RefApp(**dataclasses.asdict(a)) for a in apps],
                    RefServerCaps(r_cpu=caps.r_cpu, r_mem=caps.r_mem), alpha, beta)


def test_full_paper_pipeline():
    """The complete measurement-driven loop the paper describes, end to end:
    noisy profiling -> Eq.(1) NLLS fit -> CRMS under the §VI budgets -> the
    resulting allocation is feasible, stable, and its *simulated* response
    times agree with the analytic model it optimized."""
    apps = make_paper_apps(lam=(8, 7, 10, 15), xbar=(5, 5, 5, 5), fitted=True, seed=11,
                           device=CPU)
    caps = ServerCaps(r_cpu=30.0, r_mem=10.0)
    alloc = crms(apps, caps, alpha=1.4, beta=0.2, device=CPU)

    assert alloc.feasible and alloc.stable
    assert alloc.total_cpu() <= caps.r_cpu * 1.001
    assert alloc.total_mem() <= caps.r_mem * 1.001

    stats = simulate_allocation(apps, alloc, horizon_s=1200.0, seed=5)
    for app, st, ws in zip(apps, stats, alloc.ws):
        assert st.mean_response_s == pytest.approx(ws, rel=0.25), app.name

    # fitted-model allocation should be near the oracle (true-κ) allocation
    apps_true = make_paper_apps(lam=(8, 7, 10, 15), fitted=False)
    alloc_true = crms(apps_true, caps, 1.4, 0.2, device=CPU)
    assert alloc.utility == pytest.approx(alloc_true.utility, rel=0.1)

    # the reference's CRMS on the same apps: the same counts
    for port, port_apps in ((alloc, apps), (alloc_true, apps_true)):
        ref = _ref_crms(port_apps, caps, 1.4, 0.2)
        np.testing.assert_array_equal(port.n, ref.n)
        assert port.utility == pytest.approx(ref.utility, rel=1e-6)
        np.testing.assert_allclose(port.r_cpu, ref.r_cpu, rtol=1e-6)
        np.testing.assert_allclose(port.r_mem, ref.r_mem, rtol=1e-6)
