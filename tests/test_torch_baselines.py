"""Port parity of the §VI search baselines (``repro_torch.core.baselines``)
and their policies: repro (JAX, CPU) against repro_torch (device="cpu") on
the same NumPy-seeded draws, at the reference's test sizes
(``tests/test_baselines.py``; ``tests/test_api.py``: random search with 4000
samples at seed 3, GP-BO/TPE-BO with n_init 8 and n_iters 8 at seed 1,
SNFC, DRF). Counts, flags and the draws' quotas compare exactly where the
quotas come straight from the draws, every float within rtol 1e-6
(``chip_smoke.assert_same``); the reference's behavioural asserts hold on
the port's results.

``tests/data/torch_baselines_golden.json`` holds the reference's Figs. 11-14
comparison (crms; random search with 20000 samples, GP-BO and TPE-BO at
their defaults, each at seeds 0, 1, 2; drf; snfc1/2 at the sufficient caps)
and random search at make_tenant_mix(16) with 20000 samples, which
``chip_smoke.py`` phase 19 replays on the card. Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_baselines.py
"""
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro import api as ref_api
from repro.core import baselines as ref_baselines
from repro.core import problem as ref_problem
from repro.core import profiler as ref_profiler
from repro_torch import api as port_api
from repro_torch.core import baselines as port_baselines
from repro_torch.core import problem as port_problem
from repro_torch.core import profiler as port_profiler

from torch_scripts import chip_smoke

assert_same, baseline_record = chip_smoke.assert_same, chip_smoke.baseline_record
GOLDEN = chip_smoke.BASELINES_GOLDEN
ALPHA, BETA = 1.4, 0.2
CONSTRAINED, SUFFICIENT = chip_smoke.FIG_CAPS, chip_smoke.SUFFICIENT_CAPS
PORT_APPS = port_profiler.make_paper_apps(lam=chip_smoke.FIG_LAM, fitted=False)
REF_APPS = ref_profiler.make_paper_apps(lam=chip_smoke.FIG_LAM, fitted=False)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(policy, caps=CONSTRAINED, seed=0, extra=None):
    """(reference, port) results of one allocate() call."""
    extra = extra or {}
    ref = ref_api.allocate(policy, ref_api.AllocRequest(
        apps=REF_APPS, caps=ref_problem.ServerCaps(*caps), alpha=ALPHA, beta=BETA, seed=seed,
        extra=dict(extra)))
    port = port_api.allocate(policy, port_api.AllocRequest(
        apps=PORT_APPS, caps=port_problem.ServerCaps(*caps), alpha=ALPHA, beta=BETA, seed=seed,
        extra=dict(extra), device="cpu"))
    assert port.policy == ref.policy == policy
    assert_same(baseline_record(ref), baseline_record(port), policy)
    return ref, port


# ----------------------------------------------------------------------------
# Policies against the reference (tests/test_api.py's sizes)
# ----------------------------------------------------------------------------
def test_random_search_policy_parity():
    ref, port = _both("random_search", seed=3, extra={"n_samples": 4000})
    # the winning draw's quotas are the draw itself
    np.testing.assert_array_equal(port.allocation.r_cpu, ref.allocation.r_cpu)
    np.testing.assert_array_equal(port.allocation.r_mem, ref.allocation.r_mem)
    assert port.diagnostics.extra["n_samples"] == 4000


@pytest.mark.parametrize("policy", ["gpbo", "tpebo"])
def test_bo_policies_parity(policy):
    _both(policy, seed=1, extra={"n_init": 8, "n_iters": 8})


@pytest.mark.parametrize("caps", [CONSTRAINED, SUFFICIENT], ids=["constrained", "sufficient"])
@pytest.mark.parametrize("policy", ["snfc1", "snfc2"])
def test_snfc_policies_parity(policy, caps):
    ref, port = _both(policy, caps=caps)
    np.testing.assert_array_equal(port.allocation.r_cpu, ref.allocation.r_cpu)
    np.testing.assert_array_equal(port.allocation.r_mem, ref.allocation.r_mem)


def test_drf_policy_parity():
    _, port = _both("drf")
    assert port.diagnostics.wall_clock_s > 0
    # DRF records no refinement work
    assert port.diagnostics.refine_iters == 0 == port.diagnostics.accepted_moves


def test_functions_match_their_policies():
    caps = port_problem.ServerCaps(*CONSTRAINED)
    pairs = [
        (port_baselines.random_search(PORT_APPS, caps, ALPHA, BETA, n_samples=4000, seed=3,
                                      device="cpu"),
         ("random_search", 3, {"n_samples": 4000})),
        (port_baselines.drf(PORT_APPS, caps, ALPHA, BETA, device="cpu"), ("drf", 0, {})),
        (port_baselines.snfc(PORT_APPS, caps, ALPHA, BETA, r_cpu_fixed=1.0, r_mem_fixed="rmax",
                             device="cpu"), ("snfc2", 0, {})),
    ]
    for alloc, (policy, seed, extra) in pairs:
        res = port_api.allocate(policy, port_api.AllocRequest(
            apps=PORT_APPS, caps=caps, seed=seed, extra=extra, device="cpu"))
        assert baseline_record(res) == baseline_record(SimpleNamespace(allocation=alloc))


@pytest.mark.parametrize("seed", [0, 5])
def test_repair_matches_reference(seed):
    """The BO baselines' budget projection, on over-budget draws."""
    rng = np.random.default_rng(seed)
    caps_r, caps_p = ref_problem.ServerCaps(*CONSTRAINED), port_problem.ServerCaps(*CONSTRAINED)
    for _ in range(20):
        n = rng.integers(1, 12, size=4).astype(float)
        c = rng.uniform(0.1, 3.0, size=4)
        m = np.array([rng.uniform(a.r_min, a.r_max) for a in REF_APPS])
        # copies: _repair trims a float count vector in place
        ref = ref_baselines._repair(REF_APPS, caps_r, n.copy(), c, m)
        port = port_baselines._repair(PORT_APPS, caps_p, n.copy(), c, m)
        for a, b in zip(ref, port):
            np.testing.assert_array_equal(b, a)


def test_n_from_delta_matches_reference():
    rng = np.random.default_rng(2)
    delta = rng.uniform(0, 8, size=(50, 4))
    c = rng.uniform(0.1, 3.0, size=(50, 4))
    m = np.stack([rng.uniform(a.r_min, a.r_max, size=50) for a in REF_APPS], axis=1)
    np.testing.assert_array_equal(port_baselines._n_from_delta(PORT_APPS, delta, c, m),
                                  ref_baselines._n_from_delta(REF_APPS, delta, c, m))


# ----------------------------------------------------------------------------
# The reference's behavioural asserts (tests/test_baselines.py) on the port
# ----------------------------------------------------------------------------
CAPS = port_problem.ServerCaps(*CONSTRAINED)


def test_random_search_feasible():
    al = port_baselines.random_search(PORT_APPS, CAPS, ALPHA, BETA, n_samples=20000, seed=0,
                                      device="cpu")
    assert al.feasible and al.stable


@pytest.mark.parametrize("search", ["gpbo", "tpebo"])
def test_bo_returns_reasonable(search):
    al = getattr(port_baselines, search)(PORT_APPS, CAPS, ALPHA, BETA, n_init=8, n_iters=24,
                                         seed=0, device="cpu")
    assert al.total_cpu() <= CAPS.r_cpu * 1.05
    assert al.total_mem() <= CAPS.r_mem * 1.05


def test_drf_fills_budget_and_may_be_unstable():
    al = port_baselines.drf(PORT_APPS, CAPS, ALPHA, BETA, device="cpu")
    assert al.total_cpu() <= CAPS.r_cpu * 1.001
    assert al.total_mem() <= CAPS.r_mem * 1.001
    assert al.total_cpu() >= 0.8 * CAPS.r_cpu or al.total_mem() >= 0.8 * CAPS.r_mem


def test_snfc_variants():
    big = port_problem.ServerCaps(*SUFFICIENT)
    al1 = port_baselines.snfc(PORT_APPS, big, ALPHA, BETA, r_cpu_fixed=1.8, r_mem_fixed=0.35,
                              device="cpu")
    al2 = port_baselines.snfc(PORT_APPS, big, ALPHA, BETA, r_cpu_fixed=1.0, r_mem_fixed="rmax",
                              device="cpu")
    assert al1.stable and al2.stable
    for app, m in zip(PORT_APPS, al2.r_mem):
        assert m == app.r_max
    for app, m in zip(PORT_APPS, al1.r_mem):
        assert app.r_min - 1e-9 <= m <= app.r_max + 1e-9


def test_baselines_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, kw in ((port_baselines.random_search, {"n_samples": 10}),
                   (port_baselines.gpbo, {"n_init": 2, "n_iters": 1}),
                   (port_baselines.tpebo, {"n_init": 2, "n_iters": 1}),
                   (port_baselines.drf, {}), (port_baselines.snfc, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(PORT_APPS, CAPS, ALPHA, BETA, **kw)


# ----------------------------------------------------------------------------
# The golden file chip_smoke.py phase 19 replays on the card
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


@pytest.fixture(scope="module")
def port_fig(golden):
    return chip_smoke.run_baselines(port_api, port_problem, port_profiler, device="cpu")[0]


def test_golden_file_describes_this_comparison(golden):
    assert sorted(golden["fig11_14"]) == sorted(k for k, *_ in chip_smoke.baseline_calls())
    assert golden["setup"] == _setup()


def test_port_matches_golden_fig11_14(golden, port_fig):
    """The whole Figs. 11-14 comparison through the port on the CPU."""
    assert_same(golden["fig11_14"], port_fig, "fig11_14")


def test_crms_beats_all_baselines_on_paper_scenario(port_fig):
    """Headline claim (§VI): >= 14 % lower latency than the best search
    baseline, the port's own results."""
    red = chip_smoke.reductions_pct(port_fig)
    assert min(red.values()) >= chip_smoke.MIN_REDUCTION_PCT, red
    # ... and against the seed-0 runs alone, as tests/test_baselines.py holds it
    w_crms = chip_smoke.mean_latency_s(port_fig["crms"])
    best = min(chip_smoke.mean_latency_s(port_fig[f"{s}/0"]) for s in chip_smoke.SEARCHES)
    assert np.isfinite(best) and w_crms <= best * 0.86, (w_crms, best)


def _setup() -> dict:
    return {"lam": list(chip_smoke.FIG_LAM), "fitted": False, "caps": list(CONSTRAINED),
            "sufficient_caps": list(SUFFICIENT), "alpha": ALPHA, "beta": BETA,
            "seeds": list(chip_smoke.FIG_SEEDS), "rs_samples": chip_smoke.RS_SAMPLES,
            "search_M": chip_smoke.SEARCH_M, "rtol": chip_smoke.SCENARIO_RTOL}


def write_golden(path=GOLDEN):
    """The reference's Figs. 11-14 records and its random search at
    make_tenant_mix(16), through ``repro.api.allocate`` on the CPU."""
    records, walls, _ = chip_smoke.run_baselines(ref_api, ref_problem, ref_profiler)
    print({k: round(v, 2) for k, v in walls.items()},
          chip_smoke.reductions_pct(records), flush=True)
    out = {
        "about": "Reference (repro, JAX on the CPU) baseline allocations for the port's "
                 "parity checks; regenerate with PYTHONPATH=src JAX_PLATFORMS=cpu python "
                 "tests/test_torch_baselines.py",
        "setup": _setup(),
        "fig11_14": records,
        "search_mix16": chip_smoke.search_record(ref_api, ref_profiler),
    }
    path.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    write_golden()
    sys.exit(0)
