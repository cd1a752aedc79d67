"""Slice gate of the PyTorch port: ``allocate("crms")``,
``allocate("crms_priority")`` and ``allocate("crms_p95")`` (with and without a
DES rollout budget) through ``repro`` (JAX, CPU) and ``repro_torch``
(``device="cpu"``) on the same instances give identical container counts,
quotas and utility within rtol 1e-6, and equal Diagnostics counters (the
rollout calls and accepted rollout moves among them).

The reference's results for the larger instances live in
``tests/data/torch_port_golden.json``; ``test_golden_file_is_current``
recomputes its paper-apps and M=8 entries with ``repro`` so the file cannot go
stale. Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_crms.py
"""
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.api import AllocRequest as RefRequest
from repro.api import QuasiDynamicPolicy as RefQD
from repro.api import SolverOptions as RefOptions
from repro.api import allocate as ref_allocate
from repro.core.crms import algorithm1 as ref_algorithm1
from repro.core.crms import crms as ref_crms
from repro.core import profiler as ref_profiler
from repro.core.problem import ServerCaps as RefCaps
from repro_torch import interop
from repro_torch.api import AllocRequest, QuasiDynamicPolicy, SolverOptions, allocate
from repro_torch.core.crms import QuasiDynamicAllocator, algorithm1, crms

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "torch_port_golden.json")
COUNTERS = ("refine_iters", "accepted_moves", "p1_calls", "p1_rescued_rows",
            "p1_masked_rows", "warm_start", "rollout_calls", "rollout_accepted")
LAM4 = (8.0, 7.0, 10.0, 15.0)
PRIORITY = {"ResNet_v2": 3.0, "MobileNet_v2": 0.5}
ROLLOUT8 = {"rollout_budget": 2, "rollout_horizon_s": 20.0}
ROLLOUT64 = {"rollout_budget": 4, "rollout_horizon_s": 40.0}

# Instances by name: how each is built in both packages (the golden file
# records the same description, which chip_smoke.py reads).
INSTANCES = {
    "paper_fitted": {"builder": "make_paper_apps", "lam": list(LAM4), "fitted": True,
                     "caps": [30.0, 10.0]},
    "paper_truth": {"builder": "make_paper_apps", "lam": list(LAM4), "fitted": False,
                    "caps": [30.0, 10.0]},
    **{f"mix{M}": {"builder": "make_tenant_mix", "M": M} for M in (8, 16, 32, 64)},
}
# golden entries: (entry name, instance, policy, extra)
GOLDEN_ENTRIES = [
    ("paper_fitted", "paper_fitted", "crms", {}),
    *[(f"mix{M}", f"mix{M}", "crms", {}) for M in (8, 16, 32, 64)],
    ("priority_mix8", "mix8", "crms_priority", {"weights": PRIORITY}),
    ("p95_mix8", "mix8", "crms_p95", {}),
    ("p95_rollout_mix8", "mix8", "crms_p95", ROLLOUT8),
    ("p95_rollout_mix64", "mix64", "crms_p95", ROLLOUT64),  # checked on the card
]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ref_instance(name):
    spec = INSTANCES[name]
    if spec["builder"] == "make_tenant_mix":
        apps, caps, _ = ref_profiler.make_tenant_mix(spec["M"])
        return apps, caps
    apps = ref_profiler.make_paper_apps(lam=spec["lam"], fitted=spec["fitted"])
    return apps, RefCaps(*spec["caps"])


def _to_port(apps, caps):
    """The reference's instance, carried over as plain values."""
    port_apps = interop.apps_from_arrays(
        [a.name for a in apps],
        [a.kappa for a in apps],
        *([getattr(a, f) for a in apps]
          for f in ("lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max")),
    )
    port_caps = interop.caps_from_values(caps.r_cpu, caps.r_mem, caps.power.p_idle,
                                         caps.power.p_full)
    return port_apps, port_caps


def _ref_entry(alloc, diag):
    """The comparison record of a reference Allocation; ``diag`` is its
    Diagnostics (a dataclass) or the raw meta["diagnostics"] dict. The
    rollout counters, which the Diagnostics dataclass does not lift, come
    from the meta dict."""
    diag = diag if isinstance(diag, dict) else dataclasses.asdict(diag)
    diag = {**alloc.meta.get("diagnostics", {}), **diag}
    return {
        "n": [int(v) for v in alloc.n],
        "r_cpu": [float(v) for v in alloc.r_cpu],
        "r_mem": [float(v) for v in alloc.r_mem],
        "utility": float(alloc.utility),
        **{k: (bool if k == "warm_start" else int)(diag[k]) for k in COUNTERS},
    }


def _assert_parity(port_arrays, ref, rtol=1e-6):
    np.testing.assert_array_equal(port_arrays["n"], ref["n"])
    np.testing.assert_allclose(port_arrays["r_cpu"], ref["r_cpu"], rtol=rtol)
    np.testing.assert_allclose(port_arrays["r_mem"], ref["r_mem"], rtol=rtol)
    assert port_arrays["utility"] == pytest.approx(ref["utility"], rel=rtol)
    for k in COUNTERS:
        assert port_arrays[k] == ref[k], k


def _run_ref(instance, policy, extra=None):
    return dict(_run_ref_cached(instance, policy, json.dumps(extra or {}, sort_keys=True)))


@functools.lru_cache(maxsize=None)
def _run_ref_cached(instance, policy, extra_json):
    apps, caps = _ref_instance(instance)
    res = ref_allocate(policy, RefRequest(apps, caps, extra=json.loads(extra_json)))
    return tuple(_ref_entry(res.allocation, res.diagnostics).items())


def _run_port(instance, policy, extra=None):
    return _run_port_cached(instance, policy, json.dumps(extra or {}, sort_keys=True))


@functools.lru_cache(maxsize=None)
def _run_port_cached(instance, policy, extra_json):
    port_apps, port_caps = _to_port(*_ref_instance(instance))
    res = allocate(policy, AllocRequest(port_apps, port_caps, extra=json.loads(extra_json),
                                        device="cpu"))
    return interop.allocation_to_arrays(res.allocation), res


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.mark.parametrize(
    "instance,policy,extra",
    [
        ("paper_fitted", "crms", None),
        ("paper_truth", "crms", None),
        ("mix8", "crms", None),
        ("paper_truth", "crms_priority", {"weights": PRIORITY}),
        ("mix8", "crms_priority", {"weights": PRIORITY}),
        ("paper_truth", "crms_p95", None),
        ("mix8", "crms_p95", None),
        ("mix8", "crms_p95", ROLLOUT8),
    ],
)
def test_allocate_matches_reference(instance, policy, extra):
    port, res = _run_port(instance, policy, extra)
    _assert_parity(port, _run_ref(instance, policy, extra))
    assert res.policy == policy and res.feasible and res.stable


def test_allocate_mix16_matches_golden(golden):
    """M=16 against the reference's recorded result (the file's M=8 and paper
    entries are recomputed live by test_golden_file_is_current)."""
    port, _ = _run_port("mix16", "crms")
    _assert_parity(port, golden["entries"]["mix16"])


def test_golden_file_is_current(golden):
    for name in ("paper_fitted", "mix8", "priority_mix8", "p95_mix8", "p95_rollout_mix8"):
        entry = golden["entries"][name]
        live = _run_ref(entry["instance"], entry["policy"], entry["extra"])
        for k, v in live.items():
            if k in ("r_cpu", "r_mem", "utility"):
                np.testing.assert_allclose(entry[k], v, rtol=1e-12, err_msg=k)
            else:
                assert entry[k] == v, (name, k)


def test_quasidynamic_warm_replan_matches_reference():
    ref_apps, ref_caps = _ref_instance("paper_truth")
    port_apps, port_caps = _to_port(ref_apps, ref_caps)
    ref_qd, port_qd = RefQD("crms"), QuasiDynamicPolicy("crms")
    for scale in (1.0, 1.05, 0.8, 1.3):  # cold, cache hit, warm re-plan, cold re-plan
        r = ref_qd.allocate(RefRequest([a.with_lam(a.lam * scale) for a in ref_apps], ref_caps))
        p = port_qd.allocate(AllocRequest([a.with_lam(a.lam * scale) for a in port_apps],
                                          port_caps, device="cpu"))
        _assert_parity(interop.allocation_to_arrays(p.allocation),
                       _ref_entry(r.allocation, r.diagnostics))
        assert p.diagnostics.cache_hit == r.diagnostics.cache_hit
        assert p.diagnostics.warm_start == (scale == 0.8)  # 1.3x load: the warm P1 fails
    assert port_qd.reoptimizations == ref_qd.reoptimizations == 3


def test_quasidynamic_allocator_view():
    port_apps, port_caps = _to_port(*_ref_instance("paper_truth"))
    qd = QuasiDynamicAllocator(port_caps, 1.4, 0.2, threshold=0.15, device="cpu")
    qd.allocate(port_apps)
    qd.allocate([a.with_lam(a.lam * 1.05) for a in port_apps])
    assert qd.reoptimizations == 1
    assert qd.should_reoptimize([a.with_lam(a.lam * 1.5) for a in port_apps])


@pytest.mark.parametrize("caps", [(120.0, 40.0), (34.0, 11.0)])
def test_crms_branches_match_reference(caps):
    """The sufficient-resources branch (ample caps) and a loaded constrained
    one, through crms() directly."""
    ref_apps = ref_profiler.make_paper_apps(lam=(10, 9, 12, 18), fitted=False)
    ref_c = RefCaps(*caps)
    port_apps, port_caps = _to_port(ref_apps, ref_c)
    r = ref_crms(ref_apps, ref_c, 1.4, 0.2)
    p = crms(port_apps, port_caps, 1.4, 0.2, device="cpu")
    assert [h["stage"] for h in p.meta["history"]] == [h["stage"] for h in r.meta["history"]]
    _assert_parity(interop.allocation_to_arrays(p), _ref_entry(r, r.meta["diagnostics"]))


def test_tail_objective_matches_reference():
    ref_apps, ref_caps = _ref_instance("paper_truth")
    port_apps, port_caps = _to_port(ref_apps, ref_caps)
    r = ref_crms(ref_apps, ref_caps, 1.4, 0.2, options=RefOptions(tail_target=0.95))
    p = crms(port_apps, port_caps, 1.4, 0.2,
                       options=SolverOptions(tail_target=0.95), device="cpu")
    _assert_parity(interop.allocation_to_arrays(p), _ref_entry(r, r.meta["diagnostics"]))
    np.testing.assert_allclose(p.meta["p95_surrogate_s"], r.meta["p95_surrogate_s"],
                               rtol=1e-6)


def test_algorithm1_matches_reference():
    ref_apps, ref_caps = _ref_instance("paper_truth")
    port_apps, port_caps = _to_port(ref_apps, ref_caps)
    for r, p in zip(ref_algorithm1(ref_apps, ref_caps, 1.4, 0.2),
                    algorithm1(port_apps, port_caps, 1.4, 0.2, device="cpu")):
        assert p.n == r.n
        assert p.r_cpu == pytest.approx(r.r_cpu, rel=1e-12)
        assert p.mu == pytest.approx(r.mu, rel=1e-12)


def test_crms_p95_policy_matches_direct_tail_solve():
    """The bars of the reference's test_p95.py: the policy is the direct
    tail solve, with its options lifted into the diagnostics."""
    port_apps, port_caps = _to_port(*_ref_instance("paper_truth"))
    res = allocate("crms_p95", AllocRequest(port_apps, port_caps, device="cpu"))
    assert res.policy == "crms_p95"
    assert res.diagnostics.extra["tail_target"] == 0.95
    assert res.diagnostics.extra["rollout_budget"] == 0
    direct = crms(port_apps, port_caps, 1.4, 0.2, options=SolverOptions(tail_target=0.95),
                  device="cpu")
    np.testing.assert_array_equal(res.allocation.n, direct.n)


def test_crms_p95_rollout_budget_consumed_and_capped():
    port, res = _run_port("mix8", "crms_p95", ROLLOUT8)
    d = res.allocation.meta["diagnostics"]
    assert 0 < d["rollout_calls"] <= 2
    assert 0 <= d["rollout_accepted"] <= d["rollout_calls"]
    assert res.feasible and res.stable
    assert res.diagnostics.extra["rollout_budget"] == 2


def test_rollout_budget_needs_the_simulation_slice():
    """A rollout budget runs the refinement through the simulation slice
    (des_vector.rollout_candidates): crms() spends it as the reference does,
    on the mean objective too, and the rollout counters count."""
    ref_apps, ref_caps = _ref_instance("paper_truth")
    port_apps, port_caps = _to_port(ref_apps, ref_caps)
    options = dict(rollout_budget=1, rollout_horizon_s=20.0)
    r = ref_crms(ref_apps, ref_caps, 1.4, 0.2, options=RefOptions(**options), seed=3)
    p = crms(port_apps, port_caps, 1.4, 0.2, options=SolverOptions(**options), seed=3,
             device="cpu")
    assert [h["stage"] for h in p.meta["history"]] == [h["stage"] for h in r.meta["history"]]
    _assert_parity(interop.allocation_to_arrays(p), _ref_entry(r, r.meta["diagnostics"]))
    assert p.meta["diagnostics"]["rollout_calls"] == 1


def write_golden(path=GOLDEN):
    """Run the JAX reference on every golden entry and write the file."""
    entries = {}
    for name, instance, policy, extra in GOLDEN_ENTRIES:
        entries[name] = {"instance": instance, "policy": policy, "extra": extra,
                         **_run_ref(instance, policy, extra)}
        print(name, entries[name]["n"], entries[name]["utility"], flush=True)
    doc = {
        "about": "repro (JAX, CPU, float64) allocate() results; alpha=1.4, beta=0.2",
        "instances": INSTANCES,
        "entries": entries,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    write_golden(sys.argv[1] if len(sys.argv) > 1 else GOLDEN)
