"""The TPU-fleet binding of the port (``repro_torch.core.fleet``,
``repro_torch.serve.fleet``, ``launch.serve --plan``,
``benchmarks_torch/fleet_tpu.py``) against repro (JAX, CPU):

- the latency model, the HBM bounds, the pod caps, the chip power and
  ``default_workloads`` equal the reference's; the profile data bit for bit;
  ``workloads_from_roofline`` reads a JSON as the reference does;
- ``tests/test_fleet_engine.py``'s asserts on the port;
- ``chip_smoke.py`` phase 20's checks on the CPU at the card's bars: each
  fit's rmse at most 2e-3 relative above the reference's and its surface
  within 5e-2 of the reference's fitted surface (the fleet's Eq. (1) is
  nearly unidentifiable, κ₂·c ≤ 1.4e-6, so the multi-start LM lands
  elsewhere on a flat ridge; ROADMAP Queue 3); the plan on the reference's κ
  under ``check_fleet_record``: the port's Ws and utility at the reference's
  quotas within their rounding envelope (Eq. (1)'s 1 - exp(-κ₂c) cancels at
  κ₂c ~ 1e-14, where the two packages' exp differ by an ulp), the
  reference's counts, flags and counters, utility within rtol 2e-5, quotas
  and replica groups within 5e-2 (ROADMAP Queue 3); planted κ faults that
  those bars fail; the plan on the port's own fit with the
  reference's counts and utility within rtol 1e-4; the drift flags and the
  re-plan; the launcher's plan; the fleet_tpu comparison's records.

``tests/data/torch_fleet_binding_golden.json`` holds the reference's
workloads, profile data, fitted apps, plan, drift re-plan, launcher table,
fleet_tpu records and the values its examples print
(``tests/test_torch_examples.py``). Regenerate it (JAX, a few minutes) with

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_fleet.py
"""
import contextlib
import dataclasses
import io
import json
import pathlib
import re
import runpy
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro.core import fleet as ref_fleet
from repro.core import power as ref_power
from repro_torch.core import fleet, power

from torch_scripts import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


assert_same, plain = chip_smoke.assert_same, chip_smoke.plain
GOLDEN = chip_smoke.FLEET_BINDING_GOLDEN


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


# ----------------------------------------------------------------------------
# The NumPy layer against the reference's
# ----------------------------------------------------------------------------
def test_constants_caps_and_power_equal_the_reference():
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_PER_CHIP_GB"):
        assert getattr(fleet, name) == getattr(ref_fleet, name), name
    assert dataclasses.asdict(power.TPU_V5E_CHIP_POWER) == dataclasses.asdict(
        ref_power.TPU_V5E_CHIP_POWER)
    for n in (64, 256):
        caps, ref = fleet.pod_caps(n), ref_fleet.pod_caps(n)
        assert (caps.r_cpu, caps.r_mem) == (ref.r_cpu, ref.r_mem)
        assert dataclasses.asdict(caps.power) == dataclasses.asdict(ref.power)
    chips = np.array([0.0, 1.0, 7.5, 256.0])
    np.testing.assert_array_equal(power.pod_power(chips), np.asarray(ref_power.pod_power(chips)))
    got = power.pod_power(torch.tensor([3, 5]))
    assert got.dtype == torch.float64 and got.tolist() == [375.0, 625.0]


def test_default_workloads_equal_the_reference():
    got = [dataclasses.asdict(w) for w in fleet.default_workloads()]
    assert got == [dataclasses.asdict(w) for w in ref_fleet.default_workloads()]


def test_latency_model_and_bounds_bit_for_bit():
    chips = np.array([1.0, 2.0, 3.0, 8.0, 64.0, 256.0])[:, None]
    for w, ref_w in zip(fleet.default_workloads(), ref_fleet.default_workloads()):
        r_min, r_max = fleet.hbm_bounds_gb(w)
        assert (r_min, r_max) == ref_fleet.hbm_bounds_gb(ref_w)
        assert fleet.hbm_bounds_gb(w, 64.0) == ref_fleet.hbm_bounds_gb(ref_w, 64.0)
        hbm = np.linspace(r_min * 0.5, r_max * 1.5, 7)[None, :]
        np.testing.assert_array_equal(fleet.step_latency_ms(w, chips, hbm),
                                      ref_fleet.step_latency_ms(ref_w, chips, hbm))
        np.testing.assert_array_equal(fleet.request_latency_ms(w, chips, hbm),
                                      ref_fleet.request_latency_ms(ref_w, chips, hbm))


@pytest.mark.parametrize("seed", [0, 3])
def test_profile_data_bit_for_bit(seed):
    for i, (w, ref_w) in enumerate(zip(fleet.default_workloads(), ref_fleet.default_workloads())):
        for kw in ({}, {"chips_grid": np.array([1, 4, 16]), "noise_rel": 0.05}):
            got = fleet.profile_workload(w, seed=seed + i, **kw)
            want = ref_fleet.profile_workload(ref_w, seed=seed + i, **kw)
            for g, r in zip(got, want):
                np.testing.assert_array_equal(g, r)


def test_workloads_from_roofline_reads_as_the_reference(tmp_path):
    rows = [
        {"arch": "a", "shape": "decode_32k", "mesh": "single_pod", "chips": 256,
         "global_batch": 128, "hlo_flops_total": 3.2e15, "hlo_bytes_total": 9.1e12,
         "params_bytes": 1.6e10, "kv_bytes_per_seq": 2.1e9, "collective_bytes_total": 4e10,
         "lam": 3.5},
        {"arch": "b", "shape": "decode_32k", "mesh": "single_pod", "chips": 256,
         "global_batch": 64, "hlo_flops_total": 1e14, "hlo_bytes_total": 3.2e7,
         "collective_bytes_total": 2e9},  # defaults; bytes_per_tok floored at 1e6
        {"arch": "c", "shape": "prefill_32k", "mesh": "single_pod", "chips": 256},
        {"arch": "d", "shape": "decode_32k", "mesh": "multi_pod", "chips": 512},
    ]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(rows))
    got = [dataclasses.asdict(w) for w in fleet.workloads_from_roofline(path)]
    assert got == [dataclasses.asdict(w) for w in ref_fleet.workloads_from_roofline(str(path))]
    assert [w["name"] for w in got] == ["a", "b"] and got[1]["bytes_per_tok"] == 1e6


# ----------------------------------------------------------------------------
# tests/test_fleet_engine.py's asserts on the port
# ----------------------------------------------------------------------------
def test_fleet_latency_model_shape():
    for w in fleet.default_workloads():
        r_min, r_max = fleet.hbm_bounds_gb(w)
        assert r_max > r_min > 0
        chips = np.array([1, 2, 4, 8, 16, 32], float)
        d = fleet.request_latency_ms(w, chips, r_max)
        assert np.all(np.diff(d) < 1e-9), w.name  # more chips -> faster
        mems = np.linspace(r_min, r_max, 6)
        d2 = fleet.request_latency_ms(w, 8.0, mems)
        assert np.all(np.diff(d2) < 1e-9), w.name  # more HBM -> faster


def test_fleet_latency_model_convex():
    for w in fleet.default_workloads():
        r_min, r_max = fleet.hbm_bounds_gb(w)
        chips = np.linspace(1, 64, 32)
        d = fleet.request_latency_ms(w, chips, r_max)
        assert np.all(d[:-2] + d[2:] - 2 * d[1:-1] >= -1e-9), w.name
        mems = np.linspace(r_min * 1.001, r_max, 32)
        d2 = fleet.request_latency_ms(w, 8.0, mems)
        assert np.all(d2[:-2] + d2[2:] - 2 * d2[1:-1] >= -1e-9), w.name


def test_fleet_eq1_fit_quality():
    apps = fleet.build_fleet_apps(fleet.default_workloads()[:3], seed=0, device=CPU)
    for a in apps:
        assert all(k > 0 for k in a.kappa), a.name
        assert a.r_max > a.r_min


def test_fleet_engine_and_allocator_bind_the_device():
    workloads = fleet.default_workloads()[:2]
    apps, packed, caps, allocator = fleet.fleet_allocator(workloads, n_chips=64, device=CPU)
    assert packed.M == 2 and caps.r_cpu == 64.0 and caps.r_mem == 64 * 16.0
    np.testing.assert_array_equal(packed.kappa, [a.kappa for a in apps])
    assert allocator.device == CPU and allocator.threshold == 0.15
    alloc = allocator.allocate(apps, packed=packed)
    assert alloc.feasible and np.all(alloc.n >= 1)


# ----------------------------------------------------------------------------
# chip_smoke.py phase 20 on the CPU
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def binding(golden):
    """(a)-(d): the fit, the own-fit plan, the plan on the reference's κ and
    the drift sequence, each check raising on a miss."""
    return chip_smoke.run_fleet_binding(golden, device=CPU)


def test_golden_file_describes_phase_20(golden):
    assert golden["setup"] == _setup()
    assert [a["name"] for a in golden["apps"]] == [w["name"] for w in golden["workloads"]]
    assert golden["drift"]["reoptimized"] == [False, True]
    assert len(golden["plan"]["groups"]) == sum(golden["plan"]["n"])


def test_fit_plans_and_drift_match_the_reference(binding, golden):
    own, numbers = binding
    assert numbers["fit_rmse_excess_max"] <= chip_smoke.FIT_RMSE_REL
    assert numbers["fit_surface_gap_max"] <= chip_smoke.FIT_SURFACE_REL
    assert own["n"] == golden["plan"]["n"]
    assert numbers["own_fit_utility"] == pytest.approx(golden["plan"]["utility"], rel=1e-4)
    assert numbers["refine_iters"] == golden["plan"]["refine_iters"]


def test_launch_serve_plan_prints_the_reference_table(binding, golden, capsys):
    """``launch.serve --plan`` on the CPU: its plan equals the own-fit plan,
    and its table has the reference's lines, counts and groups."""
    from repro_torch.launch import serve

    own, _ = binding
    fm, alloc, groups = serve.main(["--plan", "--device", CPU])
    assert_same(own, chip_smoke.fleet_plan_record(alloc, groups, fm.last_result.diagnostics))
    lines = capsys.readouterr().out.strip().splitlines()
    ref = golden["launcher"]
    assert len(lines) == len(ref)
    assert lines[1] == ref[1]  # the header
    row = re.compile(r"^(\S+)\s+(\d+)\s")
    assert [row.match(ln).groups() for ln in lines[2:-1]] == [
        row.match(ln).groups() for ln in ref[2:-1]]
    assert lines[0].startswith(f"fleet utility: {alloc.utility:.3f} feasible=True stable=True")
    assert lines[-1] == ref[-1] == (f"replica groups: {len(groups)}; chips used "
                                    f"{alloc.total_cpu():.0f}/256")


def test_launch_serve_plan_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--plan"], ["--chips", "64"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(argv)


def _reference_apps(golden, fault=None):
    """The reference's fitted apps; ``fault`` = (name, δ) multiplies that
    app's κ₃ by 1 + δ."""
    from repro_torch.core.problem import App

    apps = [App(**{**a, "kappa": tuple(a["kappa"])}) for a in golden["apps"]]
    if fault is not None:
        name, delta = fault
        apps = [dataclasses.replace(a, kappa=(*a.kappa[:2], a.kappa[2] * (1 + delta)))
                if a.name == name else a for a in apps]
    return apps


# Each app's smallest κ₃ fault (of 1e-3, 1e-2, 1e-1) that moves its Ws at the
# reference's quotas out of the rounding envelope: where Eq. (1) cancels
# (gemma-2b, minitron-4b, mamba2-130m) the envelope is wide and κ₃ moves d
# little.
PLANTED = [("codeqwen1.5-7b", 1e-3), ("command-r-plus-104b", 1e-3), ("gemma-2b", 1e-1),
           ("minitron-4b", 1e-2), ("llama4-scout-17b-a16e", 1e-3),
           ("moonshot-v1-16b-a3b", 1e-3), ("jamba-1.5-large-398b", 1e-3),
           ("mamba2-130m", 1e-1), ("llama-3.2-vision-90b", 1e-3),
           ("seamless-m4t-large-v2", 1e-3)]


@pytest.mark.parametrize("fault", PLANTED, ids=[name for name, _ in PLANTED])
def test_a_planted_kappa_fault_fails_the_evaluation_check(golden, fault):
    """The port evaluating with one app's κ₃ off by δ fails
    ``check_fleet_record`` even when its solve returned the reference's plan
    itself: that app's Ws at the reference's quotas leaves its envelope."""
    apps = _reference_apps(golden, fault)
    caps = fleet.pod_caps(chip_smoke.FLEET_CHIPS)
    with pytest.raises(AssertionError, match="rounding envelope") as caught:
        chip_smoke.check_fleet_record(golden["plan"], golden["plan"], "plan", apps, caps, CPU)
    assert fault[0] in str(caught.value)
    print(fault, caught.value)


def test_a_plan_on_a_planted_kappa_fails_the_solve_check(golden, monkeypatch):
    """A plan solved on jamba-1.5-large-398b's κ₃ off by 1e-3 keeps the
    reference's counts and counters, but its utility leaves
    FLEET_UTILITY_RTOL; the evaluation check, on the right κ, passes."""
    from repro_torch.serve import fleet as serve_fleet

    faulty = _reference_apps(golden, ("jamba-1.5-large-398b", 1e-3))
    monkeypatch.setattr(serve_fleet, "build_fleet_apps", lambda *_, **__: list(faulty))
    fm = serve_fleet.FleetManager(n_chips=chip_smoke.FLEET_CHIPS, device=CPU)
    plan, _, _ = chip_smoke.fleet_plan(fm)
    assert plan["n"] == golden["plan"]["n"]
    with pytest.raises(AssertionError, match=r"plan\.utility") as caught:
        chip_smoke.check_fleet_record(golden["plan"], plan, "plan", _reference_apps(golden),
                                      fm.caps, CPU)
    print(caught.value)


def test_fleet_tpu_comparison_matches_the_reference(golden):
    out = chip_smoke.check_fleet_tpu(golden, device=CPU)
    latency = out["mean_latency_s"]
    assert np.isfinite(latency["crms"]) and latency["crms"] <= min(
        latency["random_search"], latency["tpebo"])


def test_fleet_tpu_script_writes_its_artifact(tmp_path, monkeypatch):
    """The benchmark's own entry point on two workloads: a JSON with the
    three records and ``ok``."""
    bench = chip_smoke.load_script("benchmarks_torch/fleet_tpu.py")
    every = fleet.default_workloads()
    monkeypatch.setattr(fleet, "default_workloads", lambda: every[:2])
    out = tmp_path / "fleet_tpu.json"
    doc = bench.run(["--device", CPU, "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    assert set(doc["records"]) == {"crms", "random_search", "tpebo"}
    assert doc["ok"] == (doc["records"]["crms"]["feasible"] and doc["records"]["crms"]["stable"]
                         and doc["mean_latency_s"]["crms"] is not None)


# ----------------------------------------------------------------------------
# The golden file
# ----------------------------------------------------------------------------
def _setup() -> dict:
    return {"n_chips": chip_smoke.FLEET_CHIPS, "alpha": chip_smoke.FLEET_ALPHA,
            "beta": chip_smoke.FLEET_BETA, "threshold": 0.15,
            "seed": 0, "drift": list(chip_smoke.FLEET_DRIFT),
            "rs_samples": 20000, "rtol": chip_smoke.SCENARIO_RTOL}


def _run_script(path, argv=()):
    """A reference script run as __main__: (its globals, its stdout lines)."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(buf):
            g = runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    print(buf.getvalue(), flush=True)
    return g, buf.getvalue().strip().splitlines()


def _quickstart_values(g) -> dict:
    alloc, d, info, fo = g["alloc"], g["result"].diagnostics, g["info"], g["fo"]
    return plain({
        "kappa": [list(a.kappa) for a in g["apps"]],
        "policies": g["list_policies"](),
        "crms": {"n": alloc.n, "r_cpu": alloc.r_cpu, "r_mem": alloc.r_mem, "ws": alloc.ws,
                 "power_w": alloc.power_w, "utility": alloc.utility, "feasible": alloc.feasible,
                 "stable": alloc.stable, "refine_iters": d.refine_iters,
                 "accepted_moves": d.accepted_moves, "p1_calls": d.p1_calls},
        "crms_lifecycle": {"deployed": info["deployed"], "switch_cost_j": info["switch_cost_j"],
                           "gain_rate_bar_w": info["gain_rate_bar_w"],
                           "keep_warm": g["lr"].allocation.meta["keep_warm"]},
        "crms_failover": {"reason": fo["reason"], "availability": fo["availability"],
                          "hedge": fo["hedge"], "k_extra": fo["k_extra"],
                          "shed": list(g["fr"].diagnostics.shed)},
    })


def _edge_demo_values(g) -> dict:
    return plain({"phases": [{"t": r["t"], "lam": r["lam"], "alloc_n": r["alloc_n"],
                              "mean_response": r["mean_response"]} for r in g["results"]],
                  "reoptimizations": g["qd"].reoptimizations})


def _multitenant_values(g, lines) -> dict:
    flags = [ln.split("re-optimized=")[1].split()[0] == "True" for ln in lines
             if "re-optimized=" in ln]
    return plain({"plan": chip_smoke.fleet_plan_record(g["alloc"], g["groups"]),
                  "reoptimized": flags})


def write_golden(path=GOLDEN):
    """The reference's fleet binding on the CPU: workloads, profile data,
    fitted apps, plan, drift, launcher table, fleet_tpu records, and the
    values the four examples print (train_small_lm's loss curve is not
    compared: the weights are drawn from another generator)."""
    from repro.core.baselines import random_search, tpebo
    from repro.core.crms import crms
    from repro.launch import serve as ref_serve
    from repro.serve.fleet import FleetManager as RefFleetManager

    def plan_record(fm):
        alloc, groups = fm.plan()
        return chip_smoke.fleet_plan_record(alloc, groups, fm.last_result.diagnostics)

    workloads = ref_fleet.default_workloads()
    fm = RefFleetManager(n_chips=chip_smoke.FLEET_CHIPS)
    plan = plan_record(fm)
    base_apps = list(fm.apps)
    flags = []
    for scale in chip_smoke.FLEET_DRIFT:
        fm.observe({a.name: a.lam * scale for a in fm.apps})
        before = fm.allocator.reoptimizations
        drifted = plan_record(fm)
        flags.append(fm.allocator.reoptimizations > before)
    print("plan", plan["n"], plan["utility"], "drift", flags, flush=True)

    _, launcher = _run_script(pathlib.Path(ref_serve.__file__), ["--plan"])
    bench = chip_smoke.load_script("benchmarks_torch/fleet_tpu.py")
    caps = ref_fleet.pod_caps(chip_smoke.FLEET_CHIPS)
    alpha, beta, samples = bench.ALPHA, bench.BETA, bench.RS_SAMPLES
    tpu = {"crms": crms(base_apps, caps, alpha, beta),
           "random_search": random_search(base_apps, caps, alpha, beta, n_samples=samples,
                                          seed=0),
           "tpebo": tpebo(base_apps, caps, alpha, beta, seed=0)}
    tpu = {key: bench.record(alloc) for key, alloc in tpu.items()}
    examples = {}
    g, _ = _run_script(ROOT / "examples" / "quickstart.py")
    examples["quickstart"] = _quickstart_values(g)
    g, _ = _run_script(ROOT / "examples" / "edge_crms_demo.py")
    examples["edge_crms_demo"] = _edge_demo_values(g)
    g, lines = _run_script(ROOT / "examples" / "serve_multitenant.py")
    examples["serve_multitenant"] = _multitenant_values(g, lines)

    out = {
        "about": "Reference (repro, JAX on the CPU) TPU-fleet binding for the port's parity "
                 "checks (chip_smoke.py phase 20, tests/test_torch_fleet.py, "
                 "tests/test_torch_examples.py); regenerate with PYTHONPATH=src:. "
                 "JAX_PLATFORMS=cpu python tests/test_torch_fleet.py",
        "setup": _setup(),
        "workloads": [plain(dataclasses.asdict(w)) for w in workloads],
        "profiles": [dict(zip(("cs", "ms", "d"), plain(ref_fleet.profile_workload(w, seed=i))))
                     for i, w in enumerate(workloads)],
        "apps": [plain(dataclasses.asdict(a)) for a in base_apps],
        "plan": plan,
        "drift": {"reoptimized": flags, "plan": drifted},
        "launcher": launcher,
        "fleet_tpu": tpu,
        "examples": examples,
    }
    path.write_text(json.dumps(out, separators=(",", ":")) + "\n")


if __name__ == "__main__":
    write_golden()
    sys.exit(0)
