"""Slice gate of the PyTorch port's scenario layer: ``repro_torch.api.scenario``
against ``repro.api.scenario`` (JAX, CPU) on the same descriptions.

* every constructor's ``timeline()`` (``from_trace`` on
  ``benchmarks/data/azure_synth.csv`` among them) equal to the reference's;
* the same rejections with the same messages (mirrors
  ``tests/test_api.py::test_timeline_rejects_bad_events``);
* the smoke trace's document from both packages under ``des`` with the
  event engine (the port on ``device="cpu"``) equal field by field:
  integers, booleans, strings and lists exactly, floats within rtol 1e-6, the
  wall-clock fields left out (the ``analytic`` backend and the vector engine:
  ``tests/test_torch_scenario_backends.py``);
* each package's validator accepting the other's document and rejecting the
  same corruptions with the same message (mirrors
  ``tests/test_api.py::test_schema_validator_rejects_corrupt_documents``,
  ``tests/test_scenario_des.py``'s schema 2.x cases and
  ``tests/test_failures.py::test_validator_rejects_bad_failures_block``);

The reference's documents for the six traces that ``chip_smoke.py`` replays
on the card live in ``tests/data/torch_scenario_golden.json`` with how each
trace is built. They are recorded with the vector engine, the one the card
runs: where a replay re-plans an instant-scale-up trace (smoke,
azure_trace) the reference's two engines' achieved latencies differ by more
than 1e-6 (its own test gives them 2 %), while the two packages' vector
engines agree. ``test_golden_file_is_current``
recomputes the ``smoke`` and ``crunch`` entries with ``repro``. Regenerate
the file with

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_scenario.py
"""
import copy
import dataclasses
import functools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro import api as ref_api
from repro.api import scenario as ref_scenario
from repro.core import problem as ref_problem
from repro.core import profiler as ref_profiler
from repro.core.arrivals import mmpp2 as ref_mmpp2
from repro_torch import api as port_api
from repro_torch.api import scenario as port_scenario
from repro_torch.core import problem as port_problem
from repro_torch.core import profiler as port_profiler

from torch_scripts import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]


alloc_record, assert_same = chip_smoke.alloc_record, chip_smoke.assert_same
build_scenario, plain = chip_smoke.build_scenario, chip_smoke.plain
GOLDEN = chip_smoke.SCENARIO_GOLDEN
AZURE = "benchmarks/data/azure_synth.csv"
ALPHA, BETA, SEED = 1.4, 0.2, 11
LAM4 = (8.0, 7.0, 10.0, 15.0)
P95_ROLLOUTS = {"rollout_budget": 2, "rollout_horizon_s": 20.0}
PORT = (port_api, port_problem, {"device": "cpu"})
REF = (ref_api, ref_problem, {})


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ----------------------------------------------------------------------------
# Traces as plain values (the golden file records the same descriptions)
# ----------------------------------------------------------------------------
def app_values(app) -> dict:
    return {f.name: (list(v) if isinstance(v := getattr(app, f.name), tuple) else v)
            for f in dataclasses.fields(app)}


def paper_app_values() -> list[dict]:
    """The paper's four apps (ground-truth κ) at λ (8, 7, 10, 15)."""
    return [app_values(a) for a in ref_profiler.make_paper_apps(lam=LAM4, fitted=False)]


def _runner(policies, backend="des", epoch_s=60.0, quasi_dynamic=True, extra=None,
            slo_p95_s=None):
    return {"policies": list(policies), "quasi_dynamic": quasi_dynamic, "extra": extra or {},
            "backend": backend, "epoch_s": epoch_s, "slo_p95_s": slo_p95_s}


def trace_specs() -> dict:
    """How each trace is built: the reference benchmark it comes from, its
    cut, the constructor and its arguments as values, and the runner."""
    paper = paper_app_values()
    joiner = dict(paper[2], name="MobileNet_v2_burst", lam=5.0)
    common = {"alpha": ALPHA, "beta": BETA, "seed": SEED}
    return {
        "smoke": {
            "source": "benchmarks/scenarios.py:129-149 smoke_scenario(3)", "cut": "none",
            "constructor": "Scenario", "apps": paper[:3], "caps": [26.0, 9.0],
            "kwargs": {"name": "smoke", "n_epochs": 3, "alpha": ALPHA, "beta": BETA,
                       "drift": dataclasses.asdict(ref_api.LambdaDrift())},
            "events": [
                {"kind": "AppJoin", "epoch": 1, "app": joiner},
                {"kind": "CapResize", "epoch": 2, "r_cpu": 28.0, "r_mem": 9.5},
                {"kind": "AppLeave", "epoch": 2, "name": "MobileNet_v2_burst"},
            ],
            "runner": _runner(["crms", "predictive_crms", "crms_priority", "drf"]),
        },
        "azure_trace": {
            "source": "benchmarks/burst_robustness.py:99-108 trace_leg",
            "cut": "n_epochs 2 (was 8); epoch_s 600 (was 1200)",
            "constructor": "from_trace", "apps": paper, "caps": [60.0, 20.0],
            "kwargs": {"trace": AZURE, "name": "azure_synth", "n_epochs": 2, **common},
            "runner": _runner(["crms", "robust_crms"], epoch_s=600.0),
        },
        "mmpp_p95": {
            "source": "benchmarks/burst_robustness.py:88-96 sweep_point(3.0), "
                      "p95 policies with a rollout budget",
            "cut": "none (n_epochs 2, epoch_s 400: the benchmark's smoke point)",
            "constructor": "Scenario", "apps": paper, "caps": [60.0, 20.0],
            "kwargs": {"name": "mmpp_b3", "n_epochs": 2,
                       "arrival": ref_mmpp2(3.0, 0.2, 600.0).to_dict(), **common},
            "runner": _runner(["crms_p95", "robust_crms_p95"], epoch_s=400.0,
                              extra={"crms_p95": P95_ROLLOUTS,
                                     "robust_crms_p95": P95_ROLLOUTS}, slo_p95_s=2.0),
        },
        "flash_crowd": {
            "source": "benchmarks/coldstart.py:96-102 _flash_crowd(2.0, n)",
            "cut": "n_epochs 3 (was 12; one spike)",
            "constructor": "flash_crowd", "apps": paper, "caps": [80.0, 32.0],
            "kwargs": {"name": "flash_tc2", "n_epochs": 3, "factor": 3.0, "t_cold": 2.0,
                       **common},
            "runner": _runner(["crms", "crms_lifecycle", "robust_crms_lifecycle"],
                              epoch_s=30.0, quasi_dynamic=False),
        },
        "failures": {
            "source": "benchmarks/failure_resilience.py:83-96 _scenario(60.0, n) with a "
                      "scripted crash and repair",
            "cut": "n_epochs 3 (was 12)",
            "constructor": "Scenario", "apps": paper, "caps": [80.0, 32.0],
            "kwargs": {"name": "fail_mtbf60", "n_epochs": 3, "lifecycle": {"t_cold": 1.0},
                       "failures": {"mtbf": 60.0, "mttr": 10.0, "straggler_frac": 1.0},
                       **common},
            "events": [
                {"kind": "ContainerCrash", "epoch": 1, "name": "ResNet_v2", "k": 1},
                {"kind": "ContainerRepair", "epoch": 2, "name": "ResNet_v2", "k": 1},
            ],
            "runner": _runner(["crms", "crms_failover", "crms_shed"], epoch_s=30.0,
                              quasi_dynamic=False),
        },
    }


def crunch_spec() -> dict:
    fail = {"spec": {"mtbf": 120.0, "mttr": 10.0, "straggler_frac": 1.0}, "down": {},
            "t_cold": 1.0}
    return {
        "source": "benchmarks/failure_resilience.py:195-222 shed_check", "cut": "none",
        "apps": paper_app_values(), "caps": [4.0, 1.2], "alpha": ALPHA, "beta": BETA,
        "seed": SEED,
        "calls": [{"policy": "crms_failover", "extra": {"failures": fail}},
                  {"policy": "crms_shed", "extra": {}},
                  {"policy": "crms", "extra": {}}],
    }


def test_exports_match_the_reference():
    """``repro_torch.api`` exports the reference's names, the fleet scenario
    classes among them, plus ``crms_p95_policy``; every name resolves."""
    assert set(port_api.__all__) == set(ref_api.__all__) | {"crms_p95_policy"}
    for name in port_api.__all__:
        assert getattr(port_api, name) is not None, name


# ----------------------------------------------------------------------------
# Timelines
# ----------------------------------------------------------------------------
def _every_event(api, apps, caps):
    joiner = dataclasses.replace(apps[2], name="joiner", lam=4.0)
    return api.Scenario(
        name="every_event", apps=tuple(apps), caps=caps, n_epochs=6,
        events=(api.LambdaScale(1, 1.2), api.LambdaScale(1, {apps[0].name: 0.5}),
                api.LambdaSet(2, {apps[1].name: 9.5}), api.AppJoin(2, joiner),
                api.LambdaSet(2, {"joiner": 4.5}), api.AppMigrate(3, apps[0].name, 2),
                api.CapResize(3, 25.0, 8.0), api.ContainerCrash(3, apps[3].name, 2),
                api.ContainerRepair(4, apps[3].name, 1), api.ContainerCrash(4, apps[3].name),
                api.AppLeave(5, "joiner"), api.LambdaScale(5, {"joiner": 2.0})),
        drift=api.LambdaDrift(amplitude=0.1, period=5.0),
        arrival={apps[0].name: {"kind": "mmpp", "rates": [2.0, 0.5], "sojourn": [10.0, 30.0]}},
        lifecycle=1.5, failures={"mtbf": 90.0, "mttr": 5.0},
    )


def _trace_rows(names):
    rng = np.random.default_rng(3)
    return {nm: rng.poisson(300.0 * (1 + (i % 2)), 96).astype(float)
            for i, nm in enumerate(names)}


CONSTRUCTORS = {
    "from_tenant_mix": lambda api, apps, caps: api.Scenario.from_tenant_mix(
        "mix8", 8, n_epochs=5, drift=api.LambdaDrift(), events=(api.LambdaScale(2, 1.3),)),
    "burst": lambda api, apps, caps: api.Scenario.burst(
        apps, caps, n_epochs=6, app=apps[2].name, factor=2.0, start=2, length=2),
    "burst_default": lambda api, apps, caps: api.Scenario.burst(apps, caps, n_epochs=3),
    "flash_crowd": lambda api, apps, caps: api.Scenario.flash_crowd(
        apps, caps, n_epochs=12, t_cold=2.0, warm_pool=1),
    "flash_crowd_short": lambda api, apps, caps: api.Scenario.flash_crowd(
        apps, caps, n_epochs=8, factor=3.0),
    "scale_to_zero": lambda api, apps, caps: api.Scenario.scale_to_zero(apps, caps),
    "failover": lambda api, apps, caps: api.Scenario.failover(apps, caps, drop=0.2),
    "diurnal": lambda api, apps, caps: api.Scenario.diurnal(apps, caps, n_epochs=12),
    "priority_tenants": lambda api, apps, caps: api.Scenario.priority_tenants(apps, caps),
    "from_trace_csv": lambda api, apps, caps: api.Scenario.from_trace(
        apps, caps, trace=ROOT / AZURE, n_epochs=8, seed=SEED),
    "from_trace_csv_default": lambda api, apps, caps: api.Scenario.from_trace(
        apps, caps, trace=str(ROOT / AZURE), lam_scale=0.01),
    "from_trace_rows": lambda api, apps, caps: api.Scenario.from_trace(
        apps, caps, trace=_trace_rows([a.name for a in apps]), bin_s=30.0, n_epochs=6),
    "every_event": lambda api, apps, caps: _every_event(api, apps, caps),
}


def _package(which):
    api, problem, kw = (PORT, REF)[which == "ref"]
    profiler = port_profiler if which == "port" else ref_profiler
    apps = profiler.make_paper_apps(lam=LAM4, fitted=False)
    return api, problem, kw, apps, problem.ServerCaps(30.0, 10.0)


def _timeline_record(sc):
    return {
        "name": sc.name, "n_epochs": sc.n_epochs, "alpha": sc.alpha, "beta": sc.beta,
        "seed": sc.seed, "app_weights": dict(sc.options.app_weights),
        "arrival": sc.arrival_doc(), "lifecycle": sc.lifecycle_doc(),
        "failures": sc.failures_doc(),
        "epochs": [{
            "epoch": s.epoch, "apps": [app_values(a) for a in s.apps],
            "caps": [s.caps.r_cpu, s.caps.r_mem, s.caps.power.p_idle, s.caps.power.p_full],
            "events": list(s.events), "migrations": [list(m) for m in s.migrations],
            "faults": [list(f) for f in s.faults],
        } for s in sc.timeline()],
    }


@pytest.mark.parametrize("ctor", sorted(CONSTRUCTORS))
def test_timeline_matches_reference(ctor):
    records = []
    for which in ("ref", "port"):
        api, _, _, apps, caps = _package(which)
        records.append(_timeline_record(CONSTRUCTORS[ctor](api, apps, caps)))
    assert records[1] == records[0]  # pure host arithmetic: bit for bit
    assert len(records[1]["epochs"]) == records[1]["n_epochs"]


def _mini(api, apps, caps, **kw):
    return api.Scenario(name="mini", apps=tuple(apps), caps=caps, **{"n_epochs": 4, **kw})


REJECTIONS = {
    "event_outside": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.CapResize(epoch=9, r_cpu=1.0, r_mem=1.0),)).timeline(),
    "join_twice": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.AppJoin(epoch=0, app=apps[0]),)).timeline(),
    "leave_ghost": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.AppLeave(epoch=0, name="ghost"),)).timeline(),
    "set_ghost": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.LambdaSet(epoch=0, lam={"ghost": 9.0}),)).timeline(),
    "scale_ghost": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.LambdaScale(epoch=0, factors={"ghost": 2.0}),)).timeline(),
    "migrate_ghost": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.AppMigrate(epoch=1, name="ghost", node=1),)).timeline(),
    "crash_k0": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.ContainerCrash(1, apps[0].name, 0),)).timeline(),
    "repair_ghost": lambda api, apps, caps, kw: _mini(
        api, apps, caps, events=(api.ContainerRepair(1, "ghost"),)).timeline(),
    "service": lambda api, apps, caps, kw: _mini(api, apps, caps, service="pareto"),
    "h2_scv": lambda api, apps, caps, kw: _mini(api, apps, caps, service="h2", h2_scv=0.5),
    "arrival_ghost": lambda api, apps, caps, kw: _mini(
        api, apps, caps, arrival={"ghost": {"kind": "poisson"}}),
    "arrival_kind": lambda api, apps, caps, kw: _mini(
        api, apps, caps, arrival={"kind": "selfsimilar"}),
    "lifecycle": lambda api, apps, caps, kw: _mini(api, apps, caps, lifecycle=-1.0),
    "lifecycle_keys": lambda api, apps, caps, kw: _mini(
        api, apps, caps, lifecycle={"t_cold": 1.0, "tcold": 2.0}),
    "failures": lambda api, apps, caps, kw: _mini(api, apps, caps, failures={"mtbf": -1.0}),
    "idle_frac": lambda api, apps, caps, kw: api.Scenario.scale_to_zero(
        apps, caps, idle_frac=1.5),
    "drop": lambda api, apps, caps, kw: api.Scenario.failover(apps, caps, drop=1.2),
    "trace_short": lambda api, apps, caps, kw: api.Scenario.from_trace(
        apps, caps, trace=ROOT / AZURE, n_epochs=1000),
    "trace_empty": lambda api, apps, caps, kw: api.Scenario.from_trace(apps, caps, trace={}),
    "trace_zeros": lambda api, apps, caps, kw: api.Scenario.from_trace(
        apps, caps, trace={a.name: np.zeros(16) for a in apps}),
    "trace_rows": lambda api, apps, caps, kw: api.Scenario.from_trace(
        apps, caps, trace={"x": np.ones(16)}),
    "backend": lambda api, apps, caps, kw: api.ScenarioRunner(
        _mini(api, apps, caps), ["crms"], backend="gpu", **kw),
    "des_engine": lambda api, apps, caps, kw: api.ScenarioRunner(
        _mini(api, apps, caps), ["crms"], des_engine="simpy", **kw),
    "epoch_s": lambda api, apps, caps, kw: api.ScenarioRunner(
        _mini(api, apps, caps), ["crms"], epoch_s=0.0, **kw),
    "slo": lambda api, apps, caps, kw: api.ScenarioRunner(
        _mini(api, apps, caps), ["crms"], slo_p95_s=-1.0, **kw),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_match_reference(case):
    errors = []
    for which in ("ref", "port"):
        api, _, kw, apps, caps = _package(which)
        with pytest.raises(Exception) as info:
            REJECTIONS[case](api, apps, caps, kw)
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[1] == errors[0]
    assert errors[0][0] in ("ValueError", "KeyError", "TypeError")


# ----------------------------------------------------------------------------
# The smoke trace's documents, both packages
# ----------------------------------------------------------------------------
SMOKE_RUNS = {"analytic": ("analytic", "event"), "des-event": ("des", "event"),
              "des-vector": ("des", "vector")}


@functools.lru_cache(maxsize=None)
def smoke_docs(run):
    """(reference, port) documents of the smoke trace under one of
    ``SMOKE_RUNS``, computed once per process."""
    backend, engine = SMOKE_RUNS[run]
    spec = trace_specs()["smoke"]
    ref = chip_smoke.run_trace(spec, ref_api, ref_problem, des_engine=engine, backend=backend)
    port = chip_smoke.run_trace(spec, port_api, port_problem, des_engine=engine,
                                backend=backend, device="cpu")
    return ref, port


def check_smoke(run):
    """Both documents equal field by field, each valid under both validators."""
    ref, port = smoke_docs(run)
    assert_same(plain(ref), plain(port))
    assert port["backend"] == SMOKE_RUNS[run][0]
    for doc in (ref, port):
        ref_api.validate_scenarios_doc(doc)
        port_api.validate_scenarios_doc(doc)
    pols = port["policies"]
    assert [r["M"] for r in pols["crms"]["epochs"]] == [3, 4, 3]
    assert sorted(pols) == ["crms", "crms_priority", "drf", "predictive_crms"]
    assert all(p["summary"]["all_feasible"] for p in pols.values())
    # DRF ignores queue stability (the paper's APP2/APP4 pathology), so the
    # stability gate holds the CRMS policies, as benchmarks/scenarios.py does
    assert all(p["summary"]["all_stable"] for name, p in pols.items() if name != "drf")


def test_smoke_document_matches_reference():
    """Under ``des`` with the event engine; the ``analytic`` backend and the
    vector engine are in ``tests/test_torch_scenario_backends.py``."""
    check_smoke("des-event")


def test_validators_accept_each_others_documents():
    ref, port = smoke_docs("des-event")
    for doc in (ref, port, ref_api.compact_scenarios_doc(port),
                port_api.compact_scenarios_doc(ref)):
        ref_api.validate_scenarios_doc(doc)
        port_api.validate_scenarios_doc(doc)
    bundle = {"schema_version": 2, "backend": "des", "scenarios": {"smoke": port}}
    ref_api.validate_scenarios_doc(bundle)
    port_api.validate_scenarios_doc(port_api.compact_scenarios_doc(bundle))


def _set(path, value):
    """A corruption: ``doc[path...] = value`` (value None deletes the key when
    ``delete``)."""
    def corrupt(doc):
        node = doc
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
        return doc
    return corrupt


def _del_utility(doc):
    del doc["policies"]["crms"]["epochs"][0]["utility"]
    return doc


def _achieved_none(epochs):
    def corrupt(doc):
        for rec in doc["policies"]["crms"]["epochs"][epochs]:
            rec["achieved_mean_s"] = rec["achieved_p95_s"] = None
        return doc
    return corrupt


def _bundle(key="smoke", backend="des"):
    return lambda doc: {"schema_version": 2, "backend": backend, "scenarios": {key: doc}}


def _compact(corrupt):
    return lambda doc: corrupt(port_api.compact_scenarios_doc(doc))


def _drop_column(doc):
    del doc["policies"]["crms"]["epochs_columns"]["utility"]
    return doc


def _short_column(doc):
    doc["policies"]["crms"]["epochs_columns"]["M"].pop()
    return doc


def _drop_epoch(doc):
    doc["policies"]["crms"]["epochs"].pop()
    return doc


CRMS0 = ("policies", "crms", "epochs", 0)
SUMMARY = ("policies", "crms", "summary")
CORRUPTIONS = {
    "schema_version": _set(("schema_version",), 1),
    "schema_minor": _set(("schema_minor",), 9),
    "missing_utility": _del_utility,
    "accepted_moves": _set(CRMS0 + ("accepted_moves",), 99),
    "matrix_ghost": _set(("matrix", "ghost"), {}),
    "epoch_count": _drop_epoch,
    "bundle_key": _bundle(key="renamed"),
    "bundle_backend": _bundle(backend="analytic"),
    "null_apart": _set(CRMS0 + ("achieved_mean_s",), None),
    "null_everywhere": _achieved_none(slice(None)),
    "analytic_achieved": _set(("backend",), "analytic"),
    "weights": _set(("scenario", "app_weights"), {"a": -1.0}),
    "des_engine": _set(("scenario", "des_engine"), "simpy"),
    "service": _set(("scenario", "service"), "pareto"),
    "arrival_kind": _set(("scenario", "arrival"), {"kind": "selfsimilar"}),
    "arrival_app_kind": _set(("scenario", "arrival"), {"app_a": {"kind": "selfsimilar"}}),
    "arrival_phases": _set(("scenario", "arrival"),
                           {"kind": "mmpp", "rates": [1.0], "sojourn": [2.0]}),
    "arrival_empty": _set(("scenario", "arrival"), {}),
    "lifecycle_t_cold": _set(("scenario", "lifecycle"), {"t_cold": -1.0}),
    "lifecycle_pool": _set(("scenario", "lifecycle"), {"warm_pool": 1.5}),
    "lifecycle_pool_negative": _set(("scenario", "lifecycle"), {"warm_pool": -2}),
    "lifecycle_keys": _set(("scenario", "lifecycle"), {"t_cold": 1.0, "tcold": 2.0}),
    "lifecycle_number": _set(("scenario", "lifecycle"), 2.0),
    "failures_mtbf": _set(("scenario", "failures"), {"mtbf": -1.0}),
    "failures_keys": _set(("scenario", "failures"), {"mtbf": 10.0, "junk": 1}),
    "failures_mttr": _set(("scenario", "failures"), {"mtbf": 10.0, "mttr": float("nan")}),
    "failures_straggler": _set(("scenario", "failures"), {"straggler_frac": 0.0}),
    "failures_profile": _set(("scenario", "failures"), {"profile_error": 0.0}),
    "slo": _set(("scenario", "slo_p95_s"), -1.0),
    "violation_rate": _set(SUMMARY + ("p95_violation_rate",), 1.5),
    "summary_type": _set(SUMMARY + ("n_replans",), 1.5),
    "compact_missing_column": _compact(_drop_column),
    "compact_short_column": _compact(_short_column),
}
ACCEPTED = {
    "null_together": _achieved_none(slice(0, 1)),
    "arrival_mmpp": _set(("scenario", "arrival"), {"kind": "mmpp", "rates": [3.0, 0.5],
                                                   "sojourn": [120.0, 480.0]}),
    "lifecycle": _set(("scenario", "lifecycle"), {"t_cold": 2.0, "warm_pool": 1}),
    "failures": _set(("scenario", "failures"), {"mtbf": 80.0, "mttr": 10.0}),
    "slo": _set(("scenario", "slo_p95_s"), 0.6),
    "violation_rate": _set(SUMMARY + ("p95_violation_rate",), 0.5),
    "compact": port_api.compact_scenarios_doc,
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_validators_reject_the_same_corruptions(case):
    _, port = smoke_docs("des-event")
    bad = CORRUPTIONS[case](copy.deepcopy(plain(port)))
    messages = []
    for api in (ref_api, port_api):
        with pytest.raises(ValueError, match="schema violation") as info:
            api.validate_scenarios_doc(copy.deepcopy(bad))
        messages.append(str(info.value))
    assert messages[1] == messages[0]


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_validators_accept_the_same_variants(case):
    _, port = smoke_docs("des-event")
    ok = ACCEPTED[case](copy.deepcopy(plain(port)))
    ref_api.validate_scenarios_doc(ok)
    port_api.validate_scenarios_doc(ok)


# ----------------------------------------------------------------------------
# The golden file chip_smoke.py replays on the card
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_file_is_current(golden):
    """The recorded descriptions are this file's, and the reference still
    produces the recorded smoke and crunch results."""
    specs = trace_specs()
    assert sorted(golden["traces"]) == sorted(specs)
    for name, spec in specs.items():
        assert {k: v for k, v in golden["traces"][name].items() if k != "doc"} == plain(spec)
    ref = chip_smoke.run_trace(specs["smoke"], ref_api, ref_problem)
    assert_same(golden["traces"]["smoke"]["doc"], plain(ref))
    crunch = crunch_spec()
    assert {k: v for k, v in golden["crunch"].items() if k != "results"} == plain(crunch)
    assert_same(golden["crunch"]["results"],
                chip_smoke.crunch_records(crunch, ref_api, ref_problem)[0])


def test_port_crunch_matches_golden(golden):
    """The capacity crunch (caps (4, 1.2)) through the port: crms_failover and
    crms_shed shed to a feasible, stable admitted set with the same admission
    map; plain crms records its infeasibility."""
    got, _ = chip_smoke.crunch_records(golden["crunch"], port_api, port_problem, device="cpu")
    assert_same(golden["crunch"]["results"], got)
    failover, shed, crms = got
    assert failover["feasible"] and failover["stable"] and failover["shed"]
    assert shed["admission"] == failover["admission"]
    assert crms["extra"]["infeasible"]["feasible"] is False


def write_golden(path=GOLDEN):
    """The reference's documents (des_engine "vector") for every trace, and
    its crunch allocations, beside the descriptions that built them."""
    traces = {}
    for name, spec in trace_specs().items():
        doc = chip_smoke.run_trace(spec, ref_api, ref_problem)
        ref_api.validate_scenarios_doc(doc)
        traces[name] = {**plain(spec), "doc": plain(doc)}
        print(name, {p: v["n_replans"] for p, v in doc["matrix"].items()}, flush=True)
    crunch = crunch_spec()
    out = {
        "about": "Reference (repro, JAX on the CPU) scenario documents and crunch "
                 "allocations for the port's parity checks; regenerate with "
                 "PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_scenario.py",
        "setup": {"des_engine": "vector", "rtol": chip_smoke.SCENARIO_RTOL,
                  "excluded": list(chip_smoke.SCENARIO_SKIP)},
        "traces": traces,
        "crunch": {**plain(crunch),
                   "results": chip_smoke.crunch_records(crunch, ref_api, ref_problem)[0]},
    }
    path.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    write_golden()
    sys.exit(0)
