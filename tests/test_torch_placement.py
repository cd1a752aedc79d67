"""The fleet placement layer of the port (``repro_torch.core.placement``, the
``crms_fleet`` policy, ``FleetScenario`` / ``FleetScenarioRunner``): every
case of ``tests/test_placement.py`` on the port (device="cpu"), and the port
against repro (JAX, CPU) on the same fleets — plans' assignments and counts
exactly, quotas, response times and node utilities within rtol 1e-6,
counters equal; the incremental re-plan's untouched nodes byte-identical;
the migration scenario's document field by field (floats rtol 1e-6, wall
clocks left out).

``tests/data/torch_fleet_golden.json`` holds the reference's plan of
make_fleet(1000, 16) (assignment and counts whole, every node's utility, 64
sampled nodes' floats), its incremental re-plan and the migration
scenario's document, which ``chip_smoke.py`` phase 19 replays on the card.
Regenerate it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_placement.py
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro import api as ref_api
from repro.core import placement as ref_placement
from repro_torch import api as port_api
from repro_torch.api import (
    AllocRequest,
    AppMigrate,
    CapResize,
    FleetScenario,
    FleetScenarioRunner,
    LambdaScale,
    Scenario,
    allocate,
    get_policy,
)
from repro_torch.api.scenario import AppJoin, AppLeave, LambdaSet
from repro_torch.core import engine as port_engine
from repro_torch.core import placement as port_placement
from repro_torch.core import queueing
from repro_torch.core.engine import PackedApps, p1_solve_batch
from repro_torch.core.placement import FleetPlanner, make_fleet
from repro_torch.core.problem import App, ServerCaps

from torch_scripts import chip_smoke

ALPHA, BETA = 1.4, 0.2
CPU = {"device": "cpu"}


assert_same, plain = chip_smoke.assert_same, chip_smoke.plain
GOLDEN = chip_smoke.FLEET_GOLDEN


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small_fleet():
    apps, node_caps = make_fleet(8, 6, seed=11)
    planner = FleetPlanner(apps, node_caps, alpha=ALPHA, beta=BETA, **CPU)
    plan = planner.plan()
    return planner, plan


# ----------------------------------------------------------------------------
# tests/test_placement.py on the port
# ----------------------------------------------------------------------------
def test_erlang_width_narrowing_is_exact():
    cases = [(1.0, 4.0, 6.0), (3.0, 9.0, 4.0), (7.0, 20.0, 3.5), (15.0, 31.0, 2.5)]
    for n, lam, mu in cases:
        full = float(queueing.erlang_ws(n, lam, mu))
        narrow = float(queueing.erlang_ws(n, lam, mu, width=16))
        # masked logsumexp terms are exp(-inf) = 0: bit-exact, not approximate
        assert full == narrow


def test_width_below_counts_rejected():
    apps, node_caps = make_fleet(2, 4, seed=0)
    packed = PackedApps.from_apps(apps)
    caps = ServerCaps(*node_caps[0])
    n = np.full((1, len(apps)), 9.0)
    with pytest.raises(ValueError):
        p1_solve_batch(packed, caps, n, ALPHA, BETA, max_servers=8, **CPU)


def _ragged(package, **kw):
    """Nodes with 3, 8 and 16 apps through ONE padded batch, no exchange."""
    sizes = (3, 8, 16)
    apps, _ = package.make_fleet(3, 16, seed=5)
    apps = list(apps)[: sum(sizes)]
    assignment = np.repeat(np.arange(3), sizes)
    node_caps = [(10.0 * s, 13.0 * s) for s in sizes]
    planner = package.FleetPlanner(apps, node_caps, alpha=ALPHA, beta=BETA, exchange_rounds=0,
                                   initial_assignment=assignment, **kw)
    return planner, planner.plan(), sizes, assignment


def test_ragged_fleet_padding_parity():
    """Nodes with 3, 8 and 16 apps through ONE padded batch must match each
    node's standalone p1_solve_batch row exactly."""
    planner, plan, sizes, assignment = _ragged(port_placement, **CPU)
    assert plan.diagnostics["M_pad"] == 32
    assert plan.diagnostics["nodes_failed"] == 0
    assert np.array_equal(planner.assignment, assignment)

    for j, size in enumerate(sizes):
        on_j, n_apps, caps, n_row, c_hint = planner.node_problem(j)
        assert len(on_j) == size
        ref = p1_solve_batch(
            PackedApps.from_apps(n_apps), caps, n_row, ALPHA, BETA,
            c_hint=c_hint, profile=planner.profile, max_servers=planner._width, **CPU,
        )
        assert bool(ref.converged[0])
        np.testing.assert_allclose(ref.r_cpu[0], planner.sol_c[on_j], rtol=1e-6)
        np.testing.assert_allclose(ref.r_mem[0], planner.sol_m[on_j], rtol=1e-6)
        assert abs(ref.utility[0] - planner.node_utility[j]) <= 1e-6 * abs(
            planner.node_utility[j]
        )
        assert ref.info["n_masked"] == 0
        assert ref.info.get("n_rescued", 0) == 0
    assert plan.diagnostics["p1_rescued_rows"] == 0
    assert plan.diagnostics["p1_masked_rows"] == 0


def test_fleet_parity_on_uniform_fleet(small_fleet):
    planner, plan = small_fleet
    assert plan.diagnostics["nodes_failed"] == 0
    for j in range(planner.N):
        on_j, n_apps, caps, n_row, c_hint = planner.node_problem(j)
        ref = p1_solve_batch(
            PackedApps.from_apps(n_apps), caps, n_row, ALPHA, BETA,
            c_hint=c_hint, profile=planner.profile, max_servers=planner._width, **CPU,
        )
        assert bool(ref.converged[0])
        np.testing.assert_allclose(ref.r_cpu[0], planner.sol_c[on_j], rtol=1e-6)
        np.testing.assert_allclose(ref.r_mem[0], planner.sol_m[on_j], rtol=1e-6)


def test_incremental_replan_touches_only_changed_nodes():
    apps, node_caps = make_fleet(8, 6, seed=3)
    planner = FleetPlanner(apps, node_caps, alpha=ALPHA, beta=BETA, **CPU)
    planner.plan()
    before_c = planner.sol_c.copy()
    before_n = planner.n.copy()

    target = planner.apps[0].name
    node0 = int(planner.assignment[0])
    plan = planner.replan(lam={target: float(planner.lam[0]) * 1.4})
    assert plan.diagnostics["nodes_solved"] == 1
    untouched = planner.assignment != node0
    assert planner.sol_c[untouched].tobytes() == before_c[untouched].tobytes()
    assert np.array_equal(planner.n[untouched], before_n[untouched])
    assert not np.array_equal(planner.sol_c[~untouched], before_c[~untouched])


def test_migration_moves_app_and_resolves_both_nodes():
    apps, node_caps = make_fleet(6, 6, seed=7)
    planner = FleetPlanner(apps, node_caps, alpha=ALPHA, beta=BETA, **CPU)
    planner.plan()
    name = planner.apps[0].name
    src = int(planner.assignment[0])
    dst = (src + 3) % planner.N
    plan = planner.replan(migrations=[(name, dst)])
    assert int(planner.assignment[0]) == dst
    assert plan.diagnostics["migrations"] == 1
    assert plan.diagnostics["nodes_solved"] == 2
    assert plan.diagnostics["nodes_failed"] == 0


def test_crms_fleet_policy_cold_then_incremental():
    apps, node_caps = make_fleet(4, 5, seed=1)
    pol = get_policy("crms_fleet")
    pol.reset()
    req = AllocRequest(
        apps=tuple(apps), caps=ServerCaps(*node_caps[0]), alpha=ALPHA, beta=BETA,
        extra={"node_caps": node_caps}, **CPU,
    )
    r1 = allocate("crms_fleet", req)
    assert r1.diagnostics.extra["cold"] is True
    assert r1.diagnostics.nodes_total == 4
    assert r1.allocation.feasible and r1.allocation.stable
    assert len(r1.allocation.meta["assignment"]) == len(apps)

    drifted = tuple(
        a.with_lam(a.lam * 1.1) if i == 0 else a for i, a in enumerate(apps)
    )
    r2 = allocate("crms_fleet", dataclasses.replace(req, apps=drifted))
    assert r2.diagnostics.extra["cold"] is False
    assert r2.diagnostics.nodes_solved == 1
    pol.reset()


def test_crms_fleet_requires_node_caps():
    apps, _ = make_fleet(2, 4, seed=0)
    with pytest.raises(ValueError, match="node_caps"):
        allocate("crms_fleet", AllocRequest(apps=tuple(apps), caps=ServerCaps(60.0, 80.0), **CPU))


def test_same_epoch_events_apply_in_pinned_order():
    base = [
        App(name="a0", lam=6.0, xbar=5.0, kappa=(350.0, 0.1, 60.0), r_min=0.5, r_max=2.0),
        App(name="a1", lam=7.0, xbar=5.0, kappa=(350.0, 0.1, 60.0), r_min=0.5, r_max=2.0),
    ]
    joiner = App(name="a2", lam=5.0, xbar=5.0, kappa=(350.0, 0.1, 60.0), r_min=0.5, r_max=2.0)
    events = (
        AppLeave(1, "a1"),
        LambdaScale(1, {"a2": 2.0}),
        LambdaSet(1, {"a2": 4.0}),
        CapResize(1, 25.0, 9.0),
        AppJoin(1, joiner),
    )
    for order in (events, events[::-1]):
        sc = Scenario(
            name="tiebreak", apps=tuple(base), caps=ServerCaps(30.0, 10.0),
            n_epochs=2, events=order,
        )
        state = sc.timeline()[1]
        assert [a.name for a in state.apps] == ["a0", "a2"]
        lam = {a.name: a.lam for a in state.apps}
        assert lam["a2"] == pytest.approx(8.0)
        assert state.caps.r_cpu == 25.0
        assert list(state.events) == sorted(
            state.events,
            key=lambda s: ["app_join", "app_migrate", "cap_resize",
                           "lam_set", "lam_scale", "app_leave"].index(s.split(":")[0]),
        )


def test_migrate_tiebreak_follows_join():
    base = (App(name="a0", lam=6.0, xbar=5.0, kappa=(350.0, 0.1, 60.0), r_min=0.5, r_max=2.0),)
    joiner = App(name="a1", lam=5.0, xbar=5.0, kappa=(350.0, 0.1, 60.0), r_min=0.5, r_max=2.0)
    sc = FleetScenario(
        name="mig", apps=base, caps=ServerCaps(30.0, 10.0), n_epochs=2,
        events=(AppMigrate(1, "a1", 0), AppJoin(1, joiner)),
        node_caps=((30.0, 10.0), (30.0, 10.0)),
    )
    state = sc.timeline()[1]
    assert [a.name for a in state.apps] == ["a0", "a1"]
    assert state.migrations == (("a1", 0),)


def test_migrate_unknown_app_rejected():
    base = (App(name="a0", lam=6.0, xbar=5.0, kappa=(350.0, 0.1, 60.0), r_min=0.5, r_max=2.0),)
    sc = Scenario(
        name="bad", apps=base, caps=ServerCaps(30.0, 10.0), n_epochs=2,
        events=(AppMigrate(1, "ghost", 1),),
    )
    with pytest.raises(ValueError, match="ghost"):
        sc.timeline()


def _runner_smoke(api, **kw):
    sc = api.FleetScenario.from_fleet(
        "fleet_smoke", 6, 5, seed=2, n_epochs=3,
        events=(api.LambdaScale(1, 1.2), api.AppMigrate(2, "app00000", 3)),
        validate_nodes=2,
    )
    return api.FleetScenarioRunner(sc, epoch_s=30.0, **kw).run()


def test_fleet_scenario_runner_migration_and_des_sample():
    doc = _runner_smoke(port_api, **CPU)
    assert doc["schema_version"] == "fleet-1"
    assert doc["summary"]["n_cold"] == 1
    assert doc["summary"]["migrations_total"] == 1
    assert doc["summary"]["all_nodes_ok"]
    for epoch in doc["epochs"]:
        assert 0 < epoch["validated_nodes"] <= 2
        for v in epoch["validation"]:
            assert v["n_completed"] > 0
            if v["gap_rel"] is not None:
                assert v["gap_rel"] < 0.6
    assert doc["summary"]["validation_gap_rel_mean"] < 0.25
    # ... and the reference's document, field by field
    assert_same(plain(_runner_smoke(ref_api)), plain(doc))


# ----------------------------------------------------------------------------
# The port against the reference
# ----------------------------------------------------------------------------
def test_make_fleet_matches_reference():
    for args in ((8, 6, 11, True), (3, 4, 2, False)):
        ref_apps, ref_caps = ref_placement.make_fleet(*args[:2], seed=args[2], hetero=args[3])
        apps, caps = make_fleet(*args[:2], seed=args[2], hetero=args[3])
        assert [dataclasses.asdict(a) for a in apps] == [dataclasses.asdict(a) for a in ref_apps]
        assert caps == ref_caps


def _plan_record(planner, plan):
    rec = chip_smoke.fleet_record(planner, plan, cold=True)
    rec["all"] = chip_smoke.node_floats(planner, list(range(planner.N)))
    return rec


def test_small_fleet_plan_matches_reference(small_fleet):
    apps, node_caps = ref_placement.make_fleet(8, 6, seed=11)
    ref = ref_placement.FleetPlanner(apps, node_caps, alpha=ALPHA, beta=BETA)
    ref_rec = _plan_record(ref, ref.plan())
    rec = _plan_record(*small_fleet)
    assert rec["assignment"] == ref_rec["assignment"] and rec["n"] == ref_rec["n"]
    assert rec["diagnostics"] == ref_rec["diagnostics"]
    assert_same(ref_rec, rec, "plan")


def test_ragged_padding_matches_reference():
    port, port_plan, *_ = _ragged(port_placement, **CPU)
    ref, ref_plan, *_ = _ragged(ref_placement)
    assert_same(_plan_record(ref, ref_plan), _plan_record(port, port_plan), "ragged")
    for j in range(3):  # the recorded phase-1 hints: what the parity solves start from
        hint, ref_hint = port.node_problem(j)[4], ref.node_problem(j)[4]
        np.testing.assert_allclose(hint, ref_hint, rtol=1e-12)


def test_cold_and_incremental_plans_match_reference():
    """chip_smoke's phase-19 path (cold plan, the benchmark's drift and one
    migration, the untouched nodes byte-identical) at 12 x 8 on both."""
    ref = chip_smoke.run_fleet(ref_placement, 12, 8)
    port = chip_smoke.run_fleet(port_placement, 12, 8, **CPU)
    assert_same(ref[1], port[1], "cold")
    assert_same(ref[2], port[2], "replan")
    assert port[2]["touched"] == ref[2]["touched"] and len(port[2]["touched"]) >= 2
    assert chip_smoke.fleet_parity(port[0], port_engine, range(port[0].N), **CPU) <= 1e-6


def test_crms_fleet_matches_reference_cold_then_incremental():
    apps_r, caps_r = ref_placement.make_fleet(5, 4, seed=4)
    apps_p, caps_p = make_fleet(5, 4, seed=4)
    migrate = [("app00002", 4)]
    records = []
    for api, apps, caps, kw in ((ref_api, apps_r, caps_r, {}), (port_api, apps_p, caps_p, CPU)):
        pol = api.get_policy("crms_fleet")
        pol.reset()
        seq = []
        for step in range(3):
            drifted = tuple(a.with_lam(a.lam * (1.0 + 0.1 * step)) if i % 3 == 0 else a
                            for i, a in enumerate(apps))
            extra = {"node_caps": caps, "migrations": migrate if step == 2 else []}
            res = api.allocate("crms_fleet", api.AllocRequest(
                apps=drifted, caps=caps_r[0] if api is ref_api else ServerCaps(*caps[0]),
                alpha=ALPHA, beta=BETA, extra=extra, **kw))
            a, d = res.allocation, res.diagnostics
            seq.append(plain({"n": a.n, "r_cpu": a.r_cpu, "r_mem": a.r_mem, "ws": a.ws,
                              "utility": a.utility, "power_w": a.power_w,
                              "feasible": a.feasible, "meta": {
                                  k: v for k, v in a.meta.items() if k != "diagnostics"},
                              "extra": d.extra, "nodes_solved": d.nodes_solved,
                              "migrations": d.migrations}))
        pol.reset()
        records.append(seq)
    assert [r["extra"]["cold"] for r in records[1]] == [True, False, False]
    assert records[1][2]["migrations"] == 1
    assert_same(records[0], records[1], "crms_fleet")


def test_mesh_raises():
    apps, node_caps = make_fleet(2, 3, seed=0)
    with pytest.raises(NotImplementedError, match="one device"):
        FleetPlanner(apps, node_caps, mesh=object(), **CPU)
    with pytest.raises(NotImplementedError, match="one device"):
        allocate("crms_fleet", AllocRequest(apps=tuple(apps), caps=ServerCaps(*node_caps[0]),
                                            extra={"node_caps": node_caps, "mesh": object()},
                                            **CPU))
    get_policy("crms_fleet").reset()


# ----------------------------------------------------------------------------
# The golden file chip_smoke.py phase 19 replays on the card
# ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def test_golden_file_describes_phase_19(golden):
    assert golden["setup"] == _setup()
    plan = golden["plan"]
    A = chip_smoke.FLEET_NODES * chip_smoke.FLEET_APPS
    assert len(plan["assignment"]) == len(plan["n"]) == A
    assert len(plan["node_utility"]) == chip_smoke.FLEET_NODES
    assert len(plan["sampled"]["nodes"]) == chip_smoke.FLEET_SAMPLED
    assert plan["diagnostics"]["nodes_failed"] == 0
    assert golden["replan"]["diagnostics"]["nodes_solved"] == len(golden["replan"]["touched"])


def test_port_matches_golden_scenario(golden):
    """The migration scenario (16 nodes x 8 apps, 4 epochs, vector engine)
    through the port on the CPU against the reference's document."""
    doc = chip_smoke.fleet_scenario_doc(port_api, **CPU)
    assert_same(golden["scenario"], plain(doc), "scenario")
    assert doc["summary"]["migrations_total"] == 1 and doc["summary"]["all_nodes_ok"]


def _setup() -> dict:
    return {"nodes": chip_smoke.FLEET_NODES, "apps_per_node": chip_smoke.FLEET_APPS,
            "seed": chip_smoke.FLEET_SEED, "alpha": ALPHA, "beta": BETA,
            "sampled_nodes": chip_smoke.FLEET_SAMPLED, "scenario": list(chip_smoke.FLEET_SCENARIO),
            "rtol": chip_smoke.SCENARIO_RTOL}


def write_golden(path=GOLDEN):
    """The reference's plan and incremental re-plan of make_fleet(1000, 16)
    and its migration scenario's document, on the CPU."""
    _, cold, incr, numbers = chip_smoke.run_fleet(ref_placement)
    print(numbers, flush=True)
    doc = chip_smoke.fleet_scenario_doc(ref_api)
    out = {
        "about": "Reference (repro, JAX on the CPU) fleet plans and migration scenario for "
                 "the port's parity checks; regenerate with PYTHONPATH=src JAX_PLATFORMS=cpu "
                 "python tests/test_torch_placement.py",
        "setup": _setup(),
        "plan": cold,
        "replan": incr,
        "scenario": plain(doc),
    }
    path.write_text(json.dumps(out, separators=(",", ":")) + "\n")


if __name__ == "__main__":
    write_golden()
    sys.exit(0)
