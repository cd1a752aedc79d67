"""The fleet's row solve on a mesh (``engine.ip_solve_rows(mesh=...)``,
``FleetPlanner(mesh=...)``, ``crms_fleet`` with ``request.extra["mesh"]``):
four CPU ranks over gloo (``launch.mesh.spawn``, one group for the file) on a
(4,) "nodes" mesh against the single-device port. Rows are independent, so
the mesh changes nothing: every array bit for bit, every record equal. The
row solve on the mesh is also held to the reference's (JAX, CPU) within
1e-9, ``tests/test_torch_rows.py``'s bar. (``crms_fleet``'s re-plans: see
its test.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro.core import engine as reng
from repro_torch.core import engine as teng
from repro_torch.core.placement import make_fleet
from repro_torch.launch.mesh import spawn

from torch_scripts import chip_smoke, fleet_records, mesh_fleet_cases

ALPHA, BETA, SPAN = 1.4, 0.2, 150.0
M_PAD, WIDTH = 32, 16
STACKS = {"4_rows": (3, 8, 16, 5), "8_rows": (3, 8, 16, 5, 7, 2, 11, 4)}
SENTINEL = dict(kappa=(1.0, 1.0, 1.0), lam=1e-3, xbar=1.0, r_min=0.5, r_max=2.0,
                cpu_min=0.05, cpu_max=16.0)
FIELDS = ("kappa", "lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max")
PLANS = ("uniform", "incremental", "migration", "ragged")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stack(sizes, seed=5):
    """Nodes of ``sizes`` apps padded to M_PAD sentinel slots, each its own
    budget, counts from a seeded draw, phase-1 starts from the port's masked
    waterfill (as tests/test_torch_rows.py builds its stack)."""
    apps, _ = make_fleet(len(sizes), max(sizes), seed=seed)
    packed = teng.PackedApps.from_apps(apps)
    rng = np.random.default_rng(17)
    N = len(sizes)
    mask = np.zeros((N, M_PAD))
    slots = np.zeros((N, M_PAD), dtype=int)
    for j, size in enumerate(sizes):
        mask[j, :size] = 1.0
        slots[j, :size] = (np.arange(size) + j * max(sizes)) % len(apps)
    rows = {}
    for f in FIELDS:
        g = getattr(packed, f)[slots]
        shape = mask.shape + (1,) * (g.ndim - 2)
        rows[f] = np.where(mask.reshape(shape) > 0, g, np.asarray(SENTINEL[f]))
    n = np.where(mask > 0, rng.integers(2, 5, size=(N, M_PAD)), 0).astype(float)
    caps = (np.array([10.0 * s for s in sizes]), np.array([13.0 * s for s in sizes]))
    x0, ok = teng.find_feasible_start_batch(teng.PackedApps(**rows), teng.ServerCaps(*caps), n,
                                            mask=mask)
    assert ok.all()
    return {"rows": rows, "mask": mask, "n": n, "x0": x0, "caps": caps, "span": SPAN,
            "width": WIDTH}


@pytest.fixture(scope="module")
def stacks():
    return {name: _stack(sizes) for name, sizes in STACKS.items()}


@pytest.fixture(scope="module")
def single(stacks):
    return fleet_records(None, stacks)


@pytest.fixture(scope="module")
def ranks(stacks):
    """Every rank's records of the same cases on the (4,) mesh."""
    return spawn(mesh_fleet_cases, 4, args=(stacks,), timeout=600)


def _same(a, b, path="$"):
    """Equal bit for bit: arrays by their bytes, floats exactly, containers
    member by member."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", list(STACKS))
def test_row_solve_on_mesh_is_bit_for_bit(ranks, single, name):
    for rec in ranks:
        _same(rec[("rows", name)], single[("rows", name)])


@pytest.mark.parametrize("name", list(STACKS))
def test_row_solve_on_mesh_matches_reference(ranks, stacks, name):
    s = stacks[name]
    packed = {k: jnp.asarray(v) for k, v in s["rows"].items()}
    packed["mask"] = jnp.asarray(s["mask"])
    want = reng.ip_solve_rows(jnp.asarray(s["x0"]), packed, jnp.asarray(s["n"]),
                              *(jnp.asarray(c) for c in s["caps"]), jnp.asarray(SPAN),
                              ALPHA, BETA, width=WIDTH)
    for got, ref in zip(ranks[0][("rows", name)], want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-9, atol=0)


@pytest.mark.parametrize("case", PLANS)
def test_planner_on_mesh_equals_single_device(ranks, single, case):
    """tests/test_placement.py's plans (a uniform fleet, an incremental
    re-plan, a migration, ragged nodes in one padded batch): every rank's
    plan and node solutions equal the single device's bit for bit."""
    for rec in ranks:
        _same(rec[case], single[case])


def test_phase19_path_on_mesh_equals_single_device(ranks, single):
    """chip_smoke's phase-19 path (cold plan, drift and a migration) at
    12 x 8 through FleetPlanner(mesh=...): the records equal."""
    for rec in ranks:
        chip_smoke.assert_same(single["phase19"], rec["phase19"], "phase19", rtol=0.0)


def test_crms_fleet_with_mesh_equals_single_device(ranks, single):
    """Three epochs (cold, drift, a migration): counts, flags and counters
    exactly, floats within 1e-12. A re-plan's few rows are solved here one
    a rank (padded to the axis), on one device as one smaller batch; in the
    drift epoch one quota came out 1 ulp apart on this CPU."""
    assert [r["cold"] for r in ranks[0]["crms_fleet"]] == [True, False, False]
    want = chip_smoke.plain(single["crms_fleet"])
    for rec in ranks:
        chip_smoke.assert_same(want, chip_smoke.plain(rec["crms_fleet"]), "crms_fleet",
                               rtol=1e-12)
