"""Port parity of the row-wise P1 solve (``engine.ip_solve_rows``, the fleet
placement layer's inner engine): repro (JAX, CPU) against repro_torch
(device="cpu") on one ragged, sentinel-masked row stack — every row its own
packing, mask and budgets — within 1e-9; and the shared-packing path left as
it was: a row stack whose rows all carry the shared packing solves exactly
as ``_ip_solve_batched`` does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401 — float64 on before the reference's kernels load
from repro.core import engine as reng
from repro.core.placement import make_fleet
from repro_torch.core import engine as teng

ALPHA, BETA, SPAN = 1.4, 0.2, 150.0
SIZES = (3, 8, 16, 5)
M_PAD = 32
WIDTH = 16
SENTINEL = dict(kappa=(1.0, 1.0, 1.0), lam=1e-3, xbar=1.0, r_min=0.5, r_max=2.0,
                cpu_min=0.05, cpu_max=16.0)
FIELDS = ("kappa", "lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def stack():
    """Nodes of 3, 8, 16 and 5 apps padded to 32 slots with sentinels, each
    its own (cpu, mem) budget, counts from a seeded draw, phase-1 starts from
    the reference's masked waterfill."""
    apps, _ = make_fleet(len(SIZES), max(SIZES), seed=5)
    packed = reng.PackedApps.from_apps(apps)
    rng = np.random.default_rng(17)
    N = len(SIZES)
    mask = np.zeros((N, M_PAD))
    slots = np.zeros((N, M_PAD), dtype=int)
    start = 0
    for j, size in enumerate(SIZES):
        mask[j, :size] = 1.0
        slots[j, :size] = np.arange(start, start + size)
        start += size
    rows = {}
    for f in FIELDS:
        g = getattr(packed, f)[slots]
        shape = mask.shape + (1,) * (g.ndim - 2)
        rows[f] = np.where(mask.reshape(shape) > 0, g, np.asarray(SENTINEL[f]))
    n = np.where(mask > 0, rng.integers(2, 5, size=(N, M_PAD)), 0).astype(float)
    caps_cpu = np.array([10.0 * s for s in SIZES])
    caps_mem = np.array([13.0 * s for s in SIZES])
    x0, ok = reng.find_feasible_start_batch(
        reng.PackedApps(**rows), reng.ServerCaps(caps_cpu, caps_mem), n, mask=mask)
    assert ok.all()
    return {"rows": rows, "mask": mask, "n": n, "x0": x0, "caps": (caps_cpu, caps_mem)}


def _ref(s, **kw):
    packed = {k: jnp.asarray(v) for k, v in s["rows"].items()}
    packed["mask"] = jnp.asarray(s["mask"])
    out = reng.ip_solve_rows(jnp.asarray(s["x0"]), packed, jnp.asarray(s["n"]),
                             *(jnp.asarray(c) for c in s["caps"]), jnp.asarray(SPAN),
                             ALPHA, BETA, width=WIDTH, **kw)
    return [np.asarray(a) for a in out]


def _port(s, **kw):
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=float))  # noqa: E731
    packed = {k: t(v) for k, v in s["rows"].items()}
    packed["mask"] = t(s["mask"])
    out = teng.ip_solve_rows(t(s["x0"]), packed, t(s["n"]), *(t(c) for c in s["caps"]),
                             SPAN, ALPHA, BETA, width=WIDTH, **kw)
    return [a.numpy() for a in out]


def test_phase1_start_of_a_row_stack_matches(stack):
    x0, ok = teng.find_feasible_start_batch(
        teng.PackedApps(**stack["rows"]), teng.ServerCaps(*stack["caps"]), stack["n"],
        mask=stack["mask"])
    assert ok.all()
    np.testing.assert_array_equal(x0, stack["x0"])


@pytest.mark.parametrize("profile", ["fleet", "refine"])
def test_row_solve_matches_reference(stack, profile):
    n_outer, n_inner = teng.P1_PROFILES[profile]
    ref = _ref(stack, n_outer=n_outer, n_inner=n_inner)
    port = _port(stack, n_outer=n_outer, n_inner=n_inner)
    for name, r, p in zip(("x", "utility", "ws"), ref, port):
        np.testing.assert_allclose(p, r, rtol=1e-9, atol=0.0, err_msg=name)
    # sentinel slots: frozen at their box centre, zero response time
    x, _, ws = port
    mask = stack["mask"] > 0
    centre_c = 0.5 * (SENTINEL["cpu_min"] + SENTINEL["cpu_max"])
    np.testing.assert_array_equal(x[:, :M_PAD][~mask], centre_c)
    np.testing.assert_array_equal(ws[~mask], 0.0)
    assert np.all(ws[mask] > 0) and np.all(np.isfinite(port[1]))


def test_dense_direction_on_rows_matches_structured():
    """Unmasked rows (the dense direction leaves no coordinate frozen, so it
    is held to the structured one where every slot is live), each its own
    packing and budget."""
    apps, _ = make_fleet(3, 6, seed=9)
    packed = reng.PackedApps.from_apps(apps)
    rows = {f: getattr(packed, f).reshape((3, 6) + getattr(packed, f).shape[1:])
            for f in FIELDS}
    n = np.random.default_rng(4).integers(2, 5, size=(3, 6)).astype(float)
    caps = (np.array([55.0, 60.0, 65.0]), np.array([70.0, 75.0, 80.0]))
    x0, ok = teng.find_feasible_start_batch(teng.PackedApps(**rows), teng.ServerCaps(*caps), n)
    assert ok.all()
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=float))  # noqa: E731
    args = (t(x0), {k: t(v) for k, v in rows.items()}, t(n), t(caps[0]), t(caps[1]), SPAN,
            ALPHA, BETA)
    struct = teng.ip_solve_rows(*args, n_outer=4, n_inner=2)
    dense = teng.ip_solve_rows(*args, n_outer=4, n_inner=2, solver="dense")
    for name, a, b in zip(("x", "utility", "ws"), struct, dense):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, err_msg=name)


def test_app_ws_matches_reference(stack):
    x = stack["x0"]
    for j in range(len(SIZES)):
        ref_pk = {k: jnp.asarray(v[j]) for k, v in stack["rows"].items()}
        ref_pk["mask"] = jnp.asarray(stack["mask"][j])
        port_pk = {k: torch.as_tensor(v[j]) for k, v in stack["rows"].items()}
        port_pk["mask"] = torch.as_tensor(stack["mask"][j])
        ref = np.asarray(reng.p1_app_ws(jnp.asarray(x[j]), ref_pk, jnp.asarray(stack["n"][j]),
                                        WIDTH))
        port = teng.p1_app_ws(torch.as_tensor(x[j]), port_pk, torch.as_tensor(stack["n"][j]),
                              WIDTH).numpy()
        np.testing.assert_allclose(port, ref, rtol=1e-12, atol=0.0)


def test_shared_packing_path_unchanged():
    """Rows that all carry one packing and one budget are the shared-packing
    batch: the row solve returns exactly what ``_ip_solve_batched`` does."""
    ref = reng.PackedApps.from_apps(make_fleet(1, 6, seed=2)[0])
    packed = teng.PackedApps(**{f: getattr(ref, f) for f in FIELDS})
    caps_cpu, caps_mem = 50.0, 70.0
    rng = np.random.default_rng(3)
    n = rng.integers(2, 5, size=(4, packed.M)).astype(float)
    x0, ok = teng.find_feasible_start_batch(packed, teng.ServerCaps(caps_cpu, caps_mem), n)
    assert ok.all()
    shared = packed.as_dict("cpu")
    x_b, u_b = teng._ip_solve_batched(torch.as_tensor(x0), shared, torch.as_tensor(n),
                                      caps_cpu, caps_mem, SPAN, ALPHA, BETA, n_outer=8,
                                      n_inner=3)
    rows = {k: v.expand(n.shape[:1] + v.shape).contiguous() for k, v in shared.items()}
    B = n.shape[0]
    x_r, u_r, ws_r = teng.ip_solve_rows(
        torch.as_tensor(x0), rows, torch.as_tensor(n), torch.full((B,), caps_cpu),
        torch.full((B,), caps_mem), SPAN, ALPHA, BETA)
    assert torch.equal(x_r, x_b) and torch.equal(u_r, u_b)
    assert torch.all(torch.isfinite(ws_r))


def test_mesh_raises(stack):
    with pytest.raises(NotImplementedError, match="one device"):
        _port(stack, mesh=object())
